"""Standalone chart/report components.

Parity with ``deeplearning4j-ui-components`` (2.2k LoC of Java component
classes + bundled JS renderers): serializable building blocks — line/scatter
charts, histograms, tables, text — that render to JSON (for a frontend) or
directly to self-contained SVG/HTML (no JS dependency), and compose into a
page. Used standalone or embedded in the UIServer dashboard.
"""

from __future__ import annotations

import html
import json
from typing import List, Optional, Sequence, Tuple

_PALETTE = ("#1565c0", "#c62828", "#2e7d32", "#f9a825", "#6a1b9a", "#00838f")


class StyleChart:
    """Chart styling (``StyleChart.java``): sizes, margins, colors."""

    def __init__(self, width: int = 640, height: int = 300, margin: int = 40,
                 colors: Sequence[str] = _PALETTE, title_size: int = 14):
        self.width = width
        self.height = height
        self.margin = margin
        self.colors = list(colors)
        self.title_size = title_size

    def to_dict(self):
        return {"width": self.width, "height": self.height,
                "margin": self.margin, "colors": self.colors}


class Component:
    """Base component: JSON for frontends, SVG/HTML for standalone use."""

    component_type = "component"

    def to_dict(self) -> dict:
        raise NotImplementedError

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def render(self) -> str:
        raise NotImplementedError


class _Chart(Component):
    def __init__(self, title: str = "", style: Optional[StyleChart] = None):
        self.title = title
        self.style = style or StyleChart()

    def _svg_open(self) -> List[str]:
        s = self.style
        parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{s.width}" '
                 f'height="{s.height}" font-family="sans-serif">']
        if self.title:
            parts.append(
                f'<text x="{s.width / 2}" y="{s.title_size + 4}" '
                f'text-anchor="middle" font-size="{s.title_size}">'
                f'{html.escape(self.title)}</text>')
        return parts

    def _scales(self, xmin, xmax, ymin, ymax):
        s = self.style
        m = s.margin
        xr = max(xmax - xmin, 1e-12)
        yr = max(ymax - ymin, 1e-12)
        sx = lambda x: m + (s.width - 2 * m) * (x - xmin) / xr
        sy = lambda y: s.height - m - (s.height - 2 * m) * (y - ymin) / yr
        return sx, sy

    def _axes(self, sx, sy, xmin, xmax, ymin, ymax) -> List[str]:
        s = self.style
        out = [f'<line x1="{sx(xmin)}" y1="{sy(ymin)}" x2="{sx(xmax)}" '
               f'y2="{sy(ymin)}" stroke="#888"/>',
               f'<line x1="{sx(xmin)}" y1="{sy(ymin)}" x2="{sx(xmin)}" '
               f'y2="{sy(ymax)}" stroke="#888"/>']
        for frac in (0.0, 0.5, 1.0):
            xv = xmin + frac * (xmax - xmin)
            yv = ymin + frac * (ymax - ymin)
            out.append(f'<text x="{sx(xv)}" y="{s.height - s.margin + 14}" '
                       f'font-size="10" text-anchor="middle">{xv:.3g}</text>')
            out.append(f'<text x="{s.margin - 4}" y="{sy(yv) + 3}" '
                       f'font-size="10" text-anchor="end">{yv:.3g}</text>')
        return out


class ChartLine(_Chart):
    """Multi-series line chart (``ChartLine.java``)."""

    component_type = "chart_line"

    def __init__(self, title: str = "", style: Optional[StyleChart] = None):
        super().__init__(title, style)
        self.series: List[Tuple[str, List[float], List[float]]] = []

    def add_series(self, name: str, x: Sequence[float],
                   y: Sequence[float]) -> "ChartLine":
        if len(x) != len(y):
            raise ValueError("x and y lengths differ")
        self.series.append((name, [float(v) for v in x], [float(v) for v in y]))
        return self

    def to_dict(self):
        return {"type": self.component_type, "title": self.title,
                "style": self.style.to_dict(),
                "series": [{"name": n, "x": x, "y": y}
                           for n, x, y in self.series]}

    def _marks(self, sx, sy, x, y, color) -> List[str]:
        pts = " ".join(f"{sx(a):.1f},{sy(b):.1f}" for a, b in zip(x, y))
        return [f'<polyline points="{pts}" fill="none" stroke="{color}" '
                f'stroke-width="1.5"/>']

    def render(self) -> str:
        parts = self._svg_open()
        xs = [v for _, x, _ in self.series for v in x]
        ys = [v for _, _, y in self.series for v in y]
        if xs and ys:
            sx, sy = self._scales(min(xs), max(xs), min(ys), max(ys))
            parts += self._axes(sx, sy, min(xs), max(xs), min(ys), max(ys))
            for i, (name, x, y) in enumerate(self.series):
                color = self.style.colors[i % len(self.style.colors)]
                parts += self._marks(sx, sy, x, y, color)
                parts.append(f'<text x="{self.style.width - self.style.margin}"'
                             f' y="{self.style.margin + 12 * i}" font-size="10"'
                             f' text-anchor="end" fill="{color}">'
                             f'{html.escape(name)}</text>')
        parts.append("</svg>")
        return "".join(parts)


class ChartScatter(ChartLine):
    """Scatter chart (``ChartScatter.java``): same frame/legend as ChartLine,
    point marks instead of a polyline."""

    component_type = "chart_scatter"

    def _marks(self, sx, sy, x, y, color) -> List[str]:
        return [f'<circle cx="{sx(a):.1f}" cy="{sy(b):.1f}" r="2.5" '
                f'fill="{color}"/>' for a, b in zip(x, y)]


class ChartHistogram(_Chart):
    """Histogram from (low, high, count) bins (``ChartHistogram.java``)."""

    component_type = "chart_histogram"

    def __init__(self, title: str = "", style: Optional[StyleChart] = None):
        super().__init__(title, style)
        self.bins: List[Tuple[float, float, float]] = []

    def add_bin(self, low: float, high: float, count: float) -> "ChartHistogram":
        self.bins.append((float(low), float(high), float(count)))
        return self

    @classmethod
    def from_values(cls, values, n_bins: int = 20, title: str = "",
                    style: Optional[StyleChart] = None) -> "ChartHistogram":
        import numpy as np
        counts, edges = np.histogram(np.asarray(values).ravel(), bins=n_bins)
        chart = cls(title, style)
        for i, c in enumerate(counts):
            chart.add_bin(edges[i], edges[i + 1], float(c))
        return chart

    def to_dict(self):
        return {"type": self.component_type, "title": self.title,
                "style": self.style.to_dict(),
                "bins": [{"low": l, "high": h, "count": c}
                         for l, h, c in self.bins]}

    def render(self) -> str:
        parts = self._svg_open()
        if self.bins:
            xmin = min(b[0] for b in self.bins)
            xmax = max(b[1] for b in self.bins)
            ymax = max(b[2] for b in self.bins)
            sx, sy = self._scales(xmin, xmax, 0.0, ymax)
            parts += self._axes(sx, sy, xmin, xmax, 0.0, ymax)
            color = self.style.colors[0]
            for low, high, count in self.bins:
                x0, x1 = sx(low), sx(high)
                y0, y1 = sy(count), sy(0.0)
                parts.append(
                    f'<rect x="{x0:.1f}" y="{y0:.1f}" width="{x1 - x0:.1f}" '
                    f'height="{y1 - y0:.1f}" fill="{color}" fill-opacity="0.8"'
                    f' stroke="#fff" stroke-width="0.5"/>')
        parts.append("</svg>")
        return "".join(parts)


class ChartHorizontalBar(_Chart):
    """Horizontal bar chart (``ChartHorizontalBar.java``): one bar per
    named category."""

    component_type = "chart_horizontal_bar"

    def __init__(self, title: str = "", style: Optional[StyleChart] = None):
        super().__init__(title, style)
        self.bars: List[Tuple[str, float]] = []

    def add_bar(self, name: str, value: float) -> "ChartHorizontalBar":
        self.bars.append((name, float(value)))
        return self

    def to_dict(self):
        return {"type": self.component_type, "title": self.title,
                "style": self.style.to_dict(),
                "bars": [{"name": n, "value": v} for n, v in self.bars]}

    def render(self) -> str:
        parts = self._svg_open()
        if self.bars:
            s = self.style
            m = s.margin
            vmin = min(0.0, min(v for _, v in self.bars))
            vmax = max(0.0, max(v for _, v in self.bars))
            vr = max(vmax - vmin, 1e-12)
            band = (s.height - 2 * m) / len(self.bars)
            x_of = lambda v: m + (s.width - 2 * m) * (v - vmin) / vr
            for i, (name, v) in enumerate(self.bars):
                color = s.colors[i % len(s.colors)]
                y0 = m + i * band
                x0, x1 = sorted((x_of(0.0), x_of(v)))
                parts.append(
                    f'<rect x="{x0:.1f}" y="{y0:.1f}" width="{x1 - x0:.1f}" '
                    f'height="{band * 0.8:.1f}" fill="{color}"/>')
                parts.append(
                    f'<text x="{m - 4}" y="{y0 + band * 0.5:.1f}" '
                    f'font-size="10" text-anchor="end">{html.escape(name)}'
                    f"</text>")
                parts.append(
                    f'<text x="{x1 + 4:.1f}" y="{y0 + band * 0.5:.1f}" '
                    f'font-size="10">{v:.3g}</text>')
        parts.append("</svg>")
        return "".join(parts)


class ChartStackedArea(_Chart):
    """Stacked area chart (``ChartStackedArea.java``): series share an
    x-axis and stack additively."""

    component_type = "chart_stacked_area"

    def __init__(self, title: str = "", style: Optional[StyleChart] = None):
        super().__init__(title, style)
        self.x: List[float] = []
        self.series: List[Tuple[str, List[float]]] = []

    def set_x_values(self, x: Sequence[float]) -> "ChartStackedArea":
        self.x = [float(v) for v in x]
        return self

    def add_series(self, name: str, y: Sequence[float]) -> "ChartStackedArea":
        if len(y) != len(self.x):
            raise ValueError("series length must match x values")
        self.series.append((name, [float(v) for v in y]))
        return self

    def to_dict(self):
        return {"type": self.component_type, "title": self.title,
                "style": self.style.to_dict(), "x": self.x,
                "series": [{"name": n, "y": y} for n, y in self.series]}

    def render(self) -> str:
        parts = self._svg_open()
        if self.x and self.series:
            totals = [sum(y[i] for _, y in self.series)
                      for i in range(len(self.x))]
            sx, sy = self._scales(min(self.x), max(self.x), 0.0, max(totals))
            parts += self._axes(sx, sy, min(self.x), max(self.x), 0.0,
                                max(totals))
            base = [0.0] * len(self.x)
            for i, (name, y) in enumerate(self.series):
                color = self.style.colors[i % len(self.style.colors)]
                top = [b + v for b, v in zip(base, y)]
                fwd = [f"{sx(a):.1f},{sy(b):.1f}"
                       for a, b in zip(self.x, top)]
                back = [f"{sx(a):.1f},{sy(b):.1f}"
                        for a, b in zip(reversed(self.x), reversed(base))]
                parts.append(f'<polygon points="{" ".join(fwd + back)}" '
                             f'fill="{color}" fill-opacity="0.7" '
                             f'stroke="{color}"/>')
                parts.append(
                    f'<text x="{self.style.width - self.style.margin}" '
                    f'y="{self.style.margin + 12 * i}" font-size="10" '
                    f'text-anchor="end" fill="{color}">{html.escape(name)}'
                    f"</text>")
                base = top
        parts.append("</svg>")
        return "".join(parts)


class ChartTimeline(_Chart):
    """Swim-lane timeline (``ChartTimeline.java``): one lane per named
    track, entries are (start, end, label) spans."""

    component_type = "chart_timeline"

    def __init__(self, title: str = "", style: Optional[StyleChart] = None):
        super().__init__(title, style)
        self.lanes: List[Tuple[str, List[Tuple[float, float, str]]]] = []

    def add_lane(self, name: str,
                 entries: Sequence[Tuple[float, float, str]]) -> "ChartTimeline":
        self.lanes.append(
            (name, [(float(a), float(b), str(l)) for a, b, l in entries]))
        return self

    def to_dict(self):
        return {"type": self.component_type, "title": self.title,
                "style": self.style.to_dict(),
                "lanes": [{"name": n,
                           "entries": [{"start": a, "end": b, "label": l}
                                       for a, b, l in es]}
                          for n, es in self.lanes]}

    def render(self) -> str:
        parts = self._svg_open()
        spans = [e for _, es in self.lanes for e in es]
        if spans:
            s = self.style
            m = s.margin
            tmin = min(a for a, _, _ in spans)
            tmax = max(b for _, b, _ in spans)
            tr = max(tmax - tmin, 1e-12)
            band = (s.height - 2 * m) / len(self.lanes)
            x_of = lambda t: m + (s.width - 2 * m) * (t - tmin) / tr
            for i, (name, entries) in enumerate(self.lanes):
                y0 = m + i * band
                parts.append(f'<text x="{m - 4}" y="{y0 + band * 0.5:.1f}" '
                             f'font-size="10" text-anchor="end">'
                             f"{html.escape(name)}</text>")
                for j, (a, b, label) in enumerate(entries):
                    color = s.colors[j % len(s.colors)]
                    parts.append(
                        f'<rect x="{x_of(a):.1f}" y="{y0:.1f}" '
                        f'width="{max(x_of(b) - x_of(a), 1.0):.1f}" '
                        f'height="{band * 0.8:.1f}" fill="{color}" '
                        f'fill-opacity="0.8"><title>{html.escape(label)}'
                        f"</title></rect>")
        parts.append("</svg>")
        return "".join(parts)


class DecoratorAccordion(Component):
    """Collapsible section wrapping child components
    (``DecoratorAccordion.java``); renders as <details>/<summary>."""

    component_type = "decorator_accordion"

    def __init__(self, title: str = "", default_collapsed: bool = False,
                 *children: Component):
        self.title = title
        self.default_collapsed = default_collapsed
        self.children = list(children)

    def add(self, child: Component) -> "DecoratorAccordion":
        self.children.append(child)
        return self

    def to_dict(self):
        return {"type": self.component_type, "title": self.title,
                "default_collapsed": self.default_collapsed,
                "children": [c.to_dict() for c in self.children]}

    def render(self) -> str:
        open_attr = "" if self.default_collapsed else " open"
        inner = "".join(c.render() for c in self.children)
        return (f"<details{open_attr}><summary>{html.escape(self.title)}"
                f"</summary>{inner}</details>")


class ComponentTable(Component):
    """Simple table (``ComponentTable.java``)."""

    component_type = "component_table"

    def __init__(self, header: Sequence[str], rows: Sequence[Sequence]):
        self.header = list(header)
        self.rows = [list(r) for r in rows]

    def to_dict(self):
        return {"type": self.component_type, "header": self.header,
                "rows": [[str(c) for c in r] for r in self.rows]}

    def render(self) -> str:
        th = "".join(f"<th>{html.escape(str(h))}</th>" for h in self.header)
        trs = "".join(
            "<tr>" + "".join(f"<td>{html.escape(str(c))}</td>" for c in r)
            + "</tr>" for r in self.rows)
        return (f'<table border="1" cellspacing="0" cellpadding="4">'
                f"<tr>{th}</tr>{trs}</table>")


class ComponentText(Component):
    """Text block (``ComponentText.java``)."""

    component_type = "component_text"

    def __init__(self, text: str):
        self.text = text

    def to_dict(self):
        return {"type": self.component_type, "text": self.text}

    def render(self) -> str:
        return f"<p>{html.escape(self.text)}</p>"


class ComponentDiv(Component):
    """Container composing children into one HTML page
    (``ComponentDiv.java``)."""

    component_type = "component_div"

    def __init__(self, *children: Component):
        self.children = list(children)

    def add(self, child: Component) -> "ComponentDiv":
        self.children.append(child)
        return self

    def to_dict(self):
        return {"type": self.component_type,
                "children": [c.to_dict() for c in self.children]}

    def render(self) -> str:
        return "<div>" + "".join(c.render() for c in self.children) + "</div>"

    def render_page(self, title: str = "report") -> str:
        return (f"<!DOCTYPE html><html><head><meta charset='utf-8'>"
                f"<title>{html.escape(title)}</title></head><body>"
                f"{self.render()}</body></html>")
