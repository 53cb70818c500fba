"""UI server: training dashboard + remote stats receiver.

Replaces the reference's Play-framework server
(`deeplearning4j-play/.../PlayUIServer.java:53`) and its remote receiver
module (`ui/module/remote/RemoteReceiverModule.java`) with a dependency-free
stdlib ``http.server``: JSON endpoints backed by a :class:`StatsStorage`, a
single-page HTML dashboard with inline SVG charts, and a POST endpoint that
ingests remote :class:`Persistable` records. Counterpart of the JAX
package's ``ui/server.py``, the same endpoints and payloads; it binds to
127.0.0.1 only, on the port it is given (0 for an ephemeral one).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import urlparse

from deeplearning4j_tpu_torch.ui.stats import TYPE_ID
from deeplearning4j_tpu_torch.ui.storage import Persistable, StatsStorage

_DASHBOARD_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>deeplearning4j_tpu training UI</title>
<style>
 body{font-family:sans-serif;margin:20px;background:#fafafa}
 h1{font-size:20px} h2{font-size:16px;margin-top:24px}
 .chart{border:1px solid #ccc;background:#fff;margin:4px}
 table{border-collapse:collapse;font-size:13px}
 td,th{border:1px solid #ddd;padding:4px 8px}
</style></head>
<body>
<h1>deeplearning4j_tpu training UI</h1>
<div id="sessions"></div>
<h2>Score vs iteration</h2><svg id="score" class="chart" width="720" height="260"></svg>
<h2>Parameter mean magnitudes</h2><svg id="params" class="chart" width="720" height="260"></svg>
<h2>Latest stats</h2><div id="latest"></div>
<h2 data-i18n="train.model.title">Model: per-layer detail</h2>
<div><span data-i18n="train.model.layer">Layer</span>:
 <select id="layersel"></select></div>
<h3 data-i18n="train.model.paramhist">Parameter magnitudes over time</h3>
<svg id="layerparams" class="chart" width="720" height="220"></svg>
<h3 data-i18n="train.model.ratio">Update:parameter ratio (log10)</h3>
<svg id="layerratio" class="chart" width="720" height="220"></svg>
<script>
const SVGNS = "http://www.w3.org/2000/svg";
function polyline(svg, xs, ys, color){
  if (xs.length < 2) return;
  const w = svg.width.baseVal.value, h = svg.height.baseVal.value, pad = 30;
  const xmin=Math.min(...xs), xmax=Math.max(...xs), ymin=Math.min(...ys), ymax=Math.max(...ys);
  const sx = x => pad + (w-2*pad) * (x - xmin) / Math.max(xmax - xmin, 1e-9);
  const sy = y => h - pad - (h-2*pad) * (y - ymin) / Math.max(ymax - ymin, 1e-9);
  const pl = document.createElementNS(SVGNS, "polyline");
  pl.setAttribute("points", xs.map((x,i)=>sx(x)+","+sy(ys[i])).join(" "));
  pl.setAttribute("fill","none"); pl.setAttribute("stroke",color); pl.setAttribute("stroke-width","1.5");
  svg.appendChild(pl);
}
async function refresh(){
  const sessions = await (await fetch("/train/sessions")).json();
  document.getElementById("sessions").textContent = "Sessions: " + sessions.join(", ");
  if (!sessions.length) return;
  const sid = sessions[sessions.length-1];
  const data = await (await fetch("/train/overview/" + sid)).json();
  const svg = document.getElementById("score"); svg.innerHTML = "";
  polyline(svg, data.iterations, data.scores, "#1565c0");
  const psvg = document.getElementById("params"); psvg.innerHTML = "";
  const colors = ["#1565c0","#c62828","#2e7d32","#f9a825","#6a1b9a","#00838f"];
  let ci = 0;
  for (const [name, series] of Object.entries(data.param_mean_magnitudes)){
    polyline(psvg, data.iterations.slice(-series.length), series, colors[ci++ % colors.length]);
  }
  const latest = data.latest || {};
  document.getElementById("latest").innerHTML =
    "<table><tr><th>iteration</th><td>"+latest.iteration+"</td></tr>" +
    "<tr><th>score</th><td>"+latest.score+"</td></tr>" +
    "<tr><th>minibatch</th><td>"+latest.minibatch_size+"</td></tr></table>";
  await refreshModel(sid);
}
async function refreshModel(sid){
  const model = await (await fetch("/train/model/" + sid)).json();
  const sel = document.getElementById("layersel");
  const current = sel.value;
  sel.innerHTML = "";
  for (const n of model.layer_names){
    const o = document.createElement("option"); o.value = n; o.textContent = n;
    sel.appendChild(o);
  }
  if (model.layer_names.includes(current)) sel.value = current;
  if (!sel.value) return;
  const det = await (await fetch("/train/model/" + sid + "/" + sel.value)).json();
  const colors = ["#1565c0","#c62828","#2e7d32","#f9a825","#6a1b9a","#00838f"];
  const ps = document.getElementById("layerparams"); ps.innerHTML = "";
  let ci = 0;
  for (const [p, s] of Object.entries(det.param_mean_magnitudes))
    polyline(ps, det.iterations.slice(-s.length), s, colors[ci++ % colors.length]);
  const rs = document.getElementById("layerratio"); rs.innerHTML = "";
  ci = 0;
  for (const [p, pairs] of Object.entries(det.update_param_ratio_log10))
    polyline(rs, pairs.map(x=>x[0]), pairs.map(x=>x[1]), colors[ci++ % colors.length]);
}
async function applyI18n(lang){
  const t = await (await fetch("/i18n/" + lang)).json();
  for (const el of document.querySelectorAll("[data-i18n]")){
    const k = el.getAttribute("data-i18n");
    if (t[k]) el.textContent = t[k];
  }
}
applyI18n((new URLSearchParams(location.search)).get("lang") || "en");
document.getElementById("layersel").addEventListener("change", () => refresh());
refresh(); setInterval(refresh, 3000);
</script></body></html>
"""


# i18n string tables (reference: deeplearning4j-play i18n resources /
# DefaultI18N): the dashboard fetches /i18n/<lang> and re-labels headings.
I18N = {
    "en": {
        "train.title": "deeplearning4j_tpu training UI",
        "train.sessions": "Sessions",
        "train.score.title": "Score vs iteration",
        "train.params.title": "Parameter mean magnitudes",
        "train.latest.title": "Latest stats",
        "train.model.title": "Model: per-layer detail",
        "train.model.layer": "Layer",
        "train.model.paramhist": "Parameter magnitudes over time",
        "train.model.ratio": "Update:parameter ratio (log10)",
        "train.iteration": "iteration",
        "train.score": "score",
        "train.minibatch": "minibatch",
    },
    "de": {
        "train.title": "deeplearning4j_tpu Trainings-UI",
        "train.sessions": "Sitzungen",
        "train.score.title": "Score pro Iteration",
        "train.params.title": "Mittlere Parameterbeträge",
        "train.latest.title": "Aktuelle Statistiken",
        "train.model.title": "Modell: Schicht-Detail",
        "train.model.layer": "Schicht",
        "train.model.paramhist": "Parameterbeträge über die Zeit",
        "train.model.ratio": "Update:Parameter-Verhältnis (log10)",
        "train.iteration": "Iteration",
        "train.score": "Score",
        "train.minibatch": "Minibatch",
    },
    "ja": {
        "train.title": "deeplearning4j_tpu トレーニングUI",
        "train.sessions": "セッション",
        "train.score.title": "スコア対イテレーション",
        "train.params.title": "パラメータ平均絶対値",
        "train.latest.title": "最新の統計",
        "train.model.title": "モデル: レイヤー詳細",
        "train.model.layer": "レイヤー",
        "train.model.paramhist": "パラメータ絶対値の推移",
        "train.model.ratio": "更新:パラメータ比 (log10)",
        "train.iteration": "イテレーション",
        "train.score": "スコア",
        "train.minibatch": "ミニバッチ",
    },
}


def _split_param_key(key: str):
    """'0_W' / 'lstm1_RW' flat stat keys → (layer, param)."""
    if "_" in key:
        layer, param = key.rsplit("_", 1)
        return layer, param
    return "model", key


class RemoteReceiverModule:
    """Accepts POSTed Persistable JSON into a storage router
    (``RemoteReceiverModule.java``). Enable/disable mirrors the reference."""

    def __init__(self, router=None, enabled: bool = True):
        self.router = router
        self.enabled = enabled

    def receive(self, body: bytes) -> bool:
        if not self.enabled or self.router is None:
            return False
        rec = json.loads(body.decode("utf-8"))
        p = Persistable(rec["session_id"], rec["type_id"], rec["worker_id"],
                        rec["timestamp"], rec["data"])
        if rec.get("static"):
            self.router.put_static_info(p)
        else:
            self.router.put_update(p)
        return True


class UIServer:
    """Serves the dashboard + JSON API for one or more attached
    StatsStorage instances (``UIServer.getInstance().attach(ss)`` pattern)."""

    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 9000, metrics=None):
        self.port = port
        self._storages: List[StatsStorage] = []
        self.remote = RemoteReceiverModule(router=None, enabled=False)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # optional shared observability core (observe.metrics registry):
        # request count/latency land beside the model-serving series
        self._observe = None
        if metrics is not None:
            from deeplearning4j_tpu_torch.observe.metrics import instrument_http
            self._observe = instrument_http(metrics, "ui")

    @classmethod
    def get_instance(cls, port: int = 9000) -> "UIServer":
        if cls._instance is None:
            cls._instance = UIServer(port)
        return cls._instance

    # -- storage attachment ---------------------------------------------
    def attach(self, storage: StatsStorage) -> None:
        if storage not in self._storages:
            self._storages.append(storage)

    def detach(self, storage: StatsStorage) -> None:
        if storage in self._storages:
            self._storages.remove(storage)

    def enable_remote_listener(self, router=None) -> None:
        """Route POST /remote into the given router (default: first attached
        storage)."""
        self.remote.router = router or (self._storages[0] if self._storages else None)
        self.remote.enabled = self.remote.router is not None

    # -- data assembly ---------------------------------------------------
    def _sessions(self) -> List[str]:
        out = []
        for s in self._storages:
            out.extend(s.list_session_ids())
        return sorted(set(out))

    def _overview(self, sid: str) -> dict:
        updates: List[Persistable] = []
        for s in self._storages:
            for wid in s.list_worker_ids_for_session(sid, TYPE_ID):
                updates.extend(s.get_all_updates_after(sid, TYPE_ID, -1.0, wid))
        updates.sort(key=lambda p: (p.data.get("iteration", 0), p.timestamp))
        iterations = [p.data.get("iteration", 0) for p in updates]
        scores = [p.data.get("score", 0.0) for p in updates]
        pmm: dict = {}
        for p in updates:
            for name, st in (p.data.get("param_stats") or {}).items():
                pmm.setdefault(name, []).append(st.get("mean_magnitude", 0.0))
        return {
            "session": sid,
            "iterations": iterations,
            "scores": scores,
            "param_mean_magnitudes": pmm,
            "latest": updates[-1].data if updates else None,
        }

    def _updates(self, sid: str) -> List[Persistable]:
        updates: List[Persistable] = []
        for s in self._storages:
            for wid in s.list_worker_ids_for_session(sid, TYPE_ID):
                updates.extend(s.get_all_updates_after(sid, TYPE_ID, -1.0, wid))
        updates.sort(key=lambda p: (p.data.get("iteration", 0), p.timestamp))
        return updates

    def _model(self, sid: str) -> dict:
        """Per-layer summary (the reference TrainModule 'model' tab): layer
        list with each parameter's latest stats and learning rate."""
        updates = self._updates(sid)
        layers: dict = {}
        latest = updates[-1].data if updates else {}
        for key, st in (latest.get("param_stats") or {}).items():
            layer, param = _split_param_key(key)
            layers.setdefault(layer, {"params": {}, "learning_rates": {}})
            layers[layer]["params"][param] = st
        for key, lr in (latest.get("learning_rates") or {}).items():
            layer, param = _split_param_key(key)
            layers.setdefault(layer, {"params": {}, "learning_rates": {}})
            layers[layer]["learning_rates"][param] = lr
        # numeric-aware ordering: MLN layer indices sort 0,1,2,...,10 — not
        # lexicographically
        names = sorted(layers, key=lambda n: (0, int(n)) if n.isdigit()
                       else (1, n))
        return {"session": sid, "layers": layers, "layer_names": names}

    def _layer_detail(self, sid: str, layer: str) -> dict:
        """Drill-down time series for one layer: per-param mean-magnitude
        series for params/gradients/updates, the update:param ratio (the
        reference's headline training-health chart), and latest histograms
        when the listener collects them."""
        updates = self._updates(sid)
        iterations, series, gseries, ratio = [], {}, {}, {}
        hist = {}
        for p in updates:
            it = p.data.get("iteration", 0)
            ps = p.data.get("param_stats") or {}
            gs = p.data.get("gradient_stats") or {}
            us = p.data.get("update_stats") or {}
            touched = False
            for key, st in ps.items():
                lname, param = _split_param_key(key)
                if lname != layer:
                    continue
                touched = True
                series.setdefault(param, []).append(st.get("mean_magnitude", 0.0))
                if "histogram" in st:
                    hist[param] = st["histogram"]
                u = us.get(key)
                if u is not None:
                    import math
                    pm = st.get("mean_magnitude", 0.0)
                    um = u.get("mean_magnitude", 0.0)
                    # [iteration, value] pairs: update stats may be reported
                    # intermittently, so the ratio carries its own x-values
                    ratio.setdefault(param, []).append(
                        [it, math.log10(max(um, 1e-12) / max(pm, 1e-12))])
            for key, st in gs.items():
                lname, param = _split_param_key(key)
                if lname == layer:
                    gseries.setdefault(param, []).append(
                        st.get("mean_magnitude", 0.0))
            if touched:
                iterations.append(it)
        return {"session": sid, "layer": layer, "iterations": iterations,
                "param_mean_magnitudes": series,
                "gradient_mean_magnitudes": gseries,
                "update_param_ratio_log10": ratio,
                "histograms": hist}

    # -- http -------------------------------------------------------------
    def start(self) -> int:
        """Start serving on self.port (0 → ephemeral); returns the bound port."""
        ui = self

        from deeplearning4j_tpu_torch.observe.metrics import HTTPObserverMixin

        class Handler(HTTPObserverMixin, BaseHTTPRequestHandler):
            observe = ui._observe

            @staticmethod
            def route_label(path):
                # first two path segments only (bounded cardinality:
                # session/layer ids stay out of labels)
                return "/" + "/".join([p for p in path.split("/") if p][:2])

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _try_modules(self, path, method) -> bool:
                for prefix, module in getattr(ui, "_modules", {}).items():
                    if path == prefix or path.startswith(prefix + "/"):
                        body = None
                        if method == "POST":
                            n = int(self.headers.get("Content-Length", "0"))
                            body = self.rfile.read(n)
                        try:
                            code, payload = module.handle(path, method, body)
                        except (KeyError, ValueError, TypeError) as e:
                            self._json({"error": str(e)}, 400)  # bad request
                            return True
                        except Exception as e:  # module bug → server error,
                            self._json({"error": str(e)}, 500)  # not a
                            return True                         # dropped conn
                        self._json(payload, code)
                        return True
                return False

            def do_GET(self):
                path = urlparse(self.path).path
                if self._try_modules(path, "GET"):
                    return
                if path in ("/", "/train", "/train/overview"):
                    body = _DASHBOARD_HTML.encode("utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/train/sessions":
                    self._json(ui._sessions())
                elif path.startswith("/train/overview/"):
                    sid = path.rsplit("/", 1)[-1]
                    self._json(ui._overview(sid))
                elif path.startswith("/train/model/"):
                    parts = [p for p in path.split("/") if p][2:]
                    if len(parts) == 1:
                        self._json(ui._model(parts[0]))
                    elif len(parts) == 2:
                        self._json(ui._layer_detail(parts[0], parts[1]))
                    else:
                        self._json({"error": "not found"}, 404)
                elif path == "/i18n" or path == "/i18n/":
                    self._json(sorted(I18N))
                elif path.startswith("/i18n/"):
                    lang = path.rsplit("/", 1)[-1]
                    self._json(I18N.get(lang, I18N["en"]))
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):
                path = urlparse(self.path).path
                if self._try_modules(path, "POST"):
                    return
                if path == "/remote":
                    n = int(self.headers.get("Content-Length", "0"))
                    try:
                        ok = ui.remote.receive(self.rfile.read(n))
                    except (KeyError, ValueError, UnicodeDecodeError) as e:
                        self._json({"error": str(e)}, 400)
                        return
                    self._json({"status": "ok" if ok else "disabled"},
                               200 if ok else 403)
                else:
                    self._json({"error": "not found"}, 404)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
