"""StatsListener: per-iteration training statistics.

Counterpart of ``deeplearning4j_tpu/ui/stats.py`` (reference
``deeplearning4j-ui-model/.../stats/BaseStatsListener.java``: score,
learning rates, per-layer parameter / gradient / update histograms, mean
magnitudes and stdevs, memory and runtime info, ``:355-400``), with the
same reports. Every tensor's statistics (and its histogram) are computed
with torch ops on the network's device in float32, as the JAX package's
jitted call computes them, and come back to the host in ONE transfer per
report, the score with them.

Gradient and update statistics are reported when the model exposes
``last_gradients`` / ``last_updates``. Neither network sets them (the JAX
package's do not either: the step keeps its gradients), so a report
carries none. The port's graph reports its parameters and learning
rates keyed ``<vertex>_<param>``, where the JAX package's graph reports
neither.
"""

from __future__ import annotations

import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.ui.storage import Persistable, StatsStorageRouter

TYPE_ID = "StatsListener"

#: the scalar statistics of each tensor, in the order they are read back
SCALARS = ("mean", "stdev", "mean_magnitude", "min", "max", "norm2")


@dataclass
class StatsUpdateConfiguration:
    """What to collect, how often (``StatsUpdateConfiguration.java``)."""

    report_iterations: int = 1
    collect_score: bool = True
    collect_learning_rates: bool = True
    collect_parameter_stats: bool = True
    collect_gradient_stats: bool = True
    collect_update_stats: bool = True
    collect_histograms: bool = False
    histogram_bin_count: int = 20
    collect_memory: bool = True


@dataclass
class StatsReport:
    """One iteration's stats (the update Persistable payload)."""

    iteration: int
    epoch: int
    timestamp: float
    score: float
    duration_ms: float = 0.0
    minibatch_size: int = 0
    learning_rates: Dict[str, float] = field(default_factory=dict)
    param_stats: Dict[str, Dict[str, float]] = field(default_factory=dict)
    gradient_stats: Dict[str, Dict[str, float]] = field(default_factory=dict)
    update_stats: Dict[str, Dict[str, float]] = field(default_factory=dict)
    histograms: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    memory: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in (
            "iteration", "epoch", "timestamp", "score", "duration_ms",
            "minibatch_size", "learning_rates", "param_stats",
            "gradient_stats", "update_stats", "histograms", "memory")}


def histogram(a: torch.Tensor, bins: int):
    """``(counts, edges)`` of ``a`` over [min, max] in ``bins`` equal bins,
    the last bin closed, as ``jnp.histogram(a, bins=bins)`` computes them
    (the same edge formula, ``start * (1 - i/n) + stop * i/n``). Counted
    with ``scatter_add_``: ``torch.bincount`` reads the largest index back
    to size its output, a host synchronisation a tensor."""
    lo, hi = a.min(), a.max()
    same = lo == hi
    lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5, hi)
    step = torch.arange(bins, device=a.device, dtype=a.dtype) / bins
    edges = torch.cat([lo * (1 - step) + hi * step, hi.reshape(1)])
    idx = torch.searchsorted(edges, a, right=True)
    idx = torch.where(a == edges[-1], bins, idx)
    counts = idx.new_zeros(bins + 2).scatter_add_(0, idx, idx.new_ones(()).expand(idx.shape))
    return counts[1:bins + 1], edges


def tensor_stats(named: Dict[str, torch.Tensor], bins: Optional[int]):
    """One float64 vector on the tensors' device: each tensor's
    :data:`SCALARS` in float32, then (with ``bins``) its histogram's counts
    and edges."""
    parts = []
    for t in named.values():
        a = t.detach().reshape(-1).float()
        parts.append(torch.stack([a.mean(), a.std(correction=0), a.abs().mean(),
                                  a.min(), a.max(), torch.linalg.vector_norm(a)]
                                 ).double())
        if bins:
            counts, edges = histogram(a, bins)
            parts += [counts.double(), edges.double()]
    return torch.cat(parts)


def unpack_stats(names, host, bins: Optional[int]) -> Dict[str, Dict[str, Any]]:
    """The per-tensor entries of a report from :func:`tensor_stats`' values
    read back."""
    out, i = {}, 0
    for name in names:
        entry = dict(zip(SCALARS, host[i:i + len(SCALARS)]))
        i += len(SCALARS)
        if bins:
            entry["histogram"] = {"counts": [int(c) for c in host[i:i + bins]],
                                  "edges": host[i + bins:i + 2 * bins + 1]}
            i += 2 * bins + 1
        out[name] = entry
    return out


class StatsListener(TrainingListener):
    """Collects stats each ``report_iterations`` and routes them to a
    :class:`StatsStorageRouter` (``BaseStatsListener`` behaviour)."""

    def __init__(self, router: StatsStorageRouter,
                 update_config: Optional[StatsUpdateConfiguration] = None,
                 session_id: Optional[str] = None, worker_id: Optional[str] = None):
        self.router = router
        self.cfg = update_config or StatsUpdateConfiguration()
        self.session_id = session_id or uuid.uuid4().hex[:12]
        self.worker_id = worker_id or f"pid-{os.getpid()}"
        self._last_time = None
        self._static_posted = False

    # -- helpers ---------------------------------------------------------
    @staticmethod
    def _flatten(tree) -> Dict[str, torch.Tensor]:
        """``{layer: {'W': .., 'b': ..}}`` (or a list of such dicts) →
        ``{'0_W': ..}`` flat names; a flat dict of tensors stays as it is."""
        items = enumerate(tree) if isinstance(tree, (list, tuple)) else tree.items()
        out = {}
        for k, v in items:
            if isinstance(v, dict):
                out.update({f"{k}_{n}": t for n, t in v.items()
                            if isinstance(t, torch.Tensor)})
            elif isinstance(v, torch.Tensor):
                out[k] = v
        return out

    def _collect(self, model) -> Dict[str, Any]:
        """The score and every tensor's statistics, in one read."""
        cfg = self.cfg
        bins = cfg.histogram_bin_count if cfg.collect_histograms else None
        groups = {}
        if cfg.collect_parameter_stats and getattr(model, "params", None) is not None:
            groups["param_stats"] = self._flatten(model.params)
        # gradient/update stats only where the model exposes them
        grads = getattr(model, "last_gradients", None)
        if cfg.collect_gradient_stats and grads is not None:
            groups["gradient_stats"] = self._flatten(grads)
        upds = getattr(model, "last_updates", None)
        if cfg.collect_update_stats and upds is not None:
            groups["update_stats"] = self._flatten(upds)
        groups = {k: v for k, v in groups.items() if v}
        score = getattr(model, "_score", None) if cfg.collect_score else None
        parts = [tensor_stats(named, bins) for named in groups.values()]
        if isinstance(score, torch.Tensor):
            dev = parts[0].device if parts else score.device
            parts.insert(0, score.detach().reshape(1).to(dev, torch.float64))
        host = torch.cat(parts).cpu().tolist() if parts else []
        out = {"score": 0.0}
        if cfg.collect_score:
            out["score"] = host.pop(0) if isinstance(score, torch.Tensor) else float(model.score_)
        i = 0
        for key, named in groups.items():
            n = len(named) * (len(SCALARS) + (2 * bins + 1 if bins else 0))
            out[key] = unpack_stats(named, host[i:i + n], bins)
            i += n
        return out

    @staticmethod
    def _memory_info() -> Dict[str, Any]:
        """Host RSS plus each CUDA device's memory (torch's caching
        allocator: bytes allocated now and at peak, the device's total),
        in the JAX package's keys; a CPU-only process reports the host."""
        info: Dict[str, Any] = {}
        try:
            import resource
            info["max_rss_kb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        except Exception:
            pass
        if not torch.cuda.is_available():
            return info
        per_device = []
        for i in range(torch.cuda.device_count()):
            ms = torch.cuda.memory_stats(i)
            in_use = int(ms.get("allocated_bytes.all.current", 0))
            limit = int(torch.cuda.mem_get_info(i)[1])
            per_device.append({"device": f"cuda:{i}", "bytes_in_use": in_use,
                               "bytes_limit": limit,
                               "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0))})
        info["device_bytes_in_use"] = sum(d["bytes_in_use"] for d in per_device)
        info["device_bytes_limit"] = sum(d["bytes_limit"] for d in per_device)
        info["device_count"] = len(per_device)
        info["devices"] = per_device
        return info

    # -- listener hooks --------------------------------------------------
    def iteration_done(self, model, iteration: int, epoch: int) -> None:
        if iteration % max(1, self.cfg.report_iterations) != 0:
            return
        now = time.time()
        if not self._static_posted:
            self._post_static(model, now)
        collected = self._collect(model)
        report = StatsReport(
            iteration=iteration, epoch=epoch, timestamp=now,
            score=collected.pop("score"),
            minibatch_size=getattr(model, "last_batch_size", 0) or 0, **collected)
        if self._last_time is not None:
            report.duration_ms = (now - self._last_time) * 1000.0
        self._last_time = now
        if self.cfg.collect_learning_rates:
            report.learning_rates = self._learning_rates(model, iteration, epoch)
        if self.cfg.collect_memory:
            report.memory = self._memory_info()
        self.router.put_update(Persistable(
            self.session_id, TYPE_ID, self.worker_id, now, report.to_dict()))

    @staticmethod
    def _learning_rates(model, iteration, epoch) -> Dict[str, float]:
        out = {}
        for k, named in (getattr(model, "_updaters", None) or {}).items():
            for n, u in named.items():
                try:
                    out[f"{k}_{n}"] = float(u.lr_at(iteration, epoch))
                except Exception:  # an updater with no learning rate
                    pass
        return out

    def _post_static(self, model, now: float) -> None:
        self._static_posted = True
        info = {
            "model_class": type(model).__name__,
            "n_layers": len(getattr(model, "layers", []) or []),
            "n_params": 0,
        }
        try:
            info["n_params"] = int(model.conf.num_params())
        except Exception:
            pass
        cuda = torch.cuda.is_available()
        info["backend"] = "cuda" if cuda else "cpu"
        info["devices"] = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
                           if cuda else ["cpu"])
        self.router.put_static_info(Persistable(
            self.session_id, TYPE_ID, self.worker_id, now, info))
