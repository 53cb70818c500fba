"""Continuous trainer: a streaming route feeding mini-epoch ``fit()``.

The TRAIN stage of the pipeline.  A :class:`StreamBuffer` is the sink a
``streaming.Route`` delivers into (``route.to_callable(buffer.put)``);
:class:`ContinuousTrainer` drains it in *mini-epochs* — bounded batches of
fresh examples — and runs ordinary incremental ``fit()`` on the candidate
model with the full observability loop attached through
``observe.attach_observability``: the ``TraceListener`` exports
``training_*`` series into the pipeline's metrics registry and a
``TrainingWatchdog`` guards every mini-epoch (NaN loss, gradient
explosion, divergence, stalls) with the configured action policy.

Items on the buffer are either ``DataSet`` batches or ``(features,
labels)`` tuples; single examples and whole batches both work — the
trainer rebatches to its configured ``batch_size``.

The port's copy of the JAX package's ``pipeline/trainer.py``: the
stream's items stay numpy on the host and ``fit`` moves each batch to
the network's device.
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.observe.health import attach_observability


class StreamStuck(RuntimeError):
    """The stream delivered no new examples within the wait budget —
    distinguishable from a cleanly drained route (which reports its
    processed count via ``route.result``)."""


class StreamBuffer:
    """Bounded thread-safe example buffer between a route and the trainer.

    ``put`` blocks when full (backpressure into the route thread rather
    than unbounded memory growth); ``take`` blocks up to ``timeout_s``
    for at least one item.  ``close()`` unblocks everything — a closed,
    empty buffer yields no more items.
    """

    def __init__(self, capacity: int = 1024):
        self.capacity = int(capacity)
        self._items: List[Any] = []
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False
        self.total_in = 0

    def put(self, item: Any) -> None:
        with self._lock:
            while len(self._items) >= self.capacity and not self._closed:
                self._not_full.wait(0.1)
            if self._closed:
                raise RuntimeError("buffer is closed")
            self._items.append(item)
            self.total_in += 1
            self._not_empty.notify_all()

    def take(self, max_items: int, timeout_s: Optional[float] = None
             ) -> List[Any]:
        """Up to ``max_items`` buffered items; blocks up to ``timeout_s``
        for the FIRST item (never for a full batch), so a slow stream
        still makes progress in small mini-epochs."""
        with self._lock:
            # deadline loop: Condition.wait may wake spuriously, and a
            # premature empty return would misreport a healthy stream as
            # stuck (aborting the TRAIN stage)
            deadline = (None if timeout_s is None
                        else time.monotonic() + timeout_s)
            while not self._items and not self._closed:
                if deadline is None:
                    self._not_empty.wait()
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._not_empty.wait(remaining)
            out = self._items[:max_items]
            del self._items[:len(out)]
            if out:
                self._not_full.notify_all()
            return out

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


def _example_count(item: Any) -> int:
    x = (item.features if isinstance(item, DataSet) else item[0])
    x = np.asarray(x)
    return 1 if x.ndim == 1 else int(x.shape[0])


def _to_datasets(items: List[Any], batch_size: int) -> List[DataSet]:
    """Rebatch a mix of DataSets / (x, y) pairs into ``batch_size`` rows."""
    xs, ys = [], []
    for item in items:
        if isinstance(item, DataSet):
            x, y = np.asarray(item.features), np.asarray(item.labels)
        else:
            x, y = (np.asarray(item[0]), np.asarray(item[1]))
        if x.ndim == 1:  # a single example
            x, y = x[None], np.asarray(y)[None]
        xs.append(x)
        ys.append(y)
    if not xs:
        return []
    x = np.concatenate(xs, axis=0)
    y = np.concatenate(ys, axis=0)
    return [DataSet(x[i:i + batch_size], y[i:i + batch_size])
            for i in range(0, len(x), batch_size)]


class ContinuousTrainer:
    """Mini-epoch incremental trainer over a :class:`StreamBuffer`.

    ``watchdog`` follows the ``attach_observability`` contract (``True``
    for defaults, a kwargs dict, or a ready ``TrainingWatchdog``); with a
    ``"raise"`` policy a diverging candidate aborts the TRAIN stage with
    ``WatchdogAlarm``, which the pipeline runner turns into a rejected
    run.  ``metrics``/``tracer`` ride into the attached ``TraceListener``
    so ``training_*`` series land in the same registry the canary's alert
    rules read.
    """

    def __init__(self, model, buffer: StreamBuffer, *,
                 batch_size: int = 32, batches_per_mini_epoch: int = 4,
                 take_timeout_s: float = 5.0,
                 metrics=None, tracer=None,
                 model_name: str = "candidate", watchdog=None,
                 prefetch_depth: Optional[int] = None):
        self.model = model
        self.buffer = buffer
        self.batch_size = int(batch_size)
        self.batches_per_mini_epoch = int(batches_per_mini_epoch)
        self.take_timeout_s = float(take_timeout_s)
        # forwarded to fit(): mini-epoch batch lists are small, so the
        # default (None → fit decides) usually skips the async wrap
        self.prefetch_depth = prefetch_depth
        self.examples_seen = 0
        self.mini_epochs = 0
        self.listeners = attach_observability(
            model, tracer=tracer, metrics=metrics, model_name=model_name,
            trace=True, watchdog=watchdog)

    def train_mini_epoch(self) -> dict:
        """Drain one mini-epoch of fresh examples and ``fit()`` on them.

        Raises :class:`StreamStuck` when the buffer stays empty past the
        take timeout — the caller (pipeline runner) checks the route's
        ``result``/``error`` to tell "drained" from "stuck".
        """
        budget = self.batch_size * self.batches_per_mini_epoch
        items: list = []
        taken = 0
        while taken < budget:
            # the budget counts EXAMPLES (an item may be a whole batch);
            # only the first take waits — once data flows, drain greedily
            got = self.buffer.take(
                1, timeout_s=self.take_timeout_s if not items else 0.0)
            if not got:
                break
            items.extend(got)
            taken += _example_count(got[0])
        if not items:
            raise StreamStuck(
                f"no stream items within {self.take_timeout_s}s")
        batches = _to_datasets(items, self.batch_size)
        n = sum(int(np.asarray(b.features).shape[0]) for b in batches)
        self.model.fit(batches, epochs=1,  # fit() takes any DataSet iterable
                       prefetch_depth=self.prefetch_depth)
        self.examples_seen += n
        self.mini_epochs += 1
        return {"examples": n, "batches": len(batches),
                "score": float(self.model.score_),
                "mini_epoch": self.mini_epochs}
