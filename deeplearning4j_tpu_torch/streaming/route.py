"""Route builder: source → transforms → sink pipelines.

The role of the reference's Camel routes (`dl4j-streaming/.../routes/`,
e.g. CSV → NDArray → Kafka): a small fluent pipeline that pulls from a
source, applies transforms, and pushes into a broker topic / socket / list,
optionally on a background thread.

The port's copy of the JAX package's jax-free ``streaming/route.py``;
its spans go through the port's ``observe.trace``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterable, List, Optional, Tuple

from deeplearning4j_tpu_torch.observe import trace as _trace


class RouteError(RuntimeError):
    """A transform/sink raised under the ``stop`` policy; chains the cause
    and carries the offending ``item``."""

    def __init__(self, item: Any, cause: Exception):
        super().__init__(f"route failed on item {item!r}: {cause!r}")
        self.item = item


_DROPPED = object()  # sentinel: a filter rejected the item


class Route:
    """``Route().from_source(it).transform(f).to_topic(broker, "t").start()``

    Error policy (``on_error``): what a throwing transform/sink does —
    - ``'stop'`` (default): processing stops and the error SURFACES — a
      synchronous ``run()`` raises ``RouteError``; a background ``start()``
      records it in ``route.error`` (a route thread never dies silently);
    - ``'skip'``: the item is dropped, the (item, exception) pair appended
      to ``route.errors``, and the route continues (Camel's
      dead-letter-channel role);
    - a callable ``fn(item, exc)``: invoked per failure, route continues;
      if the handler itself raises, that escalates as ``stop`` would.
    """

    def __init__(self):
        self._source: Optional[Iterable] = None
        self._transforms: List[Callable[[Any], Any]] = []
        self._sink: Optional[Callable[[Any], None]] = None
        self._thread: Optional[threading.Thread] = None
        self._on_error: Any = "stop"
        self.error: Optional[Exception] = None
        self.errors: List[Tuple[Any, Exception]] = []
        # items delivered by a completed background run (None while the
        # route is still running / never started) — consumers like the
        # pipeline trainer use it to tell "drained" from "stuck"
        self.result: Optional[int] = None

    def from_source(self, iterable: Iterable) -> "Route":
        self._source = iterable
        return self

    def transform(self, fn: Callable[[Any], Any]) -> "Route":
        self._transforms.append(("map", fn))
        return self

    def filter(self, predicate: Callable[[Any], bool]) -> "Route":
        self._transforms.append(("filter", predicate))
        return self

    def to_topic(self, broker, topic: str,
                 serializer: Optional[Callable[[Any], bytes]] = None) -> "Route":
        def sink(item):
            broker.publish(topic, serializer(item) if serializer else item)
        self._sink = sink
        return self

    def to_callable(self, fn: Callable[[Any], None]) -> "Route":
        self._sink = fn
        return self

    def to_list(self, out: List[Any]) -> "Route":
        self._sink = out.append
        return self

    def on_error(self, policy) -> "Route":
        """``'stop'`` | ``'skip'`` | ``fn(item, exc)`` — see class docs."""
        if policy not in ("stop", "skip") and not callable(policy):
            raise ValueError(
                f"on_error must be 'stop', 'skip' or a callable, "
                f"got {policy!r}")
        self._on_error = policy
        return self

    def run(self) -> int:
        """Drain the source synchronously; returns items delivered.

        When a tracer is active (``observe.enable_tracing``), the drain
        runs inside a ``route.run`` span with one ``route.item`` span per
        item and a child span per transform/sink stage — a failing or slow
        stage is visible in the same timeline as the training steps and
        serving requests it feeds."""
        if self._source is None or self._sink is None:
            raise ValueError("route needs from_source(...) and a to_*(...) sink")
        tracer = _trace.get_active_tracer()
        with _trace.span("route.run", category="stream"):
            return self._run_items(tracer)

    def _run_items(self, tracer) -> int:
        n = 0
        for index, item in enumerate(self._source):
            original = item
            try:
                item = self._process_item(tracer, item, index)
                if item is _DROPPED:
                    continue
            except Exception as e:  # noqa: BLE001 - policy decides
                if self._on_error == "skip":
                    self.errors.append((original, e))
                    continue
                if callable(self._on_error):
                    try:
                        self._on_error(original, e)
                    except Exception as handler_exc:  # noqa: BLE001
                        # handler failure escalates like 'stop' — same
                        # RouteError contract, carrying the offending item
                        raise RouteError(original, handler_exc) from handler_exc
                    self.errors.append((original, e))
                    continue
                raise RouteError(original, e) from e
            n += 1
        return n

    def _process_item(self, tracer, item, index):
        """Transforms + sink for one item; returns ``_DROPPED`` when a
        filter rejects it. Stage spans only exist while tracing is on."""
        if tracer is None:
            for kind, fn in self._transforms:
                if kind == "map":
                    item = fn(item)
                elif not fn(item):  # filter
                    return _DROPPED
            self._sink(item)
            return item
        with tracer.span("route.item", category="stream",
                         attrs={"index": index}):
            for kind, fn in self._transforms:
                stage = getattr(fn, "__name__", None) or type(fn).__name__
                with tracer.span(f"{kind}:{stage}", category="stream"):
                    if kind == "map":
                        item = fn(item)
                    elif not fn(item):  # filter
                        return _DROPPED
            with tracer.span("sink", category="stream"):
                self._sink(item)
        return item

    def start(self) -> "Route":
        """Run on a background thread (Camel's async route start). A
        failure under the ``stop`` policy lands in ``self.error`` instead
        of vanishing with the thread; a clean drain records the delivered
        count in ``self.result``."""
        def guarded():
            try:
                self.result = self.run()
            except Exception as e:  # noqa: BLE001 - surfaced via .error
                self.error = e

        self._thread = threading.Thread(target=guarded, daemon=True)
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> Optional[int]:
        """Wait for a background route; returns the delivered-item count
        (``None`` when the route stopped on an error — see ``.error``).

        Raises ``TimeoutError`` when the route is still running after
        ``timeout`` seconds: a stuck stream must be distinguishable from
        a drained one, not a silent return."""
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(f"route still running after {timeout}s")
        return self.result
