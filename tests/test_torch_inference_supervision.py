"""The rest of ParallelInference in the port on the CPU against the JAX package.

Dispatcher supervision (crash, restart in place after the backoff, budget
exhaustion) runs the same scenario on both packages' dispatchers over a
duck model, on a manual restart clock: every outcome, ``restart_state``
snapshot and ``DispatcherCrashed.retry_after_s`` is equal, and so is every
``BackoffPolicy.delay`` (its SHA-256 jitter). The metrics exposition of
one deterministic request sequence is equal series for series; the cold
dispatch counter moves as the reference's; the pad buffer is reused,
zeroed and bounded as the reference's, and never refilled before its
copy's event has completed. ``update_model`` under load: every answer
matches, within 1e-5, the reference's output of the model object that
served it (a small MLP with the reference's weights carried across). The
traced dispatcher records one ``queue_wait`` per request and one
``batch_execute`` per batch, linked, and the cost ledger's records conserve.
The fault plan parses and lints as the reference's for the serving kinds.
"""

import json
import threading
import types

import numpy as np
import pytest

from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.observe import cost as jcost
from deeplearning4j_tpu.observe import metrics as jmetrics
from deeplearning4j_tpu.observe import trace as jtrace
from deeplearning4j_tpu.parallel import elastic as jelastic
from deeplearning4j_tpu.parallel import inference as jinf
from deeplearning4j_tpu.util import faultinject as jfi
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn.conf import InputType as TIT
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration as TNNC
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TMLN
from deeplearning4j_tpu_torch.observe import cost as tcost
from deeplearning4j_tpu_torch.observe import metrics as tmetrics
from deeplearning4j_tpu_torch.observe import trace as ttrace
from deeplearning4j_tpu_torch.parallel import elastic as telastic
from deeplearning4j_tpu_torch.parallel import inference as tinf
from deeplearning4j_tpu_torch.util import faultinject as tfi
from deeplearning4j_tpu_torch.util.convert import load_reference_params
from test_torch_conv_family import jax_init, to_np

PORT = types.SimpleNamespace(inf=tinf, elastic=telastic, fi=tfi, metrics=tmetrics,
                             cost=tcost, trace=ttrace)
REF = types.SimpleNamespace(inf=jinf, elastic=jelastic, fi=jfi, metrics=jmetrics,
                            cost=jcost, trace=jtrace)
N_IN, N_OUT = 8, 3
ANSWER_TOL = 1e-5  # the port's f32 MLP against XLA's: summation order only


@pytest.fixture(autouse=True)
def _clean():
    yield
    for s in (PORT, REF):
        s.fi.set_plan(None)
        s.trace.disable_tracing()


def _mlp_conf(nnc, L, it, seed):
    return (nnc.builder().seed(seed).list()
            .layer(L.DenseLayer(n_out=16, activation="tanh"))
            .layer(L.OutputLayer(n_out=N_OUT, activation="softmax", loss="mcxent"))
            .set_input_type(it.feed_forward(N_IN)).build())


_NETS = {}


def mlp_pair(seed):
    """(JAX MLP, port MLP with its weights), made once per seed."""
    if seed not in _NETS:
        j = jax_init(JMLN, _mlp_conf(JNNC, JL, JIT, seed))
        t = TMLN(_mlp_conf(TNNC, TL, TIT, seed), device="cpu").init()
        _NETS[seed] = (j, load_reference_params(t, to_np(j.params)))
    return _NETS[seed]


class _Boom(BaseException):
    """Escapes the per-request handler and kills the dispatcher thread."""


class _Crashing:
    """Duck model whose listed forward calls kill the dispatcher."""

    def __init__(self, crash_calls=()):
        self.crash_calls, self.calls = set(crash_calls), 0

    def output(self, x):
        i, self.calls = self.calls, self.calls + 1
        if i in self.crash_calls:
            raise _Boom(f"crash at forward {i}")
        return np.zeros((np.asarray(x).shape[0], 2), np.float32)


def _pi(side, model, *, max_restarts=0, backoff=None, **kw):
    clock = [0.0]
    pi = side.inf.ParallelInference(
        model, max_batch_size=4, buckets=[4], wait_ms=0.5,
        max_restarts=max_restarts,
        restart_backoff=backoff or side.elastic.BackoffPolicy(base_s=1.0, jitter=0.0),
        restart_clock=lambda: clock[0], **kw)
    return pi, clock


def _attempt(side, pi, x):
    """The outcome of one request, as comparable data."""
    try:
        return ("ok", np.asarray(pi.output(x)).shape)
    except side.inf.DispatcherCrashed as e:
        return ("crashed", e.dispatched, e.retry_after_s, str(e).split(":")[0])


def _supervision(side, crash_calls, max_restarts, steps, backoff=None):
    metrics = side.metrics.MetricsRegistry()
    pi, clock = _pi(side, _Crashing(crash_calls), max_restarts=max_restarts,
                    backoff=backoff, metrics=metrics)
    x = np.zeros((2, 3), np.float32)
    trail = []
    try:
        for t in steps:
            clock[0] = t
            trail.append(_attempt(side, pi, x))
            trail.append(pi.restart_state())
        trail.append((pi.healthy, pi.restarts_used))
        trail.append(side.metrics.parse_prometheus_text(metrics.exposition()))
    finally:
        pi.shutdown()
    return trail


@pytest.mark.parametrize("case", [
    # crash, fast-fail while the window runs, restart, recover
    dict(crash_calls={1}, max_restarts=2, steps=[0.0, 0.0, 0.5, 1.5, 1.5]),
    # budget exhaustion: crash, restart then crash, terminal
    dict(crash_calls={0, 1}, max_restarts=1, steps=[0.0, 10.0, 10.0, 20.0]),
    # unsupervised: the crash is terminal at once
    dict(crash_calls={0}, max_restarts=0, steps=[0.0, 0.0]),
    # the ladder with the default jitter: 1st and 2nd rungs
    dict(crash_calls={0, 1}, max_restarts=3, steps=[0.0, 1.2, 1.2, 5.0],
         jitter=True),
], ids=["restart", "budget", "terminal", "jittered_ladder"])
def test_supervision_matches_the_reference(case):
    case = dict(case)
    jitter = case.pop("jitter", False)
    trails = []
    for side in (PORT, REF):
        backoff = side.elastic.BackoffPolicy(base_s=1.0) if jitter else None
        trails.append(_supervision(side, backoff=backoff, **case))
    assert trails[0] == trails[1]
    outcomes = [t for t in trails[0] if isinstance(t, tuple) and t
                and t[0] in ("ok", "crashed")]
    assert outcomes[0][0] == "crashed" or outcomes[0] == ("ok", (2, 2))


def test_backoff_delays_equal_the_reference():
    for kw in ({}, dict(base_s=0.5, factor=3.0, max_s=7.0, jitter=0.25),
               dict(jitter=0.0)):
        p, r = telastic.BackoffPolicy(**kw), jelastic.BackoffPolicy(**kw)
        for seed in ("", "default", "gpt2"):
            for attempt in range(0, 9):
                assert p.delay(attempt, seed=seed) == r.delay(attempt, seed=seed)


def test_crash_forward_fault_drives_supervision():
    trails = []
    for side in (PORT, REF):
        side.fi.set_plan(side.fi.FaultPlan.parse({"faults": [
            {"type": "crash_forward", "model": "default", "step": 1}]}))
        pi, clock = _pi(side, _Crashing(), max_restarts=1)
        x = np.zeros((1, 3), np.float32)
        try:
            trails.append([_attempt(side, pi, x), _attempt(side, pi, x),
                           isinstance(pi.dispatcher_error, side.fi.InjectedDispatcherCrash)])
            clock[0] = 5.0
            trails[-1] += [_attempt(side, pi, x), pi.restart_state()]
        finally:
            pi.shutdown()
    assert trails[0] == trails[1]
    assert trails[0][1][:2] == ("crashed", True) and trails[0][2]
    assert not isinstance(tfi.InjectedDispatcherCrash("x"), Exception)


@pytest.mark.parametrize("spec", [
    {"faults": [{"type": "crash_forward", "model": "m", "step": 2},
                {"type": "slow_forward", "model": "m", "step": 2}]},
    {"faults": [{"type": "reject_admission", "model": "*", "step": 3},
                {"type": "drop_response", "model": "*", "step": 3},
                {"type": "crash_forward", "model": "m", "step": 3},
                {"type": "crash_forward", "model": "m", "step": 3}]},
    {"faults": [{"type": "crash_forward", "step": 1}]},
    {"faults": [{"type": "crash_forward", "model": "m", "step": 1, "worker": 0}]},
    {"faults": [{"type": "kill", "worker": 0, "step": 1, "model": "m"}]},
    {"faults": [{"type": "slow_forward", "model": "m", "step": -1}]},
    {"faults": [{"type": "teleport", "model": "m", "step": 1}]},
    {"faults": "no"},
], ids=["shadowed_slow", "duplicates", "no_model", "worker_on_serving",
        "model_on_training", "negative_step", "unknown_type", "not_a_list"])
def test_fault_plan_parses_and_lints_as_the_reference(spec):
    def verdict(fi):
        try:
            plan = fi.FaultPlan.load(json.dumps(spec))
        except ValueError as e:
            return ("error", str(e))
        return ("ok", [vars(f) for f in plan.faults], plan.lint())

    assert verdict(tfi) == verdict(jfi)
    assert (tfi.ENV_VAR, tfi.ENV_HOST_VAR) == (jfi.ENV_VAR, jfi.ENV_HOST_VAR)
    assert tfi.SERVING_FAULT_TYPES == jfi.SERVING_FAULT_TYPES


def test_update_model_under_load_attributes_each_answer(rng):
    (j1, t1), (j2, t2) = mlp_pair(1), mlp_pair(2)
    pi = tinf.ParallelInference(t1, max_batch_size=8, buckets=(1, 2, 4, 8),
                                wait_ms=2.0)
    xs = [rng.normal(size=(1 + i % 3, N_IN)).astype(np.float32) for i in range(32)]
    answers = [None] * len(xs)
    done = threading.Semaphore(0)

    def client(c):
        for i in range(c, len(xs), 4):
            answers[i] = pi.output(xs[i], return_model=True)
            done.release()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for th in threads:
        th.start()
    for _ in range(12):
        done.acquire()
    pi.update_model(t2)
    for th in threads:
        th.join(timeout=60)
    pi.shutdown()
    served = {id(t1): j1, id(t2): j2}
    for x, (out, model) in zip(xs, answers):
        ref = np.asarray(served[id(model)].output(x))
        np.testing.assert_allclose(out, ref, rtol=ANSWER_TOL, atol=1e-7)
    assert {id(m) for _, m in answers} == {id(t1), id(t2)}
    assert answers[-1][1] is t2 or any(m is t2 for _, m in answers[-4:])
    inplace = tinf.ParallelInference(t1, mode="inplace")
    out, model = inplace.output(xs[0], return_model=True)
    assert model is t1
    np.testing.assert_allclose(out, np.asarray(j1.output(xs[0])), rtol=ANSWER_TOL,
                               atol=1e-7)


def _cold_sequence(side, net, net2):
    metrics = side.metrics.MetricsRegistry()
    pi = side.inf.ParallelInference(net, max_batch_size=4, buckets=[2, 4],
                                    wait_ms=0.0, metrics=metrics, metrics_name="m")

    def cold():
        parsed = side.metrics.parse_prometheus_text(metrics.exposition())
        return parsed.get("inference_cold_dispatches_total", {}).get((("model", "m"),), 0)

    x = np.ones((3, N_IN), np.float32)
    trail = [cold()]
    try:
        pi.output(x)  # lazy mode: a declared bucket is not cold
        trail.append(cold())
        trail.append(sorted(pi.warmup((N_IN,), buckets=[3])))
        for call in (lambda: pi.output(x),                     # warmed
                     lambda: pi.output(x[:2]),                 # bucket 2 never warmed
                     lambda: pi.output(x.astype(np.float64)),  # an unwarmed dtype
                     lambda: pi.output(np.ones((6, N_IN), np.float32)),  # off-bucket
                     lambda: pi.update_model(net2),
                     lambda: pi.output(x),                     # the new model is cold
                     lambda: pi.warmup((N_IN,), model=net2),
                     lambda: pi.output(x)):
            call()
            trail.append(cold())
    finally:
        pi.shutdown()
    return trail


def test_warmup_and_the_cold_dispatch_counter_match_the_reference():
    (j1, t1), (j2, t2) = mlp_pair(1), mlp_pair(2)
    port, ref = _cold_sequence(PORT, t1, t2), _cold_sequence(REF, j1, j2)
    assert port == ref == [0, 0, [4], 0, 1, 2, 3, 3, 4, 4, 4]


class _Capture:
    def __init__(self):
        self.seen = []

    def output(self, x):
        self.seen.append(np.array(x, copy=True))
        return np.asarray(x)[:, :2]


@pytest.mark.parametrize("reuse", [True, False])
def test_pad_buffer_is_reused_zeroed_and_bounded_as_the_reference(reuse):
    got = []
    for side in (PORT, REF):
        cap = _Capture()
        pi = side.inf.ParallelInference(cap, max_batch_size=8, buckets=[8],
                                        wait_ms=0.0, reuse_pad_buffer=reuse)
        try:
            # each answer compared as it was when returned (a copy made
            # before the next call)
            outs = [np.array(pi.output(np.full((6, 3), 7.0, np.float32)), copy=True),
                    np.array(pi.output(np.full((2, 3), 3.0, np.float32)), copy=True)]
            n_buffers = len(pi._pad_buffers)
            for width in range(1, pi._max_pad_buffers + 8):
                pi.output(np.zeros((2, width), np.float32))
            got.append((cap.seen[:2], outs, n_buffers,
                        len(pi._pad_buffers) <= pi._max_pad_buffers))
        finally:
            pi.shutdown()
    (p_seen, p_outs, p_n, p_bounded), (r_seen, r_outs, r_n, r_bounded) = got
    for a, b in zip(p_seen + p_outs, r_seen + r_outs):
        np.testing.assert_array_equal(a, b)
    assert p_seen[1][2:].sum() == 0  # the first batch's rows are cleared
    # the port always reuses its buffer; the reference only with reuse on
    assert (p_n, p_bounded) == (1, True)
    assert (r_n, r_bounded) == (1 if reuse else 0, True)


def _held_first_answer(side, reuse, zero_copy):
    """The first answer of a model that answers a view of its input, read
    again after later batches, beside a copy made when it was returned.
    ``zero_copy`` hands the model the host batch itself, as the
    reference's ``jnp.asarray`` does on the CPU when it aliases the
    buffer rather than copying it."""
    pi = side.inf.ParallelInference(_Capture(), max_batch_size=8, buckets=[8],
                                    wait_ms=0.0, reuse_pad_buffer=reuse)
    if zero_copy:
        pi._to_device = lambda x, *a, **k: x
    try:
        held = pi.output(np.full((6, 3), 7.0, np.float32))
        at_return = np.array(held, copy=True)
        pi.output(np.full((2, 3), 3.0, np.float32))
        pi.output(np.zeros((2, 3), np.float32))
        return held, at_return
    finally:
        pi.shutdown()


@pytest.mark.parametrize("reuse", [True, False])
def test_an_answer_outlives_the_reused_pad_buffer_where_the_reference_s_may_not(reuse):
    """C19 (ROADMAP §C, a departure kept): with reuse on, the reference's
    answer may be a view of its reused pad buffer, which later batches
    overwrite after the answer was handed out; the port copies an answer
    that shares the buffer, so a held answer keeps its values."""
    held, at_return = _held_first_answer(PORT, reuse, zero_copy=False)
    np.testing.assert_array_equal(held, at_return)
    np.testing.assert_array_equal(at_return, 7.0)
    ref_held, ref_at_return = _held_first_answer(REF, reuse, zero_copy=True)
    np.testing.assert_array_equal(ref_at_return, 7.0)
    assert np.array_equal(ref_held, ref_at_return) is (not reuse)


def test_pad_buffer_is_not_refilled_before_its_copy_completes():
    """A pinned buffer's copy to the card is asynchronous: the event
    recorded after it is waited on before the rows of the next batch land
    (on the CPU a stand-in event records what the buffer held then)."""
    pi = tinf.ParallelInference(_Capture(), mode="inplace", buckets=[4])
    seen = []

    class Event:
        def synchronize(self):
            seen.append(buf.array.copy())

    first = [tinf._Request(np.full((3, 2), 5.0, np.float32))]
    x, buf = pi._assemble(first, 3, 4, pin=False)
    buf.copied = Event()
    second = [tinf._Request(np.full((1, 2), 9.0, np.float32))]
    x2, buf2 = pi._assemble(second, 1, 4, pin=False)
    assert buf2 is buf and buf.copied is None
    np.testing.assert_array_equal(seen[0][:3], 5.0)  # waited before refilling
    np.testing.assert_array_equal(x2[:1], 9.0)
    np.testing.assert_array_equal(x2[1:], 0.0)


def _metrics_sequence(side, net, xs):
    metrics = side.metrics.MetricsRegistry()
    pi = side.inf.ParallelInference(net, max_batch_size=4, buckets=(1, 2, 4),
                                    wait_ms=0.0, metrics=metrics, metrics_name="mlp")
    try:
        pi.warmup((N_IN,))
        outs = [np.asarray(pi.output(x)) for x in xs]
    finally:
        pi.shutdown()
    return side.metrics.parse_prometheus_text(metrics.exposition()), outs


def test_metrics_series_match_the_reference(rng):
    j, t = mlp_pair(1)
    xs = [rng.normal(size=(n, N_IN)).astype(np.float32) for n in (1, 3, 2, 4, 6)]
    (pm, pouts), (rm, routs) = _metrics_sequence(PORT, t, xs), _metrics_sequence(REF, j, xs)
    assert pm == rm
    assert pm["inference_batch_size_count"][(("model", "mlp"),)] == 5
    assert pm["inference_dispatcher_up"][(("model", "mlp"),)] == 0  # shut down
    for a, b in zip(pouts, routs):
        np.testing.assert_allclose(a, b, rtol=ANSWER_TOL, atol=1e-7)


def _traced_serving(side, net, xs):
    reg = side.metrics.MetricsRegistry()
    ledger = side.cost.CostLedger(reg)
    tr = side.trace.enable_tracing(jax_hook=False)
    pi = side.inf.ParallelInference(net, max_batch_size=4, buckets=(1, 2, 4),
                                    wait_ms=0.0, cost=ledger)
    try:
        for x in xs:
            pi.output(x)
    finally:
        pi.shutdown()
        side.trace.disable_tracing()
    return tr.recorder.spans(), ledger, pi.batches_dispatched


def test_traced_batches_link_their_requests_and_the_ledger_conserves(rng):
    j, t = mlp_pair(1)
    xs = [rng.normal(size=(n, N_IN)).astype(np.float32) for n in (1, 2, 3, 4)]
    summary = {}
    for name, side, net in (("port", PORT, t), ("ref", REF, j)):
        spans, ledger, n_batches = _traced_serving(side, net, xs)
        by = {}
        for s in spans:
            by.setdefault(s.name, []).append(s)
        reqs = {s.span_id: s for s in by["inference_request"]}
        for q in by["queue_wait"]:
            assert q.parent_id in reqs
        for b in by["batch_execute"]:
            assert [l.span_id for l in b.links] and all(
                l.span_id in reqs for l in b.links)
            assert b.end_ns >= b.start_ns
        cons = ledger.conservation()
        assert cons["ok"] and cons["device_ms"] > 0
        for r in reqs.values():
            ms = ledger.device_ms(r.trace_id)
            assert ms > 0 and ledger.bill(r.trace_id, model="default") == ms
        summary[name] = (len(by["inference_request"]), len(by["queue_wait"]),
                         len(by["batch_execute"]), n_batches,
                         {k: v for k, v in cons.items()
                          if k in ("requests", "batches", "unattributed_device_ms")},
                         sorted(ledger.describe()))
    assert summary["port"] == summary["ref"]
    assert summary["port"][:4] == (4, 4, 4, 4)
