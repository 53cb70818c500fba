"""The port's threshold compression (``parallel/compression.py``) held
against the JAX package's on the same seeded numpy inputs: the index and
sign buffers and the count equal, the residual equal bit for bit in
float32, and ``EncodingHandler``'s residual and adaptive threshold over
60 steps."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import compression as jc
from deeplearning4j_tpu_torch.parallel import compression as tc


def residual(seed, shape, scale=1e-3):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def assert_same(port_msg, port_res, ref_msg, ref_res):
    np.testing.assert_array_equal(port_msg.indices.numpy(), np.asarray(ref_msg.indices))
    np.testing.assert_array_equal(port_msg.signs.numpy(), np.asarray(ref_msg.signs))
    assert port_msg.indices.dtype == torch.int32 and port_msg.signs.dtype == torch.int8
    assert int(port_msg.count) == int(ref_msg.count)
    assert float(port_msg.threshold) == float(ref_msg.threshold)
    np.testing.assert_array_equal(port_res.numpy().view(np.int32),
                                  np.asarray(ref_res).view(np.int32))


@pytest.mark.parametrize("case,shape,thr,cap", [
    ("some_pass", (40, 25), 1.5e-3, None),
    ("capacity_overflow", (1000,), 5e-4, 16),
    ("nothing_passes", (7, 9), 1.0, 32),
    ("everything_passes", (300,), 0.0, 300),
    ("signs_and_ties", (64,), 1e-3, 64),
])
def test_encode_matches_the_reference(case, shape, thr, cap):
    r = residual(3, shape)
    if case == "signs_and_ties":
        r[:8] = [1e-3, -1e-3, 2e-3, -2e-3, 0.0, -0.0, 9.99e-4, -9.99e-4]
    ref_msg, ref_res = jc.threshold_encode(jnp.asarray(r), thr, cap)
    msg, res = tc.threshold_encode(torch.from_numpy(r), thr, cap)
    assert_same(msg, res, ref_msg, ref_res)
    assert res.shape == r.shape
    want_cap = cap if cap is not None else jc.optimal_capacity(r.size)
    assert msg.indices.shape == (want_cap,)
    if case == "capacity_overflow":
        assert int(msg.count) == cap and (np.abs(r) >= thr).sum() > cap
        # what did not fit stays in the residual whole
        dropped = np.nonzero(np.abs(r.ravel()) >= thr)[0][cap:]
        np.testing.assert_array_equal(res.numpy().ravel()[dropped], r.ravel()[dropped])
    if case == "nothing_passes":
        assert int(msg.count) == 0 and (msg.indices.numpy() == -1).all()
        np.testing.assert_array_equal(res.numpy(), r)


@pytest.mark.parametrize("source", ["reference", "port"])
def test_decode_of_either_message_matches_the_reference(source):
    r = residual(5, (500,))
    ref_msg, _ = jc.threshold_encode(jnp.asarray(r), 1e-3, 64)
    msg, _ = tc.threshold_encode(torch.from_numpy(r), 1e-3, 64)
    if source == "reference":
        msg = tc.Encoded(*(torch.from_numpy(np.array(a)) for a in ref_msg))
    else:
        ref_msg = jc.Encoded(*(jnp.asarray(t.numpy()) for t in msg))
    got = tc.threshold_decode(msg, r.size)
    want = jc.threshold_decode(ref_msg, r.size)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_optimal_capacity_matches_the_reference():
    for size in (0, 100, 256, 257, 10_000):
        assert tc.optimal_capacity(size) == jc.optimal_capacity(size)
    assert tc.optimal_capacity(1000, sparsity=0.5, floor=4) == \
        jc.optimal_capacity(1000, sparsity=0.5, floor=4)


def test_encoding_handler_follows_the_reference_over_60_steps():
    """The residual and the adaptive threshold (decay while too few
    entries pass, boost when the buffer fills) step by step: a run of
    small updates, then large ones that saturate the buffer."""
    ref = jc.EncodingHandler(2e-3, min_threshold=2e-4, decay=0.9, boost=1.3, capacity=24)
    port = tc.EncodingHandler(2e-3, min_threshold=2e-4, decay=0.9, boost=1.3, capacity=24)
    rng = np.random.default_rng(11)
    thresholds, counts = [], []
    for step in range(60):
        scale = 2e-4 if step < 30 else 3e-3
        u = (rng.normal(size=(12, 16)) * scale).astype(np.float32)
        ref_msg = ref.encode(jnp.asarray(u))
        msg = port.encode(torch.from_numpy(u))
        assert_same(msg, port._residual, ref_msg, ref._residual)
        assert port.threshold == ref.threshold, step
        thresholds.append(port.threshold)
        counts.append(int(msg.count))
    # both directions of the adaptation ran
    assert min(thresholds[:30]) < 2e-3 and max(thresholds[30:]) > min(thresholds[:30])
    assert 24 in counts and min(counts) < 3
    port.reset()
    assert port._residual is None


def test_encode_follows_its_tensor_and_reads_nothing_to_the_host():
    """A float64 residual stays float64 (the threshold takes its dtype, as
    in the reference) and the encode needs no host read: the count is a
    tensor."""
    r = torch.from_numpy(residual(7, (50,)).astype(np.float64))
    msg, res = tc.threshold_encode(r, 1e-3)
    assert res.dtype == torch.float64 and isinstance(msg.count, torch.Tensor)
    ref_msg, ref_res = jc.threshold_encode(jnp.asarray(r.numpy().astype(np.float32)), 1e-3)
    assert int(msg.count) == int(ref_msg.count)
