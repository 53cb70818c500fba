"""The port's updaters, schedules and fused updater helper against the JAX
package.

Inputs are drawn with numpy from a seed and fed to both. Tolerances:
updater steps rtol 1e-5 / atol 1e-7 (float32 both ways; the scalars such
as Adam's alpha are computed in float32 in the same order on both sides,
only XLA's and ATen's elementwise rounding differ); schedule values rtol
1e-6 (float32 scalars); the fused helper on the CPU (its plain version)
against ``PallasUpdaterHelper(interpret=True)`` 2e-5, the tolerance of
the JAX package's own fused-updater tests (tests/test_helpers.py:307).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.updaters as J
import deeplearning4j_tpu_torch.nn.updaters as P
from deeplearning4j_tpu.nn import helpers as jhelpers
from deeplearning4j_tpu.nn.pallas_kernels import PallasUpdaterHelper
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import helpers as thelpers

NAMES = ["Sgd", "NoOp", "Nesterovs", "Adam", "AdaMax", "Nadam", "AMSGrad",
         "AdaGrad", "AdaDelta", "RmsProp"]
SCHEDULES = [
    ("FixedSchedule", dict(value_=0.01)),
    ("ExponentialSchedule", dict(initial_value=0.1, gamma=0.97)),
    ("InverseSchedule", dict(initial_value=0.1, gamma=0.5, power=2.0)),
    ("PolySchedule", dict(initial_value=0.1, power=2.0, max_iter=120)),
    ("SigmoidSchedule", dict(initial_value=0.1, gamma=0.05, step_size=50)),
    ("StepSchedule", dict(initial_value=0.1, decay_rate=0.5, step=30.0)),
    ("MapSchedule", dict(values=((0, 0.1), (10, 0.05), (100, 0.01)))),
    ("WarmupCosineSchedule", dict(peak_value=0.1, warmup_steps=20,
                                  total_steps=200, final_value=0.001)),
]


@pytest.fixture(autouse=True)
def _clean_seams():
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    yield
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("lr", [0.05, "schedule"])
@pytest.mark.parametrize("name", NAMES)
def test_updater_matches_reference_over_three_steps(name, lr, rng):
    jlr = J.ExponentialSchedule(initial_value=0.05, gamma=0.9) if lr == "schedule" else lr
    plr = P.ExponentialSchedule(initial_value=0.05, gamma=0.9) if lr == "schedule" else lr
    ju, pu = getattr(J, name)(jlr), getattr(P, name)(plr)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    js, ps = ju.init_state(jnp.asarray(p0)), pu.init_state(torch.from_numpy(p0))
    assert sorted(ps) == sorted(js)
    for it in range(3):
        g = rng.normal(size=p0.shape).astype(np.float32)
        jl = ju.lr_at(jnp.float32(it), jnp.float32(0))
        pl = pu.lr_at(np.float32(it), np.float32(0))
        np.testing.assert_allclose(np.float32(pl), np.float32(jl), rtol=1e-6)
        jupd, js = ju.update(jnp.asarray(g), js, jl, jnp.float32(it + 1.0))
        pupd, ps = pu.update(torch.from_numpy(g), ps, pl, it + 1.0)
        np.testing.assert_allclose(_np(pupd), _np(jupd), rtol=1e-5, atol=1e-7,
                                   err_msg=f"{name} step {it + 1}")
        for k in js:
            np.testing.assert_allclose(_np(ps[k]), _np(js[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{name}.{k}")


@pytest.mark.parametrize("stype", ["iteration", "epoch"])
@pytest.mark.parametrize("name,kw", SCHEDULES)
def test_schedule_values_match_reference(name, kw, stype):
    js = getattr(J, name)(schedule_type=stype, **kw)
    ps = getattr(P, name)(schedule_type=stype, **kw)
    for it, ep in [(0, 0), (1, 0), (9, 1), (10, 2), (19, 3), (20, 4),
                   (55, 10), (99, 20), (100, 30), (150, 60), (5000, 99)]:
        want = float(J.schedule_value(js, jnp.float32(it), jnp.float32(ep)))
        got = float(P.schedule_value(ps, np.float32(it), np.float32(ep)))
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   err_msg=f"{name} at {it}/{ep}")
    assert ps.to_dict() == js.to_dict()
    assert P.Schedule.from_dict(js.to_dict()) == ps
    assert P.schedule_value(0.25, 3, 0) == 0.25


def test_resolve_updater_names_and_serde():
    for key in ("sgd", "adam", "adamax", "nadam", "amsgrad", "adagrad",
                "adadelta", "rmsprop", "nesterovs", "noop", "none", "ADAM"):
        got, want = P.resolve_updater(key), J.resolve_updater(key)
        assert type(got).__name__ == type(want).__name__
        assert got.to_dict() == want.to_dict()
    assert type(P.resolve_updater(None)) is P.Sgd
    a = P.Adam(3e-4)
    assert P.resolve_updater(a) is a
    with pytest.raises(ValueError, match="Unknown updater"):
        P.resolve_updater("lion")
    sched = J.Adam(J.StepSchedule(initial_value=0.1, step=10.0), beta1=0.8)
    assert P.resolve_updater(sched.to_dict()) == P.Adam(
        P.StepSchedule(initial_value=0.1, step=10.0), beta1=0.8)
    assert P.Updater.from_dict(P.Nadam(1e-3).to_dict()) == P.Nadam(1e-3)


@pytest.mark.parametrize("shape", [(1,), (127,), (129, 3), (1000,)])
@pytest.mark.parametrize("name", ["Adam", "Nadam", "AMSGrad"])
def test_fused_helper_on_cpu_matches_pallas_interpret(name, shape, rng):
    """The port's helper on CPU tensors (the kernel's plain version) and
    the JAX package's Pallas kernel in interpret mode, twice in a row
    from the same state."""
    ju, pu = getattr(J, name)(1e-3), getattr(P, name)(1e-3)
    jh, ph = PallasUpdaterHelper(interpret=True), ck.FusedUpdaterHelper()
    p0 = rng.normal(size=shape).astype(np.float32)
    jp, js = jnp.asarray(p0), ju.init_state(jnp.asarray(p0))
    pp = torch.from_numpy(p0.copy())
    ps = pu.init_state(pp)
    for t in (1.0, 2.0):
        g = rng.normal(size=shape).astype(np.float32)
        jp, js = jh.apply(ju, jp, jnp.asarray(g), js, 1e-3, t)
        out_p, out_s = ph.apply(pu, pp, torch.from_numpy(g), ps, 1e-3, t)
        assert out_p is pp and out_s is ps  # in place
        np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=2e-5,
                                   atol=2e-5)
        for k in js:
            np.testing.assert_allclose(ps[k].numpy(), np.asarray(js[k]),
                                       rtol=2e-5, atol=2e-5)
    assert ck.fused_adam.launches == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("name", ["Adam", "Nadam", "AMSGrad"])
def test_fused_plain_version_matches_stock_updater(name, rng):
    """The helper's math is the stock updater's (same float32 scalars)."""
    u = getattr(P, name)(3e-4)
    p0 = rng.normal(size=(33, 5)).astype(np.float32)
    stock_p, stock_s = torch.from_numpy(p0.copy()), u.init_state(torch.zeros(33, 5))
    fused_p, fused_s = torch.from_numpy(p0.copy()), u.init_state(torch.zeros(33, 5))
    for t in (1.0, 2.0, 3.0):
        g = torch.from_numpy(rng.normal(size=p0.shape).astype(np.float32))
        upd, stock_s = u.update(g, stock_s, 3e-4, t)
        stock_p -= upd
        ck.FusedUpdaterHelper().apply(u, fused_p, g, fused_s, 3e-4, t)
        torch.testing.assert_close(fused_p, stock_p, rtol=0, atol=1e-7)
        for k in stock_s:
            torch.testing.assert_close(fused_s[k], stock_s[k], rtol=0, atol=1e-8)


def test_fused_helper_supports_gating():
    """tests/test_helpers.py's gate table for PallasUpdaterHelper."""
    h = ck.FusedUpdaterHelper()
    p = torch.zeros(24, 16)
    assert h.supports(P.Adam(1e-3), p, p)
    assert h.supports(P.Nadam(1e-3), p, p) and h.supports(P.AMSGrad(), p, p)
    assert not h.supports(P.Sgd(1e-2), p, p)  # no state to fuse
    assert not h.supports(P.AdaMax(), p, p)

    class TweakedAdam(P.Adam):
        pass

    assert not h.supports(TweakedAdam(1e-3), p, p)  # exact types only
    assert not h.supports(P.Adam(1e-3), p.bfloat16(), p.bfloat16())
    assert not h.supports(P.Adam(1e-3), p, torch.zeros(24, 8))
    assert not h.supports(P.Adam(1e-3), torch.zeros(0), torch.zeros(0))


def test_fused_adam_wrapper_rejects_bad_arguments():
    p = torch.zeros(8)
    coef = ck.adam_coefficients(P.Adam(), 1e-3, 1.0)
    with pytest.raises(ValueError, match="unknown kind"):
        ck.fused_adam(7, p, p, p, None, p, coef)
    with pytest.raises(ValueError, match="v_hat"):
        ck.fused_adam(ck.AMSGRAD, p, p, p, None, p, coef)
    with pytest.raises(ValueError, match="v_hat"):
        ck.fused_adam(ck.ADAM, p, p, p, p, p, coef)
    meta = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        ck.fused_adam(ck.ADAM, p, p, p, None, meta, coef)


def test_adam_coefficients_are_the_stock_scalars():
    u = P.Adam(3e-4, beta1=0.8, beta2=0.99, epsilon=1e-7)
    b1, b2, omb1, omb2, eps, c, om1, om2 = ck.adam_coefficients(u, 3e-4, 4.0)
    f32 = np.float32
    assert (b1, b2, eps) == (float(f32(0.8)), float(f32(0.99)), float(f32(1e-7)))
    assert (omb1, omb2) == (float(f32(1 - 0.8)), float(f32(1 - 0.99)))
    assert om1 == float(f32(1) - f32(0.8) ** f32(4.0))
    assert c == P._adam_alpha(3e-4, 0.8, 0.99, 4.0)
    assert ck.adam_coefficients(P.Nadam(3e-4), 3e-4, 4.0)[5] == float(f32(3e-4))
