"""The zoo's sequence models in the port against the JAX package.

Reduced twins of ``TextGenerationLSTM`` (12 characters, T 10),
``TransformerEncoder`` (2 layers, 16 wide, 2 heads, T 12) and
``VisionTransformer`` (16x16 images, patch 4, 2 layers, 32 wide), the
sizes of the JAX package's ``tests/test_zoo.py``: ``output`` within 1e-5
of the reference's from the same weights, and each parameter within 2e-5
x its tensor's largest entry after 3 ``fit`` steps of the model's own
updater (RmsProp with elementwise clipping at 10 and l2 1e-3; Adam), in
f32. The key bias of the encoder blocks (``bqkv``'s K columns) is held by
its gradient, not its steps (``tests/test_torch_zoo_models.py``, whose
helpers these tests use). Then:

- the encoder's padded-plus-mask batch (ids of length 12, the last 4
  masked) equals its unpadded prefix and the reference's masked output
  within 1e-5, and without the mask it does not;
- ``VisionTransformer`` refuses an image size its patch does not divide,
  as the reference does;
- a bf16 twin of the narrow encoder in the ratio form of
  ``tests/test_torch_mixed_precision.py``, fed integer ids: the port's
  bf16 loss and gradients against the JAX package's f64 ones, as a
  multiple of the JAX package's own bf16 distance from them (the whole
  gradient within 2x, each tensor within 3x or 2% of its f64 norm, the
  loss within 3x or 1e-3 relative); masters and gradients f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import helpers as jhelpers
from deeplearning4j_tpu.zoo import models as J
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.util.convert import load_reference_params
from deeplearning4j_tpu_torch.zoo import models as P
from test_torch_zoo_models import (
    ENC,
    _jax_init,
    _keyed,
    _twins,
    check_output,
    check_three_steps,
    to_np,
)

MASK_TOL = 1e-5
WHOLE_RATIO, TENSOR_RATIO, TENSOR_FLOOR = 2.0, 3.0, 2e-2
LOSS_RATIO, LOSS_FLOOR = 3.0, 1e-3
SEQUENCE_MODELS = ["TextGenerationLSTM", "TransformerEncoder", "VisionTransformer"]


@pytest.fixture(autouse=True)
def _clean_seams():
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    yield
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()


@pytest.mark.parametrize("name", SEQUENCE_MODELS)
def test_reduced_twin_output_matches_the_reference(name):
    check_output(name)


@pytest.mark.parametrize("name", SEQUENCE_MODELS)
def test_reduced_twin_three_steps_match_the_reference(name, monkeypatch):
    check_three_steps(name, monkeypatch)


def test_vision_transformer_rejects_an_indivisible_patch():
    with pytest.raises(ValueError, match="not divisible"):
        P.VisionTransformer(image_size=30, patch_size=4)
    with pytest.raises(ValueError):
        J.VisionTransformer(image_size=30, patch_size=4)


def test_encoder_padded_batch_with_a_mask_equals_its_prefix_and_the_reference():
    jnet, net = _twins("TransformerEncoder")
    rng = np.random.default_rng(8)
    valid = 8
    ids = rng.integers(0, ENC["vocab_size"], (2, ENC["max_length"])).astype(np.float32)
    mask = np.zeros((2, ENC["max_length"]), np.float32)
    mask[:, :valid] = 1.0
    padded = net.output(ids, masks=[mask]).numpy()
    prefix = net.output(ids[:, :valid]).numpy()
    ref = np.asarray(jnet.output(ids, masks=[mask]))
    np.testing.assert_allclose(padded, prefix, rtol=0, atol=MASK_TOL)
    np.testing.assert_allclose(padded, ref, rtol=0, atol=MASK_TOL)
    # without the mask the padding is attended to and pooled
    assert np.abs(net.output(ids).numpy() - prefix).max() > 1e-4


def _flat(grads):
    return {f"{k}/{n}": torch.from_numpy(np.array(v, np.float64))
            for k, named in _keyed(grads).items() for n, v in named.items()}


def test_bf16_encoder_against_f64_in_the_reference_ratio():
    rng = np.random.default_rng(12)
    ids = rng.integers(0, ENC["vocab_size"], (4, ENC["max_length"]))  # integer ids
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]
    jconf = J.TransformerEncoder(**ENC).conf()
    jconf.global_conf.compute_dtype = "bfloat16"
    jnet = _jax_init("TransformerEncoder", jconf)
    params = to_np(jnet.params)
    conf = P.TransformerEncoder(**ENC).conf()
    conf.global_conf.compute_dtype = "bfloat16"
    net = load_reference_params(ComputationGraph(conf, device="cpu").init(), params)
    g_port, l_port = net.compute_gradient_and_score(ids, y)
    assert all(g.dtype == torch.float32 for named in g_port.values() for g in named.values())
    assert all(p.dtype == torch.float32 for named in net.params.values() for p in named.values())
    g_ref, l_ref = jnet.compute_gradient_and_score(ids, y)
    with jax.enable_x64(True):
        j64, _ = _twins("TransformerEncoder", "float64")
        j64.params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), params)
        g64, l64 = j64.compute_gradient_and_score(ids, y)
        g64, l64 = _flat(g64), float(l64)
    port = _flat({k: {n: t.numpy() for n, t in named.items()} for k, named in g_port.items()})
    ref = _flat(g_ref)
    num = den = 0.0
    rows = {}
    for key, want in g64.items():
        dp, dr = (port[key] - want).norm().item(), (ref[key] - want).norm().item()
        rows[key] = (dp / max(dr, 1e-30), dp / max(want.norm().item(), 1e-30))
        num, den = num + dp * dp, den + dr * dr
    whole = (num / max(den, 1e-60)) ** 0.5
    lp, lr = abs(float(l_port) - l64), abs(float(l_ref) - l64)
    worst = max(rows.items(), key=lambda kv: kv[1][0])
    print(f"encoder bf16: whole-gradient ratio {whole:.3f}, worst tensor {worst[0]} "
          f"{worst[1][0]:.3f} ({worst[1][1]:.2e} of its f64 norm); loss error port "
          f"{lp:.3e} reference {lr:.3e}")
    assert whole <= WHOLE_RATIO
    for key, (ratio, rel) in rows.items():
        assert ratio <= TENSOR_RATIO or rel <= TENSOR_FLOOR, (key, ratio, rel)
    assert lp <= max(LOSS_RATIO * lr, LOSS_FLOOR * abs(l64))
