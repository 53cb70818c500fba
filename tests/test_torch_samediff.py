"""The port's SameDiff (``deeplearning4j_tpu_torch/autodiff/samediff.py``)
against the JAX package's on the same numpy-seeded inputs.

- every op of ``OPS``: value and gradient (a vector-Jacobian product with
  a seeded cotangent), the reference's ``OPS[name]`` called eagerly beside
  the port's, within 1e-5 x max(1, the reference's largest entry); the tie
  cases (relu, leaky relu and the relu family at 0, clip at its bounds,
  maximum/minimum/max/min/segment_max ties, hard sigmoid at 0, gelu's tanh
  form, top_k and descending sort among equal values, mod's sign) and the
  index cases (gather's -1 and NaN past the end, gather_nd's clamp,
  segment ids and scatter indices out of range, empty segments, one_hot
  out of range, slice's clamped start, strided_slice's negative step);
- the namespaces' positional-scalar binding, node for node;
- if_cond and while_loop, bounded and unbounded, their gradients, the
  unbounded loop's refusal to differentiate, nested control flow;
- infer_shape, calculate_gradients;
- fit: 3 steps with Adam and Sgd, l1 and l2, a second fit (the step
  count restarts), with and without ``FusedUpdaterHelper`` (its plain
  version on the CPU): variables and Adam slots within 1e-5;
- evaluate; the npz both ways, control-flow graphs and rename included.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import samediff as jsd
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu_torch.autodiff import samediff as psd
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn import updaters as PU

TOL = 1e-5
RNG = np.random.default_rng(18)


@pytest.fixture(autouse=True)
def _clean_seams():
    thelpers.clear_all_helpers()
    yield
    thelpers.clear_all_helpers()


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.nanmax(np.abs(want)))) if want.size and np.isfinite(
        want).any() else 1.0
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                               rtol=0, atol=tol * scale, equal_nan=True, err_msg=what)


def _n(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _pos(*shape):
    return RNG.uniform(0.5, 2.0, size=shape).astype(np.float32)


def _i(values):
    return np.asarray(values, np.int32)


TIES = np.array([-2.0, -1.0, 0.0, 0.0, 1.0, 3.0], np.float32)
MAT = _n(3, 4)
IMG = _n(2, 8, 8, 3)
IMG5 = _n(2, 5, 5, 3)

# (case id, op, inputs, attrs): an integer input takes no gradient
CASES = [
    ("add", "add", [_n(3, 4), _n(4)], {}),
    ("sub", "sub", [_n(3, 4), _n(3, 4)], {}),
    ("mul", "mul", [_n(3, 4), _n(3, 4)], {}),
    ("div", "div", [_n(3, 4), _pos(3, 4)], {}),
    ("pow", "pow", [_pos(3, 4), _n(3, 4)], {}),
    ("neg", "neg", [_n(5)], {}),
    ("rsub", "rsub", [_n(5), _n(5)], {}),
    ("rdiv", "rdiv", [_pos(5), _n(5)], {}),
    ("matmul", "matmul", [_n(3, 4), _n(4, 2)], {}),
    ("maximum_ties", "maximum", [TIES, np.array([-2, 0, 0, 1, 1, 2], np.float32)], {}),
    ("minimum_ties", "minimum", [TIES, np.array([-2, 0, 0, 1, 1, 2], np.float32)], {}),
    ("transpose", "transpose", [_n(2, 3, 4)], {"axes": (2, 0, 1)}),
    ("transpose_reverse", "transpose", [_n(2, 3, 4)], {}),
    ("reshape", "reshape", [_n(2, 6)], {"shape": (3, -1)}),
    ("concat", "concat", [_n(2, 3), _n(2, 2)], {"axis": 1}),
    ("stack", "stack", [_n(2, 3), _n(2, 3)], {"axis": 1}),
    ("slice", "slice", [_n(4, 5)], {"begin": (1, 2), "size": (2, 2)}),
    ("slice_clamped", "slice", [_n(4, 5)], {"begin": (3, -2), "size": (2, 3)}),
    ("strided_slice", "strided_slice", [_n(4, 6)],
     {"slices": ((1, 4, 2), (None, None, 1))}),
    ("strided_slice_negative_step", "strided_slice", [_n(4, 6)],
     {"slices": ((None, None, -1), (5, 0, -2))}),
    ("gather", "gather", [_n(4, 3), _i([2, 0, 2])], {"axis": 0}),
    ("gather_wrap_and_nan", "gather", [_n(3, 4), _i([[-1, 4], [1, -6]])], {"axis": 1}),
    ("gather_float_ids", "gather", [_n(4, 3), np.array([1.0, 3.0], np.float32)],
     {"axis": 0}),
    ("one_hot", "one_hot", [_i([0, 2, 5, -1])], {"depth": 3}),
    ("cast", "cast", [_n(4) * 3], {"dtype": "int32"}),
    ("where", "where", [np.array([1, 0, 1, 0], np.float32), _n(4), _n(4)], {}),
    ("tile", "tile", [_n(2, 3)], {"reps": (2, 1)}),
    ("expand_dims", "expand_dims", [_n(2, 3)], {"axis": 1}),
    ("squeeze", "squeeze", [_n(2, 1, 3)], {"axis": 1}),
    ("squeeze_all", "squeeze", [_n(1, 3, 1)], {}),
    ("sum", "sum", [_n(3, 4, 2)], {"dims": (0, 2), "keepdims": False}),
    ("sum_all", "sum", [_n(3, 4)], {}),
    ("mean", "mean", [_n(3, 4)], {"dims": (1,), "keepdims": True}),
    ("max_ties", "max", [np.array([[1, 3, 3], [2, 2, 0]], np.float32)],
     {"dims": (1,), "keepdims": False}),
    ("max_all_ties", "max", [np.array([[1, 3, 3], [3, 2, 0]], np.float32)], {}),
    ("min_ties", "min", [np.array([[1, 0, 0], [2, 2, 5]], np.float32)],
     {"dims": (1,), "keepdims": True}),
    ("prod", "prod", [_n(3, 4, 2)], {"dims": (0, 2), "keepdims": False}),
    ("prod_keep", "prod", [_n(3, 4)], {"dims": (1,), "keepdims": True}),
    ("prod_all", "prod", [_pos(2, 3)], {}),
    ("std", "std", [_n(3, 5)], {"dims": (1,), "keepdims": False, "bias_corrected": True}),
    ("variance", "variance", [_n(3, 5)], {"dims": (0,), "keepdims": True,
                                          "bias_corrected": False}),
    ("argmax", "argmax", [np.array([[1, 3, 3], [2, 2, 0]], np.float32)], {"dims": 1}),
    ("argmax_flat", "argmax", [_n(3, 4)], {}),
    ("argmin", "argmin", [np.array([[1, 0, 0], [2, 2, 5]], np.float32)], {"dims": 1}),
    ("norm2", "norm2", [_n(3, 4)], {"dims": (1,), "keepdims": False}),
    ("norm1", "norm1", [np.array([[0.0, -1.0], [2.0, 0.0]], np.float32)],
     {"dims": (1,), "keepdims": True}),
    ("abs", "abs", [TIES], {}),
    ("exp", "exp", [_n(5)], {}),
    ("log", "log", [_pos(5)], {}),
    ("sqrt", "sqrt", [_pos(5)], {}),
    ("square", "square", [_n(5)], {}),
    ("sin", "sin", [_n(5)], {}),
    ("cos", "cos", [_n(5)], {}),
    ("tan", "tan", [_n(5, scale=0.5)], {}),
    ("floor", "floor", [_n(5) * 3], {}),
    ("ceil", "ceil", [_n(5) * 3], {}),
    ("round", "round", [np.array([0.5, 1.5, 2.5, -0.5, 1.2], np.float32)], {}),
    ("sign", "sign", [TIES], {}),
    ("erf", "erf", [_n(5)], {}),
    ("clip_bounds", "clip_by_value",
     [np.array([-1.0, -0.5, 0.0, 0.5, 1.0], np.float32)],
     {"clip_min": -0.5, "clip_max": 0.5}),
    ("clip_min_only", "clip_by_value", [TIES], {"clip_min": 0.0}),
    ("reciprocal", "reciprocal", [_pos(5)], {}),
    ("log1p", "log1p", [_pos(5)], {}),
    ("expm1", "expm1", [_n(5)], {}),
    ("cumsum", "cumsum", [_n(3, 4)], {"axis": 1}),
    ("cumprod", "cumprod", [_n(3, 4)], {"axis": 0}),
    ("sort", "sort", [_n(3, 5)], {"axis": -1}),
    ("sort_descending_ties", "sort", [np.array([[1, 3, 3, 0], [2, 2, 2, 5]], np.float32)],
     {"axis": -1, "descending": True}),
    ("logsumexp", "logsumexp", [_n(3, 4)], {"axis": 1, "keepdims": True}),
    ("logsumexp_all", "logsumexp", [_n(3, 4)], {}),
    ("l2_normalize", "l2_normalize", [_n(3, 4)], {"axis": -1}),
    ("mod_signs", "mod", [np.array([-3.0, 3.0, -3.5, 5.0], np.float32),
                          np.array([2.0, -2.0, 2.0, 3.0], np.float32)], {}),
    ("floor_div", "floor_div", [np.array([-3.0, 3.0, -3.5, 5.0], np.float32),
                                np.array([2.0, -2.0, 2.0, 3.0], np.float32)], {}),
    ("atan", "atan", [_n(5)], {}),
    ("asin", "asin", [_n(5, scale=0.3)], {}),
    ("acos", "acos", [_n(5, scale=0.3)], {}),
    ("sinh", "sinh", [_n(5)], {}),
    ("cosh", "cosh", [_n(5)], {}),
    ("asinh", "asinh", [_n(5)], {}),
    ("acosh", "acosh", [_pos(5) + 1.0], {}),
    ("atanh", "atanh", [_n(5, scale=0.3)], {}),
    ("atan2", "atan2", [_n(5), _n(5)], {}),
    ("isnan", "isnan", [np.array([0.0, np.nan, np.inf], np.float32)], {}),
    ("isinf", "isinf", [np.array([0.0, np.nan, -np.inf], np.float32)], {}),
    ("top_k_ties", "top_k", [np.array([[1, 3, 3, 0, 3], [2, 5, 2, 2, 1]], np.float32)],
     {"k": 3}),
    ("diag_vector", "diag", [_n(4)], {}),
    ("diag_matrix", "diag", [_n(4, 4)], {}),
    ("trace", "trace", [_n(4, 4)], {}),
    ("gt", "gt", [TIES, np.zeros(6, np.float32)], {}),
    ("gte", "gte", [TIES, np.zeros(6, np.float32)], {}),
    ("lt", "lt", [TIES, np.zeros(6, np.float32)], {}),
    ("lte", "lte", [TIES, np.zeros(6, np.float32)], {}),
    ("eq", "eq", [TIES, np.zeros(6, np.float32)], {}),
    ("neq", "neq", [TIES, np.zeros(6, np.float32)], {}),
    ("tanh", "tanh", [_n(5)], {}),
    ("sigmoid", "sigmoid", [_n(5)], {}),
    ("relu_tie", "relu", [TIES], {}),
    ("relu6_ties", "relu6", [np.array([-1.0, 0.0, 3.0, 6.0, 7.0], np.float32)], {}),
    ("elu", "elu", [TIES], {}),
    ("selu", "selu", [TIES], {}),
    ("gelu_tanh_form", "gelu", [np.array([1.0, -1.0, 0.0, 2.5], np.float32)], {}),
    ("softplus", "softplus", [TIES], {}),
    ("softsign", "softsign", [TIES], {}),
    ("swish", "swish", [TIES], {}),
    ("hard_sigmoid_ties", "hard_sigmoid",
     [np.array([-4.0, -3.0, 0.0, 3.0, 4.0, 1.0], np.float32)], {}),
    ("leaky_relu_tie", "leaky_relu", [TIES], {"alpha": 0.2}),
    ("softmax", "softmax", [_n(3, 4)], {"dims": -1}),
    ("log_softmax", "log_softmax", [_n(3, 4)], {"dims": 0}),
    ("linear", "linear", [_n(3, 4), _n(4, 2), _n(2)], {}),
    ("linear_no_bias", "linear", [_n(3, 4), _n(4, 2)], {}),
    ("layer_norm", "layer_norm", [_n(3, 6), _n(6), _n(6)], {"eps": 1e-5}),
    ("dropout", "dropout", [_n(4)], {"p": 0.5}),
    ("conv2d_same_odd_pad", "conv2d", [IMG, _n(3, 3, 3, 4)],
     {"stride": (2, 2), "padding": "SAME"}),
    ("conv2d_valid", "conv2d", [IMG, _n(2, 3, 3, 4)], {"stride": (1, 2), "padding": "VALID"}),
    ("conv2d_explicit", "conv2d", [IMG, _n(3, 3, 3, 2)],
     {"stride": (1, 1), "padding": ((1, 2), (0, 1))}),
    ("max_pool_same", "max_pooling2d", [IMG5],
     {"size": (2, 2), "stride": (2, 2), "padding": "SAME"}),
    ("max_pool_valid", "max_pooling2d", [IMG], {}),
    ("avg_pool_same_counts", "avg_pooling2d", [IMG5],
     {"size": (2, 2), "stride": (2, 2), "padding": "SAME"}),
    ("avg_pool_overlap", "avg_pooling2d", [IMG5],
     {"size": (3, 3), "stride": (1, 1), "padding": "SAME"}),
    ("batch_mmul", "batch_mmul", [_n(2, 3, 4), _n(2, 4, 5)], {}),
    ("loss_mse", "loss_mse", [_n(4, 3), _n(4, 3)], {}),
    ("loss_mae", "loss_mae", [_n(4, 3), _n(4, 3)], {}),
    ("loss_softmax_ce", "loss_softmax_ce",
     [np.eye(3, dtype=np.float32)[[0, 2, 1, 1]], _n(4, 3)], {}),
    ("loss_sigmoid_ce", "loss_sigmoid_ce",
     [np.array([[1, 0, 1]] * 2, np.float32), np.array([[0.0, 1.5, -2.0], [0.5, 0.0, 3.0]],
                                                      np.float32)], {}),
    ("loss_log", "loss_log", [np.array([[1, 0, 1]], np.float32),
                              np.array([[0.2, 0.6, 0.9]], np.float32)], {}),
    ("loss_huber", "loss_huber", [_n(4, 3), _n(4, 3)], {"delta": 0.7}),
    ("loss_cosine", "loss_cosine", [_n(4, 3), _n(4, 3)], {"dims": -1}),
    ("loss_hinge_tie", "loss_hinge", [np.array([[1, 0, 1]], np.float32),
                                      np.array([[1.0, -1.0, 0.3]], np.float32)], {}),
    ("scatter_update", "scatter_update", [_n(5, 3), _i([1, 3]), _n(2, 3)], {}),
    ("scatter_update_dropped", "scatter_update", [_n(5, 3), _i([-1, 5, -6]), _n(3, 3)], {}),
    ("scatter_add_dups", "scatter_add", [_n(5, 3), _i([1, 1, 7, -1]), _n(4, 3)], {}),
    ("scatter_sub", "scatter_sub", [_n(5, 3), _i([0, 4, 9]), _n(3, 3)], {}),
    ("scatter_mul", "scatter_mul", [_n(5, 3), _i([2, 2, 6]), _n(3, 3)], {}),
    ("scatter_div", "scatter_div", [_n(5, 3), _i([0, 3, -7]), _pos(3, 3)], {}),
    ("scatter_max", "scatter_max", [_n(5, 3), _i([1, 4, 5]), _n(3, 3)], {}),
    ("scatter_min", "scatter_min", [_n(5, 3), _i([1, 4, 5]), _n(3, 3)], {}),
    ("gather_nd_clamped", "gather_nd", [_n(3, 4), _i([[0, 1], [5, 1], [-1, -1], [-4, 0]])],
     {}),
    ("segment_sum", "segment_sum", [_n(6, 2), _i([0, 0, 2, 7, 2, -1])], {"num_segments": 4}),
    ("segment_mean", "segment_mean", [_n(6, 2), _i([0, 0, 2, 7, 2, -1])],
     {"num_segments": 4}),
    ("segment_max_ties", "segment_max",
     [np.array([[1, 2], [1, 0], [5, 5], [0, 0], [3, 5]], np.float32), _i([0, 0, 1, 9, 1])],
     {"num_segments": 3}),
    ("segment_min", "segment_min", [_n(5, 2), _i([0, 0, 1, 9, 1])], {"num_segments": 3}),
    ("segment_prod", "segment_prod", [_n(5, 2), _i([0, 0, 1, 9, 1])], {"num_segments": 3}),
    ("conv1d", "conv1d", [_n(2, 9, 3), _n(4, 3, 5)], {"stride": 2, "padding": "SAME"}),
    ("depthwise_conv2d", "depthwise_conv2d", [IMG, _n(3, 3, 3, 2)],
     {"stride": (1, 1), "padding": "SAME"}),
    ("deconv2d_same", "deconv2d", [_n(2, 4, 4, 3), _n(3, 3, 3, 2)],
     {"stride": (2, 2), "padding": "SAME"}),
    ("deconv2d_valid", "deconv2d", [_n(2, 4, 5, 3), _n(4, 2, 3, 2)],
     {"stride": (2, 3), "padding": "VALID"}),
    ("space_to_depth", "space_to_depth", [_n(2, 4, 6, 3)], {"block_size": 2}),
    ("depth_to_space", "depth_to_space", [_n(2, 2, 3, 12)], {"block_size": 2}),
    ("tuple_get", "tuple_get", [_n(3), _n(4)], {"index": 1}),
]


# the reference cannot differentiate these (jax raises: scatter_mul
# gradients need unique indices); the port's values are held, and its
# gradients are torch's
REF_NO_GRAD = {"scatter_mul", "scatter_div", "segment_prod"}


def _run_port(op, inputs, attrs):
    """The port's op on tensors and its VJP; ``tuple_get`` takes a tuple."""
    ts = [torch.tensor(a, dtype=torch.int64) if a.dtype.kind == "i"
          else torch.tensor(a).requires_grad_(True) for a in inputs]
    out = (psd.OPS[op](tuple(ts), **attrs) if op == "tuple_get"
           else psd.OPS[op](*ts, **attrs))
    return ts, out if isinstance(out, tuple) else (out,)


def _run_ref(op, inputs, attrs):
    args = [jnp.asarray(a) for a in inputs]
    diff = [i for i, a in enumerate(inputs) if a.dtype.kind == "f"]

    def f(*d):
        full = list(args)
        for i, v in zip(diff, d):
            full[i] = v
        out = jsd.OPS[op](tuple(full), **attrs) if op == "tuple_get" else \
            jsd.OPS[op](*full, **attrs)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    if op in REF_NO_GRAD:
        with pytest.raises(NotImplementedError, match="unique_indices"):
            jax.vjp(f, *[args[i] for i in diff])
        return diff, f(*[args[i] for i in diff]), None
    outs, vjp = jax.vjp(f, *[args[i] for i in diff])
    return diff, outs, vjp


NO_GRAD = {"argmax", "argmin", "gt", "gte", "lt", "lte", "eq", "neq", "isnan",
           "isinf", "cast", "one_hot", "floor_div", "floor", "ceil", "round",
           "sign"}


def test_cases_cover_every_op():
    assert set(psd.OPS) == set(jsd.OPS)
    assert {c[1] for c in CASES} == set(jsd.OPS)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_value_and_gradient_match_reference(case):
    cid, op, inputs, attrs = case
    diff, jouts, vjp = _run_ref(op, inputs, attrs)
    ts, pouts = _run_port(op, inputs, attrs)
    assert len(pouts) == len(jouts)
    for k, (p, j) in enumerate(zip(pouts, jouts)):
        _close(p.detach().numpy(), np.asarray(j), f"{cid} output {k}")
        assert p.is_floating_point() == jnp.issubdtype(j.dtype, jnp.floating), cid
    if op in NO_GRAD or op in REF_NO_GRAD or not diff:
        return
    cot = [RNG.normal(size=np.shape(j)).astype(np.float32)
           if jnp.issubdtype(j.dtype, jnp.floating)
           else np.zeros(np.shape(j), jax.dtypes.float0) for j in jouts]
    want = vjp(tuple(c if c.dtype == jax.dtypes.float0 else jnp.asarray(c) for c in cot))
    flt = [(p, torch.from_numpy(c)) for p, c in zip(pouts, cot) if p.is_floating_point()]
    flt = [(p, c) for p, c in flt if p.requires_grad]
    # a NaN output (gather past the end) sends nothing back in either package
    got = torch.autograd.grad([p for p, _ in flt], [ts[i] for i in diff],
                              [torch.where(p.isnan(), 0.0, c) for p, c in flt],
                              allow_unused=True, materialize_grads=True)
    for i, g, w in zip(diff, got, want):
        _close(g.numpy(), np.asarray(w), f"{cid} gradient of input {i}")


def test_index_ops_never_index_out_of_range_on_device_tensors():
    """The index cases run on meta tensors too: no host read of the ids
    (a device-side assert would end the process on the card)."""
    for cid, op, inputs, attrs in CASES:
        if cid in ("gather_wrap_and_nan", "scatter_update_dropped", "segment_sum",
                   "gather_nd_clamped", "one_hot"):
            ts = [torch.empty(a.shape, dtype=torch.int64 if a.dtype.kind == "i"
                              else torch.float32, device="meta") for a in inputs]
            (out,) = (psd.OPS[op](*ts, **attrs),)
            assert out.device.type == "meta", cid


# ---------------------------------------------------------------- graphs
def _both(build, **kw):
    """The same graph built in both packages (``build(sd, pkg)``)."""
    j = jsd.SameDiff.create()
    p = psd.SameDiff.create(device="cpu")
    build(j, jsd, **kw)
    build(p, psd, **kw)
    return j, p


def _same_nodes(j, p):
    assert j._order == p._order
    for n in j._order:
        a, b = j._nodes[n], p._nodes[n]
        assert (a.kind, a.op, a.inputs, a.scope) == (b.kind, b.op, b.inputs, b.scope), n
        assert json.loads(json.dumps(a.attrs)) == json.loads(json.dumps(b.attrs)), n


def test_namespace_binds_positional_scalars_as_the_reference():
    def build(sd, pkg):
        x = sd.place_holder("x", shape=(4, 3))
        ids = sd.place_holder("ids", shape=(4,))
        sd.nn.leaky_relu(x, 0.2, name="lr")
        sd.math.clip_by_value(x, -0.5, 0.5, name="clip")
        sd.math.gather(x, 2, 0, name="g_scalar")         # index 2 is an input
        sd.math.gather(x, [0, 3], 1, name="g_list")      # a list lifts
        sd.math.maximum(x, 0.0, name="mx")               # no attrs: a constant
        sd.math.segment_sum(x, ids, 3, name="seg")
        sd.nn.space_to_depth(sd.place_holder("im", shape=(1, 4, 4, 2)), 2, name="s2d")
        sd.loss.huber_loss(x, x * 2.0, 0.5, name="hub")
        sd.nn.dropout(x, 0.3, name="drop")
        sd.math.gather(x, ids, axis=1, name="g_kw")
    j, p = _both(build)
    _same_nodes(j, p)
    xv = _n(4, 3)
    feed = {"x": xv, "ids": np.array([0, 2, 1, 2], np.float32), "im": _n(1, 4, 4, 2)}
    names = ("lr", "clip", "g_scalar", "g_list", "mx", "seg", "s2d", "hub", "drop")
    jo, po = j.output(feed, *names), p.output(feed, *names)
    for n in names:
        _close(po[n], jo[n], n)


def _cf_graph(sd, pkg, bounded=8):
    """A bounded (or unbounded) while loop that stops at 5, an if_cond
    graph, all reading the trainable ``w`` and ``r``."""
    x = sd.place_holder("x", shape=(3,))
    n = sd.place_holder("n", shape=())
    w = sd.var("w", value=np.array([0.5, -1.0, 2.0], np.float32))
    r = sd.var("r", value=np.float32(1.1))
    i0 = sd.constant("i0", np.float32(0.0))
    fin = sd.while_loop([i0, x * w], lambda s, i, v: s.math.lt(i, n),
                        lambda s, i, v: [i + 1.0, s.math.tanh(v) * r + 0.1],
                        name="loop", max_iterations=bounded)
    br = sd.if_cond(sd.math.gt(fin[1].sum(), 0.0),
                    lambda s: s.math.square(fin[1]) * w,
                    lambda s: fin[1] - w, name="branch")
    (br.sum() + fin[0]).rename("loss")
    sd.set_loss_variables("loss")


@pytest.mark.parametrize("bounded", [8, None], ids=["bounded", "unbounded"])
def test_control_flow_output_matches_reference(bounded):
    j, p = _both(_cf_graph, bounded=bounded)
    _same_nodes(j, p)
    for xv in (np.array([1.0, 2.0, 0.5], np.float32), np.array([-3.0, 0.1, -1], np.float32)):
        for nv in (np.float32(5), np.float32(0), np.float32(20)):
            feed = {"x": xv, "n": nv}
            jo, po = j.output(feed, "branch", "loop_out0", "loss"), p.output(
                feed, "branch", "loop_out0", "loss")
            for k in jo:
                _close(po[k], jo[k], f"{k} x={xv} n={nv}")


def test_bounded_loop_and_if_cond_gradients_match_reference():
    j, p = _both(_cf_graph, bounded=8)
    for xv in (np.array([1.0, 2.0, 0.5], np.float32), np.array([-3.0, 0.1, -1], np.float32)):
        feed = {"x": xv, "n": np.float32(5)}
        jg, pg = j.calculate_gradients(feed), p.calculate_gradients(feed)
        assert set(jg) == set(pg) == {"w", "r"}
        for k in jg:
            _close(pg[k], jg[k], k)
            _close(p.grad(k), jg[k], k)
        _close(p.calculate_gradients(feed, "r")["r"], jg["r"], "wrt r")
        assert set(p.calculate_gradients(feed, "r")) == {"r"}


def test_unbounded_loop_refuses_to_differentiate_as_the_reference():
    j, p = _both(_cf_graph, bounded=None)
    feed = {"x": np.ones(3, np.float32), "n": np.float32(5)}
    with pytest.raises(ValueError, match="Reverse-mode differentiation"):
        j.calculate_gradients(feed)
    with pytest.raises(ValueError, match="Reverse-mode differentiation"):
        p.calculate_gradients(feed)
    p.set_training_config(psd.TrainingConfig(PU.Sgd(0.1), data_set_feature_mapping=["x"],
                                             data_set_label_mapping=["n"]))
    with pytest.raises(ValueError, match="Reverse-mode differentiation"):
        p.fit(DataSet(np.ones(3, np.float32), np.float32(5)))


def test_unbounded_loop_without_trainable_inputs_differentiates():
    """A loop that reads no variable takes no gradient: jax.grad does not
    refuse it, and neither does the port."""
    def build(sd, pkg):
        x = sd.place_holder("x", shape=())
        w = sd.var("w", value=np.float32(3.0))
        fin = sd.while_loop([sd.constant("c0", np.float32(1.0))],
                            lambda s, c: s.math.lt(c, x), lambda s, c: [c * 2.0])
        (fin[0] * w).rename("loss")
        sd.set_loss_variables("loss")
    j, p = _both(build)
    feed = {"x": np.float32(10.0)}
    _close(p.calculate_gradients(feed)["w"], j.calculate_gradients(feed)["w"], "w")


def test_nested_control_flow_and_bodies_raise():
    for pkg in (psd,):  # the reference's own tests hold its errors
        sd = pkg.SameDiff.create(device="cpu")
        x = sd.place_holder("x", shape=())
        c = sd.constant("c", np.float32(1.0))
        with pytest.raises(NotImplementedError):
            sd.if_cond(sd.math.gt(x, 0.0),
                       lambda s: s.if_cond(s.math.gt(c, 0.0), lambda s2: c, lambda s2: c + 1),
                       lambda s: c)
        with pytest.raises(ValueError):
            sd.if_cond(sd.math.gt(x, 0.0), lambda s: s.var("w2", value=np.float32(1.0)),
                       lambda s: c)
        with pytest.raises(ValueError, match="duplicate"):
            sd.constant("c", 2.0)
        with pytest.raises(ValueError, match="unknown op"):
            sd._op("nope", [x])
        with pytest.raises(ValueError, match="different SameDiff"):
            x + pkg.SameDiff.create(device="cpu").place_holder("y")
        with pytest.raises(ValueError, match="no loss"):
            sd.calculate_gradients({"x": 1.0})
        seg = sd.math.segment_sum(x, x)
        with pytest.raises(ValueError, match="num_segments"):
            sd.output({"x": np.ones(2, np.float32)}, seg.name)


def test_infer_shape_matches_reference():
    def build(sd, pkg):
        x = sd.place_holder("x", shape=(None, 8, 8, 3))
        w = sd.var("w", shape=(3, 3, 3, 4), seed=5)
        h = sd.nn.conv2d(x, w, stride=(2, 2), padding="SAME", name="h")
        hp = sd.nn.max_pooling2d(h, name="hp")
        flat = hp.reshape(-1, 16, name="flat")
        sd.math.gather(flat, [0, 2], 1, name="g")
        v, i = sd.top_k(flat, 3, name="tk")
        sd.while_loop([flat], lambda s, f: s.math.lt(f.sum(), 5.0),
                      lambda s, f: [f + 1.0], name="lp")
        sd.while_loop([flat], lambda s, f: s.math.lt(f.sum(), 5.0),
                      lambda s, f: [f + 1.0], name="lpb", max_iterations=3)
        sd.if_cond(sd.math.gt(flat.sum(), 0.0), lambda s: flat * 2.0,
                   lambda s: flat - 1.0, name="br")
        sd.math.segment_max(sd.constant("rows", np.ones((4, 3), np.float32)),
                            sd.constant("ids", np.array([0, 1, 1, 0])), 2, name="sm")
        flat.get(slice(None, None, -1), slice(2, 10, 3), name="neg")
    j, p = _both(build)
    for name in ("x", "w", "h", "hp", "flat", "g", "tk_values", "tk_indices", "lp_out0",
                 "lpb_out0", "br", "sm", "neg"):
        assert p.infer_shape(name) == j.infer_shape(name), name
        assert p.get_variable(name).shape == j.get_variable(name).shape, name


def test_var_init_from_shape_uses_the_reference_scheme():
    sd = psd.SameDiff.create(device="cpu")
    sd.place_holder("x", shape=(None, 3))
    w = sd.var("w", shape=(300, 200), seed=3)
    sd2 = psd.SameDiff.create(device="cpu")
    sd2.place_holder("x", shape=(None, 3))
    w2 = sd2.var("w", shape=(300, 200), seed=3)
    v = sd.variables_map["w"]
    assert torch.equal(v, sd2.variables_map["w"]) and w.shape == w2.shape == (300, 200)
    # xavier: std sqrt(2 / (fan_in + fan_out))
    np.testing.assert_allclose(float(v.std()), np.sqrt(2.0 / 500), rtol=0.03)
    b = sd.var("b", shape=(7,), weight_init="zero")
    assert b.shape == (7,) and float(sd.variables_map["b"].abs().sum()) == 0.0


# ------------------------------------------------------------------ fit
def _mlp(sd, pkg, seed=0):
    """A 2-layer classifier with l1/l2-visible biases."""
    r = np.random.default_rng(seed)
    x = sd.place_holder("input", shape=(None, 5))
    y = sd.place_holder("label", shape=(None, 3))
    w0 = sd.var("w0", value=(r.normal(size=(5, 8)) * 0.5).astype(np.float32))
    b0 = sd.var("b0", value=np.zeros(8, np.float32))
    w1 = sd.var("w1", value=(r.normal(size=(8, 3)) * 0.5).astype(np.float32))
    b1 = sd.var("b1", value=(r.normal(size=(3,)) * 0.1).astype(np.float32))
    h = sd.nn.relu(sd.nn.linear(x, w0, b0))
    logits = sd.nn.linear(h, w1, b1, name="logits")
    sd.nn.softmax(logits, name="probs")
    sd.loss.softmax_cross_entropy(y, logits, name="loss")
    sd.set_loss_variables("loss")


def _batches(n=3, seed=1):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = r.normal(size=(6, 5)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[r.integers(0, 3, 6)]
        out.append((x, y))
    return out


FIT_CASES = [
    ("adam", lambda pkg: pkg.Adam(0.05), 0.0, 0.0, False),
    ("adam_fused", lambda pkg: pkg.Adam(0.05), 0.0, 0.0, True),
    ("adam_l1_l2_fused", lambda pkg: pkg.Adam(0.05), 1e-3, 1e-2, True),
    ("sgd_l1_l2", lambda pkg: pkg.Sgd(0.3), 1e-3, 1e-2, False),
]


@pytest.mark.parametrize("case", FIT_CASES, ids=[c[0] for c in FIT_CASES])
def test_three_fit_steps_then_a_second_fit_match_reference(case):
    _, upd, l1, l2, fused = case
    j, p = _both(_mlp)
    j.set_training_config(jsd.TrainingConfig(upd(JU), l1=l1, l2=l2))
    p.set_training_config(psd.TrainingConfig(upd(PU), l1=l1, l2=l2))
    if fused:
        thelpers.set_helper("updater", ck.FusedUpdaterHelper())
    data = _batches()
    jl = j.fit([JDataSet(x, y) for x, y in data])
    pl = p.fit([DataSet(x, y) for x, y in data])
    assert isinstance(pl, float)
    np.testing.assert_allclose(pl, jl, rtol=TOL, atol=TOL)
    # a second call: the step count restarts at 1, the state carries over
    jl = j.fit(JDataSet(*data[0]), epochs=2)
    pl = p.fit(DataSet(*data[0]), epochs=2)
    np.testing.assert_allclose(pl, jl, rtol=TOL, atol=TOL)
    for k in j.variables_map:
        _close(p.variables_map[k].numpy(), np.asarray(j.variables_map[k]), k)
        for s in j._updater_state[k]:
            _close(p._updater_state[k][s].numpy(), np.asarray(j._updater_state[k][s]),
                   f"{k}/{s}")


def test_fit_through_a_bounded_loop_matches_reference():
    def build(sd, pkg):
        x = sd.place_holder("x", shape=(4,))
        y = sd.place_holder("y", shape=(4,))
        r = sd.var("r", value=np.float32(1.5))
        fin = sd.while_loop([sd.constant("c_i0", np.float32(0.0)), x * 1.0],
                            lambda s, i, v: s.math.lt(i, 4.0),
                            lambda s, i, v: [i + 1.0, v * r], max_iterations=8)
        sd.math.square(fin[1] - y).mean(name="loss")
        sd.set_loss_variables("loss")
    j, p = _both(build)
    j.set_training_config(jsd.TrainingConfig(JU.Adam(0.05), data_set_feature_mapping=["x"],
                                             data_set_label_mapping=["y"]))
    p.set_training_config(psd.TrainingConfig(PU.Adam(0.05), data_set_feature_mapping=["x"],
                                             data_set_label_mapping=["y"]))
    xv, yv = np.ones(4, np.float32), np.full(4, 16.0, np.float32)
    for _ in range(3):
        jl, pl = j.fit(JDataSet(xv, yv)), p.fit(DataSet(xv, yv))
        np.testing.assert_allclose(pl, jl, rtol=TOL)
    _close(p.variables_map["r"].numpy(), np.asarray(j.variables_map["r"]), "r")


def test_fit_without_config_raises():
    sd = psd.SameDiff.create(device="cpu")
    with pytest.raises(ValueError, match="training_config"):
        sd.fit(DataSet(np.ones(2), np.ones(2)))


def test_evaluate_matches_reference():
    from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JIter
    from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
    j, p = _both(_mlp)
    j.set_training_config(jsd.TrainingConfig(JU.Adam(0.05)))
    p.set_training_config(psd.TrainingConfig(PU.Adam(0.05)))
    r = np.random.default_rng(4)
    x = r.normal(size=(20, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, 20)]
    je = j.evaluate(JIter(JDataSet(x, y), 8), "probs")
    pe = p.evaluate(ListDataSetIterator(DataSet(x, y), 8), "probs")
    assert pe.accuracy() == je.accuracy() and pe.f1() == je.f1()
    np.testing.assert_array_equal(pe.confusion, je.confusion)
    assert p.evaluate(DataSet(x, y), "probs").accuracy() == je.accuracy()


# ----------------------------------------------------------------- serde
def test_npz_both_ways_with_control_flow_and_rename(tmp_path):
    j, p = _both(_cf_graph, bounded=8)
    j.rename("w", "weights")
    p.rename("w", "weights")
    j.rename("i0", "start")
    p.rename("i0", "start")
    assert p.to_json() == j.to_json()
    j.save(str(tmp_path / "j"))
    p.save(str(tmp_path / "p.npz"))
    pj = psd.SameDiff.load(str(tmp_path / "j"), device="cpu")   # the reference's file
    jp = jsd.SameDiff.load(str(tmp_path / "p.npz"))            # the port's file
    assert pj.to_json() == jp.to_json() == j.to_json()
    feed = {"x": np.array([1.0, 2.0, 0.5], np.float32), "n": np.float32(5)}
    want = j.output(feed, "branch", "loss")
    for sd in (pj, p):
        got = sd.output(feed, "branch", "loss")
        for k in want:
            _close(got[k], want[k], k)
    got = jp.output(feed, "branch", "loss")
    for k in want:
        _close(got[k], want[k], k)
    assert pj._nodes["loop"].attrs["max_iterations"] == 8
    _close(pj.calculate_gradients(feed)["weights"], j.calculate_gradients(feed)["weights"],
           "weights")


def test_loaded_graph_trains_and_rename_errors(tmp_path):
    sd = psd.SameDiff.create(device="cpu")
    _mlp(sd, psd)
    sd.save(str(tmp_path / "g"))
    sd2 = psd.SameDiff.load(str(tmp_path / "g.npz"), device="cpu")
    sd2.set_training_config(psd.TrainingConfig(PU.Adam(0.05)))
    losses = [sd2.fit(DataSet(*_batches(1)[0])) for _ in range(10)]
    assert losses[-1] < losses[0]
    with pytest.raises(ValueError, match="control-flow"):
        s3 = psd.SameDiff.create(device="cpu")
        _cf_graph(s3, psd)
        s3.rename("loop", "other")
    assert list(sd2.variables_map) == ["w0", "b0", "w1", "b1"]
