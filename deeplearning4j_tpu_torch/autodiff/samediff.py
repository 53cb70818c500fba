"""SameDiff: the declarative graph builder with SDVariable algebra.

Counterpart of ``deeplearning4j_tpu/autodiff/samediff.py`` (ND4J's
``SameDiff``/``SDVariable`` API, the layer below DL4J's SameDiff layer
SPI). Users declare placeholders and variables, compose ops symbolically,
and the engine supplies execution, autodiff and training.

The graph is metadata: a topologically ordered tape of nodes, each naming
an op of :data:`OPS` and its inputs. ``_build_fn`` lowers the tape to one
eager function ``f(variables, placeholders) -> outputs`` over torch
tensors; gradients are ``torch.autograd`` of it, and ``fit`` takes them
with ``nn/train_step.py`` ``gradients`` and applies them through the
updater seam (``apply_updates``), so a registered ``FusedUpdaterHelper``
takes every Adam variable onto the fused kernel.

The ops are the reference's ``jnp`` / ``jax.nn`` functions, with their
layouts (NHWC activations, HWIO weights), their tie gradients (relu's 0
at 0, leaky relu's 1, 0.5 at either bound of ``clip_by_value`` and at a
tie of ``maximum`` / ``minimum``, an even split among tied maxima of the
``max`` / ``min`` reductions and ``segment_max``) and their index rules:
``gather`` wraps -1 and gives NaN past the end, ``gather_nd`` wraps once
and clamps, ``slice`` wraps and clamps its start so that the slice fits,
``one_hot`` gives a zero row for an id out of range, the scatter and
segment families drop one. No op indexes out of range on the device.

Control flow: ``if_cond`` reads its predicate on the host and runs only
the taken branch; ``while_loop(max_iterations=K)`` runs exactly K bodies,
each followed by ``where(active, new, old)`` (the reference's masked
``lax.scan``: masked steps pass values and gradients through);
``while_loop`` without a bound reads its condition on the host once a
trip, and refuses reverse-mode differentiation, as ``lax.while_loop``
does. ``infer_shape`` runs the lowered function on ``meta`` tensors.

Variables, constants and placeholders live on the graph's device (``cuda``
unless ``device="cpu"`` is passed). Floating data arrives as float32 and
integer data as int64 (the reference's jnp takes float64 and int64 down
to 32 bits). ``save`` / ``load`` write and read the reference's npz
(``__graph__`` as uint8 JSON, ``var__*``, ``const__*``), so a file
written by either package loads in the other.
"""

from __future__ import annotations

import json
import math
import numbers
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nn.activations import _max, _min, signed_abs


def _normalize_dims(dims):
    if dims is None or dims == ():
        return None
    if isinstance(dims, int):
        return (dims,)
    return tuple(int(d) for d in dims)


# ---------------------------------------------------------------------------
# Helpers of the op registry
# ---------------------------------------------------------------------------

_DTYPES = {"float32": torch.float32, "float64": torch.float32,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int32": torch.int32, "int64": torch.int32, "int16": torch.int16,
           "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}


def _dtype(d) -> torch.dtype:
    """A dtype named as numpy names it (64-bit types taken to 32 bits, as
    the reference's jnp does) or a torch dtype."""
    if isinstance(d, torch.dtype):
        return d
    return _DTYPES[np.dtype(d).name]


def canonical(value, device) -> torch.Tensor:
    """``value`` (numpy data, a Python scalar or a tensor) as a tensor on
    ``device``: float64 as float32, other integers as int64."""
    t = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
    if t.dtype == torch.float64:
        t = t.float()
    elif t.dtype in (torch.int32, torch.int16, torch.int8, torch.uint8):
        t = t.long()
    return t.to(device)


def _dims(a: torch.Tensor, dims):
    """The reduction dims of ``dims`` (None: every dim)."""
    if dims is None:
        return tuple(range(a.ndim))
    return (dims,) if isinstance(dims, int) else tuple(dims)


def _amax(a, dims=None, keepdims=False):
    # amax/amin split the gradient evenly among tied extrema, as jnp.max
    return torch.amax(a, dim=_dims(a, dims), keepdim=keepdims)


def _amin(a, dims=None, keepdims=False):
    return torch.amin(a, dim=_dims(a, dims), keepdim=keepdims)


def _prod(a, dims=None, keepdims=False):
    # torch.prod reduces one dim at a time: the highest first, so that
    # the lower ones keep their positions
    out = a
    for d in sorted({d % a.ndim for d in _dims(a, dims)}, reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdims)
    return out


def _var(a, dims, keepdims, bias_corrected):
    return torch.var(a, dim=_dims(a, dims), keepdim=keepdims,
                     correction=1 if bias_corrected else 0)


def _arg(fn, a, dims=None):
    if dims is None:
        return fn(a.reshape(-1))
    if isinstance(dims, (tuple, list)):
        (dims,) = dims
    return fn(a, dim=int(dims))


def _clip(a, clip_min=None, clip_max=None):
    """``jnp.clip`` = minimum(maximum(a, lo), hi): half the gradient at a
    bound."""
    if clip_min is not None:
        a = _max(a, clip_min)
    if clip_max is not None:
        a = _min(a, clip_max)
    return a


def _same_pads(size: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """XLA's "SAME" padding of one dim: the odd pad on the high side."""
    k = (k - 1) * d + 1
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pads(padding, spatial, ks, strides):
    """Per-dim ``(lo, hi)`` pads: "SAME", "VALID" or explicit pairs."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return [(0, 0)] * len(spatial)
        if p == "SAME":
            return [_same_pads(n, k, s) for n, k, s in zip(spatial, ks, strides)]
        raise ValueError(f"padding {padding!r}: expected SAME, VALID or pairs")
    return [tuple(int(v) for v in pair) for pair in padding]


def _pad_spatial(x, pads, value=0.0):
    """Pads the trailing spatial dims of an NC... tensor."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


def _conv2d(x, w, stride, padding):
    """x [N,H,W,C], w [kH,kW,Cin,Cout] (NHWC / HWIO)."""
    stride = tuple(int(s) for s in stride)
    pads = _pads(padding, x.shape[1:3], w.shape[:2], stride)
    xc = _pad_spatial(x.permute(0, 3, 1, 2), pads)
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def _pool2d(x, kind, size, stride, padding):
    size, stride = tuple(int(s) for s in size), tuple(int(s) for s in stride)
    pads = _pads(padding, x.shape[1:3], size, stride)
    xc = x.permute(0, 3, 1, 2)
    if kind == "max":
        y = F.max_pool2d(_pad_spatial(xc, pads, -math.inf), size, stride)
        return y.permute(0, 2, 3, 1)
    # the sum of the real elements over their count
    sums = F.avg_pool2d(_pad_spatial(xc, pads), size, stride, divisor_override=1)
    ones = torch.ones((1, 1) + tuple(x.shape[1:3]), dtype=x.dtype, device=x.device)
    counts = F.avg_pool2d(_pad_spatial(ones, pads), size, stride, divisor_override=1)
    return (sums / counts).permute(0, 2, 3, 1)


def _conv1d(x, w, stride=1, padding="SAME"):
    """x [N,T,C], w [k,Cin,Cout] (NWC / WIO)."""
    s = int(stride)
    pads = _pads(padding, x.shape[1:2], w.shape[:1], (s,))
    y = F.conv1d(_pad_spatial(x.permute(0, 2, 1), pads), w.permute(2, 1, 0), stride=s)
    return y.permute(0, 2, 1)


def _depthwise_conv2d(x, w, stride=(1, 1), padding="SAME"):
    """x [N,H,W,C], w [kH,kW,C,mult]: the weight as [kH,kW,1,C·mult] in
    C-major order, one group a channel."""
    c = x.shape[-1]
    stride = tuple(int(s) for s in stride)
    w2 = w.reshape(w.shape[0], w.shape[1], 1, c * w.shape[3])
    pads = _pads(padding, x.shape[1:3], w.shape[:2], stride)
    y = F.conv2d(_pad_spatial(x.permute(0, 3, 1, 2), pads), w2.permute(3, 2, 0, 1),
                 stride=stride, groups=c)
    return y.permute(0, 2, 3, 1)


def _transpose_pads(k: int, s: int, padding: str) -> Tuple[int, int]:
    """``lax.conv_transpose``'s padding of the stride-dilated input."""
    p = padding.upper()
    if p == "SAME":
        pad_len = k + s - 2
        lo = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    elif p == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        lo = k - 1
    else:
        raise ValueError("Padding mode must be `SAME` or `VALID`.")
    return lo, pad_len - lo


def _deconv2d(x, w, stride=(2, 2), padding="SAME"):
    """Transposed convolution, x [N,H,W,Cin], w [kH,kW,Cin,Cout]: the
    input dilated by the stride, padded as ``lax.conv_transpose`` pads
    it, and correlated with the spatially flipped kernel flipped once more
    (the reference hands ``conv_transpose`` ``flip(w)``, which correlates
    it as given)."""
    stride = tuple(int(s) for s in stride)
    n, h, wd, c = x.shape
    xc = x.permute(0, 3, 1, 2)
    sh, sw = stride
    if sh > 1 or sw > 1:
        xd = xc.new_zeros((n, c, (h - 1) * sh + 1, (wd - 1) * sw + 1))
        xd[:, :, ::sh, ::sw] = xc
        xc = xd
    pads = [_transpose_pads(int(w.shape[i]), stride[i], padding) for i in range(2)]
    y = F.conv2d(_pad_spatial(xc, pads), torch.flip(w, (0, 1)).permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def _space_to_depth(x, block_size=2):
    n, h, w, c = x.shape
    b = int(block_size)
    x = x.reshape(n, h // b, b, w // b, b, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // b, w // b, b * b * c)


def _depth_to_space(x, block_size=2):
    n, h, w, c = x.shape
    b = int(block_size)
    x = x.reshape(n, h, w, b, b, c // (b * b))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * b, w * b, c // (b * b))


def _ids(idx) -> torch.Tensor:
    return idx.long() if isinstance(idx, torch.Tensor) else torch.as_tensor(idx).long()


def _wrapped(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Indices with a negative one in [-n, 0) wrapped once."""
    return torch.where(idx < 0, idx + n, idx)


def _fill(dtype):
    if dtype.is_floating_point:
        return math.nan
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min


def _gather(a, idx, axis=0):
    """``jnp.take``: -1 wraps; past either end the row is the fill (NaN)."""
    axis = int(axis) % a.ndim
    n = a.shape[axis]
    i = _wrapped(_ids(idx).to(a.device), n)
    valid = (i >= 0) & (i < n)
    flat = torch.where(valid, i, 0).reshape(-1)
    out = torch.index_select(a, axis, flat)
    shape = tuple(a.shape[:axis]) + tuple(i.shape) + tuple(a.shape[axis + 1:])
    out = out.reshape(shape)
    v = valid.reshape((1,) * axis + tuple(i.shape) + (1,) * (a.ndim - axis - 1))
    return torch.where(v, out, out.new_full((), _fill(a.dtype)))


def _gather_nd(params, indices):
    """``gatherNd``: indices [..., D] index the first D dims, wrapped once
    and then clamped, as jnp indexing does; as there, a row whose index
    was out of range takes no gradient."""
    idx = _ids(indices).to(params.device)
    cols, valid = [], None
    for d in range(idx.shape[-1]):
        n = params.shape[d]
        i = _wrapped(idx[..., d], n)
        ok = (i >= 0) & (i < n)
        valid = ok if valid is None else valid & ok
        cols.append(i.clamp(0, n - 1))
    out = params[tuple(cols)]
    v = valid.reshape(tuple(valid.shape) + (1,) * (out.ndim - valid.ndim))
    return torch.where(v, out, out.detach())


def _one_hot(a, depth=None):
    ids = _ids(a).to(a.device)
    return (ids[..., None] == torch.arange(int(depth), device=a.device)).to(torch.float32)


def _dynamic_slice(a, begin=None, size=None):
    """``lax.dynamic_slice``: each start wrapped once, then clamped so that
    the slice fits."""
    out = a
    for d, (b, s) in enumerate(zip(begin, size)):
        n, b, s = a.shape[d], int(b), int(s)
        b = b + n if b < 0 else b
        b = min(max(b, 0), n - s)
        out = out.narrow(d, b, s)
    return out


def _strided_slice(a, slices=None):
    """Python slicing per dim; a negative step takes the indices it names
    (torch slicing refuses one)."""
    out = a
    for d, s in enumerate(slices):
        sl = slice(*s)
        if sl.step is not None and sl.step < 0:
            idx = torch.arange(*sl.indices(out.shape[d]), device=a.device)
            out = torch.index_select(out, d, idx)
        else:
            out = out[(slice(None),) * d + (sl,)]
    return out


def _scatter_rows(ref, idx, upd):
    """``(ref with one spare row, indices, updates as rows)``: an index out
    of range after wrapping points at the spare row, so it is dropped."""
    n = ref.shape[0]
    i = _wrapped(_ids(idx).to(ref.device), n)
    i = torch.where((i >= 0) & (i < n), i, n).reshape(-1)
    spare = torch.zeros((1,) + tuple(ref.shape[1:]), dtype=ref.dtype, device=ref.device)
    rows = upd.reshape((-1,) + tuple(ref.shape[1:])).to(ref.dtype)
    return torch.cat([ref, spare]), i, rows


def _scatter(kind):
    def op(ref, idx, upd):
        base, i, rows = _scatter_rows(ref, idx, upd)
        if kind == "set":
            out = base.index_put((i,), rows)
        elif kind == "add":
            out = base.index_put((i,), rows, accumulate=True)
        elif kind == "sub":
            out = base.index_put((i,), -rows, accumulate=True)
        else:
            reduce = "prod" if kind == "div" else kind
            if kind == "div":
                rows = 1.0 / rows
            index = i.reshape((-1,) + (1,) * (rows.ndim - 1)).expand(rows.shape)
            out = base.scatter_reduce(0, index, rows, reduce, include_self=True)
        return out[:-1]
    return op


def _nseg(num_segments, op: str) -> int:
    """Segment ops need a static segment count (it is the output shape)."""
    if num_segments is None:
        raise ValueError(
            f"{op} requires num_segments (static output size), e.g. "
            f"sd.math.{op}(data, ids, 5) or num_segments=5")
    return int(num_segments)


def _segment(kind):
    """A segment reduction over dim 0: ids out of range are dropped; an
    empty segment is 0 (sum), 1 (prod), -inf (max) or +inf (min)."""
    init = {"sum": 0.0, "prod": 1.0, "amax": -math.inf, "amin": math.inf}[kind]
    name = {"sum": "segment_sum", "prod": "segment_prod", "amax": "segment_max",
            "amin": "segment_min"}[kind]

    def op(d, ids, num_segments=None):
        n = _nseg(num_segments, name)
        i = _ids(ids).to(d.device)
        i = torch.where((i >= 0) & (i < n), i, n)
        index = i.reshape(i.shape + (1,) * (d.ndim - i.ndim)).expand(d.shape)
        base = torch.full((n + 1,) + tuple(d.shape[i.ndim:]), init, dtype=d.dtype,
                          device=d.device)
        return base.scatter_reduce(0, index, d, kind, include_self=True)[:n]
    return op


def _segment_mean(data, segment_ids, num_segments=None):
    n = _nseg(num_segments, "segment_mean")
    tot = _segment("sum")(data, segment_ids, n)
    ids = _ids(segment_ids).to(data.device)
    cnt = _segment("sum")(torch.ones(ids.shape, dtype=data.dtype, device=data.device),
                          ids, n)
    return tot / torch.clamp(cnt.reshape(cnt.shape + (1,) * (tot.ndim - cnt.ndim)),
                             min=1.0)


def _top_k(a, k=1):
    """The k largest along the last axis, the lower index first among ties
    (a stable descending sort)."""
    values, indices = torch.sort(a, dim=-1, descending=True, stable=True)
    return values[..., :int(k)], indices[..., :int(k)]


def _sort(a, axis=-1, descending=False):
    if descending:
        return -torch.sort(-a, dim=int(axis), stable=True).values
    return torch.sort(a, dim=int(axis), stable=True).values


def _transpose(a, axes=None):
    if not axes:
        axes = tuple(reversed(range(a.ndim)))
    return a.permute(*axes)


def _squeeze(a, axis=None):
    return a.squeeze() if axis is None else a.squeeze(axis)


def _trace(a):
    return torch.diagonal(a, 0, 0, 1).sum(-1)


def _softplus(a):
    return torch.logaddexp(a, torch.zeros((), dtype=a.dtype, device=a.device))


def _leaky_relu(a, alpha=0.01):
    """``jax.nn.leaky_relu``: the gradient at 0 is 1."""
    return torch.where(a >= 0, a, alpha * a)


def _floats(t):
    return t.to(torch.float32)


def _layer_norm(x, gain, bias=None, eps=1e-5):
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mean) / torch.sqrt(var + eps) * gain
    return y + (0.0 if bias is None else bias)


def _loss_cosine(labels, preds, dims=-1):
    num = torch.sum(labels * preds, dim=dims)
    den = (torch.linalg.vector_norm(labels, dim=dims)
           * torch.linalg.vector_norm(preds, dim=dims) + 1e-12)
    return torch.mean(1.0 - num / den)


def _loss_sigmoid_ce(labels, logits):
    return torch.mean(_max(logits, 0.0) - logits * labels
                      + torch.log1p(torch.exp(-signed_abs(logits))))


def _loss_huber(labels, preds, delta=1.0):
    d = preds - labels
    return torch.mean(torch.where(signed_abs(d) <= delta, 0.5 * d ** 2,
                                  delta * signed_abs(d) - 0.5 * delta ** 2))


# ---------------------------------------------------------------------------
# Op registry: name -> fn(*input_tensors, **attrs), the reference's names
# ---------------------------------------------------------------------------

OPS: Dict[str, Callable] = {
    # arithmetic
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "pow": lambda a, b: a ** b,
    "neg": lambda a: -a,
    "rsub": lambda a, b: b - a,
    "rdiv": lambda a, b: b / a,
    "matmul": lambda a, b: a @ b,
    "maximum": torch.maximum,  # a tie gives each side half the gradient
    "minimum": torch.minimum,
    # structure
    "transpose": _transpose,
    "reshape": lambda a, shape=None: torch.reshape(a, tuple(shape)),
    "concat": lambda *xs, axis=0: torch.cat(xs, dim=axis),
    "stack": lambda *xs, axis=0: torch.stack(xs, dim=axis),
    "slice": _dynamic_slice,
    "strided_slice": _strided_slice,
    "gather": _gather,
    "one_hot": _one_hot,
    "cast": lambda a, dtype=None: a.to(_dtype(dtype)),
    "where": lambda c, a, b: torch.where(c if c.dtype == torch.bool else c != 0, a, b),
    "tile": lambda a, reps=None: torch.tile(a, tuple(reps)),
    "expand_dims": lambda a, axis=0: torch.unsqueeze(a, axis),
    "squeeze": _squeeze,
    # reductions
    "sum": lambda a, dims=None, keepdims=False: torch.sum(a, dim=_dims(a, dims),
                                                          keepdim=keepdims),
    "mean": lambda a, dims=None, keepdims=False: torch.mean(a, dim=_dims(a, dims),
                                                            keepdim=keepdims),
    "max": _amax,
    "min": _amin,
    "prod": _prod,
    "std": lambda a, dims=None, keepdims=False, bias_corrected=True:
        torch.sqrt(_var(a, dims, keepdims, bias_corrected)),
    "variance": lambda a, dims=None, keepdims=False, bias_corrected=True:
        _var(a, dims, keepdims, bias_corrected),
    "argmax": lambda a, dims=None: _arg(torch.argmax, a, dims),
    "argmin": lambda a, dims=None: _arg(torch.argmin, a, dims),
    "norm2": lambda a, dims=None, keepdims=False:
        torch.sqrt(torch.sum(a * a, dim=_dims(a, dims), keepdim=keepdims)),
    "norm1": lambda a, dims=None, keepdims=False:
        torch.sum(signed_abs(a), dim=_dims(a, dims), keepdim=keepdims),
    # elementwise math
    "abs": signed_abs, "exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt,
    "square": torch.square, "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "floor": torch.floor, "ceil": torch.ceil, "round": torch.round,
    "sign": torch.sign, "erf": torch.erf,
    "clip_by_value": _clip,
    "reciprocal": lambda a: 1.0 / a,
    "log1p": torch.log1p, "expm1": torch.expm1,
    "cumsum": lambda a, axis=0: torch.cumsum(a, dim=axis),
    "cumprod": lambda a, axis=0: torch.cumprod(a, dim=axis),
    "sort": _sort,
    "logsumexp": lambda a, axis=None, keepdims=False:
        torch.logsumexp(a, dim=_dims(a, axis), keepdim=keepdims),
    "l2_normalize": lambda a, axis=-1, eps=1e-12: a / torch.sqrt(
        torch.clamp_min(torch.sum(torch.square(a), dim=axis, keepdim=True), eps)),
    "mod": lambda a, b: torch.remainder(a, b),
    "floor_div": lambda a, b: torch.floor_divide(a, b),
    "atan": torch.atan,
    "asin": torch.asin,
    "acos": torch.acos,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "asinh": torch.asinh,
    "acosh": torch.acosh,
    "atanh": torch.atanh,
    "atan2": lambda a, b: torch.atan2(a, b),
    "isnan": lambda a: _floats(torch.isnan(a)),
    "isinf": lambda a: _floats(torch.isinf(a)),
    "top_k": _top_k,
    "diag": torch.diag,
    "trace": _trace,
    # comparisons (float outputs, ND4J-style)
    "gt": lambda a, b: _floats(a > b),
    "gte": lambda a, b: _floats(a >= b),
    "lt": lambda a, b: _floats(a < b),
    "lte": lambda a, b: _floats(a <= b),
    "eq": lambda a, b: _floats(a == b),
    "neq": lambda a, b: _floats(a != b),
    # activations / nn
    "tanh": torch.tanh, "sigmoid": torch.sigmoid, "relu": torch.relu,
    "relu6": F.relu6, "elu": F.elu, "selu": F.selu,
    "gelu": lambda a: F.gelu(a, approximate="tanh"), "softplus": _softplus,
    "softsign": F.softsign, "swish": F.silu,
    "hard_sigmoid": lambda a: F.relu6(a + 3.0) / 6.0,
    "leaky_relu": _leaky_relu,
    "softmax": lambda a, dims=-1: torch.softmax(a, dim=dims),
    "log_softmax": lambda a, dims=-1: torch.log_softmax(a, dim=dims),
    "linear": lambda x, w, b=None: (x @ w + b) if b is not None else x @ w,
    "layer_norm": _layer_norm,
    "dropout": lambda a, p=0.5: a,  # inference semantics, as the reference
    "conv2d": _conv2d,
    "max_pooling2d": lambda x, size=(2, 2), stride=(2, 2), padding="VALID":
        _pool2d(x, "max", size, stride, padding),
    "avg_pooling2d": lambda x, size=(2, 2), stride=(2, 2), padding="VALID":
        _pool2d(x, "avg", size, stride, padding),
    "batch_mmul": torch.matmul,
    # losses (mean-reduced scalars)
    "loss_mse": lambda labels, preds: torch.mean((preds - labels) ** 2),
    "loss_mae": lambda labels, preds: torch.mean(signed_abs(preds - labels)),
    "loss_softmax_ce": lambda labels, logits:
        torch.mean(-torch.sum(labels * torch.log_softmax(logits, dim=-1), dim=-1)),
    "loss_sigmoid_ce": _loss_sigmoid_ce,
    "loss_log": lambda labels, preds, eps=1e-7: torch.mean(
        -(labels * torch.log(preds + eps) + (1 - labels) * torch.log(1 - preds + eps))),
    "loss_huber": _loss_huber,
    "loss_cosine": _loss_cosine,
    "loss_hinge": lambda labels, preds: torch.mean(
        _max(1.0 - (2.0 * labels - 1.0) * preds, 0.0)),
    # the scatter family: indices address dim 0 of ref; updates shape =
    # indices.shape + ref.shape[1:]; duplicates accumulate in the
    # arithmetic ops; an index out of range is dropped
    "scatter_update": _scatter("set"),
    "scatter_add": _scatter("add"),
    "scatter_sub": _scatter("sub"),
    "scatter_mul": _scatter("prod"),
    "scatter_div": _scatter("div"),
    "scatter_max": _scatter("amax"),
    "scatter_min": _scatter("amin"),
    "gather_nd": _gather_nd,
    # segment reductions ((unsorted)segment*: one op serves both)
    "segment_sum": _segment("sum"),
    "segment_mean": _segment_mean,
    "segment_max": _segment("amax"),
    "segment_min": _segment("amin"),
    "segment_prod": _segment("prod"),
    "conv1d": _conv1d,
    "depthwise_conv2d": _depthwise_conv2d,
    "deconv2d": _deconv2d,
    "space_to_depth": _space_to_depth,
    "depth_to_space": _depth_to_space,
    # control-flow plumbing: a while_loop node's value is the carried tuple;
    # tuple_get projects one element out at the top level
    "tuple_get": lambda t, index=0: t[index],
}


class SDVariable:
    """A symbolic node: placeholder, trainable variable, constant, or op
    result (ND4J ``SDVariable``). Every operation records a new node on
    the owning ``SameDiff`` tape."""

    def __init__(self, sd: "SameDiff", name: str, kind: str,
                 op: Optional[str] = None, inputs: Sequence[str] = (),
                 attrs: Optional[dict] = None,
                 shape: Optional[Tuple] = None,
                 scope: Optional[str] = None):
        self.sd = sd
        self.name = name
        self.kind = kind  # "placeholder" | "variable" | "constant" | "op"
        self.op = op
        self.inputs = tuple(inputs)
        self.attrs = attrs or {}
        self._declared_shape = shape
        # non-None: the node belongs to a control-flow branch or loop body
        # and runs only inside its owning if_cond / while_loop node
        self.scope = scope

    # -- algebra ------------------------------------------------------------
    def _bin(self, other, op, name=None):
        other = self.sd._as_var(other)
        return self.sd._op(op, [self, other], name=name)

    def __add__(self, o):
        return self._bin(o, "add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._bin(o, "sub")

    def __rsub__(self, o):
        return self._bin(o, "rsub")

    def __mul__(self, o):
        return self._bin(o, "mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._bin(o, "div")

    def __rtruediv__(self, o):
        return self._bin(o, "rdiv")

    def __pow__(self, o):
        return self._bin(o, "pow")

    def __matmul__(self, o):
        return self._bin(o, "matmul")

    def __neg__(self):
        return self.sd._op("neg", [self])

    # named algebra (ND4J method spellings)
    def add(self, o, name=None):
        return self._bin(o, "add", name)

    def sub(self, o, name=None):
        return self._bin(o, "sub", name)

    def mul(self, o, name=None):
        return self._bin(o, "mul", name)

    def div(self, o, name=None):
        return self._bin(o, "div", name)

    def mmul(self, o, name=None):
        return self._bin(o, "matmul", name)

    def rsub(self, o, name=None):
        return self._bin(o, "rsub", name)

    def rdiv(self, o, name=None):
        return self._bin(o, "rdiv", name)

    # reductions
    def _reduce(self, op, dims, keepdims, name=None):
        return self.sd._op(op, [self], name=name,
                           attrs={"dims": _normalize_dims(dims),
                                  "keepdims": keepdims})

    def sum(self, dims=None, keepdims=False, name=None):
        return self._reduce("sum", dims, keepdims, name)

    def mean(self, dims=None, keepdims=False, name=None):
        return self._reduce("mean", dims, keepdims, name)

    def max(self, dims=None, keepdims=False, name=None):
        return self._reduce("max", dims, keepdims, name)

    def min(self, dims=None, keepdims=False, name=None):
        return self._reduce("min", dims, keepdims, name)

    def prod(self, dims=None, keepdims=False, name=None):
        return self._reduce("prod", dims, keepdims, name)

    def std(self, dims=None, bias_corrected=True, keepdims=False, name=None):
        return self.sd._op("std", [self], name=name,
                           attrs={"dims": _normalize_dims(dims),
                                  "keepdims": keepdims,
                                  "bias_corrected": bias_corrected})

    def norm2(self, dims=None, keepdims=False, name=None):
        return self._reduce("norm2", dims, keepdims, name)

    def norm1(self, dims=None, keepdims=False, name=None):
        return self._reduce("norm1", dims, keepdims, name)

    def argmax(self, dims=None, name=None):
        return self.sd._op("argmax", [self], name=name, attrs={"dims": dims})

    # structure
    def T(self, *axes, name=None):
        return self.sd._op("transpose", [self], name=name,
                           attrs={"axes": axes or None})

    transpose = T

    def reshape(self, *shape, name=None):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return self.sd._op("reshape", [self], name=name, attrs={"shape": shape})

    def get(self, *slices, name=None):
        if len(slices) == 1 and isinstance(slices[0], tuple):
            slices = slices[0]  # x[0:1, 2:5] arrives as one tuple
        spec = [[s.start, s.stop, s.step if s.step else 1]
                if isinstance(s, slice) else [s, s + 1, 1] for s in slices]
        return self.sd._op("strided_slice", [self], name=name,
                           attrs={"slices": spec})

    __getitem__ = get

    # -- execution ----------------------------------------------------------
    @property
    def shape(self):
        """The inferred shape (``meta`` tensors, no compute). ``None`` dims
        of placeholder shapes count as 1."""
        return self.sd.infer_shape(self.name)

    def eval(self, placeholders: Optional[Dict[str, np.ndarray]] = None):
        return self.sd.output(placeholders or {}, self.name)[self.name]

    def gradient(self):
        return self.sd.grad(self.name)

    def rename(self, name: str) -> "SDVariable":
        return self.sd.rename(self.name, name)

    def __repr__(self):
        return f"SDVariable(name={self.name!r}, kind={self.kind!r}, op={self.op!r})"


class _Namespace:
    """Op namespace (``sd.math``, ``sd.nn``, ``sd.loss``) exposing registry
    ops as methods, as ND4J's ``sd.math()`` / ``sd.nn()`` / ``sd.loss()``."""

    def __init__(self, sd: "SameDiff", ops: Dict[str, str], attr_names: Dict[str, tuple]):
        self._sd = sd
        self._ops = ops
        self._attr_names = attr_names

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        op = self._ops.get(item)
        if op is None:
            raise AttributeError(f"unknown op {item!r}; available: {sorted(self._ops)}")

        def call(*args, name=None, **kwargs):
            # SDVariable args are graph inputs. A plain scalar positional
            # arg fills the op's declared positional attrs (e.g.
            # nn.leaky_relu(x, 0.2)), but only once the op's required
            # tensor inputs are there (_MIN_INPUTS), so a scalar gather
            # index (gather(x, 2, 0)) binds as the indices input, not the
            # axis. Arrays and lists always lift to constant inputs, as do
            # scalars of ops without declared attrs (math.maximum(x, 0.0)).
            # An attr given as a kwarg is never overwritten.
            pos_attrs = [a for a in self._attr_names.get(item, ()) if a not in kwargs]
            need = _MIN_INPUTS.get(item, 1)
            inputs, attrs, attr_i = [], dict(kwargs), 0
            for a in args:
                if isinstance(a, SDVariable):
                    inputs.append(a)
                elif (attr_i < len(pos_attrs) and len(inputs) >= need
                      and isinstance(a, (numbers.Number, str))):
                    attrs[pos_attrs[attr_i]] = a
                    attr_i += 1
                else:
                    inputs.append(self._sd._as_var(a))
            return self._sd._op(op, inputs, name=name, attrs=attrs)

        return call


# ops whose leading positional args are tensor inputs even when spelled as
# plain scalars or lists (a scalar after them still fills positional attrs)
_MIN_INPUTS = {
    "gather": 2, "gather_nd": 2,
    "segment_sum": 2, "segment_mean": 2, "segment_max": 2,
    "segment_min": 2, "segment_prod": 2,
    "scatter_update": 3, "scatter_add": 3, "scatter_sub": 3,
    "scatter_mul": 3, "scatter_div": 3, "scatter_max": 3, "scatter_min": 3,
}

_MATH_OPS = {n: n for n in (
    "abs exp log sqrt square sin cos tan floor ceil round sign erf "
    "reciprocal log1p expm1 neg maximum minimum pow clip_by_value "
    "sum mean max min prod std variance argmax argmin norm2 norm1 "
    "gt gte lt lte eq neq where cast tanh "
    "cumsum cumprod sort logsumexp l2_normalize mod floor_div "
    "atan asin acos sinh cosh asinh acosh atanh atan2 isnan isinf "
    "diag trace "
    "gather gather_nd scatter_update scatter_add scatter_sub scatter_mul "
    "scatter_div scatter_max scatter_min "
    "segment_sum segment_mean segment_max segment_min segment_prod").split()}
_NN_OPS = {n: n for n in (
    "relu relu6 elu selu gelu softplus softsign swish hard_sigmoid "
    "leaky_relu softmax log_softmax sigmoid tanh linear layer_norm dropout "
    "conv2d max_pooling2d avg_pooling2d batch_mmul "
    "conv1d depthwise_conv2d deconv2d space_to_depth depth_to_space").split()}
_LOSS_OPS = {
    "mean_squared_error": "loss_mse",
    "mse": "loss_mse",
    "absolute_difference": "loss_mae",
    "softmax_cross_entropy": "loss_softmax_ce",
    "sigmoid_cross_entropy": "loss_sigmoid_ce",
    "log_loss": "loss_log",
    "huber_loss": "loss_huber",
    "cosine_distance": "loss_cosine",
    "hinge_loss": "loss_hinge",
}
# positional attr spellings for namespace calls like nn.leaky_relu(x, 0.2)
_ATTRS = {
    "leaky_relu": ("alpha",),
    "clip_by_value": ("clip_min", "clip_max"),
    "dropout": ("p",),
    "huber_loss": ("delta",),
    "gather": ("axis",),
    "segment_sum": ("num_segments",),
    "segment_mean": ("num_segments",),
    "segment_max": ("num_segments",),
    "segment_min": ("num_segments",),
    "segment_prod": ("num_segments",),
    "space_to_depth": ("block_size",),
    "depth_to_space": ("block_size",),
}

_CONTROL = ("if_cond", "while_loop")


class TrainingConfig:
    """Training configuration (ND4J ``TrainingConfig``): updater,
    regularization, and which DataSet slots feed which placeholders."""

    def __init__(self, updater=None, l1: float = 0.0, l2: float = 0.0,
                 data_set_feature_mapping: Sequence[str] = ("input",),
                 data_set_label_mapping: Sequence[str] = ("label",)):
        from deeplearning4j_tpu_torch.nn.updaters import Sgd
        self.updater = updater if updater is not None else Sgd(1e-2)
        self.l1 = float(l1)
        self.l2 = float(l2)
        self.feature_mapping = list(data_set_feature_mapping)
        self.label_mapping = list(data_set_label_mapping)


class SameDiff:
    """The graph container (ND4J ``SameDiff``). Nodes are appended in
    creation order, which is a topological order (an op can only name
    existing nodes), so lowering is one pass. ``device=None`` places the
    graph's tensors on ``cuda`` and raises when there is none."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._nodes: Dict[str, SDVariable] = {}
        self._order: List[str] = []
        self.variables_map: Dict[str, torch.Tensor] = {}   # trainable values
        self.constants_map: Dict[str, torch.Tensor] = {}
        self._loss_variables: List[str] = []
        self._training_config: Optional[TrainingConfig] = None
        self._updater_state = None
        self._grads: Dict[str, np.ndarray] = {}
        self._counter = 0
        self._active_scope: Optional[str] = None
        self.math = _Namespace(self, _MATH_OPS, _ATTRS)
        self.nn = _Namespace(self, _NN_OPS, _ATTRS)
        self.loss = _Namespace(self, _LOSS_OPS, _ATTRS)

    # -- construction -------------------------------------------------------
    @staticmethod
    def create(device=None) -> "SameDiff":
        return SameDiff(device)

    def _fresh_name(self, base: str) -> str:
        while True:
            self._counter += 1
            name = f"{base}_{self._counter}"
            if name not in self._nodes:
                return name

    def _register(self, v: SDVariable) -> SDVariable:
        if v.name in self._nodes:
            raise ValueError(f"duplicate variable name {v.name!r}")
        if v.scope is None:
            v.scope = self._active_scope
        self._nodes[v.name] = v
        self._order.append(v.name)
        return v

    def place_holder(self, name: str, shape: Optional[Sequence] = None,
                     dtype=None) -> SDVariable:
        if self._active_scope is not None:
            raise ValueError("create placeholders outside control-flow bodies")
        return self._register(SDVariable(
            self, name, "placeholder",
            shape=None if shape is None else tuple(shape)))

    placeHolder = place_holder  # ND4J spelling

    def var(self, name: str, value=None, shape: Optional[Sequence] = None,
            weight_init: str = "xavier", seed: int = 0,
            dtype=torch.float32) -> SDVariable:
        """A trainable variable from an initial value, or from a shape and
        a weight init drawn from a generator seeded ``seed`` plus the
        number of nodes so far (the reference's key; not its draws)."""
        if self._active_scope is not None:
            raise ValueError("create variables outside control-flow bodies "
                             "(close over them instead)")
        dtype = _dtype(dtype)
        if value is None:
            if shape is None:
                raise ValueError("var() needs an initial value or a shape")
            from deeplearning4j_tpu_torch.nn.weights import init_weight
            shape = tuple(int(s) for s in shape)
            fan_in = shape[0] if shape else 1
            fan_out = shape[-1] if len(shape) >= 2 else (shape[0] if shape else 1)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed + len(self._order))
            value = init_weight(gen, shape, weight_init, fan_in, fan_out,
                                dtype=dtype, device=self.device)
        value = canonical(value, self.device).to(dtype).detach()
        self.variables_map[name] = value
        return self._register(SDVariable(self, name, "variable",
                                         shape=tuple(value.shape)))

    def constant(self, name: str, value) -> SDVariable:
        value = canonical(value, self.device)
        self.constants_map[name] = value
        return self._register(SDVariable(self, name, "constant",
                                         shape=tuple(value.shape)))

    def _as_var(self, v) -> SDVariable:
        if isinstance(v, SDVariable):
            if v.sd is not self:
                raise ValueError("SDVariable belongs to a different SameDiff")
            return v
        return self.constant(self._fresh_name("const"), v)

    def _op(self, op: str, inputs: Sequence[SDVariable], name: Optional[str] = None,
            attrs: Optional[dict] = None) -> SDVariable:
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}")
        name = name or self._fresh_name(op)
        return self._register(SDVariable(
            self, name, "op", op=op,
            inputs=[self._as_var(i).name for i in inputs],
            attrs={k: v for k, v in (attrs or {}).items() if v is not None}))

    # -- control flow -------------------------------------------------------
    def _scoped_build(self, scope_id: str, build: Callable) -> Tuple:
        """Run a body builder with ``scope_id`` active; returns (result,
        names of the nodes it created)."""
        if self._active_scope is not None:
            raise NotImplementedError(
                "nested control flow (if/while inside a branch/body) is not "
                "supported")
        start = len(self._order)
        self._active_scope = scope_id
        try:
            result = build()
        finally:
            self._active_scope = None
        return result, self._order[start:]

    def _outer_deps(self, scope_names: Sequence[str],
                    outs: Sequence[str] = ()) -> List[str]:
        """Top-level nodes a scope reads (closure captures), in tape order;
        a result that is an outer node (``lambda s: c``) is one too."""
        scope_set = set(scope_names)
        deps = {o for o in outs if o not in scope_set}
        for m in scope_names:
            for i in self._nodes[m].inputs:
                if i not in scope_set:
                    deps.add(i)
        return [n for n in self._order if n in deps]

    def if_cond(self, cond: SDVariable, true_fn: Callable,
                false_fn: Callable, name: Optional[str] = None) -> SDVariable:
        """Conditional execution (ND4J ``sd.ifCond``): ``true_fn(sd)`` and
        ``false_fn(sd)`` each build a subgraph (closing over outer nodes is
        fine) and return one SDVariable of the same shape; the predicate is
        read on the host and only the taken branch runs, differentiably."""
        name = name or self._fresh_name("if")
        t_out, t_scope = self._scoped_build(name, lambda: true_fn(self))
        f_out, f_scope = self._scoped_build(name, lambda: false_fn(self))
        outer = self._outer_deps(list(t_scope) + list(f_scope),
                                 outs=(t_out.name, f_out.name))
        return self._register(SDVariable(
            self, name, "op", op="if_cond",
            inputs=[cond.name] + outer,
            attrs={"true_scope": list(t_scope), "false_scope": list(f_scope),
                   "true_out": t_out.name, "false_out": f_out.name,
                   "n_outer": len(outer)}))

    ifCond = if_cond  # ND4J spelling

    def top_k(self, x, k: int, name: Optional[str] = None):
        """(values, indices) of the k largest along the last axis (ND4J
        ``sd.nn.topK``), the lower index first among ties."""
        name = name or self._fresh_name("topk")
        node = self._register(SDVariable(
            self, name, "op", op="top_k", inputs=[self._as_var(x).name],
            attrs={"k": int(k)}))
        values = self._op("tuple_get", [node], name=f"{name}_values",
                          attrs={"index": 0})
        indices = self._op("tuple_get", [node], name=f"{name}_indices",
                           attrs={"index": 1})
        return values, indices

    topK = top_k  # ND4J spelling

    def while_loop(self, loop_vars: Sequence[SDVariable],
                   cond_fn: Callable, body_fn: Callable,
                   name: Optional[str] = None,
                   max_iterations: Optional[int] = None) -> List[SDVariable]:
        """Carried loop (ND4J ``sd.whileLoop``): ``cond_fn(sd, *vars) ->
        scalar`` and ``body_fn(sd, *vars) -> [vars']`` build subgraphs over
        symbolic loop variables (closing over outer nodes is fine); shapes
        are loop-invariant. Returns the final loop variables.

        - ``max_iterations=None``: the condition is read on the host once a
          trip; forward only (gradients through it raise).
        - ``max_iterations=K``: exactly K bodies, each step kept only while
          the condition has held so far (``where(active, new, old)``); the
          same results whenever the true trip count is <= K, and
          differentiable: masked steps pass values and gradients through."""
        name = name or self._fresh_name("while")
        init = [self._as_var(v) for v in loop_vars]

        def build():
            syms = [SDVariable(self, f"{name}_lv{i}", "op", op="loop_input",
                               attrs={"index": i}, scope=name)
                    for i in range(len(init))]
            for s in syms:
                self._register(s)
            c_out = cond_fn(self, *syms)
            b_outs = body_fn(self, *syms)
            if not isinstance(b_outs, (list, tuple)):
                b_outs = [b_outs]
            if len(b_outs) != len(init):
                raise ValueError(
                    f"while_loop body returned {len(b_outs)} values for "
                    f"{len(init)} loop variables")
            return c_out, list(b_outs)

        (c_out, b_outs), scope = self._scoped_build(name, build)
        outer = self._outer_deps(scope, outs=[c_out.name] + [b.name for b in b_outs])
        attrs = {"scope": list(scope), "cond_out": c_out.name,
                 "body_outs": [b.name for b in b_outs],
                 "n_loop_vars": len(init)}
        if max_iterations is not None:
            attrs["max_iterations"] = int(max_iterations)
        self._register(SDVariable(
            self, name, "op", op="while_loop",
            inputs=[v.name for v in init] + outer, attrs=attrs))
        return [self._op("tuple_get", [self._nodes[name]],
                         name=f"{name}_out{i}", attrs={"index": i})
                for i in range(len(init))]

    whileLoop = while_loop  # ND4J spelling

    def rename(self, old: str, new: str) -> SDVariable:
        node = self._nodes[old]
        if node.scope is not None or node.op in _CONTROL:
            # control-flow attrs reference subgraph nodes by name
            raise ValueError("cannot rename control-flow nodes")
        v = self._nodes.pop(old)
        v.name = new
        self._nodes[new] = v
        self._order[self._order.index(old)] = new
        for n in self._nodes.values():
            if old in n.inputs:
                n.inputs = tuple(new if i == old else i for i in n.inputs)
            if n.op in _CONTROL:
                # control-flow attrs carry node names (a branch result may
                # be a passthrough reference to a top-level node)
                for k, val in n.attrs.items():
                    if val == old:
                        n.attrs[k] = new
                    elif isinstance(val, (list, tuple)) and old in val:
                        n.attrs[k] = [new if m == old else m for m in val]
        if old in self.variables_map:
            self.variables_map[new] = self.variables_map.pop(old)
        if old in self.constants_map:
            self.constants_map[new] = self.constants_map.pop(old)
        self._loss_variables = [new if x == old else x for x in self._loss_variables]
        return v

    def get_variable(self, name: str) -> SDVariable:
        return self._nodes[name]

    # -- lowering -----------------------------------------------------------
    def _needed(self, outputs: Sequence[str], within=None) -> List[str]:
        """The nodes ``outputs`` read, in tape order: top-level ones, or
        with ``within`` (a scope's node names) that scope's."""
        needed, stack = set(), list(outputs)
        while stack:
            n = stack.pop()
            if n in needed:
                continue
            needed.add(n)
            stack.extend(self._nodes[n].inputs)
        if within is None:
            return [n for n in self._order
                    if n in needed and self._nodes[n].scope is None]
        return [n for n in within if n in needed]

    def _build_fn(self, output_names: Sequence[str]):
        """Lower the tape to one eager function ``f(variables, placeholders,
        constants=None) -> [outputs]``."""
        order = self._needed(output_names)
        nodes = self._nodes

        def run_scope(scope_names, outs, env, carry=None):
            """The values of ``outs`` computed inside a control-flow scope:
            ``env`` holds the captured outer values, ``carry`` the loop
            variables (while_loop only)."""
            env2 = dict(env)
            for m in self._needed(outs, scope_names):
                nd = nodes[m]
                if nd.kind == "constant":
                    env2[m] = consts[m]
                elif nd.op == "loop_input":
                    env2[m] = carry[nd.attrs["index"]]
                else:
                    env2[m] = OPS[nd.op](*(env2[i] for i in nd.inputs), **nd.attrs)
            return [env2[o] for o in outs]

        def fn(variables, placeholders, constants=None):
            nonlocal consts
            consts = self.constants_map if constants is None else constants
            env = {}
            for n in order:
                node = nodes[n]
                if node.kind == "placeholder":
                    env[n] = placeholders[n]
                elif node.kind == "variable":
                    env[n] = variables[n]
                elif node.kind == "constant":
                    env[n] = consts[n]
                elif node.op == "if_cond":
                    a = node.attrs
                    pred = env[node.inputs[0]]
                    # the predicate is read on the host; a meta tensor has
                    # no value, and both branches have one shape
                    taken = pred.is_meta or bool(pred.reshape(()) != 0)
                    scope, out = ((a["true_scope"], a["true_out"]) if taken
                                  else (a["false_scope"], a["false_out"]))
                    outer = {d: env[d] for d in node.inputs[1:]}
                    env[n] = run_scope(scope, [out], outer)[0]
                elif node.op == "while_loop":
                    env[n] = self._run_loop(node, env, run_scope)
                else:
                    env[n] = OPS[node.op](*(env[i] for i in node.inputs), **node.attrs)
            return [env[n] for n in output_names]

        consts = self.constants_map
        return fn

    @staticmethod
    def _run_loop(node, env, run_scope):
        a = node.attrs
        nlv = a["n_loop_vars"]
        carry = tuple(env[i] for i in node.inputs[:nlv])
        outer = {d: env[d] for d in node.inputs[nlv:]}
        if any(t.is_meta for t in carry):
            return carry  # shapes are loop-invariant
        body = [a["cond_out"]] + list(a["body_outs"])
        max_it = a.get("max_iterations")
        if max_it:
            # K bodies; a step after the condition first fails keeps the
            # old values (and passes their gradients through)
            active = torch.ones((), dtype=torch.bool, device=carry[0].device)
            for _ in range(int(max_it)):
                cond, *new = run_scope(a["scope"], body, outer, carry)
                active = torch.logical_and(active, cond.reshape(()) != 0)
                carry = tuple(torch.where(active, nv, v) for nv, v in zip(new, carry))
            return carry
        if torch.is_grad_enabled() and any(
                isinstance(t, torch.Tensor) and t.requires_grad
                for t in list(carry) + list(outer.values())):
            raise ValueError(
                "Reverse-mode differentiation does not work for a while_loop "
                "without max_iterations (a trip count decided at run time); "
                "pass max_iterations to differentiate through it")
        while True:
            (cond,) = run_scope(a["scope"], [a["cond_out"]], outer, carry)
            if not bool(cond.reshape(()) != 0):  # one host read a trip
                return carry
            carry = tuple(run_scope(a["scope"], list(a["body_outs"]), outer, carry))

    # -- execution ----------------------------------------------------------
    def _placeholders(self, placeholders) -> Dict[str, torch.Tensor]:
        return {k: canonical(v, self.device) for k, v in placeholders.items()}

    def output(self, placeholders: Dict[str, np.ndarray],
               *output_names: str) -> Dict[str, np.ndarray]:
        """Execute the graph (ND4J ``sd.output(map, names)``); numpy
        values."""
        from deeplearning4j_tpu_torch.nn.train_step import to_host
        if not output_names:
            raise ValueError("no output names given")
        fn = self._build_fn(output_names)
        with torch.no_grad():
            outs = fn(self.variables_map, self._placeholders(placeholders))
        return {n: to_host(o) for n, o in zip(output_names, outs)}

    exec = output

    def infer_shape(self, name: str):
        node = self._nodes[name]
        if node._declared_shape is not None and node.kind != "op":
            return node._declared_shape
        fn = self._build_fn([name])
        meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in self.variables_map.items()}
        consts = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                  for k, v in self.constants_map.items()}
        ph = {}
        for n in self._nodes.values():
            if n.kind == "placeholder":
                s = n._declared_shape or (1,)
                ph[n.name] = torch.empty(tuple(1 if d is None else d for d in s),
                                         device="meta")
        with torch.no_grad():
            out = fn(meta, ph, consts)
        return tuple(out[0].shape)

    # -- autodiff -----------------------------------------------------------
    def set_loss_variables(self, *names) -> None:
        self._loss_variables = [n if isinstance(n, str) else n.name for n in names]

    def _loss_fn(self):
        if not self._loss_variables:
            raise ValueError("no loss variables set (set_loss_variables)")
        inner = self._build_fn(self._loss_variables)

        def loss(variables, placeholders):
            return sum(torch.sum(o) for o in inner(variables, placeholders))

        return loss

    def calculate_gradients(self, placeholders: Dict[str, np.ndarray],
                            *wrt) -> Dict[str, np.ndarray]:
        """d(sum of loss variables)/d(wrt) (ND4J ``calculateGradients``);
        every variable when ``wrt`` is empty."""
        from deeplearning4j_tpu_torch.nn.train_step import gradients, to_host
        wrt = [w if isinstance(w, str) else w.name for w in wrt] or list(self.variables_map)
        loss_fn = self._loss_fn()
        ph = self._placeholders(placeholders)
        _, grads, _ = gradients(lambda live: (loss_fn(live[""], ph), None),
                                {"": self.variables_map})
        self._grads = {k: to_host(v) for k, v in grads[""].items() if k in wrt}
        return dict(self._grads)

    def grad(self, name: str) -> np.ndarray:
        if name not in self._grads:
            raise ValueError(f"no gradient for {name!r}; run calculate_gradients first")
        return self._grads[name]

    # -- training -----------------------------------------------------------
    def set_training_config(self, cfg: TrainingConfig) -> None:
        self._training_config = cfg
        self._updater_state = None

    def _step_loss(self, cfg: TrainingConfig):
        """The loss a ``fit`` step minimizes: the summed loss variables plus
        ``l2·Σv²`` and ``l1·Σ|v|`` over every variable, biases included."""
        from deeplearning4j_tpu_torch.nn.activations import signed_abs
        loss_fn = self._loss_fn()

        def step_loss(variables, ph):
            loss = loss_fn(variables, ph)
            if cfg.l2:
                loss = loss + cfg.l2 * sum(torch.sum(v * v) for v in variables.values())
            if cfg.l1:
                loss = loss + cfg.l1 * sum(torch.sum(signed_abs(v))
                                           for v in variables.values())
            return loss

        return step_loss

    def _fit_step(self, step_loss, ph, it: int, epoch: int) -> torch.Tensor:
        """One update of every variable: the gradients of ``step_loss``,
        then the updater seam at the learning rate of ``(it, epoch)`` and
        the 1-based step ``it + 1``. Returns the loss, a device scalar."""
        from deeplearning4j_tpu_torch.nn.train_step import apply_updates, gradients
        upd = self._training_config.updater
        loss, grads, _ = gradients(lambda live: (step_loss(live[""], ph), None),
                                   {"": self.variables_map})
        apply_updates({"": self.variables_map}, grads,
                      {"": {k: upd for k in self.variables_map}},
                      {"": self._updater_state}, it, epoch)
        return loss

    def fit(self, dataset=None, epochs: int = 1, features=None, labels=None):
        """Train on a DataSet or an iterable of them (ND4J ``sd.fit``).
        The step count restarts at 0 in each call while the updater state
        carries over (the reference's rule: a second call restarts Adam's
        bias correction). Returns the last loss as a float."""
        cfg = self._training_config
        if cfg is None:
            raise ValueError("set_training_config first")
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet

        if dataset is None:
            dataset = DataSet(features, labels)
        batches = [dataset] if isinstance(dataset, DataSet) else list(dataset)
        step_loss = self._step_loss(cfg)
        if self._updater_state is None:
            self._updater_state = {k: cfg.updater.init_state(v)
                                   for k, v in self.variables_map.items()}
        it, last = 0, None
        for epoch in range(int(epochs)):
            for ds in batches:
                last = self._fit_step(step_loss, self._feed(cfg, ds, True), it, epoch)
                it += 1
        return None if last is None else float(last)

    def _feed(self, cfg: TrainingConfig, ds, with_labels: bool) -> dict:
        """DataSet to placeholder dict through the TrainingConfig mappings
        (shared by fit and evaluate)."""
        feats = ds.features if isinstance(ds.features, (list, tuple)) else [ds.features]
        ph = dict(zip(cfg.feature_mapping, feats))
        if with_labels:
            labs = ds.labels if isinstance(ds.labels, (list, tuple)) else [ds.labels]
            ph.update(zip(cfg.label_mapping, labs))
        return self._placeholders(ph)

    def evaluate(self, iterator, output_name: str, evaluation=None):
        """Evaluate an output variable against labels from a DataSet
        iterator (ND4J ``sd.evaluate``) into an ``Evaluation`` (or the
        given metric)."""
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        from deeplearning4j_tpu_torch.nn.train_step import to_host
        cfg = self._training_config
        if cfg is None:
            raise ValueError("set_training_config first (placeholder mappings)")
        ev = evaluation if evaluation is not None else Evaluation()
        batches = [iterator] if isinstance(iterator, DataSet) else iterator
        for ds in batches:
            preds = self.output(self._feed(cfg, ds, with_labels=False),
                                output_name)[output_name]
            labs = ds.labels if isinstance(ds.labels, (list, tuple)) else [ds.labels]
            ev.eval(to_host(labs[0]), preds)
        return ev

    # -- serde --------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "nodes": [{
                "name": n, "kind": v.kind, "op": v.op,
                "inputs": list(v.inputs), "attrs": v.attrs,
                "shape": None if v._declared_shape is None else list(v._declared_shape),
                "scope": v.scope,
            } for n, v in ((n, self._nodes[n]) for n in self._order)],
            "loss_variables": self._loss_variables,
        })

    def save(self, path: str) -> None:
        """The graph's JSON and the variable and constant values in one npz
        (the reference's format)."""
        from deeplearning4j_tpu_torch.nn.train_step import to_host
        arrays = {f"var__{k}": to_host(v) for k, v in self.variables_map.items()}
        arrays |= {f"const__{k}": to_host(v) for k, v in self.constants_map.items()}
        np.savez(path, __graph__=np.frombuffer(self.to_json().encode(), dtype=np.uint8),
                 **arrays)

    @staticmethod
    def load(path: str, device=None) -> "SameDiff":
        data = np.load(path if str(path).endswith(".npz") else str(path) + ".npz",
                       allow_pickle=False)
        spec = json.loads(bytes(data["__graph__"]).decode())
        sd = SameDiff(device)
        for nd in spec["nodes"]:
            name, kind = nd["name"], nd["kind"]
            shape = None if nd["shape"] is None else tuple(nd["shape"])
            if kind == "placeholder":
                sd.place_holder(name, shape)
            elif kind == "variable":
                sd.var(name, value=data[f"var__{name}"])
            elif kind == "constant":
                sd.constant(name, data[f"const__{name}"])
                sd._nodes[name].scope = nd.get("scope")
            elif nd["op"] in ("if_cond", "while_loop", "loop_input"):
                # control-flow attrs hold name lists that must stay lists
                sd._register(SDVariable(sd, name, "op", op=nd["op"],
                                        inputs=nd["inputs"], attrs=nd["attrs"],
                                        scope=nd.get("scope")))
            else:
                attrs = {k: (tuple(v) if isinstance(v, list) else v)
                         for k, v in (nd["attrs"] or {}).items()}
                sd._register(SDVariable(sd, name, "op", op=nd["op"],
                                        inputs=nd["inputs"], attrs=attrs,
                                        scope=nd.get("scope")))
        sd._loss_variables = spec.get("loss_variables", [])
        return sd
