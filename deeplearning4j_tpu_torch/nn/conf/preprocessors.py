"""Named input preprocessors (DL4J ``InputPreProcessor`` family).

Counterpart of ``deeplearning4j_tpu/nn/conf/preprocessors.py``: each
preprocessor is a spec string, so configurations stay JSON:
``"cnn_to_ff"``, parameterized ``"ff_to_cnn:28,28,1"``, or composed with
``|`` (``"zero_mean|unit_variance"``, DL4J's ComposableInputPreProcessor).
``ListBuilder.input_pre_processor(idx, spec)`` places one in front of a
layer, overriding the automatic inference. Layouts are NHWC and
``[N, T, C]``, so the conversions are reshapes; autograd gives the
backward.

``zero_mean``, ``unit_variance`` and ``standardize`` use per-feature
statistics over the batch axis, the variance with ddof 0 as ``jnp.var``
(``torch.var`` defaults to the unbiased estimator). ``binomial_sampling``
draws one fixed mask per seed, as the reference does, from a
``torch.Generator`` (so its draws match the reference's in distribution
only), with a straight-through gradient. A rank-4 ``reshape`` gives an
image sequence ([T,H,W,C], the ``cnn_seq`` kind).

The ``*_nchw`` specs are DL4J's own preprocessors for imported
checkpoints (``modelimport/dl4j.py``): DL4J flattens an image in C, H, W
order, so the dense weights after a convolution index its features as
``c·H·W + h·W + w``. ``cnn_to_ff_nchw`` flattens NHWC activations in
that order and ``ff_to_cnn_nchw:h,w,c`` inverts it. The reference builds
these as closures; here they are specs, so an imported configuration
stays serializable. Likewise for image sequences: ``cnn_seq_to_rnn_nchw``
(DL4J's CnnToRnnPreProcessor) flattens each step of [N,T,H,W,C] in C, H,
W order and ``rnn_to_cnn_seq_nchw:h,w,c`` (RnnToCnnPreProcessor) inverts
it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType


def _parse(spec: str) -> Tuple[str, Tuple[int, ...]]:
    if ":" in spec:
        name, args = spec.split(":", 1)
        return name, tuple(int(a) for a in args.split(","))
    return spec, ()


def _safe_std(x):
    """Per-column std with 0-variance columns mapped to 1, masked BEFORE
    the sqrt so that the backward stays finite."""
    var = torch.var(x, dim=0, keepdim=True, unbiased=False)
    zero = var == 0
    one = torch.ones_like(var)
    return torch.where(zero, one, torch.sqrt(torch.where(zero, one, var)))


def apply(spec: str, x):
    if "|" in spec:  # ComposableInputPreProcessor
        for part in spec.split("|"):
            x = apply(part, x)
        return x
    name, args = _parse(spec)
    if name == "identity":
        return x
    if name == "zero_mean":          # ZeroMeanPrePreProcessor
        return x - x.mean(dim=0, keepdim=True)
    if name == "unit_variance":      # UnitVarianceProcessor
        return x / _safe_std(x)
    if name == "standardize":        # ZeroMeanAndUnitVariancePreProcessor
        return (x - x.mean(dim=0, keepdim=True)) / _safe_std(x)
    if name == "binomial_sampling":  # BinomialSamplingPreProcessor
        gen = torch.Generator(device=x.device)
        gen.manual_seed(args[0] if args else 0)
        sample = torch.bernoulli(x.detach().clamp(0.0, 1.0), generator=gen)
        return x + (sample - x).detach()
    if name == "cnn_to_ff":          # [N,H,W,C] -> [N, H*W*C]
        return x.reshape(x.shape[0], -1)
    if name == "ff_to_cnn":          # [N, H*W*C] -> [N,H,W,C]
        h, w, c = args
        return x.reshape(x.shape[0], h, w, c)
    if name == "rnn_to_ff":          # [N,T,C] -> [N*T, C]
        return x.reshape(-1, x.shape[-1])
    if name == "ff_to_rnn":          # [N*T, C] -> [N,T,C]
        (t,) = args
        return x.reshape(-1, t, x.shape[-1])
    if name == "cnn_to_rnn":         # [N,H,W,C] -> [N, T=H, W*C]
        return x.reshape(x.shape[0], x.shape[1], -1)
    if name == "rnn_to_cnn":         # [N,T,H'*W'*C'] -> [N*T,H',W',C']
        h, w, c = args
        return x.reshape(-1, h, w, c)
    if name == "cnn_to_ff_nchw":     # DL4J CnnToFeedForward: C, H, W order
        return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
    if name == "ff_to_cnn_nchw":     # DL4J FeedForwardToCnn
        h, w, c = args
        return x.reshape(x.shape[0], c, h, w).permute(0, 2, 3, 1)
    if name == "cnn_seq_to_rnn_nchw":  # DL4J CnnToRnn: each step in C, H, W order
        return x.permute(0, 1, 4, 2, 3).reshape(x.shape[0], x.shape[1], -1)
    if name == "rnn_to_cnn_seq_nchw":  # DL4J RnnToCnn
        h, w, c = args
        return x.reshape(x.shape[0], x.shape[1], c, h, w).permute(0, 1, 3, 4, 2)
    if name == "reshape":            # ReshapePreprocessor (Keras Reshape)
        return x.reshape((x.shape[0],) + args)
    raise ValueError(f"unknown preprocessor {spec!r}")


def output_type(spec: str, it: InputType) -> InputType:
    if "|" in spec:
        for part in spec.split("|"):
            it = output_type(part, it)
        return it
    name, args = _parse(spec)
    if name in ("identity", "zero_mean", "unit_variance", "standardize",
                "binomial_sampling"):
        return it
    if name in ("cnn_to_ff", "cnn_to_ff_nchw"):
        return InputType.feed_forward(it.height * it.width * it.channels)
    if name in ("ff_to_cnn", "rnn_to_cnn", "ff_to_cnn_nchw"):
        h, w, c = args
        return InputType.convolutional(h, w, c)
    if name == "rnn_to_ff":
        return InputType.feed_forward(it.size)
    if name == "ff_to_rnn":
        (t,) = args
        return InputType.recurrent(it.size, t)
    if name == "cnn_to_rnn":
        return InputType.recurrent(it.width * it.channels, it.height)
    if name == "cnn_seq_to_rnn_nchw":
        return InputType.recurrent(it.flat_size(), it.timesteps)
    if name == "rnn_to_cnn_seq_nchw":
        h, w, c = args
        return InputType.recurrent_convolutional(h, w, c, it.timesteps)
    if name == "reshape":
        # the target rank decides: 1 -> ff, 2 -> [T,C], 3 -> [H,W,C],
        # 4 -> [T,H,W,C] (an image sequence)
        if len(args) == 1:
            return InputType.feed_forward(args[0])
        if len(args) == 2:
            return InputType.recurrent(args[1], args[0])
        if len(args) == 3:
            return InputType.convolutional(*args)
        if len(args) == 4:
            t, h, w, c = args
            return InputType.recurrent_convolutional(h, w, c, t)
        raise ValueError(f"reshape target rank {len(args)} unsupported")
    raise ValueError(f"unknown preprocessor {spec!r}")
