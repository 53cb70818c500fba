"""KV-cache decoding and text generation of the port on the CPU, against
the JAX package, with the same weights (carried by
``load_reference_params``).

The model is example 11's decoder (``TransformerLM`` with vocab 11,
``max_length`` 32, 2 layers, d_model 32, 4 heads, d_ff 64). Tolerances:
probabilities within 1e-5 absolute (f32 through 2 blocks and the softmax;
XLA and ATen sum in other orders), caches and key validity within 1e-6,
positions equal; tokens equal (the nets are seeded random ones, where a
tie between two probabilities has probability ~0); ``beam_search``
scores within 1e-5 relative.

- ``rnn_time_step``: a prompt chunk, then single steps ([N,1] inputs,
  the squeeze rule), with the stored carries against the reference's;
  a padded prompt (a query row whose own key is padding sees no valid
  slot: uniform weights, no NaN); overflow, ``rnn_clear_previous_state``
  and set/get state with ``position=``, with the reference's messages.
- The cache write: in place under inference mode, into a copy (so the
  gradient reaches ``Wqkv``) under autograd.
- ``generate`` (greedy, temperature), ``generate_on_device`` (greedy,
  ``top_k=1``, a tiny ``top_p``; 4096 sampled one-token draws against
  the filtered softmax of the reference's probabilities, within 5
  standard errors) and ``beam_search`` against the JAX package's.
- A ``MultiLayerNetwork`` (Embedding, Positional, CausalSelfAttention,
  RnnOutput) through ``generate``, and the graph-only paths' TypeError.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.layers import CausalSelfAttentionLayer as JCausal
from deeplearning4j_tpu.nn.layers import EmbeddingSequenceLayer as JEmbed
from deeplearning4j_tpu.nn.layers import PositionalEmbeddingLayer as JPos
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.zoo import models as jzoo
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    CausalSelfAttentionLayer,
    EmbeddingSequenceLayer,
    PositionalEmbeddingLayer,
    RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.convert import load_reference_params
from deeplearning4j_tpu_torch.zoo import (
    TransformerLM,
    beam_search,
    generate,
    generate_on_device,
)

VOCAB, MAX_LEN = 11, 32
EX11 = dict(vocab_size=VOCAB, max_length=MAX_LEN, n_layers=2, d_model=32,
            n_heads=4, d_ff=64, seed=3)
PROB_ATOL, CACHE_ATOL, SCORE_RTOL = 1e-5, 1e-6, 1e-5
DRAWS, SIGMAS = 4096, 5.0
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


@pytest.fixture(scope="module")
def pair():
    """(JAX graph, port graph on the CPU with its weights)."""
    thelpers.clear_all_helpers()
    jnet = JaxGraph(jzoo.TransformerLM(**EX11).conf()).init()
    tnet = load_reference_params(TransformerLM(**EX11).init(device="cpu"),
                                 to_np(jnet.params))
    return jnet, tnet


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(1).integers(0, VOCAB, (2, 6)).astype(np.float32)


def _recurrent_names(net):
    return [n for n in net.conf.topo_order if n.endswith("-att") or n == "pos"]


def _assert_carry(got, want, name):
    if name == "pos":
        assert got == int(want)
        return
    for part, g, w in zip(("k_cache", "v_cache", "validity"), got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=CACHE_ATOL, err_msg=f"{name} {part}")
    assert isinstance(got[3], int) and got[3] == int(want[3])


def test_prompt_then_single_steps_match_reference(pair, prompt):
    jnet, tnet = pair
    for net in pair:
        net.rnn_clear_previous_state()
    want = np.asarray(jnet.rnn_time_step(prompt[:, :, None]))
    got = tnet.rnn_time_step(prompt[:, :, None])
    assert got.shape == (2, 6, VOCAB)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PROB_ATOL)
    steps = np.random.default_rng(2).integers(0, VOCAB, (5, 2, 1)).astype(np.float32)
    for x in steps:  # [N,1]: one step, squeezed to [N,V]
        want = np.asarray(jnet.rnn_time_step(x))
        got = tnet.rnn_time_step(x)
        assert got.shape == want.shape == (2, VOCAB)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PROB_ATOL)
    assert tnet._rnn_pos == jnet._rnn_pos == 11
    names = _recurrent_names(tnet)
    assert sorted(tnet.rnn_get_previous_states()) == sorted(names)
    for name in names:
        _assert_carry(tnet.rnn_get_previous_state(name),
                      to_np(jnet.rnn_get_previous_state(name)), name)
    # the same probabilities as the whole sequence through output
    whole = np.concatenate([prompt, steps[:, :, 0].T], axis=1)
    np.testing.assert_allclose(got.numpy(), tnet.output(whole)[:, -1].numpy(),
                               rtol=0, atol=PROB_ATOL)


def test_padded_prompt_matches_reference(pair, prompt):
    """Left padding: the first query rows see no valid slot; the reference
    weighs all Tc slots alike there (finfo.min, not -inf)."""
    jnet, tnet = pair
    mask = np.ones((2, 6), np.float32)
    mask[0, :3] = 0.0
    mask[1, :1] = 0.0
    jcarries = {vd.name: vd.obj.init_carry(2)
                for vd in jnet.conf.layer_vertices()
                if hasattr(vd.obj, "init_carry")}
    jacts, _, _, jnew = jnet._forward_all(
        jnet.params, jnet.states, {"tokens": jax.numpy.asarray(prompt)},
        train=False, rng=None, masks={"tokens": jax.numpy.asarray(mask)},
        carries=jcarries)
    with torch.inference_mode():
        acts, new, _ = tnet._forward_all(
            tnet.params, {"tokens": torch.from_numpy(prompt)},
            {"tokens": torch.from_numpy(mask)}, carries=tnet.init_carries(2))
    got = acts["out"].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jacts["out"]), rtol=0,
                               atol=PROB_ATOL)
    for name in _recurrent_names(tnet):
        _assert_carry(new[name], to_np(jnew[name]), name)
    np.testing.assert_array_equal(new["block0-att"][2].numpy()[:, :6], mask)


def test_layer_overflow_messages_match_reference():
    x = jax.numpy.zeros((1, 3, 8))
    jatt = JCausal(n_in=8, n_out=8, n_heads=2, max_cache=4)
    jpos = JPos(n_in=8, max_len=4)
    att = CausalSelfAttentionLayer(n_in=8, n_out=8, n_heads=2, max_cache=4)
    pos = PositionalEmbeddingLayer(n_in=8, max_len=4)
    gen = torch.Generator().manual_seed(0)
    for jl, tl in ((jatt, att), (jpos, pos)):
        jp = jl.init_params(jax.random.PRNGKey(0))
        tp = tl.init_params(gen)
        carry = jl.init_carry(1)
        carry = ((*carry[:3], jax.numpy.asarray(2, jax.numpy.int32))
                 if isinstance(carry, tuple) else jax.numpy.asarray(2))
        with pytest.raises(ValueError) as jerr:
            jl.forward_seq(jp, x, carry=carry)
        tcarry = tl.init_carry(1)
        tcarry = (*tcarry[:3], 2) if isinstance(tcarry, tuple) else 2
        with pytest.raises(ValueError) as terr:
            tl.forward_seq(tp, torch.zeros((1, 3, 8)), carry=tcarry)
        assert str(terr.value) == str(jerr.value)


def test_overflow_clear_and_state_round_trip_match_reference(pair, prompt):
    jnet, tnet = pair
    for net in pair:
        net.rnn_clear_previous_state()
        net.rnn_time_step(np.tile(prompt, (1, 5))[:, :, None])  # 30 steps
    errs = []
    for net in pair:
        with pytest.raises(ValueError) as e:
            net.rnn_time_step(np.zeros((2, 3, 1), np.float32))
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "rnn_time_step at position 30+3" in errs[1]

    # cleared: the next call starts over, as a fresh network's would
    for net in pair:
        net.rnn_clear_previous_state()
    first = tnet.rnn_time_step(prompt[:, :, None])
    np.testing.assert_allclose(first.numpy(), tnet.output(prompt).numpy(),
                               rtol=0, atol=PROB_ATOL)
    jnet.rnn_time_step(prompt[:, :, None])

    # the reference's carries set into the port continue as the reference
    jstates = {n: to_np(c) for n, c in jnet.rnn_get_previous_states().items()}
    saved = tnet.rnn_get_previous_states()
    tnet.rnn_clear_previous_state()
    tnet.rnn_time_step(np.zeros((2, 4, 1), np.float32))  # other state
    errs = []
    for net, states in ((jnet, jstates), (tnet, jstates)):
        with pytest.raises(ValueError) as e:
            net.rnn_set_previous_state("pos", states["pos"])
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    tnet.rnn_set_previous_states(jstates, position=6)
    step = np.full((2, 1), 4.0, np.float32)
    want = np.asarray(jnet.rnn_time_step(step))
    np.testing.assert_allclose(tnet.rnn_time_step(step).numpy(), want,
                               rtol=0, atol=PROB_ATOL)
    # the port's own saved copies were not touched by the in-place writes
    tnet.rnn_set_previous_states(saved, position=6)
    np.testing.assert_allclose(tnet.rnn_time_step(step).numpy(), want,
                               rtol=0, atol=PROB_ATOL)
    fresh = TransformerLM(**EX11).init(device="cpu")
    with pytest.raises(ValueError) as terr:
        fresh.rnn_set_previous_state("pos", 0, position=0)
    with pytest.raises(ValueError) as jerr:
        JaxGraph(jzoo.TransformerLM(**EX11).conf()).init() \
            .rnn_set_previous_state("pos", 0, position=0)
    assert str(terr.value) == str(jerr.value)


def test_cache_write_in_place_for_decode_and_copied_under_autograd():
    layer = CausalSelfAttentionLayer(n_in=8, n_out=8, n_heads=2, max_cache=6)
    params = layer.init_params(torch.Generator().manual_seed(0))
    x = torch.randn((1, 2, 8), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        carry = layer.init_carry(1)
        _, new = layer.forward_seq(params, x, carry=carry)
    assert new[0] is carry[0] and new[1] is carry[1] and new[3] == 2
    assert carry[0][:, :, :2].abs().sum() > 0  # written in place

    live = {n: t.clone().requires_grad_(True) for n, t in params.items()}
    carry = layer.init_carry(1)
    y, new = layer.forward_seq(live, x, carry=carry)
    assert new[0] is not carry[0] and carry[0].abs().sum() == 0
    assert new[0].requires_grad
    g = torch.autograd.grad(new[0].sum() + new[1].sum(), live["Wqkv"])[0]
    assert g.abs().sum() > 0


def test_generate_matches_reference(pair, prompt):
    jnet, tnet = pair
    for kw in (dict(), dict(temperature=0.8, seed=4)):
        want = jzoo.generate(jnet, prompt, 12, **kw)
        got = generate(tnet, prompt, 12, **kw)
        assert got.dtype == np.int64 and got.shape == (2, 12)
        np.testing.assert_array_equal(got, want)
    assert generate(tnet, prompt, 0).shape == (2, 0)
    errs = []
    for net, gen_fn in ((jnet, jzoo.generate), (tnet, generate)):
        with pytest.raises(ValueError) as e:
            gen_fn(net, prompt, 28)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("kw", [dict(), dict(temperature=0.8, top_k=1, seed=5),
                                dict(temperature=0.8, top_p=1e-6, seed=6)],
                         ids=["greedy", "top_k_1", "tiny_top_p"])
def test_generate_on_device_greedy_paths_match_reference(pair, prompt, kw):
    jnet, tnet = pair
    want = jzoo.generate_on_device(jnet, prompt, 12)
    got = generate_on_device(tnet, prompt, 12, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, generate(tnet, prompt, 12))


def _filtered(p, temperature, top_k, top_p):
    """The reference's filtered softmax, in float64 from its
    probabilities."""
    logits = np.log(np.maximum(p.astype(np.float64), 1e-20)) / temperature
    srt = np.sort(logits)[::-1]
    keep = np.ones_like(logits, bool)
    if top_k:
        keep &= logits >= srt[top_k - 1]
        srt = np.where(np.arange(srt.size) < top_k, srt, -np.inf)
    if top_p:
        q = np.exp(srt - srt.max())
        q /= q.sum()
        cut = srt[(np.cumsum(q) - q) < top_p].min()
        keep &= logits >= cut
    z = np.where(keep, np.exp(logits - logits.max()), 0.0)
    return z / z.sum()


@pytest.mark.parametrize("temperature,top_k,top_p",
                         [(0.8, 5, 0.0), (1.3, 0, 0.9), (0.8, 6, 0.8)])
def test_sampled_draws_follow_the_filtered_softmax(pair, prompt, temperature,
                                                   top_k, top_p):
    jnet, tnet = pair
    p = np.asarray(jnet.output(prompt[:1]))[0, -1]
    want = _filtered(p, temperature, top_k, top_p)
    rows = np.repeat(prompt[:1], DRAWS, axis=0)
    draws = generate_on_device(tnet, rows, 1, temperature=temperature,
                               top_k=top_k, top_p=top_p, seed=7)[:, 0]
    freq = np.bincount(draws, minlength=VOCAB) / DRAWS
    assert (freq[want == 0] == 0).all(), (freq, want)
    se = np.sqrt(want * (1 - want) / DRAWS)
    assert (np.abs(freq - want) <= SIGMAS * se + 1e-12).all(), (freq, want)
    assert (want > 0).sum() >= 2  # the filter left a real choice
    again = generate_on_device(tnet, rows[:64], 3, temperature=temperature,
                               top_k=top_k, top_p=top_p, seed=7)
    np.testing.assert_array_equal(
        again, generate_on_device(tnet, rows[:64], 3, temperature=temperature,
                                  top_k=top_k, top_p=top_p, seed=7))
    assert not np.array_equal(again, generate_on_device(
        tnet, rows[:64], 3, temperature=temperature, top_k=top_k,
        top_p=top_p, seed=8))


@pytest.mark.parametrize("beam,eos,penalty",
                         [(1, False, 0.0), (3, False, 0.0), (3, True, 0.0),
                          (3, True, 1.0), (3, False, 1.0)])
def test_beam_search_matches_reference(pair, prompt, beam, eos, penalty):
    jnet, tnet = pair
    eos_id = int(generate(tnet, prompt, 3)[0, 1]) if eos else None
    want_t, want_s = jzoo.beam_search(jnet, prompt, 10, beam_size=beam,
                                      eos_id=eos_id, length_penalty=penalty)
    got_t, got_s = beam_search(tnet, prompt, 10, beam_size=beam,
                               eos_id=eos_id, length_penalty=penalty)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_allclose(got_s, want_s, rtol=SCORE_RTOL, atol=0)
    if beam == 1:
        np.testing.assert_array_equal(got_t, generate(tnet, prompt, 10))
    if eos:
        assert (got_t == eos_id).any()


def test_beam_search_refuses_a_negative_length_penalty(pair, prompt):
    jnet, tnet = pair
    with pytest.raises(ValueError) as jerr:
        jzoo.beam_search(jnet, prompt, 4, length_penalty=-1.0)
    with pytest.raises(ValueError) as terr:
        beam_search(tnet, prompt, 4, length_penalty=-1.0)
    assert str(terr.value) == str(jerr.value)


def _mln_conf(b, embed, pos, att, out, it):
    return (b.builder().seed(9).list()
            .layer(embed(n_in=VOCAB, n_out=16))
            .layer(pos(max_len=MAX_LEN))
            .layer(att(n_heads=2, max_cache=MAX_LEN))
            .layer(out(n_out=VOCAB, activation="softmax", loss="mcxent"))
            .set_input_type(it.recurrent(1, MAX_LEN)).build())


def test_multilayer_network_generates_as_the_reference(prompt):
    jnet = JaxMLN(_mln_conf(JNNC, JEmbed, JPos, JCausal, JRnnOut, JIT)).init()
    tnet = load_reference_params(MultiLayerNetwork(_mln_conf(
        NeuralNetConfiguration, EmbeddingSequenceLayer,
        PositionalEmbeddingLayer, CausalSelfAttentionLayer, RnnOutputLayer,
        InputType), device="cpu").init(), to_np(jnet.params))
    for kw in (dict(), dict(temperature=0.9, seed=2)):
        np.testing.assert_array_equal(generate(tnet, prompt, 10, **kw),
                                      jzoo.generate(jnet, prompt, 10, **kw))
    _assert_carry(tnet.rnn_get_previous_state(2),
                  to_np(jnet.rnn_get_previous_state(2)), "att")
    assert tnet.rnn_get_previous_state(1) == int(jnet.rnn_get_previous_state(1))
    for fn, jfn in ((generate_on_device, jzoo.generate_on_device),
                    (beam_search, jzoo.beam_search)):
        with pytest.raises(TypeError) as terr:
            fn(tnet, prompt, 4)
        with pytest.raises(TypeError) as jerr:
            jfn(jnet, prompt, 4)
        assert str(terr.value) == str(jerr.value)
