"""Embedding learning algorithms: SkipGram / CBOW (+ DM / DBOW on top).

Counterpart of the JAX package's ``nlp/learning.py`` (reference
`models/embeddings/learning/impl/elements/{SkipGram,CBOW}.java` and
`.../sequence/{DM,DBOW}.java`). Pairs, windows, subsampling and negatives
are drawn on the host from the reference's numpy generator in the
reference's order; each batch is one torch step on the table's device:
gather every row the step needs, compute both gradients from those old
values, then ``index_add_`` them (repeated rows add up), the batch-
synchronous update of the reference's jitted steps. Gradient math is
word2vec's: g = (label − σ(h·v)) · lr.

The steps run the batch's exact rows: the reference pads a batch to a
power of two so that XLA compiles once per bucket, and its padded rows
change nothing. The indices and masks reach the device in one copy a
step; the labels of negative sampling are one row kept on the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable


# ------------------------------------------------------------------- steps

def _on(table: InMemoryLookupTable, *arrays: np.ndarray):
    """The integer-valued arrays as int64 tensors on the table's device,
    in one host-to-device copy (from pageable memory, which CUDA stages
    before the call returns)."""
    flat = np.concatenate([np.asarray(a, np.int64).reshape(-1) for a in arrays])
    dev = torch.from_numpy(flat).to(table.device, non_blocking=True)
    out, start = [], 0
    for a in arrays:
        out.append(dev[start:start + a.size].view(a.shape))
        start += a.size
    return out


def _positive_first(k: int, dtype, device) -> torch.Tensor:
    """[k] labels of one row of targets: 1 for the positive column 0."""
    labels = torch.zeros(k, dtype=dtype, device=device)
    labels[0] = 1.0
    return labels


def _scores(h, vt):
    """h·v for each row's targets: [B, D] × [B, K, D] → [B, K]."""
    return torch.bmm(vt, h.unsqueeze(2)).squeeze(2)


def _input_grad(g, vt):
    """Σ_k g_k v_k for each row: [B, K] × [B, K, D] → [B, D]."""
    return torch.bmm(g.unsqueeze(1), vt).squeeze(1)


def _ns_step(syn0, syn1neg, centers, targets, labels, valid, lr):
    """Negative-sampling update for a batch of center→target rows.

    centers: [B] rows of syn0; targets: [B, K] rows of syn1neg (1 positive
    + K-1 negatives); labels [B, K] (or [K]) 1.0 for the positive column;
    valid [B, K] 0.0 masks self-collision negatives. Updates both in
    place."""
    h = syn0[centers]                                        # [B, D]
    vt = syn1neg[targets]                                    # [B, K, D]
    g = (labels - torch.sigmoid(_scores(h, vt))) * valid * lr  # [B, K]
    dh = _input_grad(g, vt)
    dvt = g[..., None] * h[:, None, :]
    syn0.index_add_(0, centers, dh)
    syn1neg.index_add_(0, targets.reshape(-1), dvt.reshape(-1, dvt.shape[-1]))


def _hs_step(syn0, syn1, centers, points, codes, valid, lr):
    """Hierarchical-softmax update: points are inner-node rows of syn1,
    label for node j is (1 - code_j)."""
    h = syn0[centers]
    vt = syn1[points]
    g = ((1.0 - codes) - torch.sigmoid(_scores(h, vt))) * valid * lr
    dh = _input_grad(g, vt)
    dvt = g[..., None] * h[:, None, :]
    syn0.index_add_(0, centers, dh)
    syn1.index_add_(0, points.reshape(-1), dvt.reshape(-1, dvt.shape[-1]))


def _cbow_mean(syn0, contexts, ctx_valid):
    """h = mean of the valid context vectors (at least one counted)."""
    cv = syn0[contexts] * ctx_valid[..., None]               # [B, C, D]
    n_ctx = torch.clamp_min(ctx_valid.sum(dim=1), 1.0)       # [B]
    return cv.sum(dim=1) / n_ctx[:, None]


def _cbow_spread(syn0, contexts, ctx_valid, dh):
    """word2vec applies the full dh to every valid context word."""
    dctx = dh[:, None, :].expand(*ctx_valid.shape, dh.shape[-1]) * ctx_valid[..., None]
    syn0.index_add_(0, contexts.reshape(-1), dctx.reshape(-1, dh.shape[-1]))


def _cbow_hs_step(syn0, syn1, contexts, ctx_valid, points, codes, valid, lr):
    """CBOW with hierarchical softmax: h = mean of context vectors, labels
    from Huffman codes, input gradient spread to every context word."""
    h = _cbow_mean(syn0, contexts, ctx_valid)
    vt = syn1[points]
    g = ((1.0 - codes) - torch.sigmoid(_scores(h, vt))) * valid * lr
    dh = _input_grad(g, vt)
    dvt = g[..., None] * h[:, None, :]
    _cbow_spread(syn0, contexts, ctx_valid, dh)
    syn1.index_add_(0, points.reshape(-1), dvt.reshape(-1, dvt.shape[-1]))


def _cbow_ns_step(syn0, syn1neg, contexts, ctx_valid, targets, labels,
                  valid, lr):
    """CBOW: h = mean of context vectors; input gradient spread equally."""
    h = _cbow_mean(syn0, contexts, ctx_valid)
    vt = syn1neg[targets]                                    # [B, K, D]
    g = (labels - torch.sigmoid(_scores(h, vt))) * valid * lr
    dh = _input_grad(g, vt)                                  # [B, D]
    dvt = g[..., None] * h[:, None, :]
    _cbow_spread(syn0, contexts, ctx_valid, dh)
    syn1neg.index_add_(0, targets.reshape(-1), dvt.reshape(-1, dvt.shape[-1]))


# ------------------------------------------------------- pair generation

def _reduced_window(L: int, window: int, rng: np.random.Generator
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """word2vec's random reduced-window machinery, shared by SG and CBOW:
    (idx, ok) where idx[L, 2W] are neighbor positions and ok masks
    out-of-range positions and those beyond the per-center random width."""
    b = rng.integers(1, window + 1, size=L)
    offsets = np.concatenate([np.arange(-window, 0), np.arange(1, window + 1)])
    idx = np.arange(L)[:, None] + offsets[None, :]            # [L, 2W]
    ok = (idx >= 0) & (idx < L) & (np.abs(offsets)[None, :] <= b[:, None])
    return idx, ok


def generate_sg_pairs(seq: np.ndarray, window: int,
                      rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """(center, context) index pairs with word2vec's random reduced window."""
    L = len(seq)
    if L < 2:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    idx, ok = _reduced_window(L, window, rng)
    ii, jj = np.nonzero(ok)
    return seq[ii].astype(np.int32), seq[idx[ii, jj]].astype(np.int32)


def generate_cbow_groups(seq: np.ndarray, window: int,
                         rng: np.random.Generator
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(target, context_matrix, context_valid): contexts padded to 2*window."""
    L = len(seq)
    if L < 2:
        z = np.empty((0,), np.int32)
        return z, np.empty((0, 2 * window), np.int32), np.empty((0, 2 * window), np.float32)
    idx, ok = _reduced_window(L, window, rng)
    ctx = np.where(ok, seq[np.clip(idx, 0, L - 1)], 0).astype(np.int32)
    return seq.astype(np.int32), ctx, ok.astype(np.float32)


def subsample(seq: np.ndarray, keep_prob: np.ndarray,
              rng: np.random.Generator) -> np.ndarray:
    """Frequent-word subsampling (word2vec `sample` parameter)."""
    if keep_prob is None:
        return seq
    return seq[rng.random(len(seq)) < keep_prob[seq]]


def make_keep_prob(cache, sample: float) -> Optional[np.ndarray]:
    if not sample or sample <= 0:
        return None
    freqs = np.array([vw.frequency for vw in cache.vocab_words()], np.float64)
    total = freqs.sum()
    ratio = freqs / (sample * total)
    keep = (np.sqrt(ratio) + 1.0) / ratio
    return np.minimum(keep, 1.0)


# ------------------------------------------------------ learning algorithms

class ElementsLearningAlgorithm:
    """SPI mirroring `learning/ElementsLearningAlgorithm.java`."""

    name: str = "base"

    def configure(self, table: InMemoryLookupTable, window: int,
                  negative: int, seed: int) -> None:
        self.table = table
        self.window = window
        self.negative = negative
        self.rng = np.random.default_rng(seed)
        self._max_code = max(
            (len(vw.code) for vw in table.cache.vocab_words()), default=1) or 1
        if table.use_hs:
            n = table.cache.num_words()
            self._points = np.zeros((n, self._max_code), np.int32)
            self._codes = np.zeros((n, self._max_code), np.float32)
            self._code_valid = np.zeros((n, self._max_code), np.float32)
            for vw in table.cache.vocab_words():
                L = len(vw.code)
                self._points[vw.index, :L] = vw.points
                self._codes[vw.index, :L] = vw.code
                self._code_valid[vw.index, :L] = 1.0
            # the points, codes and their mask by word, on the device once
            dev, dtype = table.device, table.syn0.dtype
            self._points_dev = torch.from_numpy(self._points).to(dev, torch.int64)
            self._codes_dev = torch.from_numpy(self._codes).to(dev, dtype)
            self._code_valid_dev = torch.from_numpy(self._code_valid).to(dev, dtype)

    def _sample_negatives(self, positives: np.ndarray):
        """targets [B, 1+neg] — col 0 is the positive — and valid (0 where
        a negative equals its positive), the reference's draw; the labels
        are one [1+neg] row on the device."""
        B = len(positives)
        table = self.table.unigram_table()
        negs = table[self.rng.integers(0, len(table), size=(B, self.negative))]
        targets = np.concatenate([positives[:, None], negs], axis=1)
        valid = np.ones(targets.shape, np.int64)
        valid[:, 1:] = negs != positives[:, None]
        return targets, valid

    def _labels(self) -> torch.Tensor:
        t = self.table
        key = (self.negative + 1, t.syn0.dtype, t.device)
        if getattr(self, "_labels_key", None) != key:
            self._labels_key = key
            self._labels_dev = _positive_first(key[0], key[1], key[2])
        return self._labels_dev

    def _hs_rows(self, words: torch.Tensor):
        """points, codes and their mask of each predicted word."""
        return (self._points_dev[words], self._codes_dev[words],
                self._code_valid_dev[words])

    def train_pairs(self, centers: np.ndarray, predicted: np.ndarray,
                    lr: float) -> None:
        """Update tables for (input-row, predicted-word) pairs: the HS step
        first, then the NS step on the syn0 it wrote."""
        if len(centers) == 0:
            return
        t = self.table
        # the HS step draws nothing, so drawing the negatives first keeps
        # the reference's order of draws
        extra = self._sample_negatives(predicted) if self.negative > 0 else ()
        c, w, *ns = _on(t, centers, predicted, *extra)
        if t.use_hs:
            _hs_step(t.syn0, t.syn1, c, *self._hs_rows(w), lr)
        if self.negative > 0:
            _ns_step(t.syn0, t.syn1neg, c, ns[0], self._labels(),
                     ns[1].to(t.syn0.dtype), lr)
        t.touch()


class SkipGram(ElementsLearningAlgorithm):
    """Predict each context word from the center word (SkipGram.java).

    word2vec convention: the *context* word's syn0 row is the input and the
    center word is predicted — equivalent by symmetry; we follow the
    original C code (input = center of the pair list below)."""

    name = "SkipGram"

    def train_sequence(self, seq: np.ndarray, lr: float,
                       keep_prob: Optional[np.ndarray] = None) -> int:
        seq = subsample(seq, keep_prob, self.rng)
        centers, contexts = generate_sg_pairs(seq, self.window, self.rng)
        self.train_pairs(contexts, centers, lr)  # input=context, predict=center
        return len(centers)


class CBOW(ElementsLearningAlgorithm):
    """Predict the center word from the mean of its context (CBOW.java)."""

    name = "CBOW"

    def train_sequence(self, seq: np.ndarray, lr: float,
                       keep_prob: Optional[np.ndarray] = None) -> int:
        seq = subsample(seq, keep_prob, self.rng)
        targets, ctx, ctx_valid = generate_cbow_groups(seq, self.window, self.rng)
        return self._train_groups(targets, ctx, ctx_valid, lr)

    def _train_groups(self, targets: np.ndarray, ctx: np.ndarray,
                      ctx_valid: np.ndarray, lr: float) -> int:
        """HS and/or negative-sampling update for (context-group → target)
        batches; shared by CBOW and DM."""
        if len(targets) == 0:
            return 0
        t = self.table
        extra = self._sample_negatives(targets) if self.negative > 0 else ()
        w, cx, cv, *ns = _on(t, targets, ctx, ctx_valid, *extra)  # the masks are 0/1
        cv = cv.to(t.syn0.dtype)
        if t.use_hs:
            _cbow_hs_step(t.syn0, t.syn1, cx, cv, *self._hs_rows(w), lr)
        if self.negative > 0:
            _cbow_ns_step(t.syn0, t.syn1neg, cx, cv, ns[0], self._labels(),
                          ns[1].to(t.syn0.dtype), lr)
        t.touch()
        return len(targets)


class DBOW(SkipGram):
    """Distributed bag-of-words for ParagraphVectors (DBOW.java): the
    document/label row predicts each word in the document."""

    name = "DBOW"

    def train_document(self, label_idx: int, seq: np.ndarray, lr: float,
                       keep_prob: Optional[np.ndarray] = None) -> int:
        seq = subsample(seq, keep_prob, self.rng)
        if len(seq) == 0:
            return 0
        labels = np.full(len(seq), label_idx, np.int32)
        self.train_pairs(labels, seq.astype(np.int32), lr)
        return len(seq)


class DM(CBOW):
    """Distributed memory (DM.java): label row joins the context average."""

    name = "DM"

    def train_document(self, label_idx: int, seq: np.ndarray, lr: float,
                       keep_prob: Optional[np.ndarray] = None) -> int:
        seq = subsample(seq, keep_prob, self.rng)
        targets, ctx, ctx_valid = generate_cbow_groups(seq, self.window, self.rng)
        if len(targets) == 0:
            return 0
        # append the label row as an always-valid context column
        lab_col = np.full((len(targets), 1), label_idx, np.int32)
        ctx = np.concatenate([ctx, lab_col], axis=1)
        ctx_valid = np.concatenate(
            [ctx_valid, np.ones((len(targets), 1), np.float32)], axis=1)
        return self._train_groups(targets, ctx, ctx_valid, lr)
