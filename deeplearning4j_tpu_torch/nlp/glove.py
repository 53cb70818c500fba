"""GloVe embeddings.

Parity with `models/glove/Glove.java` (429 LoC): builds a co-occurrence
table from windowed corpus scans, then fits with the GloVe weighted
least-squares objective under AdaGrad. The reference loops nonzero cells in
shuffled order across threads; here the nonzeros are flat arrays and each
epoch is a sequence of fixed-size AdaGrad steps.

Counterpart of the JAX package's ``nlp/glove.py``: the same co-occurrence
table, draws and order; each step is a torch function on the model's
device (``device=``) that gathers, then ``index_add_``s the AdaGrad
accumulators and reads them back after every duplicate row was added, as
the reference's step reads ``new_hw[rows]``. A last short batch runs its
exact rows (the reference pads it with rows that change nothing).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor


def _glove_step(w, wc, b, bc, hw, hwc, hb, hbc,
                rows, cols, logx, weight, lr):
    """One AdaGrad minibatch on nonzero co-occurrence cells, in place.

    w/wc: center/context embeddings; b/bc their biases; h*: AdaGrad
    accumulators. diff = w_i·wc_j + b_i + bc_j − log X_ij;
    loss = f(X_ij)·diff²."""
    wi, wj = w[rows], wc[cols]
    diff = torch.sum(wi * wj, dim=1) + b[rows] + bc[cols] - logx
    fdiff = weight * diff
    gw = fdiff[:, None] * wj
    gwc = fdiff[:, None] * wi
    # AdaGrad
    hw.index_add_(0, rows, gw * gw)
    hwc.index_add_(0, cols, gwc * gwc)
    hb.index_add_(0, rows, fdiff * fdiff)
    hbc.index_add_(0, cols, fdiff * fdiff)
    eps = 1e-8
    w.index_add_(0, rows, -lr * gw / torch.sqrt(hw[rows] + eps))
    wc.index_add_(0, cols, -lr * gwc / torch.sqrt(hwc[cols] + eps))
    b.index_add_(0, rows, -lr * fdiff / torch.sqrt(hb[rows] + eps))
    bc.index_add_(0, cols, -lr * fdiff / torch.sqrt(hbc[cols] + eps))


class Glove(SequenceVectors):
    def __init__(self, layer_size: int = 100, window: int = 5,
                 learning_rate: float = 0.05, epochs: int = 5,
                 min_word_frequency: int = 1, x_max: float = 100.0,
                 alpha: float = 0.75, batch_size: int = 8192,
                 symmetric: bool = True, seed: int = 12345,
                 tokenizer_factory=None, device=None, dtype=torch.float32):
        """``dtype`` is the tables' (the reference's float32; float64 runs
        an f64 twin from the same f32 draws)."""
        super().__init__(layer_size=layer_size, window=window,
                         learning_rate=learning_rate, epochs=epochs,
                         min_word_frequency=min_word_frequency, seed=seed,
                         device=device)
        self.x_max = x_max
        self.alpha = alpha
        self.batch_size = batch_size
        self.symmetric = symmetric
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.dtype = dtype

    def _tokenize(self, sentences) -> List[List[str]]:
        out = []
        for s in sentences:
            if isinstance(s, str):
                out.append(self.tokenizer_factory.create(s).get_tokens())
            else:
                out.append(list(s))
        return out

    def build_cooccurrence(self, corpus: List[List[str]]
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Windowed counts weighted 1/distance (AbstractCoOccurrences.java)."""
        counts: Dict[Tuple[int, int], float] = defaultdict(float)
        for tokens in corpus:
            idx = [self.vocab.index_of(t) for t in tokens]
            idx = [i for i in idx if i >= 0]
            for i, wi in enumerate(idx):
                for off in range(1, self.window + 1):
                    j = i + off
                    if j >= len(idx):
                        break
                    inc = 1.0 / off
                    counts[(wi, idx[j])] += inc
                    if self.symmetric:
                        counts[(idx[j], wi)] += inc
        rows = np.fromiter((k[0] for k in counts), np.int32, len(counts))
        cols = np.fromiter((k[1] for k in counts), np.int32, len(counts))
        vals = np.fromiter(counts.values(), np.float32, len(counts))
        return rows, cols, vals

    def fit(self, sentences: Iterable) -> "Glove":
        corpus = self._tokenize(sentences)
        if self.vocab is None:
            constructor = VocabConstructor(
                min_word_frequency=self.min_word_frequency)
            self.vocab = constructor.build_vocab(corpus)
        rows, cols, vals = self.build_cooccurrence(corpus)
        n, d = self.vocab.num_words(), self.layer_size
        dev, dt = self.device, self.dtype
        rng = np.random.default_rng(self.seed)

        def drawn():
            return torch.from_numpy(((rng.random((n, d)) - 0.5) / d)
                                    .astype(np.float32)).to(dev, dt)

        w, wc = drawn(), drawn()
        b, bc, hb, hbc = (torch.zeros((n,), dtype=dt, device=dev)
                          for _ in range(4))
        hw, hwc = (torch.zeros((n, d), dtype=dt, device=dev)
                   for _ in range(2))

        logx = np.log(vals)
        weight = np.minimum((vals / self.x_max) ** self.alpha, 1.0).astype(np.float32)
        m = len(rows)
        bs = self.batch_size
        for _epoch in range(self.epochs):
            order = rng.permutation(m)
            for start in range(0, m, bs):
                sel = order[start:start + bs]
                idx = torch.from_numpy(np.stack([rows[sel], cols[sel]]).astype(np.int64))
                cells = torch.from_numpy(np.stack([logx[sel], weight[sel]]).astype(np.float32))
                idx = idx.to(dev, non_blocking=True)
                cells = cells.to(dev, non_blocking=True).to(dt)
                _glove_step(w, wc, b, bc, hw, hwc, hb, hbc,
                            idx[0], idx[1], cells[0], cells[1], self.learning_rate)

        # final embedding = w + wc (standard GloVe)
        from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
        self.lookup_table = InMemoryLookupTable(self.vocab, d, seed=self.seed,
                                                negative=0, use_hs=False,
                                                init_syn0=False, device=dev)
        self.lookup_table.syn0 = w + wc
        return self
