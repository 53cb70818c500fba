"""Weight lookup table for embedding models.

Counterpart of the JAX package's ``nlp/lookup.py`` (reference
`models/embeddings/inmemory/InMemoryLookupTable.java:56`): syn0 (input
vectors), syn1 (hierarchical-softmax inner nodes), syn1neg (negative-sampling
output vectors), and the unigram sampling table. The arrays are torch
tensors on the table's device, updated in place by the training steps of
:mod:`learning` (gather, products, ``index_add_``). The initial values are
drawn from the reference's numpy generator, so they equal the reference's.

Queries read syn0 on the host: :meth:`host_vectors` copies the table once
and again only after training changed it (:meth:`touch`), so a batch of
lookups costs one device read, and every row handed out is a copy that
later training leaves alone.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the current card's ``cuda:<n>``, the device its tensors
    report, so that a tensor of this table is recognised as one."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class InMemoryLookupTable:
    def __init__(self, cache: VocabCache, vector_length: int,
                 seed: int = 12345, use_hs: bool = False,
                 negative: int = 5, dtype=torch.float32,
                 init_syn0: bool = True, device=None):
        """``init_syn0=False`` skips the random init for callers about to
        install weights (loaders, GloVe). ``device=None`` means cuda (and
        raises without one); pass ``device="cpu"`` to run on the CPU."""
        self.device = _indexed(resolve_device(device))
        self.cache = cache
        self.vector_length = vector_length
        self.use_hs = use_hs
        self.negative = negative
        self.version = 0
        self._host: Optional[np.ndarray] = None
        self._host_version = -1
        n = cache.num_words()
        if init_syn0:
            rng = np.random.default_rng(seed)
            # word2vec init: uniform(-0.5, 0.5)/dim for syn0, zeros for outputs
            self.syn0 = self._tensor(
                (rng.random((n, vector_length)) - 0.5) / vector_length, dtype)
        else:
            self.syn0 = None
        self.syn1 = (torch.zeros((max(n - 1, 1), vector_length), dtype=dtype,
                                 device=self.device) if use_hs else None)
        self.syn1neg = (torch.zeros((n, vector_length), dtype=dtype,
                                    device=self.device)
                        if negative > 0 else None)
        self._unigram: Optional[np.ndarray] = None
        self._unigram_size = 0

    def _tensor(self, values, dtype=torch.float32) -> torch.Tensor:
        """``values`` (numpy or a tensor) as a tensor of its own on the
        table's device, rounded to ``dtype`` on the host as the reference's
        ``jnp.asarray(..., dtype)`` rounds."""
        if isinstance(values, torch.Tensor):
            return values.detach().to(self.device, dtype).clone()
        return torch.as_tensor(np.array(values, copy=True)).to(dtype).to(self.device)

    @property
    def syn0(self) -> Optional[torch.Tensor]:
        return self._syn0

    @syn0.setter
    def syn0(self, value) -> None:
        """Installing a table (a loader, GloVe, ``infer_vector``'s restore)
        takes it as a tensor of its own on the table's device."""
        if isinstance(value, torch.Tensor):
            if value.device != self.device:
                value = self._tensor(value, value.dtype)
        elif value is not None:
            value = self._tensor(value)
        self._syn0 = value
        self.touch()

    def touch(self) -> None:
        """Marks syn0 as changed: the next query reads it again."""
        self.version += 1

    def to(self, device=None, dtype=None) -> "InMemoryLookupTable":
        """Moves (and casts) every table to ``device`` / ``dtype`` in place
        of the old ones; ``device=None`` keeps the table's device."""
        if device is not None:
            self.device = _indexed(resolve_device(device))
        for name in ("_syn0", "syn1", "syn1neg"):
            t = getattr(self, name)
            if t is not None:
                setattr(self, name, t.to(self.device, dtype or t.dtype))
        self.touch()
        return self

    def unigram_table(self, table_size: int = 100_000,
                      power: float = 0.75) -> np.ndarray:
        """Negative-sampling table: word i appears ∝ freq(i)^0.75."""
        if self._unigram is None or self._unigram_size != table_size:
            self._unigram_size = table_size
            freqs = np.array([vw.frequency for vw in self.cache.vocab_words()],
                             np.float64)
            probs = freqs ** power
            probs /= probs.sum()
            counts = np.maximum((probs * table_size).astype(np.int64), 1)
            self._unigram = np.repeat(np.arange(len(freqs)), counts)
        return self._unigram

    def host_vectors(self) -> np.ndarray:
        """syn0 on the host: read once a change (:meth:`touch`). The array
        is shared by the queries until the next change: do not write it."""
        if self._host is None or self._host_version != self.version:
            self._host = self.syn0.detach().to("cpu", copy=True).numpy()
            self._host_version = self.version
        return self._host

    def vector(self, word: str) -> Optional[np.ndarray]:
        idx = self.cache.index_of(word)
        if idx < 0:
            return None
        return self.host_vectors()[idx].copy()

    def all_vectors(self) -> np.ndarray:
        return self.host_vectors().copy()

    def resize(self, new_rows: int, seed: int = 0) -> None:
        """Grow syn0/syn1neg for newly added vocab rows (ParagraphVectors
        label insertion). The grown tables are new tensors: the old ones
        are left as they were."""
        n, d = self.syn0.shape
        if new_rows <= n:
            return
        rng = np.random.default_rng(seed)
        extra = self._tensor((rng.random((new_rows - n, d)) - 0.5) / d,
                             self.syn0.dtype)
        self.syn0 = torch.cat([self.syn0, extra], dim=0)
        if self.syn1neg is not None:
            self.syn1neg = torch.cat(
                [self.syn1neg, torch.zeros((new_rows - n, d),
                                           dtype=self.syn1neg.dtype,
                                           device=self.device)], dim=0)
        self._unigram = None
