"""ParagraphVectors (doc2vec).

Parity with `models/paragraphvectors/ParagraphVectors.java` (1,461 LoC):
documents carry labels; label rows live in the same lookup table as words
and are trained by DM (label joins the context window) or DBOW (label
predicts document words). ``infer_vector`` trains a fresh row for an unseen
document with the table frozen.

Counterpart of the JAX package's ``nlp/paragraph_vectors.py`` on the
port's torch steps (``device=``). The steps write the tables in place, so
``infer_vector`` trains on tables of its own (the grown syn0 and syn1neg
are new tensors, syn1 a clone) and puts the model's back untouched.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from deeplearning4j_tpu_torch.nlp.learning import DBOW, DM, make_keep_prob
from deeplearning4j_tpu_torch.nlp.sentence import LabelAwareIterator, LabelledDocument
from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor, VocabWord


class ParagraphVectors(SequenceVectors):
    def __init__(self, layer_size: int = 100, window_size: int = 5,
                 negative_sample: int = 5, learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4,
                 min_word_frequency: int = 1, sampling: float = 0.0,
                 epochs: int = 1, iterations: int = 1, seed: int = 12345,
                 sequence_algorithm: str = "dm",
                 use_hierarchic_softmax: bool = False,
                 tokenizer_factory=None, device=None):
        algo = DBOW() if sequence_algorithm.lower() == "dbow" else DM()
        super().__init__(
            layer_size=layer_size, window=window_size,
            negative=negative_sample, learning_rate=learning_rate,
            min_learning_rate=min_learning_rate,
            min_word_frequency=min_word_frequency, sample=sampling,
            epochs=epochs, iterations=iterations, seed=seed,
            use_hierarchic_softmax=use_hierarchic_softmax,
            elements_algorithm=algo, device=device)
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.labels: List[str] = []

    def _to_docs(self, documents) -> List[Tuple[List[str], List[str]]]:
        """→ [(tokens, labels)]. Plain strings are auto-labelled DOC_i (the
        reference's behaviour for unlabelled sentence iterators)."""
        out = []
        for i, d in enumerate(documents):
            if isinstance(d, LabelledDocument):
                content, labels = d.content, d.labels
            elif isinstance(d, str):
                content, labels = d, [f"DOC_{i}"]
            else:
                content, labels = d
            if isinstance(content, str):
                tokens = self.tokenizer_factory.create(content).get_tokens()
            else:
                tokens = list(content)
            out.append((tokens, list(labels)))
        return out

    def fit(self, documents: Union[LabelAwareIterator, Iterable]
            ) -> "ParagraphVectors":
        docs = self._to_docs(documents)
        constructor = VocabConstructor(min_word_frequency=self.min_word_frequency)
        self.vocab = constructor.build_vocab(
            (tokens for tokens, _ in docs),
            labels=(labels for _, labels in docs))
        self.labels = [vw.word for vw in self.vocab.vocab_words() if vw.is_label]
        from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
        self.lookup_table = InMemoryLookupTable(
            self.vocab, self.layer_size, seed=self.seed,
            use_hs=self.use_hs, negative=self.negative, device=self.device)
        algo = self._make_algorithm()
        keep = make_keep_prob(self.vocab, self.sample)
        encoded = [(self._label_indices(labels), self._encode(tokens))
                   for tokens, labels in docs]
        total = (sum(len(seq) for _, seq in encoded)
                 * self.epochs * self.iterations) or 1
        seen = 0
        for _epoch in range(self.epochs):
            for label_idx, seq in encoded:
                if len(seq) == 0:
                    continue
                for _it in range(self.iterations):
                    lr = max(self.learning_rate * (1.0 - seen / total),
                             self.min_learning_rate)
                    for li in label_idx:
                        algo.train_document(li, seq, lr, keep)
                    seen += len(seq)
        return self

    def _label_indices(self, labels: Sequence[str]) -> List[int]:
        return [self.vocab.index_of(l) for l in labels
                if self.vocab.index_of(l) >= 0]

    # --------------------------------------------------------------- query

    def get_label_vector(self, label: str) -> Optional[np.ndarray]:
        return self.get_word_vector(label)

    def infer_vector(self, text: Union[str, Sequence[str]],
                     steps: int = 10, lr: float = 0.025) -> np.ndarray:
        """Train a fresh document row against the frozen table
        (ParagraphVectors.inferVector parity)."""
        if isinstance(text, str):
            tokens = self.tokenizer_factory.create(text).get_tokens()
        else:
            tokens = list(text)
        seq = self._encode(tokens)
        if len(seq) == 0:
            return np.zeros(self.layer_size, np.float32)
        # Temp row appended to the table; restore afterwards. resize()
        # makes syn0 and syn1neg new tensors, so the steps' in-place writes
        # never reach the saved ones
        import zlib
        table = self.lookup_table
        n = table.cache.num_words()
        saved_syn0, saved_syn1neg = table.syn0, table.syn1neg
        saved_syn1 = table.syn1
        content_seed = zlib.crc32(" ".join(tokens).encode("utf-8"))
        table.resize(n + 1, seed=content_seed)
        # resize() reallocates syn0/syn1neg but not syn1: the HS path (DM with
        # negative=0) would otherwise train the frozen inner-node weights
        # during inference — clone so the model table stays untouched
        if table.syn1 is not None:
            table.syn1 = table.syn1.clone()
        try:
            algo = self._make_algorithm()
            for step in range(steps):
                step_lr = max(lr * (1.0 - step / steps), self.min_learning_rate)
                algo.train_document(n, seq, step_lr)
            vec = table.syn0[n].detach().to("cpu", copy=True).numpy()
        finally:
            table.syn0, table.syn1neg = saved_syn0, saved_syn1neg
            table.syn1 = saved_syn1
            table._unigram = None
        return vec
