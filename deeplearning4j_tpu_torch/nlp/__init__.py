"""NLP: embedding trainers, tokenization, vocab, vectorizers.

TPU-native re-design of the reference's `deeplearning4j-nlp` module
(SURVEY.md §2 "NLP: SequenceVectors family", 26.5k LoC):
`SequenceVectors.java` / `Word2Vec.java` / `ParagraphVectors.java` /
`Glove.java`. The reference trains embeddings hogwild-style — N JVM threads
racing on `InMemoryLookupTable` rows with no locks. Hogwild has no jit
analog; here training is deterministic minibatched scatter-add under a
single jit step (SURVEY.md §7 "Hard parts"), which keeps the MXU busy with
one big gather→dot→scatter per batch instead of millions of tiny row ops.

The port's ``nlp/``: the reference's exports, its jax-free modules copied
and its training steps, lookup table and serializer on torch (one gather →
products → ``index_add_`` step a batch on the table's device). The
embedding models, the lookup table and the serializer's readers take
``device=`` (None means the card). ``distributed.py`` waits for the
multi-device slice.
"""

from deeplearning4j_tpu_torch.nlp.tokenization import (
    CommonPreprocessor,
    DefaultTokenizer,
    DefaultTokenizerFactory,
    NGramTokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.dictionary_tokenizer import (
    DictionaryTokenizerFactory,
    MorphologicalDictionary,
)
from deeplearning4j_tpu_torch.nlp.sentence import (
    AggregatingSentenceIterator,
    BasicLabelAwareIterator,
    BasicLineIterator,
    CollectionSentenceIterator,
    FileDocumentIterator,
    FileLabelAwareIterator,
    FilenamesLabelAwareIterator,
    FileSentenceIterator,
    LabelsSource,
    LineSentenceIterator,
    MutipleEpochsSentenceIterator,
    PrefetchingSentenceIterator,
    StreamLineIterator,
    SynchronizedSentenceIterator,
)
from deeplearning4j_tpu_torch.nlp.cnn_sentence import (
    CnnSentenceDataSetIterator,
    CollectionLabeledSentenceProvider,
    FileLabeledSentenceProvider,
    LabelAwareConverter,
    LabeledSentenceProvider,
)
from deeplearning4j_tpu_torch.nlp.stemming import (
    CustomStemmingPreprocessor,
    EmbeddedStemmingPreprocessor,
    PorterStemmer,
    PosTokenizerFactory,
    StemmingPreprocessor,
)
from deeplearning4j_tpu_torch.nlp.sentiment import SWN3
from deeplearning4j_tpu_torch.nlp.trees import (
    BinarizeTreeTransformer,
    CollapseUnaries,
    HeadWordFinder,
    Tree,
    TreeVectorizer,
)
from deeplearning4j_tpu_torch.nlp.text_utils import (
    InMemoryInvertedIndex,
    InputHomogenization,
    StopWords,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabConstructor, VocabWord
from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import ParagraphVectors
from deeplearning4j_tpu_torch.nlp.glove import Glove
from deeplearning4j_tpu_torch.nlp.serializer import WordVectorSerializer
from deeplearning4j_tpu_torch.nlp.vectorizer import (
    BagOfWordsVectorizer,
    TfidfVectorizer,
)

__all__ = [
    "AggregatingSentenceIterator", "BagOfWordsVectorizer",
    "CnnSentenceDataSetIterator", "CollectionLabeledSentenceProvider",
    "FileLabeledSentenceProvider", "LabelAwareConverter",
    "LabeledSentenceProvider",
    "BinarizeTreeTransformer", "CollapseUnaries", "CustomStemmingPreprocessor",
    "EmbeddedStemmingPreprocessor", "HeadWordFinder", "PorterStemmer",
    "PosTokenizerFactory", "SWN3", "StemmingPreprocessor", "Tree",
    "TreeVectorizer",
    "BasicLabelAwareIterator", "BasicLineIterator",
    "CollectionSentenceIterator", "CommonPreprocessor", "DefaultTokenizer",
    "DefaultTokenizerFactory", "DictionaryTokenizerFactory",
    "FileDocumentIterator", "FileLabelAwareIterator",
    "FilenamesLabelAwareIterator", "FileSentenceIterator", "Glove",
    "InMemoryInvertedIndex", "InMemoryLookupTable", "InputHomogenization",
    "LabelsSource", "LineSentenceIterator", "MorphologicalDictionary",
    "MutipleEpochsSentenceIterator", "NGramTokenizerFactory",
    "ParagraphVectors", "PrefetchingSentenceIterator", "SequenceVectors",
    "StopWords", "StreamLineIterator", "SynchronizedSentenceIterator",
    "TfidfVectorizer", "VocabCache", "VocabConstructor", "VocabWord",
    "Word2Vec", "WordVectorSerializer",
]
