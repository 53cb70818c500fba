"""The port's text tooling (copies of the JAX package's jax-free ``nlp/``
modules) against the reference on the CPU.

One test a module, parametrized over cases taken from the reference's own
tests (``test_nlp.py``, ``test_nlp_text_pipeline.py``,
``test_nlp_uima_pack.py``, ``test_dictionary_tokenizer.py``): each case runs
the same calls on both packages' module, each in a directory of its own,
and their results, made plain (arrays as dtype, shape and values; trees as
Penn strings; documents as content and labels; exceptions as their type),
must be equal. Iterators with a producer thread are joined with a bound.
"""

import dataclasses
import importlib
import os
import threading

import numpy as np
import pytest

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
JA_DICT = os.path.join(FIXTURES, "mini_ja_dict")
JA_EVAL = os.path.join(FIXTURES, "ja_eval_dict")
JA_CORPUS = [os.path.join(FIXTURES, "ja_tagged_corpus.tsv"),
             os.path.join(FIXTURES, "ja_tagged_corpus_traps.tsv")]
PTB = "(S (NP (DT the) (NN cat)) (VP (VBZ sits) (PP (IN on) (NP (DT the) (NN mat)))))"
PACKAGES = ("deeplearning4j_tpu", "deeplearning4j_tpu_torch")


def plain(x):
    """A comparable form of a result."""
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape, x.tolist())
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (set, frozenset)):
        return ("set", sorted(plain(v) for v in x))
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if hasattr(x, "to_penn"):
        return ("tree", x.to_penn(), getattr(x, "gold_label", None), x.value)
    if type(x).__name__ == "LabelledDocument":
        return ("doc", x.content, list(x.labels))
    if hasattr(x, "get_tokens"):
        return ("tokens", x.get_tokens())
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, plain(dataclasses.astuple(x)))
    if type(x).__name__ == "Window":
        return ("window", x.words, x.label, x.begin_label, x.end_label, x.focus_word())
    return x


def run(case, pkg, tmp):
    """``case(module getter, directory)``, its result or its exception's
    type made plain."""
    def m(name):
        return importlib.import_module(f"{pkg}.nlp.{name}")
    os.makedirs(tmp, exist_ok=True)
    try:
        return plain(case(m, tmp))
    except Exception as e:  # the exception is the result to compare
        return ("raises", type(e).__name__)


def check(case, tmp_path):
    ref, port = (run(case, pkg, str(tmp_path / pkg)) for pkg in PACKAGES)
    assert port == ref


def _files(tmp, spec):
    """Writes ``{relative path: text}`` under ``tmp``; returns ``tmp``."""
    for rel, text in spec.items():
        p = os.path.join(tmp, rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "w", encoding="utf-8") as f:
            f.write(text)
    return tmp


# ------------------------------------------------------------ tokenization

TOKENIZATION = {
    "default_common": lambda m, t: m("tokenization").DefaultTokenizerFactory(
        m("tokenization").CommonPreprocessor()).create("Hello, World! 123 foo-bar").get_tokens(),
    "default_plain": lambda m, t: m("tokenization").DefaultTokenizer(
        "  a\tb  Café ").get_tokens(),
    "ngram_1_2": lambda m, t: m("tokenization").NGramTokenizerFactory(1, 2).create(
        "a b c").get_tokens(),
    "ngram_2_3": lambda m, t: m("tokenization").NGramTokenizerFactory(2, 3).create(
        "the quick brown fox").get_tokens(),
    "lowcase_count": lambda m, t: (lambda tok: (tok.get_tokens(), tok.count_tokens(),
                                                list(tok)))(
        m("tokenization").DefaultTokenizerFactory(
            m("tokenization").LowCasePreProcessor()).create("ONE Two three")),
    "common_edge_tokens": lambda m, t: [m("tokenization").CommonPreprocessor().pre_process(s)
                                        for s in ("123", "...", "Ünïcode!", "a1b2", "")],
}


@pytest.mark.parametrize("case", list(TOKENIZATION))
def test_tokenization(case, tmp_path):
    check(TOKENIZATION[case], tmp_path)


# -------------------------------------------------------------- text_utils

def _inverted_index(m, t):
    idx = m("text_utils").InMemoryInvertedIndex()
    idx.add_words_to_doc(0, ["the", "cat"])
    idx.add_words_to_doc(1, ["the", "dog"])
    return [idx.documents("the"), idx.documents("cat"), idx.document(1),
            idx.num_documents(), idx.total_words(), idx.words(),
            list(idx.batch_iter(1))]


TEXT_UTILS = {
    "homogenize": lambda m, t: m("text_utils").InputHomogenization(
        "Hello, World!!! 42").transform(),
    "homogenize_case": lambda m, t: m("text_utils").InputHomogenization(
        "ABC", preserve_case=True).transform(),
    "homogenize_ignored": lambda m, t: [m("text_utils").InputHomogenization(
        "a.b", ignore_characters_containing=["."]).transform(),
        m("text_utils").InputHomogenization("a.b").transform()],
    "stop_words": lambda m, t: m("text_utils").StopWords.get_stop_words(),
    "inverted_index": _inverted_index,
}


@pytest.mark.parametrize("case", list(TEXT_UTILS))
def test_text_utils(case, tmp_path):
    check(TEXT_UTILS[case], tmp_path)


# ---------------------------------------------------------------- stemming

PORTER = ["caresses", "ponies", "cats", "feed", "agreed", "plastered", "motoring",
          "sing", "conflated", "happy", "relational", "conditional", "rational",
          "digitizer", "operator", "feudalism", "decisiveness", "hopefulness",
          "formaliti", "triplicate", "formative", "formalize", "electrical",
          "hopeful", "goodness", "revival", "allowance", "inference", "airliner",
          "adoption", "activate", "probate", "controll", "roll"]


def _pos_corpus_tags(m, t):
    with open(os.path.join(FIXTURES, "en_pos_corpus.tsv"), encoding="utf-8") as f:
        return [m("stemming").heuristic_pos_tagger([p.rsplit("/", 1)[0] for p in line.split()])
                for line in f]


class _Lower:
    def pre_process(self, t):
        return t.lower()


class _Three:
    def stem(self, t):
        return t[:3]


STEMMING = {
    "porter": lambda m, t: [m("stemming").PorterStemmer().stem(w) for w in PORTER],
    "preprocessor": lambda m, t: m("stemming").StemmingPreprocessor().pre_process("Motoring,"),
    "embedded": lambda m, t: m("stemming").EmbeddedStemmingPreprocessor(
        _Lower()).pre_process("MOTORING"),
    "custom": lambda m, t: m("stemming").CustomStemmingPreprocessor(
        _Three()).pre_process("abcdef"),
    "tagger_rules": lambda m, t: [m("stemming").heuristic_pos_tagger(s) for s in (
        ["the", "cat", "is", "running", "quickly"], ["they", "have", "walked", "home"],
        ["to", "buy", "milk"], ["will", "probably", "win"],
        ["My", "brother", "must", "buy", "three", "eggs", "."],
        ["The", "US", "economy"], ["In", "May", "we", "met"], ["May", "I", "help"],
        ["It", "costs", ".5", "dollars"])],
    "tagger_corpus": _pos_corpus_tags,
    "pos_none": lambda m, t: m("stemming").PosTokenizerFactory(
        allowed_pos_tags={"NN", "NNS"}).create("the cat is running").get_tokens(),
    "pos_stemmed": lambda m, t: (lambda tf: (tf.set_token_pre_processor(
        m("stemming").StemmingPreprocessor()), tf.create("the cat is running").get_tokens()))(
        m("stemming").PosTokenizerFactory(allowed_pos_tags={"NN", "VBG"}))[1],
    "pos_strip": lambda m, t: m("stemming").PosTokenizerFactory(
        allowed_pos_tags={"NN"}, strip_nones=True).create("the cat sat <TAG>").get_tokens(),
    "pos_custom_tagger": lambda m, t: m("stemming").PosTokenizerFactory(
        allowed_pos_tags={"KEEP"},
        tagger=lambda ts: ["KEEP" if x == "x" else "DROP" for x in ts]).create(
        "x y x").get_tokens(),
}


@pytest.mark.parametrize("case", list(STEMMING))
def test_stemming(case, tmp_path):
    check(STEMMING[case], tmp_path)


# ----------------------------------------------------- dictionary_tokenizer

def _ja_greedy_and_lattice(m, t):
    dt = m("dictionary_tokenizer")
    d = dt.derive_dictionary_from_tagged_corpus(JA_CORPUS)
    return [[e.surface for e in dt.viterbi_segment("くるまでまつ。", d)],
            dt.greedy_segment("くるまでまつ。", d),
            dt.evaluate_segmentation(JA_CORPUS, d)]


def _ja_unknowns(m, t):
    dt = m("dictionary_tokenizer")
    d = dt.derive_dictionary_from_tagged_corpus(JA_CORPUS)
    d._by_surface.pop("牛乳", None)
    empty = dt.MorphologicalDictionary([])
    return [dt.viterbi_segment(s, d) for s in ("私はテレビゲームです。", "私はABC123です。",
                                               "子供は牛乳を飲みました。")] + \
        [dt.viterbi_segment("カメラ2024ABCで写真を撮る!", empty)]


DICTIONARY = {
    "mini_lattice": lambda m, t: [m("dictionary_tokenizer").viterbi_segment(
        s, m("dictionary_tokenizer").MorphologicalDictionary.load(JA_DICT))
        for s in ("すもももももももものうち", "食べた", "もXもY", "")],
    "mini_factory": lambda m, t: [
        m("dictionary_tokenizer").DictionaryTokenizerFactory.from_path(JA_DICT).create(
            "すもももももももものうち").get_tokens(),
        m("dictionary_tokenizer").DictionaryTokenizerFactory(
            m("dictionary_tokenizer").MorphologicalDictionary.load(JA_DICT),
            use_base_form=True).create("食べた").get_tokens()],
    "csv_load": lambda m, t: sorted(e.surface for e in m(
        "dictionary_tokenizer").MorphologicalDictionary.load(
        _files(t, {"d.csv": "abc,1,1,100,pos\nab,1,1,50,pos\n"}) + "/d.csv").lookup("abc", 0)),
    "eval_dict": lambda m, t: [m("dictionary_tokenizer").viterbi_segment(
        s, m("dictionary_tokenizer").MorphologicalDictionary.load(JA_EVAL))
        for s in ("すもももももももものうち。", "魚を食べた犬。")],
    "bootstrapped": _ja_greedy_and_lattice,
    "unigram": lambda m, t: m("dictionary_tokenizer").evaluate_segmentation(
        JA_CORPUS, m("dictionary_tokenizer").derive_dictionary_from_tagged_corpus(
            JA_CORPUS, bigram=False)),
    "unknowns": _ja_unknowns,
}


@pytest.mark.parametrize("case", list(DICTIONARY))
def test_dictionary_tokenizer(case, tmp_path):
    check(DICTIONARY[case], tmp_path)


# ---------------------------------------------------------- language_packs

def _zh(m, t):
    d = m("dictionary_tokenizer").derive_dictionary_from_tagged_corpus(
        os.path.join(FIXTURES, "zh_tagged_corpus.tsv"))
    lp = m("language_packs")
    return [lp.ChineseTokenizerFactory(dictionary=d).create("他研究生命的起源").get_tokens(),
            lp.ChineseTokenizerFactory(dictionary=set(d._by_surface)).create(
                "他研究生命的起源").get_tokens(),
            lp.ChineseTokenizerFactory().create("我爱 NLP 2024!").get_tokens()]


LANGUAGE_PACKS = {
    "chinese": _zh,
    "japanese": lambda m, t: [m("language_packs").JapaneseTokenizerFactory(
        dictionary=set(m("dictionary_tokenizer").MorphologicalDictionary.load(
            JA_EVAL)._by_surface)).create(s).get_tokens()
        for s in ("すもももももももものうち。", "魚を食べた犬。カメラ")],
    "korean": lambda m, t: [m("language_packs").KoreanTokenizerFactory(
        strip_josa=s).create("나는 학교에 갑니다 서울에서").get_tokens() for s in (False, True)],
    "uima": lambda m, t: [m("language_packs").UimaTokenizerFactory.segment_sentences(
        "One two. Three four! Five?"),
        m("language_packs").UimaTokenizerFactory().create(
            "One two. Three four! Five?").get_tokens()],
}


@pytest.mark.parametrize("case", list(LANGUAGE_PACKS))
def test_language_packs(case, tmp_path):
    check(LANGUAGE_PACKS[case], tmp_path)


# ---------------------------------------------------------------- sentence

def _drain(it):
    out = []
    it.reset()
    while it.has_next():
        out.append(it.next_sentence())
    return out


def _prefetching(m, t):
    s = m("sentence")
    src = [str(i) for i in range(100)]
    it = s.PrefetchingSentenceIterator(s.CollectionSentenceIterator(src), 8)
    try:
        return [list(it), list(it)]
    finally:
        thread = getattr(it, "_thread", None)
        if thread is not None:
            thread.join(timeout=10)
            assert not thread.is_alive()


def _prefetching_error(m, t):
    s = m("sentence")

    class Exploding(s.CollectionSentenceIterator):
        def next_sentence(self):
            if self._pos >= 2:
                raise IOError("disk on fire")
            return super().next_sentence()

    it = s.PrefetchingSentenceIterator(Exploding(["a", "b", "c", "d"]), 1)
    got = []
    try:
        while it.has_next():
            got.append(it.next_sentence())
    except IOError:
        got.append("raised")
    thread = getattr(it, "_thread", None)
    if thread is not None:
        thread.join(timeout=10)
        assert not thread.is_alive()
    return got


def _synchronized(m, t):
    s = m("sentence")
    src = [str(i) for i in range(300)]
    it = s.SynchronizedSentenceIterator(s.CollectionSentenceIterator(src))
    it.reset()
    seen, lock = [], threading.Lock()

    def consume():
        while (x := it.next_sentence()) is not None:
            with lock:
                seen.append(x)

    threads = [threading.Thread(target=consume) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
        assert not th.is_alive()
    return sorted(seen, key=int)


def _labels_source(m, t):
    s = m("sentence")
    a = s.LabelsSource("DOC_%d")
    b = s.LabelsSource("SENT_")
    c = s.LabelsSource(["a", "b"])
    d = s.LabelsSource("DOC_%d")
    d.store_label("extra")
    out = [a.next_label(), a.next_label(), a.get_labels(), b.next_label(),
           c.next_label(), d.next_label(), d.next_label()]
    c.store_label("c")
    c.store_label("c")
    return out + [c.get_labels(), c.index_of("c")]


def _label_aware(m, t):
    s = m("sentence")
    _files(t, {"pos/0.txt": "good", "pos/1.txt": "great", "neg/0.txt": "bad"})
    it = s.FileLabelAwareIterator.builder().add_source_folder(t).build()
    basic = s.BasicLabelAwareIterator(s.CollectionSentenceIterator(["d0", "d1"]),
                                      s.LabelsSource("DOC_%d"))
    names = s.FilenamesLabelAwareIterator(os.path.join(t, "pos"))
    return [sorted(plain(list(it))), sorted(it.labels_source.get_labels()),
            list(basic), basic.labels_source.get_labels(), list(names),
            list(s.LabelAwareIterator([("doc one", ["a"]), ("doc two", ["b"])]))]


SENTENCE = {
    "collection_pre": lambda m, t: (lambda it: (it.set_pre_processor(str.lower),
                                                list(it), _drain(it)))(
        m("sentence").CollectionSentenceIterator(["Hello World", "BYE"]))[1:],
    "line_file": lambda m, t: (lambda it: [list(it), list(it)])(
        m("sentence").LineSentenceIterator(_files(t, {"f.txt": "one\ntwo\nthree\n"})
                                           + "/f.txt")),
    "basic_line": lambda m, t: _drain(m("sentence").BasicLineIterator(
        _files(t, {"f.txt": "a b\n\nc\n"}) + "/f.txt")),
    "file_sentences": lambda m, t: _drain(m("sentence").FileSentenceIterator(
        _files(t, {"c/a.txt": "one\ntwo\n", "c/b.txt": "three\n"}) + "/c")),
    "stream_documents": lambda m, t: list(m("sentence").StreamLineIterator(
        m("sentence").FileDocumentIterator(_files(t, {"d/a.txt": "l1\nl2", "d/b.txt": "l3"})
                                           + "/d"))),
    "stream_generator": lambda m, t: (lambda it: [list(it), list(it)])(
        m("sentence").StreamLineIterator(iter(["a\nb", "c"]))),
    "aggregating": lambda m, t: list(m("sentence").AggregatingSentenceIterator.builder()
                                     .add_sentence_iterator(
                                         m("sentence").CollectionSentenceIterator(["A", "B"]))
                                     .add_sentence_iterator(
                                         m("sentence").CollectionSentenceIterator(["C"]))
                                     .add_sentence_pre_processor(str.lower).build()),
    "epochs": lambda m, t: list(m("sentence").MutipleEpochsSentenceIterator(
        m("sentence").CollectionSentenceIterator(["x", "y"]), 3)),
    "epochs_zero": lambda m, t: m("sentence").MutipleEpochsSentenceIterator(
        m("sentence").CollectionSentenceIterator([]), 0),
    "prefetching": _prefetching,
    "prefetching_error": _prefetching_error,
    "synchronized": _synchronized,
    "documents": lambda m, t: list(m("sentence").FileDocumentIterator(
        _files(t, {"d/1.txt": "first doc", "d/2.txt": "second doc"}) + "/d")),
    "labels_source": _labels_source,
    "label_aware": _label_aware,
}


@pytest.mark.parametrize("case", list(SENTENCE))
def test_sentence(case, tmp_path):
    check(SENTENCE[case], tmp_path)


# --------------------------------------------------------------- sentiment

SENTIMENT = {
    "builtin": lambda m, t: (lambda swn: [
        swn.extract(w) for w in ("good", "terrible", "pretty", "please", "praise",
                                 "delight", "waste", "damage", "anger", "love", "zzz")] + [
        swn.score(s) for s in ("a good movie", "not a good movie", "Not a good movie",
                               "hardly a good movie", "barely acceptable")] + [
        swn.classify(s) for s in ("pretty bad", "an outstanding and memorable masterpiece",
                                  "a dreadful waste of time , confusing and dull")] + [
        swn.class_for_score(v) for v in (0.8, -0.8, 0.0, 0.3, -0.3, 0.1)])(
        m("sentiment").SWN3()),
    "swn_file": lambda m, t: (lambda swn: [swn.extract(w) for w in ("good", "unspoiled", "bad")]
                              + [swn.classify("bad bad bad")])(m("sentiment").SWN3(
        _files(t, {"swn.txt": "# comment line\n"
                              "a\t001\t0.75\t0\tgood#1 unspoiled#2\tgloss text\n"
                              "a\t002\t0\t0.625\tbad#1\tgloss\n"
                              "v\t003\t0.5\t0\tgood#1\tgloss\n"}) + "/swn.txt")),
    "score_tokens": lambda m, t: m("sentiment").SWN3().score_tokens(
        ["not", "bad", "at", "all", "great"]),
}


@pytest.mark.parametrize("case", list(SENTIMENT))
def test_sentiment(case, tmp_path):
    check(SENTIMENT[case], tmp_path)


# ------------------------------------------------------------------- trees

def _tree_parts(m, t):
    tree = m("trees").Tree.from_penn(PTB)
    np_ = tree.children[0]
    return [tree.yield_words(), tree.tags(), tree.depth(), tree.first_child().label,
            np_.is_leaf(), np_.is_pre_terminal(), np_.children[0].is_pre_terminal(),
            m("trees").Tree.from_penn(tree.to_penn()).to_penn(),
            m("trees").Tree.from_penn("( (S (NP (NN dog)) (VP (VBZ barks))) )")]


def _collapse_keeps_source(m, t):
    t1 = m("trees").Tree.from_penn("(S (X (NP (DT the) (NN cat))))")
    np_node = t1.children[0].children[0]
    out = m("trees").CollapseUnaries().transform(t1)
    return [out, np_node.parent is t1.children[0], t1.to_penn()]


TREES = {
    "parse": _tree_parts,
    "unbalanced": lambda m, t: m("trees").Tree.from_penn("(S (NP"),
    "trailing": lambda m, t: m("trees").Tree.from_penn("(S a)) extra"),
    "binarize_right": lambda m, t: m("trees").BinarizeTreeTransformer().transform(
        m("trees").Tree.from_penn("(X (A a) (B b) (C c) (D d))")),
    "binarize_left": lambda m, t: m("trees").BinarizeTreeTransformer(factor="left").transform(
        m("trees").Tree.from_penn("(X (A a) (B b) (C c))")),
    "collapse": lambda m, t: m("trees").CollapseUnaries().transform(
        m("trees").Tree.from_penn("(S (X (Y (NP (DT the) (NN cat)))))")),
    "collapse_source": _collapse_keeps_source,
    "vectorizer": lambda m, t: [m("trees").TreeVectorizer().get_trees([PTB]),
                                m("trees").TreeVectorizer().get_trees_with_labels(
                                    [PTB], "pos", ["neg", "pos"])],
    "vectorizer_missing": lambda m, t: m("trees").TreeVectorizer().get_trees_with_labels(
        [PTB], "missing", ["neg", "pos"]),
    "head_words": lambda m, t: (lambda tree, hf: [hf.find_head(tree).value,
                                                  hf.find_head(tree.children[0]).value,
                                                  hf.find_head_child(tree).label])(
        m("trees").Tree.from_penn(PTB), m("trees").HeadWordFinder()),
}


@pytest.mark.parametrize("case", list(TREES))
def test_trees(case, tmp_path):
    check(TREES[case], tmp_path)


# ------------------------------------------------------------ movingwindow

class _Vecs:
    def vector(self, w):
        return {"a": [1.0, 0.0], "b": [0.0, 2.0]}.get(w)


class _Scalar:
    def vector(self, w):
        return [3.0] if w == "a" else None


MOVINGWINDOW = {
    "windows": lambda m, t: m("movingwindow").windows("the quick brown", 3),
    "windows_tokens": lambda m, t: m("movingwindow").windows(
        ["a", "b", "c", "d", "e", "f"], 5),
    "labels": lambda m, t: m("movingwindow").Window(["<LOC>", "york", "</LOC>"], 3, 0, 3),
    "example_array": lambda m, t: [
        m("movingwindow").as_example_array(m("movingwindow").Window(["a", "b", "a"], 3, 0, 3),
                                           _Vecs(), normalize=n) for n in (False, True)],
    "example_matrix": lambda m, t: m("movingwindow").as_example_matrix(
        m("movingwindow").Window(["a", "zz", "a"], 3, 0, 3), _Scalar()),
    "string_with_labels": lambda m, t: m("movingwindow").string_with_labels(
        "i live in <LOC> new york </LOC> now"),
    "string_broken": lambda m, t: m("movingwindow").string_with_labels("broken </LOC> here"),
    "position": lambda m, t: [m("movingwindow").window_for_word_in_position(
        5, i, ["a", "b", "c", "d"]) for i in range(4)],
}


@pytest.mark.parametrize("case", list(MOVINGWINDOW))
def test_movingwindow(case, tmp_path):
    check(MOVINGWINDOW[case], tmp_path)


# -------------------------------------------------------------- vectorizer

def _bow(m, t):
    v = m("vectorizer").BagOfWordsVectorizer(min_word_frequency=1)
    return [v.fit_transform(["a b a", "b c"]), v.vocab.words(),
            v.transform(["c c a zzz"])]


def _tfidf(m, t):
    v = m("vectorizer").TfidfVectorizer(min_word_frequency=1)
    return [v.fit_transform(["a b", "a c", "a d"]), v.vocab.words(),
            v.tfidf_word("b", ["a", "b"]), v.transform([["b", "d", "d"]])]


VECTORIZER = {
    "bag_of_words": _bow,
    "tfidf": _tfidf,
    "cutoff": lambda m, t: (lambda v: [v.fit_transform(["x y y", "y z", "x"]),
                                       v.vocab.words()])(
        m("vectorizer").BagOfWordsVectorizer(min_word_frequency=2)),
}


@pytest.mark.parametrize("case", list(VECTORIZER))
def test_vectorizer(case, tmp_path):
    check(VECTORIZER[case], tmp_path)
