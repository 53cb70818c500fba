"""Constituency-tree toolkit.

Parity with the reference's tree stack: the ``Tree`` data structure
(``deeplearning4j-nn/.../autoencoder/recursive/Tree.java``) and the
``text/corpora/treeparser/`` package (TreeParser role via Penn-treebank
parsing, BinarizeTreeTransformer, CollapseUnaries, HeadWordFinder with
the classic Charniak head-rule tables, TreeVectorizer). The reference
obtains parses from an OpenNLP UIMA annotator; no parser models exist in
this image, so trees enter through the standard PTB bracketed format
(``Tree.from_penn``) — the interchange every treebank ships in.

The port's copy of the JAX package's jax-free ``nlp/trees.py``: the same
trees, transforms and vectorizer.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Tree",
    "BinarizeTreeTransformer",
    "CollapseUnaries",
    "HeadWordFinder",
    "TreeVectorizer",
]


class Tree:
    """An n-ary labeled tree; leaves carry tokens (``Tree.java``)."""

    def __init__(self, label: str, children: Optional[List["Tree"]] = None,
                 value: Optional[str] = None):
        self.label = label
        self.children: List[Tree] = list(children or [])
        self.value = value          # token text for leaves
        self.gold_label: Optional[int] = None
        self.parent: Optional[Tree] = None
        for c in self.children:
            c.parent = self

    # -- structure -----------------------------------------------------------
    def is_leaf(self) -> bool:
        return not self.children

    def is_pre_terminal(self) -> bool:
        return len(self.children) == 1 and self.children[0].is_leaf()

    def first_child(self) -> Optional["Tree"]:
        return self.children[0] if self.children else None

    def last_child(self) -> Optional["Tree"]:
        return self.children[-1] if self.children else None

    def depth(self) -> int:
        if self.is_leaf():
            return 0
        return 1 + max(c.depth() for c in self.children)

    def leaves(self) -> List["Tree"]:
        if self.is_leaf():
            return [self]
        out: List[Tree] = []
        for c in self.children:
            out.extend(c.leaves())
        return out

    def yield_words(self) -> List[str]:
        """Token sequence under this node (``Tree.yield``)."""
        return [l.value for l in self.leaves() if l.value is not None]

    def tags(self) -> List[str]:
        """Pre-terminal labels left to right."""
        if self.is_pre_terminal():
            return [self.label]
        out: List[str] = []
        for c in self.children:
            out.extend(c.tags())
        return out

    def connect(self, children: Sequence["Tree"]) -> "Tree":
        """Replace children, fixing parent pointers (``Tree.connect``)."""
        self.children = list(children)
        for c in self.children:
            c.parent = self
        return self

    def clone(self) -> "Tree":
        t = Tree(self.label, [c.clone() for c in self.children], self.value)
        t.gold_label = self.gold_label
        return t

    # -- serde ---------------------------------------------------------------
    def to_penn(self) -> str:
        if self.is_leaf():
            return self.value or ""
        inner = " ".join(c.to_penn() for c in self.children)
        return f"({self.label} {inner})"

    def __repr__(self) -> str:
        return f"Tree({self.to_penn()!r})"

    @staticmethod
    def from_penn(s: str) -> "Tree":
        """Parse one Penn-treebank bracketed sentence (TreeParser role)."""
        tokens = s.replace("(", " ( ").replace(")", " ) ").split()
        if not tokens:
            raise ValueError("empty tree string")
        pos = 0

        def parse() -> Tree:
            nonlocal pos
            if tokens[pos] != "(":
                # bare token = leaf
                leaf = Tree(label=tokens[pos], value=tokens[pos])
                pos += 1
                return leaf
            pos += 1  # consume '('
            if tokens[pos] == "(":
                # PTB empty-label wrapper: ( (S ...) )
                label = ""
            else:
                label = tokens[pos]
                pos += 1
            children: List[Tree] = []
            while pos < len(tokens) and tokens[pos] != ")":
                children.append(parse())
            if pos >= len(tokens):
                raise ValueError(f"unbalanced parens in {s!r}")
            pos += 1  # consume ')'
            return Tree(label, children)

        tree = parse()
        if pos != len(tokens):
            raise ValueError(f"trailing content in {s!r}")
        # unwrap the empty-label / ROOT wrapper down to the real clause
        while tree.label in ("", "ROOT") and len(tree.children) == 1:
            tree = tree.children[0]
            tree.parent = None
        return tree


class CollapseUnaries:
    """Skip through unary chains, keeping the top label
    (``CollapseUnaries.java``)."""

    def transform(self, tree: Tree) -> Tree:
        # leaves/pre-terminals are cloned so the result never aliases (and
        # never re-parents) nodes of the source tree
        if tree.is_pre_terminal() or tree.is_leaf():
            return tree.clone()
        children = tree.children
        while len(children) == 1 and not children[0].is_leaf() \
                and not children[0].is_pre_terminal():
            children = children[0].children
        out = Tree(tree.label, [self.transform(c) for c in children],
                   tree.value)
        out.gold_label = tree.gold_label
        return out


class BinarizeTreeTransformer:
    """Binarize n-ary nodes (``BinarizeTreeTransformer.java``).

    ``factor="right"`` (default here and in practice) splits
    ``A -> c1 c2 c3 c4`` into a right-branching chain whose intermediate
    nodes are labeled ``A@c2-c3-c4`` (the sibling labels truncated to
    ``horizontal_markov``). The reference embeds a bare ``(`` in these
    labels; a paren-free separator is used here so binarized trees stay
    round-trippable through ``to_penn``/``from_penn``.
    """

    def __init__(self, factor: str = "right", horizontal_markov: int = 999):
        if factor not in ("left", "right"):
            raise ValueError("factor must be 'left' or 'right'")
        self.factor = factor
        self.horizontal_markov = horizontal_markov

    def transform(self, tree: Tree) -> Tree:
        children = [self.transform(c) for c in tree.children]
        out = Tree(tree.label, children, tree.value)
        out.gold_label = tree.gold_label
        node = out
        while len(node.children) > 2:  # descend into each new inner node
            kids = node.children
            if self.factor == "right":
                rest = kids[1:]
                labels = [k.label for k in rest[: self.horizontal_markov]]
                inner = Tree(f"{tree.label}@{'-'.join(labels)}", rest)
                node.connect([kids[0], inner])
            else:
                rest = kids[:-1]
                labels = [k.label for k in rest[-self.horizontal_markov:]][::-1]
                inner = Tree(f"{tree.label}@{'-'.join(labels)}", rest)
                node.connect([inner, kids[-1]])
            node = inner
        return out


class HeadWordFinder:
    """Charniak-style head-percolation rules
    (``HeadWordFinder.java`` head1/head2/terminal tables)."""

    _HEAD1 = {tuple(r.split()) for r in [
        "ADJP JJ", "ADJP JJR", "ADJP JJS", "ADVP RB", "ADVP RBB", "LST LS",
        "NAC NNS", "NAC NN", "NAC PRP", "NAC NNPS", "NAC NNP", "NX NNS",
        "NX NN", "NX PRP", "NX NNPS", "NX NNP", "NP NNS", "NP NN", "NP PRP",
        "NP NNPS", "NP NNP", "NP POS", "NP $", "PP IN", "PP TO", "PP RP",
        "PRT RP", "S VP", "S1 S", "SBAR IN", "SBAR WHNP", "SBARQ SQ",
        "SBARQ VP", "SINV VP", "SQ MD", "SQ AUX", "VP VB", "VP VBZ",
        "VP VBP", "VP VBG", "VP VBN", "VP VBD", "VP AUX", "VP AUXG",
        "VP TO", "VP MD", "WHADJP WRB", "WHADVP WRB", "WHNP WP", "WHNP WDT",
        "WHNP WP$", "WHPP IN", "WHPP TO"]}
    _HEAD2 = {tuple(r.split()) for r in [
        "ADJP VBN", "ADJP RB", "NAC NP", "NAC CD", "NAC FW", "NAC ADJP",
        "NAC JJ", "NX NP", "NX CD", "NX FW", "NX ADJP", "NX JJ", "NP CD",
        "NP ADJP", "NP JJ", "S SINV", "S SBARQ", "S X", "PRT RB", "PRT IN",
        "SBAR WHADJP", "SBAR WHADVP", "SBAR WHPP", "SBARQ S", "SBARQ SINV",
        "SBARQ X", "SINV SBAR", "SQ VP"]}
    _PUNC = {"#", "$", ".", ",", ":", "-RRB-", "-LRB-", "``", "''"}

    def find_head(self, tree: Tree) -> Optional[Tree]:
        """The head WORD (leaf) of a parse tree (``findHead``)."""
        node = tree
        while not node.is_leaf():
            child = self.find_head_child(node)
            if child is None:
                return None
            node = child
        return node

    def find_head_child(self, tree: Tree) -> Optional[Tree]:
        if tree.is_leaf():
            return None
        if tree.is_pre_terminal():
            return tree.children[0]
        parent = tree.label
        for c in tree.children:                      # rule table 1, L->R
            if (parent, c.label) in self._HEAD1:
                return c
        for c in reversed(tree.children):            # rule table 2, R->L
            if (parent, c.label) in self._HEAD2:
                return c
        for c in tree.children:                      # first non-punctuation
            if c.label not in self._PUNC:
                return c
        return tree.children[0]


class TreeVectorizer:
    """Parse + normalize trees for recursive models
    (``TreeVectorizer.java``: parse, binarize, collapse unaries, attach
    gold labels)."""

    def __init__(self, binarizer: Optional[BinarizeTreeTransformer] = None,
                 collapser: Optional[CollapseUnaries] = None):
        self.binarizer = binarizer or BinarizeTreeTransformer()
        self.collapser = collapser or CollapseUnaries()

    def get_trees(self, penn_strings: Sequence[str]) -> List[Tree]:
        out = []
        for s in penn_strings:
            t = Tree.from_penn(s)
            t = self.binarizer.transform(t)
            t = self.collapser.transform(t)
            out.append(t)
        return out

    def get_trees_with_labels(self, penn_strings: Sequence[str],
                              label: str, labels: Sequence[str]) -> List[Tree]:
        """Attach the sentence label's index as gold_label on every node
        (``getTreesWithLabels``). Unknown labels raise."""
        if label not in labels:
            raise ValueError(f"label {label!r} not in label set {list(labels)}")
        idx = list(labels).index(label)
        trees = self.get_trees(penn_strings)
        for t in trees:
            self._label_all(t, idx)
        return trees

    def _label_all(self, tree: Tree, idx: int) -> None:
        tree.gold_label = idx
        for c in tree.children:
            self._label_all(c, idx)
