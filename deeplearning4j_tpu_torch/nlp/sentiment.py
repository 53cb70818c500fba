"""SentiWordNet sentiment scoring.

Parity with ``text/corpora/sentiwordnet/SWN3.java``: loads the standard
SentiWordNet 3.0 tab-separated format (POS, id, PosScore, NegScore,
SynsetTerms, ...), aggregates per ``word#pos`` with the 1/rank-weighted
average the reference computes, and scores token lists with the same
negation-flip and seven-class polarity buckets. The data file is not
vendored (it carries its own license) — point ``SWN3`` at a local copy;
a built-in ~220-word fallback lexicon (the common opinion core) keeps
the class usable without it.

The port's copy of the JAX package's jax-free ``nlp/sentiment.py``: the same
SWN3 lexicon reader and scores.
"""

from __future__ import annotations

import gzip
from typing import Dict, Iterable, List, Optional, Sequence

__all__ = ["SWN3"]

# compact fallback lexicon (word#pos -> polarity in [-1, 1]) so the API
# works without the 20 MB SentiWordNet download: ~220 of the commonest
# English sentiment words with hand-assigned polarities (the standard
# opinion-word core every public lexicon shares; magnitudes follow the
# strong/plain/weak convention 0.875 / 0.625 / 0.375)
_BUILTIN = {
    # strong positive adjectives
    "excellent#a": 0.875, "outstanding#a": 0.875, "superb#a": 0.875,
    "magnificent#a": 0.875, "exceptional#a": 0.875, "perfect#a": 0.875,
    "brilliant#a": 0.875, "amazing#a": 0.875, "fantastic#a": 0.875,
    "best#a": 0.875, "marvelous#a": 0.875, "flawless#a": 0.875,
    "stunning#a": 0.75, "terrific#a": 0.75, "awesome#a": 0.75,
    "wonderful#a": 0.75, "great#a": 0.75, "superior#a": 0.75,
    "remarkable#a": 0.75, "impressive#a": 0.75, "delightful#a": 0.75,
    "beautiful#a": 0.75, "incredible#a": 0.75, "extraordinary#a": 0.75,
    # plain positive adjectives
    "good#a": 0.625, "happy#a": 0.625, "glad#a": 0.625, "joyful#a": 0.625,
    "pleasant#a": 0.625, "enjoyable#a": 0.625, "favorable#a": 0.625,
    "positive#a": 0.625, "reliable#a": 0.625, "friendly#a": 0.625,
    "generous#a": 0.625, "honest#a": 0.625, "successful#a": 0.625,
    "effective#a": 0.625, "efficient#a": 0.625, "elegant#a": 0.625,
    "helpful#a": 0.625, "useful#a": 0.625, "valuable#a": 0.625,
    "comfortable#a": 0.625, "clean#a": 0.5, "fresh#a": 0.5,
    "smooth#a": 0.5, "strong#a": 0.5, "safe#a": 0.5, "healthy#a": 0.5,
    "nice#a": 0.5, "lovely#a": 0.625, "fine#a": 0.5,
    "solid#a": 0.5, "fast#a": 0.375, "modern#a": 0.375, "rich#a": 0.375,
    # weak positive adjectives
    "decent#a": 0.375, "adequate#a": 0.375, "acceptable#a": 0.375,
    "satisfactory#a": 0.375, "fair#a": 0.375, "okay#a": 0.25,
    "interesting#a": 0.375, "worthy#a": 0.375, "capable#a": 0.375,
    # positive verbs
    "love#v": 0.625, "enjoy#v": 0.625, "admire#v": 0.625,
    "appreciate#v": 0.625, "delight#v": 0.625, "praise#v": 0.625,
    "recommend#v": 0.625, "adore#v": 0.75, "like#v": 0.375,
    "impress#v": 0.5, "improve#v": 0.375, "succeed#v": 0.5,
    "win#v": 0.5, "help#v": 0.375, "support#v": 0.375, "thank#v": 0.5,
    "celebrate#v": 0.5, "satisfy#v": 0.5,
    # positive nouns
    "love#n": 0.625, "joy#n": 0.625, "happiness#n": 0.625,
    "pleasure#n": 0.625, "success#n": 0.625, "triumph#n": 0.625,
    "benefit#n": 0.5, "advantage#n": 0.5,
    "masterpiece#n": 0.75, "gem#n": 0.625, "winner#n": 0.5,
    "hope#n": 0.375, "friend#n": 0.375, "gift#n": 0.375,
    "comfort#n": 0.375, "strength#n": 0.375, "quality#n": 0.375,
    # positive adverbs
    "well#r": 0.5, "nicely#r": 0.5, "perfectly#r": 0.75,
    "beautifully#r": 0.625, "happily#r": 0.5, "gladly#r": 0.5,
    "smoothly#r": 0.375, "easily#r": 0.375,
    # strong negative adjectives
    "terrible#a": -0.75, "awful#a": -0.75, "horrible#a": -0.75,
    "dreadful#a": -0.75, "atrocious#a": -0.875, "abysmal#a": -0.875,
    "appalling#a": -0.875, "worst#a": -0.875, "disastrous#a": -0.875,
    "horrendous#a": -0.875, "unbearable#a": -0.75, "disgusting#a": -0.75,
    "hideous#a": -0.75, "pathetic#a": -0.75, "useless#a": -0.75,
    "worthless#a": -0.75, "dire#a": -0.625,
    # plain negative adjectives
    "bad#a": -0.625, "poor#a": -0.5, "wrong#a": -0.5, "sad#a": -0.625,
    "unhappy#a": -0.625, "angry#a": -0.625, "ugly#a": -0.625,
    "nasty#a": -0.625, "painful#a": -0.625, "unpleasant#a": -0.625,
    "negative#a": -0.5, "harmful#a": -0.625, "dangerous#a": -0.625,
    "broken#a": -0.5, "faulty#a": -0.625, "defective#a": -0.625,
    "inferior#a": -0.625, "disappointing#a": -0.625, "annoying#a": -0.625,
    "frustrating#a": -0.625, "boring#a": -0.5, "dull#a": -0.5,
    "weak#a": -0.5, "dirty#a": -0.5, "cheap#a": -0.375, "slow#a": -0.375,
    "unreliable#a": -0.625, "dishonest#a": -0.625, "rude#a": -0.625,
    "cruel#a": -0.75, "evil#a": -0.75, "toxic#a": -0.625,
    # weak negative adjectives
    "mediocre#a": -0.375, "flawed#a": -0.375, "questionable#a": -0.375,
    "awkward#a": -0.375, "messy#a": -0.375, "noisy#a": -0.25,
    "uncomfortable#a": -0.375, "confusing#a": -0.375,
    # negative verbs
    "hate#v": -0.75, "despise#v": -0.75, "loathe#v": -0.875,
    "detest#v": -0.75, "dislike#v": -0.5, "fail#v": -0.5,
    "disappoint#v": -0.625, "annoy#v": -0.5, "irritate#v": -0.5,
    "hurt#v": -0.5, "harm#v": -0.5, "damage#v": -0.5,
    "ruin#v": -0.625, "destroy#v": -0.625,
    "complain#v": -0.375, "suffer#v": -0.5, "worry#v": -0.375,
    "regret#v": -0.5, "blame#v": -0.375, "deceive#v": -0.625,
    "mislead#v": -0.5, "break#v": -0.375,
    # negative nouns
    "hate#n": -0.75, "hatred#n": -0.75, "failure#n": -0.625,
    "disaster#n": -0.75, "catastrophe#n": -0.75, "tragedy#n": -0.75,
    "problem#n": -0.375, "issue#n": -0.25, "defect#n": -0.5,
    "flaw#n": -0.375, "fault#n": -0.375,
    "loss#n": -0.5, "pain#n": -0.5, "misery#n": -0.625, "grief#n": -0.625,
    "anger#n": -0.5, "fear#n": -0.5, "disgust#n": -0.625,
    "disappointment#n": -0.625, "complaint#n": -0.375, "waste#n": -0.5,
    "garbage#n": -0.625, "junk#n": -0.5, "scam#n": -0.75, "fraud#n": -0.75,
    "liar#n": -0.625, "enemy#n": -0.5, "threat#n": -0.5, "crisis#n": -0.5,
    # negative adverbs
    "badly#r": -0.5, "poorly#r": -0.5, "terribly#r": -0.625,
    "horribly#r": -0.75, "sadly#r": -0.5, "painfully#r": -0.5,
    "wrongly#r": -0.5,
}


class SWN3:
    """Word/sentence polarity from SentiWordNet (``SWN3.java``)."""

    NEGATION_WORDS = {"could", "would", "should", "not", "hardly",
                      "barely", "isn't", "aren't",
                      "wasn't", "weren't", "haven't", "doesn't", "didn't",
                      "don't"}

    def __init__(self, senti_word_net_path: Optional[str] = None):
        if senti_word_net_path is None:
            self._dict: Dict[str, float] = dict(_BUILTIN)
        else:
            self._dict = self._load(senti_word_net_path)

    @staticmethod
    def _load(path: str) -> Dict[str, float]:
        temp: Dict[str, Dict[int, float]] = {}
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                data = line.split("\t")
                if len(data) < 5 or not data[2] or not data[3]:
                    continue
                try:
                    score = float(data[2]) - float(data[3])
                except ValueError:
                    continue
                for w in data[4].split(" "):
                    if not w or "#" not in w:
                        continue
                    term, rank_s = w.rsplit("#", 1)
                    try:
                        rank = int(rank_s)
                    except ValueError:
                        continue
                    temp.setdefault(f"{term}#{data[0]}", {})[rank] = score
        out: Dict[str, float] = {}
        for key, ranks in temp.items():
            # 1/rank-weighted mean over synset senses (SWN3.java tail)
            total = sum(s / r for r, s in ranks.items())
            norm = sum(1.0 / r for r in ranks)
            out[key] = total / norm if norm else 0.0
        return out

    # -- scoring -------------------------------------------------------------
    def extract(self, word: str) -> float:
        """Summed polarity of a word over the n/a/r/v POS entries
        (``extract``)."""
        return sum(self._dict.get(f"{word}#{pos}", 0.0)
                   for pos in ("n", "a", "r", "v"))

    def score_tokens(self, tokens: Sequence[str]) -> float:
        """Sentence score with the reference's negation flip
        (``scoreTokens``): any negation word present inverts the sum."""
        total = sum(self.extract(t.lower()) for t in tokens)
        if any(t.lower() in self.NEGATION_WORDS for t in tokens):
            total *= -1.0
        return total

    def score(self, text: str, tokenizer_factory=None) -> float:
        if tokenizer_factory is not None:
            tokens = tokenizer_factory.create(text).get_tokens()
        else:
            tokens = text.split()
        return self.score_tokens(tokens)

    def classify(self, text: str, tokenizer_factory=None) -> str:
        return self.class_for_score(self.score(text, tokenizer_factory))

    @staticmethod
    def class_for_score(score: float) -> str:
        """Seven-bucket polarity label (``classForScore``). The
        reference's conditionals overlap ("> 0.25 && <= 0.5" vs
        "> 0 && >= 0.25"); rationalized here to contiguous monotone
        buckets with the same thresholds."""
        if score >= 0.75:
            return "strong_positive"
        if score > 0.25:
            return "positive"
        if score > 0:
            return "weak_positive"
        if score == 0:
            return "neutral"
        if score >= -0.25:
            return "weak_negative"
        if score > -0.75:
            return "negative"
        return "strong_negative"
