"""Dialogue evaluation metrics: normalized token-level F1
(tasks/msdp/metrics.py, the ParlAI-derived F1Metric): lowercase, strip
punctuation and articles, bag-of-words overlap F1 averaged over pairs.
"""
from __future__ import annotations

from collections import Counter
from typing import List, Optional, Tuple


_ARTICLES = {"a", "an", "the"}
_PUNCT = set("!\"#$%&()*+,-./:;<=>?@[]\\^`{|}~_'")


def normalize_answer(s: str) -> str:
    """Lowercase, replace punctuation with spaces, drop articles, squeeze
    whitespace."""
    out = []
    for ch in s.lower():
        out.append(" " if ch in _PUNCT else ch)
    words = "".join(out).split()
    return " ".join(w for w in words if w not in _ARTICLES)


def _f1(pred: List[str], gold: List[str]) -> Tuple[float, float, float]:
    overlap = Counter(pred) & Counter(gold)
    n_same = sum(overlap.values())
    if n_same == 0:
        return 0.0, 0.0, 0.0
    precision = n_same / len(pred)
    recall = n_same / len(gold)
    return precision, recall, 2 * precision * recall / (precision + recall)


class F1Metric:
    """Token-level F1 between guesses and references."""

    @staticmethod
    def compute_each_pair(guess: str, answer: str
                          ) -> Tuple[Optional[float], Optional[float],
                                     Optional[float]]:
        if answer == "":
            return None, None, None  # no reference: pair is skipped
        if guess == "":
            return 0.0, 0.0, 0.0
        return _f1(normalize_answer(guess).split(),
                   normalize_answer(answer).split())

    @staticmethod
    def compute_all_pairs(guesses: List[str], answers: List[str]
                          ) -> Tuple[float, float, float]:
        if len(guesses) != len(answers):
            raise ValueError("guess/answer lists differ in length")
        ps, rs, f1s = [], [], []
        for guess, answer in zip(guesses, answers):
            p, r, f1 = F1Metric.compute_each_pair(guess, answer)
            if p is None:
                continue
            ps.append(p)
            rs.append(r)
            f1s.append(f1)
        if not f1s:
            return 0.0, 0.0, 0.0
        n = len(f1s)
        return sum(ps) / n, sum(rs) / n, sum(f1s) / n
