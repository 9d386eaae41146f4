"""Answer-in-passage matching for open-retrieval QA (tasks/orqa/qa_utils.py,
the standard library's `re` only): a unicode-normalising word tokenizer and
token-subsequence matching ("string"), or a regex search ("regex"), with
cumulative top-k hit counts over the retrieved passages.
"""
from __future__ import annotations

import re
import unicodedata
from typing import Dict, List, NamedTuple, Sequence, Tuple

# word = run of letters/digits (underscore excluded); anything else is
# dropped. Matches the token stream DPR's SimpleTokenizer produces for
# answer matching purposes.
_WORD_RE = re.compile(r"[^\W_]+", re.UNICODE)


def _normalize(text: str) -> str:
    return unicodedata.normalize("NFD", text)


def _words(text: str, *, lower: bool = True) -> List[str]:
    text = _normalize(text)
    if lower:
        text = text.lower()
    return _WORD_RE.findall(text)


def has_answer(answers: Sequence[str], text: str,
               match_type: str = "string") -> bool:
    """True if any answer occurs in `text` — token-subsequence match for
    'string', raw regex search for 'regex'
    (ref: qa_utils.py:113-141 has_answer)."""
    text = _normalize(text)
    if match_type == "regex":
        for ans in answers:
            try:
                if re.search(ans, text, re.IGNORECASE | re.UNICODE
                             | re.MULTILINE):
                    return True
            except re.error:
                continue
        return False
    doc = _words(text)
    for ans in answers:
        toks = _words(ans)
        if not toks:
            continue
        k = len(toks)
        for i in range(len(doc) - k + 1):
            if doc[i:i + k] == toks:
                return True
    return False


class QAMatchStats(NamedTuple):
    top_k_hits: List[int]
    questions_doc_hits: List[List[bool]]


def calculate_matches(all_docs: Dict[object, Tuple[str, str]],
                      answers: List[List[str]],
                      closest_docs: List[Tuple[Sequence[object],
                                               Sequence[float]]],
                      match_type: str = "string") -> QAMatchStats:
    """For each question, check its top-k retrieved docs for the answer;
    accumulate cumulative top-k hit counts
    (ref: qa_utils.py:32-84 calculate_matches). `all_docs` maps
    doc_id -> (text, title); `closest_docs[q]` is (doc_ids, scores)."""
    n_docs = len(closest_docs[0][0]) if closest_docs else 0
    top_k_hits = [0] * n_docs
    per_question: List[List[bool]] = []
    for q_answers, (doc_ids, _scores) in zip(answers, closest_docs):
        hits = []
        for doc_id in doc_ids:
            doc = all_docs.get(doc_id)
            text = doc[0] if doc else None
            hits.append(bool(text) and has_answer(q_answers, text,
                                                  match_type))
        per_question.append(hits)
        first = next((i for i, h in enumerate(hits) if h), None)
        if first is not None:
            for i in range(first, n_docs):
                top_k_hits[i] += 1
    return QAMatchStats(top_k_hits, per_question)
