"""Corpus detokenizers for zero-shot LM evaluation
(tasks/zeroshot_gpt/detokenizer.py).

WikiText-103 ships pre-tokenized with `@-@`-style joiners and spaced
punctuation; perplexity is reported against the detokenized text, so the
published normalization rules are applied in the same order as the
reference applies them.
"""
from __future__ import annotations

import re

_PTB_SUBS = (
    (" '", "'"), (" \n", "\n"), ("\n ", "\n"), (" n't", "n't"),
    (" N ", "1 "), ("$ 1", "$1"), ("# 1", "#1"),
)

# plain string replacements, applied in order
_WIKI_SUBS = (
    ("s '", "s'"),
    (" @-@ ", "-"), (" @,@ ", ","), (" @.@ ", "."),          # joiners
    (" : ", ": "), (" ; ", "; "), (" . ", ". "), (" ! ", "! "),
    (" ? ", "? "), (" , ", ", "),                            # punctuation
    ("= = = =", "===="), ("= = =", "==="), ("= =", "=="),    # headings
    (" ° ", "°"),
    (" \n", "\n"), ("\n ", "\n"),
    (" N ", " 1 "), (" 's", "'s"),
)

# bracket-pair tightening: "( x )" -> "(x)" etc.
_WIKI_RES = (
    (re.compile(r"/' [0-9]/"), r"/'[0-9]/"),
    (re.compile(r"\(\s*([^\)]*?)\s*\)"), r"(\1)"),
    (re.compile(r"\[\s*([^\]]*?)\s*\]"), r"[\1]"),
    (re.compile(r"{\s*([^}]*?)\s*}"), r"{\1}"),
    (re.compile(r"\"\s*([^\"]*?)\s*\""), r'"\1"'),
    (re.compile(r"'\s*([^']*?)\s*'"), r"'\1'"),
)


def ptb_detokenizer(text: str) -> str:
    for old, new in _PTB_SUBS:
        text = text.replace(old, new)
    return text


def wikitext_detokenizer(text: str) -> str:
    # contractions, joiners and punctuation, then the bracket tightening,
    # then headings and the rest: the published rules' order
    text = text.replace("s '", "s'")
    text = _WIKI_RES[0][0].sub(_WIKI_RES[0][1], text)
    for old, new in _WIKI_SUBS[1:10]:
        text = text.replace(old, new)
    for pat, rep in _WIKI_RES[1:]:
        text = pat.sub(rep, text)
    for old, new in _WIKI_SUBS[10:]:
        text = text.replace(old, new)
    return text


def lambada_detokenizer(text: str) -> str:
    return text


_BY_HINT = {
    "ptb": ptb_detokenizer,
    "wiki": wikitext_detokenizer,
    "lambada": lambada_detokenizer,
}


def get_detokenizer(path: str):
    """The detokenizer whose hint is a substring of the data path."""
    for hint, fn in _BY_HINT.items():
        if hint in path:
            return fn
    return lambada_detokenizer
