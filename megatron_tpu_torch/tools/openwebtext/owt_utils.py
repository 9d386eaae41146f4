"""Shared helpers for the openwebtext corpus-cleaning suite.

The port's copy of the root tools/openwebtext/owt_utils.py.

Self-contained stand-ins for the reference suite's external dependencies
(ref: tools/openwebtext/README.md lists ftfy, langdetect, tldextract and
the mattilyra/LSH minhash package — none are vendored here):

- `fix_text`: the high-frequency subset of ftfy's repairs — mojibake from
  latin-1/cp1252 round-trips, unicode NFC normalization, control-char and
  stray-BOM removal.
- `looks_english`: a stopword-hit-rate + ascii-ratio heuristic in place of
  langdetect (the corpus filter only needs a coarse en/non-en split).
- `registered_domain`: urlparse + public-suffix-ish heuristics in place of
  tldextract.
- `MinHasher` / `LshIndex`: numpy minhash fingerprints + banded LSH
  buckets, the same candidate-generation scheme as the reference's lsh
  package (ref: find_duplicates.py:34-41,150-200).
"""
from __future__ import annotations

import hashlib
import json
import re
import unicodedata
from typing import Iterable, Iterator, List, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# text repair / language heuristics
# ---------------------------------------------------------------------------

_MOJIBAKE = {
    "â": "'", "â": "'",
    "â": '"', "â": '"',
    "â": "–", "â": "—",
    "â¦": "…",
    "Ã©": "é", "Ã¨": "è",
    "Ã¡": "á", "Ã³": "ó",
    "Ãº": "ú", "Ã±": "ñ",
    "Â ": " ",
}
_CTRL = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f\x7f﻿]")


def fix_text(text: str) -> str:
    """Light ftfy: undo common cp1252 mojibake, normalize to NFC, strip
    control characters and BOMs."""
    if any(k in text for k in _MOJIBAKE):
        for bad, good in _MOJIBAKE.items():
            text = text.replace(bad, good)
    # full round-trip repair when the text looks double-encoded: cp1252
    # first (the visible "â€™"-style mojibake: € and ™ are cp1252-only),
    # then latin-1 (the raw \x80-\x9f control variant)
    for enc in ("cp1252", "latin-1"):
        try:
            candidate = text.encode(enc).decode("utf-8")
        except (UnicodeDecodeError, UnicodeEncodeError):
            continue
        if candidate.count("�") == 0 and len(candidate) < len(text):
            text = candidate
            break
    text = unicodedata.normalize("NFC", text)
    return _CTRL.sub("", text)


_STOPWORDS = frozenset(
    "the of and to in a is that it for on as with was at by an be this "
    "have from or had not are but they you we his her she he will which "
    "their all there been one can more has when who what about if out so "
    "up said do its".split())


def looks_english(text: str, min_stopword_rate: float = 0.08,
                  min_ascii_rate: float = 0.7) -> bool:
    """Coarse English detector: enough ascii letters AND enough common
    English stopwords among the words."""
    if not text:
        return False
    sample = text[:4000]
    ascii_rate = sum(c.isascii() for c in sample) / len(sample)
    if ascii_rate < min_ascii_rate:
        return False
    words = re.findall(r"[a-zA-Z']+", sample.lower())
    if len(words) < 5:
        return False
    hits = sum(w in _STOPWORDS for w in words)
    return hits / len(words) >= min_stopword_rate


# ---------------------------------------------------------------------------
# URLs
# ---------------------------------------------------------------------------

_TWO_LEVEL_SUFFIXES = frozenset(
    ("co.uk", "org.uk", "ac.uk", "gov.uk", "com.au", "net.au", "org.au",
     "co.jp", "co.in", "co.nz", "com.br", "com.cn", "com.mx", "co.za"))


def registered_domain(url: str) -> str:
    """Second-level domain of a URL ('https://a.b.example.co.uk/x' ->
    'example') — the tldextract.domain equivalent the blacklist keys on."""
    from urllib.parse import urlparse
    host = urlparse(url if "//" in url else "//" + url).hostname or ""
    parts = host.lower().split(".")
    if len(parts) < 2:
        return host.lower()
    if len(parts) >= 3 and ".".join(parts[-2:]) in _TWO_LEVEL_SUFFIXES:
        return parts[-3]
    return parts[-2]


def url_extension(url: str) -> str:
    from urllib.parse import urlparse
    path = urlparse(url if "//" in url else "//" + url).path
    dot = path.rfind(".")
    return path[dot + 1:].lower() if dot >= 0 else ""


# ---------------------------------------------------------------------------
# jsonl IO
# ---------------------------------------------------------------------------

def iter_jsonl(path: str) -> Iterator[dict]:
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    continue


def write_jsonl(path: str, records: Iterable[dict]) -> int:
    n = 0
    with open(path, "w", encoding="utf-8") as f:
        for rec in records:
            f.write(json.dumps(rec, ensure_ascii=False) + "\n")
            n += 1
    return n


# ---------------------------------------------------------------------------
# minhash LSH
# ---------------------------------------------------------------------------

def shingles(text: str, char_ngram: int = 5) -> set:
    """Character n-gram shingle set (ref: find_duplicates.py:13-15)."""
    return {text[i:i + char_ngram]
            for i in range(max(len(text) - char_ngram + 1, 1))}


def jaccard(a: set, b: set, mode: str = "union") -> float:
    if not a or not b:
        return 0.0
    inter = len(a & b)
    if mode == "min":
        return inter / min(len(a), len(b))
    if mode == "max":
        return inter / max(len(a), len(b))
    return inter / len(a | b)


_MERSENNE = (1 << 61) - 1


class MinHasher:
    """Minhash fingerprints over character shingles: k universal-hash
    permutations a*x+b mod p, minimum per permutation."""

    def __init__(self, num_perm: int = 128, char_ngram: int = 5,
                 seed: int = 1234):
        rng = np.random.default_rng(seed)
        self.a = rng.integers(1, _MERSENNE, size=num_perm, dtype=np.int64)
        self.b = rng.integers(0, _MERSENNE, size=num_perm, dtype=np.int64)
        self.char_ngram = char_ngram
        self.num_perm = num_perm

    def fingerprint(self, text: str) -> np.ndarray:
        hashes = np.fromiter(
            (int.from_bytes(
                hashlib.blake2b(s.encode("utf-8", "ignore"),
                                digest_size=8).digest(), "big")
             for s in shingles(text, self.char_ngram)),
            dtype=np.uint64)
        if hashes.size == 0:
            return np.zeros(self.num_perm, np.uint64)
        x = hashes.astype(np.int64)[:, None]
        hv = (self.a[None, :] * x + self.b[None, :]) % _MERSENNE
        return hv.min(axis=0).astype(np.uint64)


class LshIndex:
    """Banded LSH over minhash fingerprints: keys whose fingerprints agree
    on all rows of any band land in the same bucket -> candidate pairs."""

    def __init__(self, num_perm: int = 128, num_bands: int = 16):
        assert num_perm % num_bands == 0
        self.num_bands = num_bands
        self.rows = num_perm // num_bands
        self.buckets: List[dict] = [{} for _ in range(num_bands)]

    def add(self, key, fingerprint: np.ndarray) -> None:
        for band in range(self.num_bands):
            sig = fingerprint[band * self.rows:(band + 1) * self.rows]
            self.buckets[band].setdefault(sig.tobytes(), []).append(key)

    def candidate_buckets(self) -> Iterator[List]:
        for band_buckets in self.buckets:
            for members in band_buckets.values():
                if len(members) > 1:
                    yield members
