"""A reader of HuggingFace `tokenizer.json` files on the standard library
alone: the port's counterpart of the `tokenizers` package, which the card's
machine does not have.

`TokenizerJSON` encodes and decodes as `tokenizers.Tokenizer` does with
`add_special_tokens=False`, for the two layouts published checkpoints use:

- byte-level BPE (Falcon-7B's file): the ByteLevel pre-tokenizer on GPT-2's
  pattern, often in a Sequence with Punctuation, Digits and Split, and the
  ByteLevel decoder;
- Metaspace BPE with byte fallback (Llama-2's HF file): the `Prepend` and
  `Replace` normalizers (or the Metaspace pre-tokenizer), `<0xNN>` pieces
  for characters outside the vocabulary, and the Replace, ByteFallback,
  Fuse and Strip decoders.

The pipeline is the reference library's: added tokens are split out first
(those with `normalized` false on the raw text, the others after
normalization; leftmost-longest, with `lstrip`, `rstrip` and
`single_word`), then each remaining segment is normalized and
pre-tokenized, and each piece is split by the BPE model (merge ranks,
`unk_token` and `fuse_unk`, `byte_fallback`, `ignore_merges`). Decoding
maps ids to pieces (added tokens first; `skip_special_tokens` drops the
special ones) and runs the decoder chain. The post-processor adds special
tokens only when asked to, which this reader never is, so it is not read.

It holds the normalizers Sequence, Prepend, Replace, NFC and NFKC; the
pre-tokenizers Sequence, ByteLevel, Metaspace, Split, Punctuation and
Digits; and the decoders Sequence, ByteLevel, Metaspace, Replace,
ByteFallback, Fuse and Strip. Any other component, a BPE dropout, a
continuing-subword prefix or an end-of-word suffix raises
NotImplementedError naming itself. The byte map, the merge loop and GPT-2's
pre-tokenizer are GPT2BPETokenizer's (data/tokenizers.py).
"""
from __future__ import annotations

import json
import os
import re
import unicodedata
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from megatron_tpu_torch.data.tokenizers import (bpe_merge, bytes_to_unicode,
                                                gpt2_pretokenize)

_BYTE_ENCODER = bytes_to_unicode()
_BYTE_DECODER = {c: b for b, c in _BYTE_ENCODER.items()}

# a piece on its way through the pipeline: (text, added-token id or None,
# whether it starts at offset 0 of the input)
Piece = Tuple[str, Optional[int], bool]


def _unsupported(kind: str, spec) -> NotImplementedError:
    name = spec.get("type") if isinstance(spec, dict) else spec
    return NotImplementedError(
        f"tokenizer.json {kind} {name!r} is not supported by the port's "
        "reader (data/hf_tokenizer.py)")


def _pattern(spec: dict):
    """A Replace/Split pattern: {"String": s} or {"Regex": r}."""
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    if "Regex" in spec:
        return re.compile(spec["Regex"])
    raise _unsupported("pattern", str(spec))


# ---- normalizers ------------------------------------------------------
def _normalizer(spec: Optional[dict]) -> Callable[[str], str]:
    if spec is None:
        return lambda s: s
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_normalizer(n) for n in spec["normalizers"]]

        def seq(s):
            for fn in parts:
                s = fn(s)
            return s
        return seq
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if kind == "Replace":
        pat, content = _pattern(spec["pattern"]), spec["content"]
        return lambda s: pat.sub(lambda m: content, s)
    if kind in ("NFC", "NFKC"):
        return lambda s: unicodedata.normalize(kind, s)
    raise _unsupported("normalizer", spec)


# ---- splitting, as NormalizedString::split ---------------------------
def _char_matches(text: str, pred) -> List[Tuple[int, int, bool]]:
    """Spans of `text`: each character `pred` holds for is a match of its
    own; the characters between matches form one non-match span."""
    out, last = [], 0
    for i, c in enumerate(text):
        if pred(c):
            if last < i:
                out.append((last, i, False))
            out.append((i, i + 1, True))
            last = i + 1
    if last < len(text):
        out.append((last, len(text), False))
    return out


def _regex_matches(text: str, pat) -> List[Tuple[int, int, bool]]:
    out, prev = [], 0
    for m in pat.finditer(text):
        if prev != m.start():
            out.append((prev, m.start(), False))
        out.append((m.start(), m.end(), True))
        prev = m.end()
    if prev != len(text):
        out.append((prev, len(text), False))
    return out


def _split(text: str, matches, behavior: str) -> List[str]:
    """Split `text` on its match spans by a SplitDelimiterBehavior; empty
    pieces are dropped."""
    if not text:
        return []
    spans: List[list] = []  # [start, end, remove]
    if behavior == "Isolated":
        spans = [[a, b, False] for a, b, _ in matches]
    elif behavior == "Removed":
        spans = [[a, b, m] for a, b, m in matches]
    elif behavior in ("Contiguous", "MergedWithPrevious"):
        prev = False
        for a, b, m in matches:
            merge = (m == prev if behavior == "Contiguous"
                     else m and not prev)
            if merge and spans:
                spans[-1][1] = b
            else:
                spans.append([a, b, False])
            prev = m
    elif behavior == "MergedWithNext":
        prev = False
        for a, b, m in reversed(matches):
            if m and not prev and spans:
                spans[-1][0] = a
            else:
                spans.append([a, b, False])
            prev = m
        spans.reverse()
    else:
        raise _unsupported("split behavior", behavior)
    return [text[a:b] for a, b, remove in spans if not remove and b > a]


def _is_punctuation(c: str) -> bool:
    return ((c.isascii() and not c.isalnum() and c.isprintable()
             and c != " ") or unicodedata.category(c).startswith("P"))


def _is_numeric(c: str) -> bool:
    return unicodedata.category(c) in ("Nd", "Nl", "No")


# ---- pre-tokenizers ---------------------------------------------------
def _pre_tokenizer(spec: Optional[dict]):
    """A function [(text, at_start)] -> [(text, at_start)]; a piece split
    off the front of another keeps its `at_start`."""
    if spec is None:
        return lambda pieces: pieces
    kind = spec["type"]

    def each(fn):
        def run(pieces):
            out = []
            for text, at_start in pieces:
                parts = fn(text, at_start)
                out.extend((p, at_start and i == 0)
                           for i, p in enumerate(parts))
            return out
        return run

    if kind == "Sequence":
        parts = [_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def seq(pieces):
            for fn in parts:
                pieces = fn(pieces)
            return pieces
        return seq
    if kind == "ByteLevel":
        prefix, use_regex = spec.get("add_prefix_space", True), spec.get(
            "use_regex", True)

        def byte_level(text, at_start):
            if prefix and not text.startswith(" "):
                text = " " + text
            parts = gpt2_pretokenize(text) if use_regex else [text]
            return ["".join(_BYTE_ENCODER[b] for b in p.encode("utf-8"))
                    for p in parts if p]
        return each(byte_level)
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:  # files written before prepend_scheme
            scheme = "always" if spec.get("add_prefix_space", True) \
                else "never"
        split = spec.get("split", True)

        def metaspace(text, at_start):
            text = text.replace(" ", rep)
            if not text.startswith(rep) and (
                    scheme == "always" or (scheme == "first" and at_start)):
                text = rep + text
            if not split:
                return [text] if text else []
            return _split(text, _char_matches(text, lambda c: c == rep),
                          "MergedWithNext")
        return each(metaspace)
    if kind == "Split":
        pat, behavior = _pattern(spec["pattern"]), spec["behavior"]
        invert = spec.get("invert", False)

        def split(text, at_start):
            m = _regex_matches(text, pat)
            if invert:
                m = [(a, b, not x) for a, b, x in m]
            return _split(text, m, behavior)
        return each(split)
    if kind == "Punctuation":
        behavior = spec.get("behavior", "Isolated")
        return each(lambda text, _: _split(
            text, _char_matches(text, _is_punctuation), behavior))
    if kind == "Digits":
        behavior = ("Isolated" if spec.get("individual_digits", False)
                    else "Contiguous")
        return each(lambda text, _: _split(
            text, _char_matches(text, _is_numeric), behavior))
    raise _unsupported("pre_tokenizer", spec)


# ---- decoders ---------------------------------------------------------
def _byte_fallback(tokens: List[str]) -> List[str]:
    out: List[str] = []
    pending = bytearray()

    def flush():
        if pending:
            try:
                out.append(pending.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" * len(pending))
            pending.clear()

    for tok in tokens:
        byte = None
        if len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">"):
            try:
                byte = int(tok[3:5], 16)
            except ValueError:
                pass
        if byte is not None:
            pending.append(byte)
        else:
            flush()
            out.append(tok)
    flush()
    return out


def _byte_level_decode(tokens: List[str]) -> List[str]:
    data = bytearray()
    for tok in tokens:
        if all(c in _BYTE_DECODER for c in tok):
            data.extend(_BYTE_DECODER[c] for c in tok)
        else:
            data.extend(tok.encode("utf-8"))
    return [data.decode("utf-8", errors="replace")]


def _strip(content: str, start: int, stop: int):
    def run(tokens):
        out = []
        for tok in tokens:
            a, b = 0, len(tok)
            for i in range(min(start, len(tok))):
                if tok[i] != content:
                    break
                a = i + 1
            for i in range(min(stop, len(tok))):
                j = len(tok) - i - 1
                if tok[j] != content:
                    break
                b = j
            out.append(tok[a:b])
        return out
    return run


def _decoder(spec: Optional[dict]):
    """A function [token strings] -> [strings] (joined by the caller)."""
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_decoder(d) for d in spec["decoders"]]

        def seq(tokens):
            for fn in parts:
                tokens = fn(tokens)
            return tokens
        return seq
    if kind == "ByteLevel":
        return _byte_level_decode
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) \
                else "never"
        # every replacement char of the FIRST token is dropped unless the
        # scheme is "never", as the reference library decodes
        return lambda tokens: [
            "".join("" if c == rep and i == 0 and scheme != "never"
                    else " " if c == rep else c for c in tok)
            for i, tok in enumerate(tokens)]
    if kind == "Replace":
        pat, content = _pattern(spec["pattern"]), spec["content"]
        return lambda tokens: [pat.sub(lambda m: content, t)
                               for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        return _strip(spec["content"], spec["start"], spec["stop"])
    raise _unsupported("decoder", spec)


# ---- the BPE model ----------------------------------------------------
class _BPE:
    def __init__(self, spec: dict):
        if spec.get("type", "BPE") != "BPE":
            raise _unsupported("model", spec)
        for opt in ("continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(opt):
                raise _unsupported("BPE option", opt)
        if spec.get("dropout") not in (None, 0.0):
            raise _unsupported("BPE option", "dropout")
        self.vocab: Dict[str, int] = spec["vocab"]
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                  for m in spec.get("merges", [])]
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.unk = spec.get("unk_token")
        self.fuse_unk = spec.get("fuse_unk", False)
        self.byte_fallback = spec.get("byte_fallback", False)
        self.ignore_merges = spec.get("ignore_merges", False)
        self._cache: Dict[str, List[int]] = {}

    def _symbols(self, word: str) -> List[str]:
        """The word's initial symbols: each character in the vocabulary;
        else its bytes as <0xNN> pieces (byte_fallback); else the unk
        token (consecutive ones fused with fuse_unk); else dropped."""
        out: List[str] = []
        unk_open = False
        for c in word:
            if c in self.vocab:
                out.append(c)
                unk_open = False
                continue
            if self.byte_fallback:
                pieces = [f"<0x{b:02X}>" for b in c.encode("utf-8")]
                if all(p in self.vocab for p in pieces):
                    out.extend(pieces)
                    unk_open = False
                    continue
            if self.unk is not None:
                if self.unk not in self.vocab:
                    raise ValueError(f"unk_token {self.unk!r} is not in "
                                     "the vocabulary")
                if not (unk_open and self.fuse_unk):
                    out.append(self.unk)
                unk_open = True
        return out

    def tokenize(self, word: str) -> List[int]:
        if not word:
            return []
        ids = self._cache.get(word)
        if ids is not None:
            return ids
        if self.ignore_merges and word in self.vocab:
            ids = [self.vocab[word]]
        else:
            ids = [self.vocab[p] for p in
                   bpe_merge(tuple(self._symbols(word)), self.ranks)]
        if len(self._cache) < 65536:
            self._cache[word] = ids
        return ids


# ---- added tokens -----------------------------------------------------
class _AddedToken:
    __slots__ = ("id", "content", "special", "normalized", "lstrip",
                 "rstrip", "single_word")

    def __init__(self, spec: dict):
        self.id = int(spec["id"])
        self.content = spec["content"]
        self.special = bool(spec.get("special", False))
        self.normalized = bool(spec.get("normalized", not self.special))
        self.lstrip = bool(spec.get("lstrip", False))
        self.rstrip = bool(spec.get("rstrip", False))
        self.single_word = bool(spec.get("single_word", False))


def _is_word_char(c: str) -> bool:
    return c.isalnum() or c == "_"


def _split_added(text: str, tokens: Sequence[_AddedToken]
                 ) -> List[Tuple[str, Optional[int], int]]:
    """Split `text` on the added tokens, leftmost-longest: [(piece, token
    id or None, start offset)]."""
    if not tokens or not text:
        return [(text, None, 0)]
    by_first: Dict[str, List[_AddedToken]] = {}
    for t in sorted(tokens, key=lambda t: -len(t.content)):
        if t.content:
            by_first.setdefault(t.content[0], []).append(t)
    out: List[Tuple[str, Optional[int], int]] = []
    done = 0  # text before this offset has been emitted
    i = 0
    while i < len(text):
        hit = next((t for t in by_first.get(text[i], ())
                    if text.startswith(t.content, i)), None)
        if hit is None:
            i += 1
            continue
        start, stop = i, i + len(hit.content)
        if hit.single_word and (
                (start > 0 and _is_word_char(text[start - 1]))
                or (stop < len(text) and _is_word_char(text[stop]))):
            i = stop  # the search resumes after the rejected match
            continue
        if hit.lstrip:
            j = start
            while j > done and text[j - 1].isspace():
                j -= 1
            start = j
        if hit.rstrip:
            while stop < len(text) and text[stop].isspace():
                stop += 1
        if done < start:
            out.append((text[done:start], None, done))
        out.append((text[start:stop], hit.id, start))
        done = stop
        i = i + len(hit.content)
    if done < len(text):
        out.append((text[done:], None, done))
    return out


class TokenizerJSON:
    """A `tokenizer.json` file: `encode(text)` and `decode(ids)` as
    `tokenizers.Tokenizer.encode(text, add_special_tokens=False).ids` and
    `.decode(ids, skip_special_tokens)` give them."""

    def __init__(self, spec: dict):
        self.model = _BPE(spec["model"])
        self.added = [_AddedToken(t) for t in spec.get("added_tokens", [])]
        self._normalize = _normalizer(spec.get("normalizer"))
        self._pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self._decode = _decoder(spec.get("decoder"))
        self._reindex()

    @classmethod
    def from_file(cls, path: str) -> "TokenizerJSON":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    def _reindex(self):
        self._raw = [t for t in self.added if not t.normalized]
        self._norm = [t for t in self.added if t.normalized]
        self._added_by_id = {t.id: t for t in self.added}
        self._added_by_content = {t.content: t for t in self.added}
        self._id_to_token = {i: tok for tok, i in self.model.vocab.items()}

    def add_special_token(self, content: str) -> int:
        """Register `content` as a special added token (not normalized) at
        the next free id, as `transformers` does for a configured special
        token the file lacks; returns its id."""
        tid = self.get_vocab_size()
        self.added.append(_AddedToken({"id": tid, "content": content,
                                       "special": True}))
        self._reindex()
        return tid

    def token_to_id(self, token: str) -> Optional[int]:
        t = self._added_by_content.get(token)
        return t.id if t is not None else self.model.vocab.get(token)

    def id_to_token(self, i: int) -> Optional[str]:
        t = self._added_by_id.get(i)
        return t.content if t is not None else self._id_to_token.get(i)

    def get_vocab_size(self, with_added_tokens: bool = True) -> int:
        if not with_added_tokens:
            return len(self.model.vocab)
        return len(set(self.model.vocab) | set(self._added_by_content))

    def encode(self, text: str) -> List[int]:
        # empty splits are dropped at every stage, as the reference
        # library drops them (so an empty text gets no prefix space)
        pieces: List[Piece] = []
        for seg, tid, start in _split_added(text, self._raw):
            if tid is not None:
                pieces.append((seg, tid, start == 0))
                continue
            if not seg:
                continue
            for sub, sid, sstart in _split_added(self._normalize(seg),
                                                 self._norm):
                if sub:
                    pieces.append((sub, sid, start == 0 and sstart == 0))
        ids: List[int] = []
        for text_, tid, at_start in pieces:
            if tid is not None:
                ids.append(tid)
                continue
            for word, _ in self._pre_tokenize([(text_, at_start)]):
                ids.extend(self.model.tokenize(word))
        return ids

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = False) -> str:
        tokens = []
        for i in ids:
            tok = self.id_to_token(int(i))
            if tok is None:
                continue
            added = self._added_by_content.get(tok)
            if skip_special_tokens and added is not None and added.special:
                continue
            tokens.append(tok)
        if self._decode is None:
            return " ".join(tokens)
        return "".join(self._decode(tokens))


def find_tokenizer_json(path: str) -> str:
    """`path` itself when it is a file, else `path`/tokenizer.json."""
    if os.path.isdir(path):
        path = os.path.join(path, "tokenizer.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path}: no tokenizer.json (the port reads a local HF "
            "tokenizer file; it downloads nothing)")
    return path
