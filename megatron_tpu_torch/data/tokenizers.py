"""Tokenizer factory with Megatron vocab-padding semantics.

A copy of megatron_tpu/data/tokenizers.py (plain Python over vocab files);
the port keeps its own so that it never imports the JAX package. Both port
megatron/tokenizer/tokenizer.py (:12-62 factory +
padded-vocab derivation, :254 GPT-2 BPE, :288 Falcon/HF, :326-499
SentencePiece with special-token injection). The abstract contract —
`tokenize/detokenize/vocab_size/eod` plus optional cls/sep/pad/bos/eos ids —
is preserved. All of them are self-contained: the port imports none of
`transformers`, `tokenizers`, `sentencepiece` and `regex` (the card's
machine has none of them). HFTokenizer, the JAX package's AutoTokenizer
wrapper, reads a local `tokenizer.json` with the stdlib reader of
data/hf_tokenizer.py, and SentencePieceTokenizer reads the `tokenizer.json`
beside its model file, the reference's fallback when `sentencepiece` is
missing.

GPT-2's pre-tokenizer pattern needs Unicode classes (`\\p{L}`, `\\p{N}`) that
the stdlib `re` lacks. `gpt2_pretokenize` is a scanner that matches the
pattern exactly, with the characters classified by `unicodedata.category`
(letters L*, numbers N*) and whitespace by the Unicode White_Space
property, so the CPU and the card run one code path. It agrees with the
`regex` package on every character Python's `unicodedata` has assigned
(Unicode 15.0 in Python 3.12); characters assigned in later Unicode
versions count as "other" here.

Vocab padding: `padded_vocab_size(vocab, multiple)` rounds up so the
embedding shards cleanly (ref: tokenizer.py:42-62 pads to
make-vocab-size-divisible-by * tp; we pad tp-independently — see
ModelConfig.padded_vocab_size — so checkpoints are layout-free).
"""
from __future__ import annotations

import json
import os
import re
import unicodedata
from typing import Optional, Sequence


def padded_vocab_size(orig_vocab_size: int, multiple: int) -> int:
    after = orig_vocab_size
    while after % multiple != 0:
        after += 1
    return after


class AbstractTokenizer:
    name = "abstract"

    @property
    def vocab_size(self) -> int:
        raise NotImplementedError

    def tokenize(self, text: str) -> list[int]:
        raise NotImplementedError

    def detokenize(self, ids: Sequence[int]) -> str:
        raise NotImplementedError

    @property
    def eod(self) -> int:
        raise NotImplementedError

    @property
    def eos(self) -> Optional[int]:
        return None

    @property
    def bos(self) -> Optional[int]:
        return None

    @property
    def pad(self) -> Optional[int]:
        return None


def _special_token_names(directory: str) -> dict:
    """The configured special tokens (eos/bos/pad/unk: a string or
    {"content": ...}) of `tokenizer_config.json`, else
    `special_tokens_map.json`, and `clean_up_tokenization_spaces`."""
    out: dict = {}
    for name in ("special_tokens_map.json", "tokenizer_config.json"):
        path = os.path.join(directory, name)
        if not os.path.isfile(path):
            continue
        with open(path, encoding="utf-8") as f:
            conf = json.load(f)
        for key in ("eos_token", "bos_token", "pad_token", "unk_token"):
            tok = conf.get(key)
            if isinstance(tok, dict):
                tok = tok.get("content")
            if tok is not None:
                out[key] = tok
        for key in ("clean_up_tokenization_spaces", "add_prefix_space"):
            if key in conf:
                out[key] = bool(conf[key])
    return out


def _clean_up_tokenization(text: str) -> str:
    """transformers' clean_up_tokenization (spaces before punctuation and
    English contractions)."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                 (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                 (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


class HFTokenizer(AbstractTokenizer):
    """The reference's FalconTokenizer and `--tokenizer_type
    HuggingFaceTokenizer` (ref: tokenizer.py:288-325): a published
    tokenizer's `tokenizer.json`, read by data/hf_tokenizer.py. `path` is
    a directory holding it or the file itself; the directory's
    `tokenizer_config.json` or `special_tokens_map.json` names eos, bos
    and pad (a configured one the file lacks becomes a special token at
    the next id, as transformers adds it), `clean_up_tokenization_spaces`
    (default False) and `add_prefix_space` (default False; as transformers
    does, it overrides the file's own when the top-level pre-tokenizer
    carries one). Ids are those of transformers' `encode(text,
    add_special_tokens=False)` and text that of its `decode(ids)`."""

    name = "HFTokenizer"

    def __init__(self, path: str, **kwargs):
        from megatron_tpu_torch.data.hf_tokenizer import (TokenizerJSON,
                                                          find_tokenizer_json)
        if kwargs:
            raise TypeError(f"HFTokenizer takes no AutoTokenizer options "
                            f"in the port: {sorted(kwargs)}")
        file = find_tokenizer_json(path)
        conf = _special_token_names(os.path.dirname(file))
        with open(file, encoding="utf-8") as f:
            spec = json.load(f)
        pre = spec.get("pre_tokenizer")
        if isinstance(pre, dict) and "add_prefix_space" in pre:
            spec["pre_tokenizer"] = dict(
                pre, add_prefix_space=conf.get("add_prefix_space", False))
        self._t = TokenizerJSON(spec)
        self._clean_up = conf.get("clean_up_tokenization_spaces", False)
        self._ids = {}
        for key in ("eos_token", "bos_token", "pad_token", "unk_token"):
            tok = conf.get(key)
            if tok is None:
                continue
            tid = self._t.token_to_id(tok)
            self._ids[key] = (tid if tid is not None
                              else self._t.add_special_token(tok))

    @property
    def vocab_size(self) -> int:
        return self._t.get_vocab_size(with_added_tokens=True)

    def tokenize(self, text: str) -> list[int]:
        return self._t.encode(text)

    def detokenize(self, ids) -> str:
        text = self._t.decode([int(i) for i in ids])
        return _clean_up_tokenization(text) if self._clean_up else text

    @property
    def eod(self) -> int:
        eos = self.eos
        return eos if eos is not None else self.pad

    @property
    def eos(self):
        return self._ids.get("eos_token")

    @property
    def bos(self):
        return self._ids.get("bos_token")

    @property
    def pad(self):
        return self._ids.get("pad_token")


class SentencePieceTokenizer(AbstractTokenizer):
    """SentencePiece model with Megatron special-token injection
    (ref: tokenizer.py:326-499 _SentencePieceTokenizer: registers
    <CLS>/<SEP>/<EOD>/<MASK>/<PAD> plus `vocab_extra_ids_list` entries on top
    of the base model, tracking an _extra_id map). The base model is the
    HF tokenizer of the model file's directory (its `tokenizer.json`, read
    as HFTokenizer reads it): the reference's path when the
    `sentencepiece` package is missing, as it is on the card's machine,
    where it loads AutoTokenizer from the same directory. The port never
    imports `sentencepiece`."""

    name = "SentencePieceTokenizer"
    SPECIAL = ("<CLS>", "<SEP>", "<EOD>", "<MASK>", "<PAD>")

    def __init__(self, model_file: str, vocab_extra_ids: int = 0,
                 vocab_extra_ids_list: Optional[str] = None,
                 new_tokens: bool = True):
        self._hf = HFTokenizer(os.path.dirname(model_file) or ".")
        base_vocab = self._hf.vocab_size
        self._bos_id = self._hf.bos
        self._eos_id = self._hf.eos
        self._special: dict[str, int] = {}
        self._vocab_size = base_vocab
        if new_tokens:
            for tok in self.SPECIAL:
                self._special[tok] = self._vocab_size
                self._vocab_size += 1
            extra = []
            if vocab_extra_ids_list:
                extra += [t.strip() for t in vocab_extra_ids_list.split(",")]
            extra += [f"<extra_id_{i}>" for i in range(vocab_extra_ids)]
            for tok in extra:
                if tok not in self._special:
                    self._special[tok] = self._vocab_size
                    self._vocab_size += 1

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    def tokenize(self, text: str) -> list[int]:
        return self._hf.tokenize(text)

    def detokenize(self, ids) -> str:
        ids = [i for i in ids if i < self._vocab_size - len(self._special)]
        return self._hf.detokenize(ids)

    @property
    def eod(self) -> int:
        if "<EOD>" in self._special:
            return self._special["<EOD>"]
        return self._eos_id

    @property
    def eos(self):
        return self._eos_id

    @property
    def bos(self):
        return self._bos_id

    @property
    def pad(self):
        return self._special.get("<PAD>")


class GPT2BPETokenizer(AbstractTokenizer):
    """Self-contained GPT-2 byte-level BPE from vocab.json + merges.txt
    (ref: tokenizer.py:254-287 _GPT2BPETokenizer over the vendored
    megatron/tokenizer/gpt2_tokenization.py). The byte-level BPE algorithm is
    public (GPT-2 paper / tiktoken); implemented here directly."""

    name = "GPT2BPETokenizer"

    def __init__(self, vocab_file: str, merge_file: str):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merge_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines
                  if l and not l.startswith("#version") and len(l.split()) == 2]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._bpe_cache: dict[str, tuple[str, ...]] = {}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

    def _bpe(self, token: str) -> tuple[str, ...]:
        # per-instance cache (an lru_cache on the method would pin every
        # tokenizer instance in a process-global cache forever)
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word = bpe_merge(tuple(token), self.bpe_ranks)
        if len(self._bpe_cache) < 65536:
            self._bpe_cache[token] = word
        return word

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def tokenize(self, text: str) -> list[int]:
        ids = []
        for tok in gpt2_pretokenize(text):
            mapped = "".join(self.byte_encoder[b]
                             for b in tok.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(mapped))
        return ids

    def detokenize(self, ids) -> str:
        text = "".join(self.decoder[i] for i in ids)
        return bytearray(self.byte_decoder[c] for c in text).decode(
            "utf-8", errors="replace")

    @property
    def eod(self) -> int:
        return self.encoder["<|endoftext|>"]


def bpe_merge(word: tuple, ranks: dict) -> tuple:
    """Byte-pair merging of a symbol tuple: repeatedly join every
    occurrence, left to right, of the adjacent pair with the lowest rank in
    `ranks` ({(a, b): rank}) until no pair has one."""
    while len(word) > 1:
        pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        best = min(pairs, key=lambda p: ranks.get(p, 1 << 30))
        if best not in ranks:
            break
        a, b = best
        out = []
        i = 0
        while i < len(word):
            if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                out.append(a + b)
                i += 2
            else:
                out.append(word[i])
                i += 1
        word = tuple(out)
    return word


# the Unicode White_Space property, which `\s` means in GPT-2's pattern
_WHITE_SPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
    + "".join(chr(c) for c in range(0x2000, 0x200B)))
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _char_class(c: str) -> str:
    """'s' whitespace, 'L' a letter, 'N' a number, 'o' anything else."""
    if c in _WHITE_SPACE:
        return "s"
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "o"


def gpt2_pretokenize(text: str) -> list[str]:
    """The matches of GPT-2's pre-tokenizer pattern
    `'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`
    in order, by a scanner that tries its alternatives at each position as
    the regex engine does."""
    out = []
    n = len(text)
    cls = [_char_class(c) for c in text]
    i = 0
    while i < n:
        if text[i] == "'":
            con = next((c for c in _CONTRACTIONS if text.startswith(c, i)),
                       None)
            if con is not None:
                out.append(con)
                i += len(con)
                continue
        # ` ?X+` for X in letters, numbers, other: an optional U+0020, then
        # a run of one class
        start = i + 1 if (text[i] == " " and i + 1 < n
                          and cls[i + 1] != "s") else i
        c = cls[start]
        if c != "s":
            j = start + 1
            while j < n and cls[j] == c:
                j += 1
            out.append(text[i:j])
            i = j
            continue
        # `\s+(?!\S)`: a whitespace run, less its last character when a
        # non-space follows it and it is longer than one; else `\s+`
        j = i + 1
        while j < n and cls[j] == "s":
            j += 1
        if j < n and j - i > 1:
            j -= 1
        out.append(text[i:j])
        i = j
    return out


def bytes_to_unicode():
    """GPT-2's reversible byte<->printable-unicode map (public algorithm)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


# The basic tokenization below for ASCII text, at C speed: the control
# characters other than \t\n\r dropped and those three made spaces (ASCII
# has no marks for NFD to strip), then runs of letters and digits and each
# punctuation character (the four ASCII ranges of `_is_punct`).
_ASCII_CLEAN = {**dict.fromkeys([*range(9), 11, 12, *range(14, 32), 127]),
                9: 32, 10: 32, 13: 32}
_ASCII_WORDS = re.compile(r"[0-9A-Za-z]+|[!-/:-@\[-`{-~]")


class BertWordPieceTokenizer(AbstractTokenizer):
    """Self-contained BERT WordPiece tokenizer
    (ref: megatron/tokenizer/tokenizer.py:123-253 _BertWordPieceTokenizer
    wrapping the original Google FullTokenizer). Pipeline: clean + optional
    lowercase -> whitespace/punctuation basic tokenization -> greedy
    longest-match-first wordpiece with '##' continuation prefix.

    vocab_file: one token per line (standard BERT vocab.txt)."""

    name = "BertWordPiece"

    def __init__(self, vocab_file: str, lower_case: bool = True,
                 vocab_extra_ids: int = 0):
        self.lower_case = lower_case
        with open(vocab_file, encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        self._vocab = {t: i for i, t in enumerate(tokens)}
        # T5-style extra ids appended on top (ref: tokenizer.py:246-253)
        for i in range(vocab_extra_ids):
            self._add_token(f"<extra_id_{i}>")
        self._inv = {i: t for t, i in self._vocab.items()}
        for tok in ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"):
            assert tok in self._vocab, f"vocab missing {tok}"

    def _add_token(self, tok: str):
        if tok not in self._vocab:
            self._vocab[tok] = len(self._vocab)

    # -- basic tokenization ------------------------------------------------
    @staticmethod
    def _is_punct(ch: str) -> bool:
        import unicodedata
        cp = ord(ch)
        if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
                or 123 <= cp <= 126):
            return True
        return unicodedata.category(ch).startswith("P")

    @staticmethod
    def _is_cjk(ch: str) -> bool:
        # the CJK Unified Ideograph blocks the original BERT BasicTokenizer
        # splits per-character (standard BERT vocabs carry individual chars)
        cp = ord(ch)
        return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
                or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
                or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
                or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)

    @staticmethod
    def _is_control(ch: str) -> bool:
        import unicodedata
        if ch in ("\t", "\n", "\r"):
            return False
        return unicodedata.category(ch).startswith("C")

    def _basic_tokenize(self, text: str) -> list[str]:
        if text.isascii():
            text = text.translate(_ASCII_CLEAN)
            return _ASCII_WORDS.findall(text.lower() if self.lower_case
                                        else text)
        # clean: drop control chars and the replacement char, normalize
        # whitespace (the original BasicTokenizer's _clean_text)
        text = "".join(" " if ch.isspace() else ch for ch in text
                       if ord(ch) != 0 and ord(ch) != 0xFFFD
                       and not self._is_control(ch))
        if self.lower_case:
            text = text.lower()
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        out: list[str] = []
        word: list[str] = []

        def flush():
            if word:
                out.append("".join(word))
                word.clear()

        for ch in text:
            if ch.isspace():
                flush()
            elif self._is_punct(ch) or self._is_cjk(ch):
                flush()
                out.append(ch)
            else:
                word.append(ch)
        flush()
        return out

    def _wordpiece(self, word: str) -> list[str]:
        """Greedy longest-match-first (the published WordPiece algorithm)."""
        if len(word) > 200:
            return ["[UNK]"]
        pieces: list[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self._vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return ["[UNK]"]
            pieces.append(piece)
            start = end
        return pieces

    # -- AbstractTokenizer surface ------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self._vocab)

    @property
    def vocab(self):
        return self._vocab

    @property
    def inv_vocab(self):
        return self._inv

    def tokenize(self, text: str) -> list[int]:
        ids = []
        for word in self._basic_tokenize(text):
            for piece in self._wordpiece(word):
                ids.append(self._vocab[piece])
        return ids

    def detokenize(self, ids: Sequence[int]) -> str:
        toks = [self._inv[int(i)] for i in ids]
        out = []
        for t in toks:
            if t.startswith("##") and out:
                out[-1] = out[-1] + t[2:]
            else:
                out.append(t)
        return " ".join(out)

    @property
    def cls(self) -> int:
        return self._vocab["[CLS]"]

    @property
    def sep(self) -> int:
        return self._vocab["[SEP]"]

    @property
    def mask(self) -> int:
        return self._vocab["[MASK]"]

    @property
    def pad(self) -> int:
        return self._vocab["[PAD]"]

    @property
    def eod(self) -> int:
        return self._vocab["[SEP]"]  # (ref: tokenizer.py eod == sep)


def build_tokenizer(tokenizer_type: str, *, vocab_file=None, merge_file=None,
                    tokenizer_model=None, vocab_extra_ids=0,
                    vocab_extra_ids_list=None, new_tokens=True,
                    **kwargs) -> AbstractTokenizer:
    """Factory (ref: tokenizer.py:12-41 build_tokenizer)."""
    t = tokenizer_type
    if t in ("GPT2BPETokenizer",):
        assert vocab_file and merge_file
        return GPT2BPETokenizer(vocab_file, merge_file)
    if t in ("BertWordPieceTokenizer", "BertWordPieceLowerCase",
             "BertWordPieceCase"):
        assert vocab_file
        return BertWordPieceTokenizer(
            vocab_file, lower_case=t != "BertWordPieceCase",
            vocab_extra_ids=vocab_extra_ids)
    if t in ("SentencePieceTokenizer",):
        assert tokenizer_model
        return SentencePieceTokenizer(
            tokenizer_model, vocab_extra_ids=vocab_extra_ids,
            vocab_extra_ids_list=vocab_extra_ids_list, new_tokens=new_tokens)
    if t in ("FalconTokenizer", "HuggingFaceTokenizer", "HFTokenizer"):
        # the reference's default names a hub repository; the port reads
        # local files only, so that path raises FileNotFoundError
        path = tokenizer_model or vocab_file or "tiiuae/falcon-40b"
        return HFTokenizer(path, **kwargs)
    raise ValueError(f"unknown tokenizer_type {tokenizer_type!r}")
