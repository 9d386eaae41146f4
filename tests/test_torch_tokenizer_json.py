"""The port's stdlib tokenizer.json reader (data/hf_tokenizer.py) and the
tokenizers built on it, against `tokenizers` 0.22.2 and the JAX package.

- Vocabularies are trained here with `tokenizers`' BPE trainer in the two
  published layouts, nothing downloaded: byte-level BPE (Falcon-7B's
  pre-tokenizer Sequence: Punctuation, ByteLevel, Digits, a 3-digit
  Split; ByteLevel decoder; added tokens), and Metaspace BPE with byte
  fallback (Llama-2's HF file: Prepend + Replace normalizers, 256 <0xNN>
  pieces, fuse_unk, the Replace/ByteFallback/Fuse/Strip decoder). Two more
  files cover the Metaspace pre-tokenizer and decoder, NFKC, and added
  tokens that are normalized, lstrip/rstrip or single-word.
- Ids and decoded text (skip_special_tokens both ways) equal `tokenizers`'
  exactly on a fixed corpus: whitespace runs, digits, `²½Ⅻ`, CJK, emoji,
  characters outside the vocabulary and added tokens, plus random strings.
- HFTokenizer (and build_tokenizer's FalconTokenizer/HuggingFaceTokenizer)
  and SentencePieceTokenizer (no `sentencepiece` here) equal the JAX
  package's, which go through transformers' AutoTokenizer: ids, text,
  vocab size and the eod/eos/bos/pad ids.
- The stdlib GPT-2 pre-tokenizer equals `regex`'s on that corpus, on
  random strings, and in how it classifies every assigned code point.
"""
import json
import random
import unicodedata

import pytest
import regex
from tokenizers import (AddedToken, Regex, Tokenizer, decoders, models,
                        normalizers, pre_tokenizers, trainers)

from megatron_tpu.data import tokenizers as j_tok
from megatron_tpu_torch.data import tokenizers as t_tok
from megatron_tpu_torch.data.hf_tokenizer import TokenizerJSON

CORPUS = [
    "Hello  world!\n\tThe quick brown fox jumps over 12345 lazy dogs.",
    "x² + y½ = Ⅻ, 東京タワー is tall; 🙂🙃 emoji…",
    "naïve café — it's don't we'll I'm they've you're",
    "   leading spaces and trailing   ", "tabs\t\tand\nnewlines\n\n",
    "1234567890 3.14159 1,000,000", "<s>special</s> inside <unk> text",
    "ÿ\x00\x1c\x7f control 　 ideographic space",
    "__init__ snake_case CamelCase", "", " ", "a", "中文字符串测试",
    "Ελληνικά κείμενο", "русский текст", "العربية", "ﬁ ligature Ａ fullwidth",
    "<|endoftext|>tail >>TITLE<< x", " [MASK]a [MASK] b[MASK]",
]
TRAIN = CORPUS[:6] * 5
GPT2_PATTERN = regex.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
    r"|\s+(?!\S)|\s+")


def _random_texts(n, seed):
    rs = random.Random(seed)
    alphabet = list(" \t\n'sdtrevmlaZ0129²½Ⅻ東京🙂_-.,!?　\xa0ﬁ")
    return ["".join(rs.choice(alphabet) for _ in range(rs.randint(0, 30)))
            for _ in range(n)]


def _byte_level():
    t = Tokenizer(models.BPE())
    t.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Punctuation("contiguous"),
        pre_tokenizers.ByteLevel(add_prefix_space=False),
        pre_tokenizers.Digits(individual_digits=False),
        pre_tokenizers.Split(Regex("[0-9][0-9][0-9]"), "isolated")])
    t.decoder = decoders.ByteLevel()
    t.train_from_iterator(TRAIN, trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<|endoftext|>", ">>TITLE<<"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    return t


def _metaspace_fallback():
    """Llama-2's HF layout: the <0xNN> pieces sit in the model vocabulary
    right after the three special tokens."""
    t = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True,
                             fuse_unk=True))
    t.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                         normalizers.Replace(" ", "▁")])
    t.decoder = decoders.Sequence([
        decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(),
        decoders.Strip(" ", 1, 0)])
    t.train_from_iterator(TRAIN[:20], trainers.BpeTrainer(
        vocab_size=300, special_tokens=["<unk>", "<s>", "</s>"]))
    spec = json.loads(t.to_str())
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    vocab.update({f"<0x{b:02X}>": 3 + b for b in range(256)})
    for tok, _ in sorted(spec["model"]["vocab"].items(), key=lambda kv: kv[1]):
        vocab.setdefault(tok, len(vocab))
    spec["model"]["vocab"] = vocab
    return Tokenizer.from_str(json.dumps(spec))


def _metaspace_pre_tokenizer():
    t = Tokenizer(models.BPE(unk_token="<unk>"))
    t.normalizer = normalizers.NFKC()
    t.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme="first")
    t.decoder = decoders.Metaspace(prepend_scheme="first")
    t.train_from_iterator(TRAIN, trainers.BpeTrainer(
        vocab_size=300, special_tokens=["<unk>", "<s>", "</s>"]))
    t.add_special_tokens([AddedToken("[MASK]", lstrip=True, rstrip=True)])
    t.add_tokens([AddedToken("fox", normalized=True),
                  AddedToken("ee", single_word=True)])
    return t


def _byte_level_prefix():
    t = Tokenizer(models.BPE())
    t.normalizer = normalizers.NFC()
    t.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True)
    t.decoder = decoders.ByteLevel()
    t.train_from_iterator(TRAIN, trainers.BpeTrainer(
        vocab_size=350, special_tokens=["<|endoftext|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    return t


LAYOUTS = {"byte_level": _byte_level, "metaspace_fallback":
           _metaspace_fallback, "metaspace_pre": _metaspace_pre_tokenizer,
           "byte_level_prefix": _byte_level_prefix}
# the special tokens each layout's tokenizer_config.json names
SPECIALS = {"byte_level": dict(eos_token="<|endoftext|>"),
            "metaspace_fallback": dict(bos_token="<s>", eos_token="</s>",
                                       unk_token="<unk>"),
            "metaspace_pre": dict(bos_token="<s>", eos_token="</s>",
                                  pad_token="<pad>"),
            "byte_level_prefix": dict(eos_token="<|endoftext|>",
                                      pad_token="<|endoftext|>")}


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def layout(request, tmp_path_factory):
    name = request.param
    ref = LAYOUTS[name]()
    d = tmp_path_factory.mktemp(name)
    ref.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps(dict(
        tokenizer_class="PreTrainedTokenizerFast", **SPECIALS[name])))
    return name, ref, d


def test_reader_matches_tokenizers(layout):
    name, ref, d = layout
    mine = TokenizerJSON.from_file(str(d / "tokenizer.json"))
    assert mine.get_vocab_size() == ref.get_vocab_size()
    for text in CORPUS + _random_texts(200, 1):
        want = ref.encode(text, add_special_tokens=False).ids
        assert mine.encode(text) == want, (name, text)
        for skip in (False, True):
            assert mine.decode(want, skip_special_tokens=skip) == \
                ref.decode(want, skip_special_tokens=skip), (name, text)
    # any id sequence decodes the same, bytes that form no character too
    ids = list(range(ref.get_vocab_size()))
    random.Random(2).shuffle(ids)
    for k in range(0, 350, 7):
        assert mine.decode(ids[k:k + 7]) == ref.decode(
            ids[k:k + 7], skip_special_tokens=False)


def test_hf_tokenizer_matches_jax(layout):
    name, _, d = layout
    jt = j_tok.HFTokenizer(str(d))
    for tt in (t_tok.HFTokenizer(str(d)),
               t_tok.build_tokenizer("FalconTokenizer",
                                     tokenizer_model=str(d)),
               t_tok.build_tokenizer("HuggingFaceTokenizer",
                                     vocab_file=str(d / "tokenizer.json"))):
        assert (tt.vocab_size, tt.eod, tt.eos, tt.bos, tt.pad) == (
            jt.vocab_size, jt.eod, jt.eos, jt.bos, jt.pad), name
        for text in CORPUS:
            ids = tt.tokenize(text)
            assert ids == jt.tokenize(text), (name, text)
            assert tt.detokenize(ids) == jt.detokenize(ids), (name, text)


def test_sentencepiece_tokenizer_matches_jax(layout):
    """Neither package has `sentencepiece` here: both read the HF tokenizer
    beside the model file, and inject Megatron's special tokens on top."""
    name, _, d = layout
    model_file = str(d / "tokenizer.model")
    for kw in (dict(), dict(vocab_extra_ids=2, vocab_extra_ids_list="<a>,<b>"),
               dict(new_tokens=False)):
        jt = j_tok.SentencePieceTokenizer(model_file, **kw)
        tt = t_tok.SentencePieceTokenizer(model_file, **kw)
        assert (tt.vocab_size, tt.eod, tt.eos, tt.bos, tt.pad) == (
            jt.vocab_size, jt.eod, jt.eos, jt.bos, jt.pad), (name, kw)
        for text in CORPUS:
            ids = tt.tokenize(text)
            assert ids == jt.tokenize(text), (name, text)
            # the injected ids are dropped before decoding
            assert tt.detokenize(ids + [tt.vocab_size - 1]) == \
                jt.detokenize(ids + [jt.vocab_size - 1]), (name, text)


def test_gpt2_pattern_equals_regex():
    for text in CORPUS + _random_texts(3000, 3):
        assert t_tok.gpt2_pretokenize(text) == GPT2_PATTERN.findall(text), \
            text
    classes = dict(s=regex.compile(r"\s"), L=regex.compile(r"\p{L}"),
                   N=regex.compile(r"\p{N}"))
    for cp in range(0x110000):
        c = chr(cp)
        if 0xD800 <= cp <= 0xDFFF or unicodedata.category(c) == "Cn":
            continue  # surrogates; and code points Python's Unicode
            #           version has not assigned (regex's may have)
        want = next((k for k, pat in classes.items() if pat.match(c)), "o")
        assert t_tok._char_class(c) == want, hex(cp)


def test_gpt2_tokenizer_exact_on_unicode_numbers(tmp_path):
    """`²½Ⅻ` are numbers (No, Nl) to GPT-2's pattern: the port's ids equal
    the JAX package's with `regex`."""
    from megatron_tpu_torch.tools import synthetic_corpus
    vocab, merges = synthetic_corpus.write_gpt2_vocab(str(tmp_path), 600)
    jt = j_tok.GPT2BPETokenizer(vocab, merges)
    tt = t_tok.GPT2BPETokenizer(vocab, merges)
    assert "regex" in type(jt.pat).__module__
    for text in CORPUS + ["x²y½zⅫ 42²", "café²"]:
        ids = tt.tokenize(text)
        assert ids == jt.tokenize(text), text
        assert tt.detokenize(ids) == jt.detokenize(ids) == text


def test_unsupported_components_raise(tmp_path):
    spec = json.loads(_byte_level().to_str())
    for key, value, name in (
            ("normalizer", {"type": "Lowercase"}, "Lowercase"),
            ("pre_tokenizer", {"type": "Whitespace"}, "Whitespace"),
            ("decoder", {"type": "WordPiece", "prefix": "##",
                         "cleanup": True}, "WordPiece"),
            ("model", {"type": "WordPiece", "vocab": {}}, "WordPiece")):
        bad = dict(spec, **{key: value})
        with pytest.raises(NotImplementedError, match=name):
            TokenizerJSON(bad)
    bad = dict(spec, model=dict(spec["model"], dropout=0.1))
    with pytest.raises(NotImplementedError, match="dropout"):
        TokenizerJSON(bad)
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        t_tok.build_tokenizer("FalconTokenizer")  # a hub name: no download
    with pytest.raises(FileNotFoundError):
        t_tok.HFTokenizer(str(tmp_path))
