"""The port's data path (megatron_tpu_torch/data, tools/preprocess_data.py)
against the JAX package's on the same inputs.

Everything here is exact: the `.bin/.idx` files byte for byte, the doc,
sample, shuffle and blending indices element for element (same dtype and
shape), the batches of `BatchIterator` (tokens, loss_mask, position_ids,
segment_ids) exactly, and the tokenizers' ids exactly. Each package builds
its index mappings in its own copy of the corpus, so neither reads the
other's `.npy` cache.
"""
import json
import shutil
import sys

import numpy as np
import pytest
import torch

from megatron_tpu.data import blendable as j_blend
from megatron_tpu.data import gpt_dataset as j_gpt
from megatron_tpu.data import indexed_dataset as j_idx
from megatron_tpu.data import samplers as j_samp
from megatron_tpu.data import tokenizers as j_tok
from megatron_tpu_torch.data import blendable as t_blend
from megatron_tpu_torch.data import gpt_dataset as t_gpt
from megatron_tpu_torch.data import indexed_dataset as t_idx
from megatron_tpu_torch.data import samplers as t_samp
from megatron_tpu_torch.data import tokenizers as t_tok
from megatron_tpu_torch.tools import preprocess_data as t_pre
from megatron_tpu_torch.tools import synthetic_corpus as sc
from tools import preprocess_data as j_pre

torch.set_num_threads(2)
EOD = 1999  # the last id of the 2,000-entry vocabulary


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    d = tmp_path_factory.mktemp("vocab")
    vocab_file, merge_file = sc.write_gpt2_vocab(str(d), 2000)
    bert = d / "bert_vocab.txt"
    words = sorted({w for doc in sc.random_documents(20, 3) for w in
                    doc.lower().replace(".", " ").replace(",", " ").split()})
    bert.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
                               ".", ",", "##s", "##e"] + words[:400]) + "\n")
    jsonl = sc.write_jsonl(str(d / "corpus.jsonl"), 40, 1, min_words=5,
                           max_words=80)
    with open(jsonl, "a") as f:  # one empty line and one multi-byte text
        f.write("\n" + json.dumps({"text": "naïve café — 東京 x_y 42!"})
                + "\n")
    return dict(vocab=vocab_file, merges=merge_file, bert=str(bert),
                jsonl=jsonl, dir=d)


def _texts(vocab):
    with open(vocab["jsonl"]) as f:
        return [json.loads(line)["text"] for line in f if line.strip()]


@pytest.mark.parametrize("with_regex", [True, False])
def test_gpt2_tokenizer_ids_match_jax(vocab, monkeypatch, with_regex):
    if not with_regex:
        monkeypatch.setitem(sys.modules, "regex", None)
    jt = j_tok.GPT2BPETokenizer(vocab["vocab"], vocab["merges"])
    tt = t_tok.GPT2BPETokenizer(vocab["vocab"], vocab["merges"])
    # the JAX package takes `regex` where it imports and a stdlib
    # approximation where not; the port has one exact stdlib scanner
    assert ("regex" in type(jt.pat).__module__) == with_regex
    assert not hasattr(tt, "pat")
    assert tt.vocab_size == jt.vocab_size == 2000 and tt.eod == jt.eod
    for text in _texts(vocab) + ["it's 3.14 o'clock  _x\n\tend"]:
        ids = tt.tokenize(text)
        assert ids == jt.tokenize(text)
        assert tt.detokenize(ids) == jt.detokenize(ids) == text


@pytest.mark.parametrize("tokenizer_type", ["BertWordPieceLowerCase",
                                            "BertWordPieceCase"])
def test_bert_wordpiece_ids_match_jax(vocab, tokenizer_type):
    jt = j_tok.build_tokenizer(tokenizer_type, vocab_file=vocab["bert"])
    tt = t_tok.build_tokenizer(tokenizer_type, vocab_file=vocab["bert"])
    assert (tt.vocab_size, tt.eod, tt.cls, tt.pad) == (
        jt.vocab_size, jt.eod, jt.cls, jt.pad)
    for text in _texts(vocab):
        ids = tt.tokenize(text)
        assert ids == jt.tokenize(text)
        assert tt.detokenize(ids) == jt.detokenize(ids)


@pytest.mark.parametrize("tokenizer_type", ["BertWordPieceLowerCase",
                                            "BertWordPieceCase"])
def test_bert_wordpiece_ascii_matches_jax(vocab, tokenizer_type):
    """ASCII text takes the port's fast basic tokenization: every ASCII
    code point, the controls, whitespace and punctuation included, splits
    and maps as the reference's character loop does."""
    jt = j_tok.build_tokenizer(tokenizer_type, vocab_file=vocab["bert"])
    tt = t_tok.build_tokenizer(tokenizer_type, vocab_file=vocab["bert"])
    rng = np.random.RandomState(0)
    words = [w for w in open(vocab["bert"]).read().split() if w.isalpha()]
    texts = ["".join(map(chr, rng.randint(0, 128, size=n)))
             for n in rng.randint(0, 120, size=200)]
    texts += [" ".join(rng.choice(words, 12)).title() + "\x0bA\tb\x1fC,d!"
              for _ in range(20)]
    for text in texts:
        assert text.isascii()
        assert tt._basic_tokenize(text) == jt._basic_tokenize(text), text
        assert tt.tokenize(text) == jt.tokenize(text), text


def _preprocess(main, vocab, out, workers=1):
    main(["--input", vocab["jsonl"], "--output_prefix", str(out),
          "--tokenizer_type", "GPT2BPETokenizer", "--vocab_file",
          vocab["vocab"], "--merge_file", vocab["merges"], "--append_eod",
          "--workers", str(workers)])
    return str(out) + "_document"


def test_preprocess_writes_jax_bytes(vocab, tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jp = _preprocess(j_pre.main, vocab, tmp_path / "j" / "c")
    tp = _preprocess(t_pre.main, vocab, tmp_path / "t" / "c")
    for ext in (".bin", ".idx"):
        assert (open(tp + ext, "rb").read()
                == open(jp + ext, "rb").read()), ext
    ds = t_idx.make_dataset(tp)
    assert ds.dtype == np.uint16 and len(ds) == 41


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
def test_builder_bytes_and_reads_match_jax(tmp_path, dtype):
    rng = np.random.RandomState(0)
    docs = [rng.randint(0, 60000, size=n).tolist()
            for n in (5, 0, 17, 1, 33)]
    prefixes = {}
    for name, mod in (("j", j_idx), ("t", t_idx)):
        part = str(tmp_path / f"{name}_part")
        b = mod.IndexedDatasetBuilder(part, dtype=dtype)
        b.add_item([1, 2, 3])
        b.end_document()
        b.finalize()
        prefix = str(tmp_path / name)
        b = mod.IndexedDatasetBuilder(prefix, dtype=dtype)
        for doc in docs:
            b.add_item(doc)
            b.end_document()
        b.merge_file(part)
        b.finalize()
        prefixes[name] = prefix
    for ext in (".bin", ".idx"):
        assert (open(prefixes["t"] + ext, "rb").read()
                == open(prefixes["j"] + ext, "rb").read())
    jd, td = (j_idx.MMapIndexedDataset(prefixes["j"]),
              t_idx.MMapIndexedDataset(prefixes["t"]))
    np.testing.assert_array_equal(td.doc_idx, jd.doc_idx)
    for i in range(len(jd)):
        np.testing.assert_array_equal(td[i], jd[i])
        np.testing.assert_array_equal(td.get(i, offset=min(1, td.sizes[i]),
                                             length=0), jd.get(i, 0, 0))
    assert t_idx.best_fitting_dtype(32000) == j_idx.best_fitting_dtype(32000)


def _mappings(mod, prefix, sizes, documents, n, sl, seed, cache):
    return mod.build_index_mappings("train", prefix, documents, sizes, n, sl,
                                    seed, cache=cache)


@pytest.mark.parametrize("seq_length,seed,num_samples", [
    (16, 1234, 10), (16, 7, 300), (64, 1, 40), (7, 99, 1000)])
@pytest.mark.parametrize("empty_docs", [False, True])
def test_index_mappings_match_jax(tmp_path, seq_length, seed, num_samples,
                                  empty_docs):
    rng = np.random.RandomState(seed)
    sizes = rng.randint(1, 50, size=60).astype(np.int32)
    if empty_docs:  # the native walk (gpt_dataset.py:75-78)
        sizes[rng.choice(60, size=9, replace=False)] = 0
    documents = np.arange(3, 55, dtype=np.int32)
    for cache in (False, True):
        got = {}
        for name, mod in (("j", j_gpt), ("t", t_gpt)):
            d = tmp_path / f"{name}{int(cache)}"
            d.mkdir()
            got[name] = _mappings(mod, str(d / "c"), sizes, documents,
                                  num_samples, seq_length, seed, cache)
        for want, have in zip(got["j"], got["t"]):
            assert have.dtype == want.dtype and have.shape == want.shape
            np.testing.assert_array_equal(have, want)
    # the port rereads its own cache
    again = _mappings(t_gpt, str(tmp_path / "t1" / "c"), sizes, documents,
                      num_samples, seq_length, seed, True)
    for a, b in zip(again, got["t"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("weights,size", [([0.5, 0.5], 64),
                                          ([0.7, 0.2, 0.1], 1000),
                                          ([1, 3, 5, 11], 333)])
def test_blending_indices_match_jax(weights, size):
    w = np.asarray(weights, np.float64) / sum(weights)
    for want, have in zip(j_blend.build_blending_indices(w, size),
                          t_blend.build_blending_indices(w, size)):
        assert have.dtype == want.dtype
        np.testing.assert_array_equal(have, want)


@pytest.fixture(scope="module")
def corpora(vocab, tmp_path_factory):
    """The same preprocessed corpus in two directories, one per package."""
    d = tmp_path_factory.mktemp("corpora")
    base = _preprocess(t_pre.main, vocab, d / "c")
    out = {}
    for name in ("j", "t"):
        (d / name).mkdir()
        for ext in (".bin", ".idx"):
            shutil.copy(base + ext, d / name / ("c" + ext))
        out[name] = str(d / name / "c")
    return out


def _iterators(corpora, blend, flags, consumed=0, **kw):
    its = {}
    for name, gpt, samp in (("j", j_gpt, j_samp), ("t", t_gpt, t_samp)):
        path = ([corpora[name]] if not blend else
                [0.3, corpora[name], 0.7, corpora[name]])
        train, _, _ = gpt.build_train_valid_test_datasets(
            path, "90,5,5", 32, 1234, 64, 4, 4)
        its[name] = samp.BatchIterator(
            train, 2, 1, 2, consumed_samples=consumed, eod_token=EOD,
            **flags, **kw)
    return its


def _assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("flags", [
    {}, dict(eod_mask_loss=True), dict(reset_position_ids=True),
    dict(reset_attention_mask=True),
    dict(reset_position_ids=True, reset_attention_mask=True,
         eod_mask_loss=True)])
@pytest.mark.parametrize("blend,dataloader_type", [
    (False, "single"), (True, "single"), (False, "cyclic")])
def test_batches_and_resume_match_jax(corpora, flags, blend,
                                      dataloader_type):
    its = _iterators(corpora, blend, flags, dataloader_type=dataloader_type)
    states = []
    for _ in range(5):
        _assert_batches_equal(next(its["t"]), next(its["j"]))
        states.append((its["t"].state_dict(), its["j"].state_dict()))
    assert states[-1][0] == states[-1][1]
    if flags.get("reset_attention_mask"):
        assert int(next(its["t"])["segment_ids"].max()) > 0
    # resume from the state after batch 2 in fresh iterators
    fresh = _iterators(corpora, blend, flags, consumed=0,
                       dataloader_type=dataloader_type)
    assert t_samp.restore_data_state(fresh["t"], states[1][0])
    assert j_samp.restore_data_state(fresh["j"], states[1][1])
    replay = _iterators(corpora, blend, flags,
                        dataloader_type=dataloader_type)
    for _ in range(2):
        next(replay["t"])
    for _ in range(6):
        b = next(fresh["t"])
        _assert_batches_equal(b, next(fresh["j"]))
        _assert_batches_equal(b, next(replay["t"]))


def test_prefetch_state_counts_delivered_batches(corpora):
    its = _iterators(corpora, False, {})
    pf = t_samp.PrefetchIterator(its["t"], depth=3)
    try:
        for _ in range(2):
            _assert_batches_equal(next(pf), next(its["j"]))
        state = pf.state_dict()
    finally:
        pf.close()
    assert state["prefetch_depth"] == 3
    assert state["samples_yielded"] == its["j"].state_dict()[
        "samples_yielded"] == 8


@pytest.mark.parametrize("flags", [dict(reset_position_ids=True),
                                   dict(reset_attention_mask=True,
                                        eod_mask_loss=True)])
def test_ltor_masks_match_jax(flags):
    toks = np.random.RandomState(0).randint(0, 5, size=(3, 40))
    for want, have in zip(
            j_samp.get_ltor_masks_and_position_ids(toks, 0, **flags),
            t_samp.get_ltor_masks_and_position_ids(toks, 0, **flags)):
        np.testing.assert_array_equal(have, want)
