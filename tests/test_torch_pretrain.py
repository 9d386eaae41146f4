"""The port's pretrain_bert and pretrain_t5 entry points on the CPU, on the
JAX entry points' tiny corpus (tests/test_pretrain_entrypoints.py): each
returns 0 and writes an npz checkpoint that the JAX package's loader reads
leaf for leaf; a JAX checkpoint of the same family resumes in the port; an
interrupted run resumed from its checkpoint ends bit-equal to the
uninterrupted one; the WordPiece vocabulary of tools/synthetic_corpus.py
leaves its BPE mode's output as it was.
"""
import importlib
import os

import jax
import numpy as np
import pytest
import torch

from megatron_tpu import config as jc
from megatron_tpu.data.indexed_dataset import IndexedDatasetBuilder
from megatron_tpu.models import bert as jbert
from megatron_tpu.models import t5 as jt5
from megatron_tpu.training import checkpointing as j_ckpt
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import pretrain_bert, pretrain_t5
from megatron_tpu_torch.data.tokenizers import build_tokenizer
from megatron_tpu_torch.tools import synthetic_corpus
from megatron_tpu_torch.training import checkpointing as t_ckpt

jts = importlib.import_module("megatron_tpu.training.train_step")

torch.set_num_threads(2)
VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
         + [f"tok{i}" for i in range(59)])
EXTRA_IDS = 8
ENTRY = {"bert": pretrain_bert, "t5": pretrain_t5}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """8 documents of 96 random ids and the 64-entry vocab.txt."""
    tmp = tmp_path_factory.mktemp("pretrain")
    rng = np.random.default_rng(0)
    vocab_file = tmp / "vocab.txt"
    vocab_file.write_text("\n".join(VOCAB) + "\n")
    prefix = str(tmp / "docs")
    b = IndexedDatasetBuilder(prefix)
    for _ in range(8):
        b.add_item(rng.integers(5, 64, size=96).tolist())
        b.end_document()
    b.finalize()
    return {"vocab": str(vocab_file), "docs": prefix, "tmp": tmp}


def _argv(corpus, family, save, *extra, iters=3):
    argv = ["--data_path", corpus["docs"], "--vocab_file", corpus["vocab"],
            "--tokenizer_type", "BertWordPieceLowerCase",
            "--num_layers", "2", "--hidden_size", "64",
            "--num_attention_heads", "4", "--seq_length", "32",
            "--max_position_embeddings", "32", "--micro_batch_size", "2",
            "--global_batch_size", "4", "--train_iters", str(iters),
            "--lr", "1e-4", "--log_interval", "1", "--attention_impl",
            "flash", "--save", save, *extra]
    if family == "t5":
        argv += ["--vocab_extra_ids", str(EXTRA_IDS), "--decoder_seq_length",
                 "16"]
    return argv


def _jax_example(family):
    """A JAX state of the entry points' tiny model (vocab 64 + extra ids,
    padded to 128)."""
    vocab = len(VOCAB) + (EXTRA_IDS if family == "t5" else 0)
    kw = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
              seq_length=32, vocab_size=vocab)
    model = (jbert.bert_config if family == "bert" else jt5.t5_config)(**kw)
    cfg = jc.MegatronConfig(model=model)
    init = jbert.bert_init if family == "bert" else jt5.t5_init
    return cfg, jts.state_from_params(init(jax.random.PRNGKey(3), model),
                                      cfg)


def _params(root):
    return t_ckpt.read_params(t_ckpt.tracked_dir(root))


@pytest.mark.parametrize("family", ["bert", "t5"])
def test_entry_point_checkpoint_loads_in_jax_and_resumes_exactly(corpus,
                                                                 family):
    """Uninterrupted 3 iterations; 2 then a resume to 3 from the checkpoint
    at 2: the same final parameters bit for bit. The JAX loader reads the
    port's checkpoint with every leaf equal."""
    tmp = corpus["tmp"]
    whole, part = str(tmp / f"{family}_whole"), str(tmp / f"{family}_part")
    main = ENTRY[family].main
    assert main(_argv(corpus, family, whole, "--save_interval", "3"),
                device="cpu") == 0
    assert main(_argv(corpus, family, part, "--save_interval", "2",
                      "--exit_interval", "2"), device="cpu") == 0
    assert t_ckpt.read_tracker(part) == "2"
    assert main(_argv(corpus, family, part, "--save_interval", "3"),
                device="cpu") == 0
    want, got = _params(whole), _params(part)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    _, example = _jax_example(family)
    loaded = j_ckpt.load_checkpoint(whole, example)
    assert loaded.iteration == 3
    flat = _flatten(loaded.state.params)
    assert sorted(flat) == sorted(want)
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(v), want[k], err_msg=k)


@pytest.mark.parametrize("family", ["bert", "t5"])
def test_jax_checkpoint_resumes_in_the_entry_point(corpus, family):
    """A JAX state of the family saved as npz at iteration 1: the port's
    entry point loads it (the loaded log line names iteration 1) and trains
    to 2; the untouched leaves of an iteration-1 save read back equal."""
    cfg, state = _jax_example(family)
    root = str(corpus["tmp"] / f"{family}_from_jax")
    j_ckpt.save_checkpoint(root, state, cfg, 1, consumed_samples=4,
                           backend="npz")
    want = _flatten(state.params)
    assert ENTRY[family].main(
        _argv(corpus, family, root, "--save_interval", "2", iters=2),
        device="cpu") == 0
    assert t_ckpt.read_tracker(root) == "2"
    got = t_ckpt.read_params(os.path.join(root, "iter_0000001"))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    after = _params(root)
    moved = [k for k in want if not np.array_equal(after[k], want[k])]
    assert moved, "the resumed step changed no parameter"


def test_wordpiece_vocabulary_and_bpe_mode_unchanged(tmp_path):
    """The WordPiece mode writes exactly the size asked, the five specials
    first, and the port's WordPiece tokenizer reads the synthetic documents
    without [UNK]; the BPE vocabulary of a seed is what it was."""
    path = synthetic_corpus.write_wordpiece_vocab(str(tmp_path), 2000)
    tokens = open(path, encoding="utf-8").read().splitlines()
    assert len(tokens) == len(set(tokens)) == 2000
    assert tokens[:5] == synthetic_corpus.WORDPIECE_SPECIALS
    tok = build_tokenizer("BertWordPieceLowerCase", vocab_file=path,
                          vocab_extra_ids=100)
    assert tok.vocab_size == 2100
    ids = [i for d in synthetic_corpus.random_documents(5, 0)
           for i in tok.tokenize(d)]
    assert ids and tok.vocab["[UNK]"] not in ids
    vocab_file, merge_file = synthetic_corpus.write_gpt2_vocab(
        str(tmp_path / "bpe"), 300)
    vocab = open(vocab_file, encoding="utf-8").read()
    merges = open(merge_file, encoding="utf-8").read().splitlines()
    assert len(merges) == 1 + 300 - 257
    assert merges[:3] == ["#version: 0.2", "Ġ a", "Ġ b"]
    assert vocab.endswith('"<|endoftext|>": 299}')
