"""The port's zero-shot GPT evaluation (tasks/zeroshot_gpt, `tasks.main
--task WIKITEXT103/LAMBADA`) on the CPU against the JAX package's.

- detokenizers and dataset items bit for bit: the same strings, the same
  token windows and masks (with and without overlap, LAMBADA strict and
  not, `iterate_batches`' padded last batch);
- `evaluate_dataset` on the same weights (JAX's initialised weights
  carried across by the bridge) and data, fp32: loss_sum within 1e-5
  relative (float sums in another order), `correct` equal, on a GPT config
  whose vocabulary is padded (95 -> 128) and a Llama config whose is not.
  The port runs the flash path (its plain version here), JAX the dot path.
  Half of the LAMBADA samples end in the model's own argmax, so `correct`
  is not trivially 0;
- `tasks.main` end to end on an npz checkpoint the JAX package wrote,
  with a GPT-2 BPE tokenizer: the printed JSON equals JAX's `run_task`
  within 1e-5.
"""
import json
import string

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jc
from megatron_tpu.models import language_model as jlm
from megatron_tpu.training.checkpointing import save_checkpoint
from megatron_tpu.training.train_step import TrainState as JTrainState
from megatron_tpu_torch import config as tc
from megatron_tpu_torch.convert.from_jax import params_from_numpy
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.tasks import main as tmain
from megatron_tpu_torch.tasks.zeroshot_gpt import datasets as tds
from megatron_tpu_torch.tasks.zeroshot_gpt import detokenizer as tdt
from megatron_tpu_torch.tasks.zeroshot_gpt import evaluate as tev
from megatron_tpu_torch.tools import synthetic_corpus as sc
from tasks import main as jmain
from tasks.zeroshot_gpt import datasets as jds
from tasks.zeroshot_gpt import detokenizer as jdt
from tasks.zeroshot_gpt import evaluate as jev

torch.set_num_threads(2)
# printable ASCII without the whitespace but the space: 95 symbols
ALPHABET = "".join(c for c in string.printable
                   if c not in "\t\n\r\x0b\x0c")
V = len(ALPHABET)
SEQ = 32
WIKI_PIECES = ["the", "city", "@-@", "@,@", "@.@", ",", ".", ":", ";", "!",
               "?", "=", "( a )", "[ b ]", "{ c }", '" q "', "' s '", "'s",
               "n't", "N", "$ 1", "# 1", "°", "\n", "river", "north"]


class AlphabetTokenizer:
    """One token a symbol of ALPHABET (both packages' datasets call only
    `tokenize`)."""

    def tokenize(self, text):
        return [ALPHABET.index(c) for c in text if c in ALPHABET]


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


def _random_texts(seed, n, lo=5, hi=40):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        words = ["".join(rs.choice(list(string.ascii_letters + ".,;!?'"),
                                   rs.randint(1, 8)))
                 for _ in range(rs.randint(lo, hi))]
        out.append(" ".join(words))
    return out


# -- detokenizers and datasets --------------------------------------------

@pytest.mark.parametrize("name", ["ptb_detokenizer", "wikitext_detokenizer",
                                  "lambada_detokenizer"])
def test_detokenizers_equal_jax(name):
    rs = np.random.RandomState(0)
    texts = [" @-@ ", "a @,@ b", "x = = y", "( spaced )", "he 's",
             "= = = = T = = = =", "don 't", " N 5", "$ 1 and # 1",
             "it ' s", "[ x ]", "{ y }", '" z "', "a ° b", " \n x \n "]
    for _ in range(200):
        texts.append(" ".join(rs.choice(WIKI_PIECES, rs.randint(1, 30))))
    for text in texts:
        assert getattr(tdt, name)(text) == getattr(jdt, name)(text), text
    for path in ("wiki.test.tokens", "ptb.test.txt", "lambada.jsonl",
                 "other.txt"):
        assert (tdt.get_detokenizer(path).__name__
                == jdt.get_detokenizer(path).__name__)


def test_reference_detokenizer_rules():
    """The rules tests/test_tasks_zeroshot.py::TestDetokenizer pins."""
    assert tdt.wikitext_detokenizer(" @-@ ") == "-"
    assert tdt.wikitext_detokenizer("a @,@ b") == "a,b"
    assert tdt.wikitext_detokenizer("x = = y") == "x == y"
    assert tdt.wikitext_detokenizer("( spaced )") == "(spaced)"
    assert tdt.wikitext_detokenizer("he 's") == "he's"


def _same_items(tds_, jds_):
    assert len(tds_) == len(jds_)
    for i in range(len(jds_)):
        t, j = tds_[i], jds_[i]
        assert sorted(t) == sorted(j)
        for k in j:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k])


@pytest.mark.parametrize("overlap", [None, 4, 16])
@pytest.mark.parametrize("n_tok", [10, 100, 101])
def test_lm_dataset_items_equal_jax(overlap, n_tok):
    tokens = list(np.random.RandomState(n_tok).randint(0, 50, n_tok))
    kw = dict(seq_len=16, pad_idx=0, num_original_tokens=n_tok - 3,
              num_tokenized_tokens=n_tok, overlapping_eval=overlap)
    t, j = tds.LMDataset(tokens, **kw), jds.LMDataset(tokens, **kw)
    assert t.stride == j.stride and t.total_sequences == j.total_sequences
    _same_items(t, j)


def _lambada_file(path, texts):
    path.write_text("".join(json.dumps({"text": t}) + "\n" for t in texts)
                    + "\n")
    return str(path)


@pytest.mark.parametrize("strict", [False, True])
def test_lambada_items_equal_jax(tmp_path, strict):
    path = _lambada_file(tmp_path / "lambada.jsonl",
                         _random_texts(1, 9, 2, 6))
    tok = AlphabetTokenizer()
    t = tds.LambadaDataset(path, 0, tok, 64, strict=strict)
    j = jds.LambadaDataset(path, 0, tok, 64, strict=strict)
    assert t.examples == j.examples
    _same_items(t, j)
    for bs in (2, 4, 9, 16):
        tb = list(tds.iterate_batches(t, bs))
        jb = list(jds.iterate_batches(j, bs))
        assert len(tb) == len(jb)
        for a, b in zip(tb, jb):
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
    # the last batch repeats the final example with valid 0, mask 0
    last = list(tds.iterate_batches(t, 4))[-1]
    assert last["valid"].tolist() == [1.0, 0.0, 0.0, 0.0]
    assert last["pad_mask"][1:].sum() == 0
    np.testing.assert_array_equal(last["text"][3], last["text"][0])


def test_lambada_overlong_raises(tmp_path):
    path = _lambada_file(tmp_path / "lambada.jsonl", ["x" * 40])
    ds = tds.LambadaDataset(path, 0, AlphabetTokenizer(), 16)
    with pytest.raises(ValueError, match="longer"):
        ds[0]


def _wiki_text(seed, n):
    rs = np.random.RandomState(seed)
    return " ".join(rs.choice(WIKI_PIECES, n))


@pytest.mark.parametrize("overlap", [None, 8])
def test_wikitext_dataset_equals_jax(tmp_path, overlap):
    path = tmp_path / "wiki.test.tokens"
    path.write_text(_wiki_text(2, 300))
    tok = AlphabetTokenizer()
    t = tds.build_wikitext_dataset(str(path), tok, SEQ, overlap)
    j = jds.build_wikitext_dataset(str(path), tok, SEQ, overlap)
    assert (t.num_original_tokens, t.num_tokenized_tokens) == (
        j.num_original_tokens, j.num_tokenized_tokens)
    assert t.tokens == j.tokens
    _same_items(t, j)


# -- evaluate_dataset ---------------------------------------------------

def _configs(family):
    common = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
                  vocab_size=V, seq_length=SEQ, compute_dtype="float32")
    if family == "gpt":  # the vocabulary padded to 128
        jcfg = jc.gpt_config(**common)
        tcfg = tc.gpt_config(**common, attention_impl="flash")
    else:  # llama: not padded
        jcfg = jc.llama2_config("tiny", **common,
                                make_vocab_size_divisible_by=1)
        tcfg = tc.llama2_config("tiny", **common,
                                make_vocab_size_divisible_by=1,
                                attention_impl="flash")
    return jcfg, tcfg


def _models(family, seed=0):
    jcfg, tcfg = _configs(family)
    params = jlm.model_init(jax.random.PRNGKey(seed), jcfg)
    model = LanguageModel.from_state_dict(
        tcfg, params_from_numpy(params, tcfg, device="cpu"))
    return (jc.MegatronConfig(model=jcfg), params,
            tc.MegatronConfig(model=tcfg), model)


def _argmax_texts(model, tcfg, seed, n):
    """n texts: even ones random, odd ones end in the model's argmax
    symbol after their prefix (the non-strict target)."""
    texts = _random_texts(seed, n, 2, 5)
    tok = AlphabetTokenizer()
    out = []
    for i, text in enumerate(texts):
        if i % 2:
            ids = torch.tensor([tok.tokenize(text)])
            with torch.no_grad():
                logits, _ = model(ids)
            text += ALPHABET[int(logits[0, -1, :V].argmax())]
        out.append(text)
    return out


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_evaluate_dataset_matches_jax(tmp_path, family):
    jcfg, params, tcfg, model = _models(family)
    assert (tcfg.model.padded_vocab_size > V) == (family == "gpt")
    tok = AlphabetTokenizer()
    wiki = tmp_path / "wiki.test.tokens"
    wiki.write_text(_wiki_text(3, 120))
    lam = _lambada_file(tmp_path / "lambada.jsonl",
                        _argmax_texts(model, tcfg.model, 4, 10))
    cases = [
        (tds.build_wikitext_dataset(str(wiki), tok, SEQ, 8),
         jds.build_wikitext_dataset(str(wiki), tok, SEQ, 8)),
        (tds.build_wikitext_dataset(str(wiki), tok, SEQ, None),
         jds.build_wikitext_dataset(str(wiki), tok, SEQ, None)),
        (tds.build_lambada_dataset(lam, tok, SEQ, strict=False),
         jds.build_lambada_dataset(lam, tok, SEQ, strict=False)),
        (tds.build_lambada_dataset(lam, tok, SEQ, strict=True),
         jds.build_lambada_dataset(lam, tok, SEQ, strict=True))]
    for i, (t_ds, j_ds) in enumerate(cases):
        got = tev.evaluate_dataset(model, t_ds, tcfg, batch_size=4,
                                   device="cpu")
        want = jev.evaluate_dataset(params, j_ds, jcfg, batch_size=4)
        assert got["num_examples"] == want["num_examples"]
        assert _rel(got["loss_sum"], want["loss_sum"]) < 1e-5, (i, got,
                                                                 want)
        assert got["correct"] == want["correct"], (i, got, want)
        if i < 2:
            t_m, j_m = (tev.wikitext_metrics(got, t_ds),
                        jev.wikitext_metrics(want, j_ds))
        else:
            t_m, j_m = tev.lambada_metrics(got), jev.lambada_metrics(want)
        assert list(t_m) == list(j_m)
        for k in j_m:
            assert _rel(t_m[k], j_m[k]) < 1e-5, (k, t_m, j_m)
        if i == 2:
            # the argmax endings: at least those count as correct
            assert got["correct"] >= 5
    # the metric functions alone, on the same statistics
    stats = {"loss_sum": 123.456, "correct": 3.0, "num_examples": 7}
    assert tev.lambada_metrics(stats) == jev.lambada_metrics(stats)
    assert (tev.wikitext_metrics(stats, cases[0][0])
            == jev.wikitext_metrics(stats, cases[0][1]))


def test_evaluate_dataset_refuses_mesh_and_misplaced_weights():
    _, _, tcfg, model = _models("llama")
    ds = tds.LMDataset(list(range(40)), SEQ, 0, 40, 40)
    with pytest.raises(NotImplementedError, match="item 7"):
        tev.evaluate_dataset(model, ds, tcfg, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="weights lie on"):
        tev.evaluate_dataset(model, ds, tcfg, device="meta")


# -- tasks.main end to end ---------------------------------------------

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A GPT (vocabulary 300 -> 384) saved by the JAX package's npz writer,
    a GPT-2 BPE vocabulary of 300 and the task files."""
    root = tmp_path_factory.mktemp("zeroshot")
    vocab, merges = sc.write_gpt2_vocab(str(root / "tok"), 300)
    jcfg = jc.gpt_config(num_layers=2, hidden_size=64, num_attention_heads=4,
                         vocab_size=300, seq_length=64,
                         compute_dtype="float32")
    params = jlm.model_init(jax.random.PRNGKey(5), jcfg)
    ckpt = str(root / "ckpt")
    save_checkpoint(ckpt, JTrainState(params, None, jnp.int32(1)),
                    jc.MegatronConfig(model=jcfg), iteration=1,
                    backend="npz")
    docs = sc.random_documents(6, 3, min_words=30, max_words=60)
    wiki = root / "wiki.test.tokens"
    wiki.write_text(" @-@ ".join(docs) + " \n = = heading = = \n")
    lam = root / "lambada_test.jsonl"
    lam.write_text("".join(json.dumps({"text": " ".join(d.split()[:12])})
                           + "\n" for d in docs))
    return dict(ckpt=ckpt, vocab=vocab, merges=merges, wiki=str(wiki),
                lambada=str(lam))


@pytest.mark.parametrize("task,extra", [
    ("WIKITEXT103", []), ("WIKITEXT103", ["--overlapping_eval", "16"]),
    ("LAMBADA", []), ("LAMBADA", ["--strict_lambada"])])
def test_tasks_main_matches_jax_run_task(checkpoint, capsys, task, extra):
    argv = ["--task", task, "--load", checkpoint["ckpt"],
            "--valid_data", checkpoint["wiki" if task == "WIKITEXT103"
                                       else "lambada"],
            "--tokenizer_type", "GPT2BPETokenizer", "--vocab_file",
            checkpoint["vocab"], "--merge_file", checkpoint["merges"],
            "--micro_batch_size", "3", *extra]
    want = jmain.run_task(jmain.get_tasks_parser().parse_args(argv))
    capsys.readouterr()
    got = tmain.main(argv, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[-3].startswith(f" validation results on {task} | ")
    printed = json.loads(out[-1])
    assert printed == {"task": task, **got}
    assert list(got) == list(want)
    for k in want:
        assert _rel(got[k], want[k]) < 1e-5, (k, got, want)


def test_tasks_flag_defaults_equal_jax():
    argv = ["--task", "LAMBADA", "--valid_data", "x"]
    t = vars(tmain.get_tasks_parser().parse_args(argv))
    j = vars(jmain.get_tasks_parser().parse_args(argv))
    for flag in ("overlapping_eval", "strict_lambada", "micro_batch_size",
                 "seq_length", "tokenizer_type"):
        assert t[flag] == j[flag], flag
