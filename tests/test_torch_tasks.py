"""The port's task heads and harnesses on the CPU against the JAX package:
classification and multiple-choice logits and gradients, the GLUE, RACE
and NQ-supervised datasets, one `finetune_and_evaluate` step and one
`finetune_retriever` step, and `tasks.main` for MNLI, RACE, NQ and
RET-FINETUNE-NQ (the reference's `tasks/main.py` beside it), on inputs
made from numpy seeds and JAX's initialised weights carried across by the
bridge (into the finetuning steps as a pretrained checkpoint that JAX's
npz writer saved).

Tolerances and why:
- logits 1e-5 relative to the largest magnitude, loss gradients 1e-4
  relative per leaf (as tests/test_torch_bert_t5.py);
- dataset samples and accuracies exactly: the same numpy and Python draws;
- one training step: loss and grad norm 1e-5 relative (the retriever's
  grad norm 1e-4: its in-batch softmax's gradients cancel at random init,
  as tests/test_torch_retrieval.py sets out); each parameter
  within 1e-5 except where JAX's first gradient is under G_EXEMPT, whose
  Adam step lr g / (|g| + eps) may turn with g's rounding (as
  test_custom_loss_train_step_matches_jax);
- the task entry points: the same result keys as the reference's lines.
"""
import importlib
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jc
from megatron_tpu.data.tokenizers import BertWordPieceTokenizer as JWP
from megatron_tpu.models import bert as jbert
from megatron_tpu.models import biencoder as jbi
from megatron_tpu.models import classification as jcls
from megatron_tpu.training import checkpointing as j_ckpt
from megatron_tpu.training import optimizer as jopt
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu.training.train_step import TrainState as JTrainState
from megatron_tpu_torch import config as tc
from megatron_tpu_torch.convert.from_jax import (params_from_numpy,
                                                 train_state_to_numpy)
from megatron_tpu_torch.data.tokenizers import BertWordPieceTokenizer as TWP
from megatron_tpu_torch.models import bert as tbert
from megatron_tpu_torch.models import biencoder as tbi
from megatron_tpu_torch.models import classification as tcls
from megatron_tpu_torch.tasks import data_utils as tdu
from megatron_tpu_torch.tasks import finetune_utils as tfu
from megatron_tpu_torch.tasks import main as tmain
from megatron_tpu_torch.tasks.glue import data as tglue
from megatron_tpu_torch.tasks.orqa import data as tnq
from megatron_tpu_torch.tasks.orqa import finetune as tret
from megatron_tpu_torch.tasks.race import data as trace
from tasks import data_utils as jdu
from tasks import finetune_utils as jfu
from tasks import main as jmain
from tasks.glue import data as jglue
from tasks.orqa import data as jnq
from tasks.orqa import finetune as jret
from tasks.race import data as jrace

jts = importlib.import_module("megatron_tpu.training.train_step")
tts = importlib.import_module("megatron_tpu_torch.training.train_step")

torch.set_num_threads(2)
TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=300, seq_length=64, compute_dtype="float32")
S, B, C = 32, 2, 4
# the first-step gradient below which Adam's step may turn with the
# rounding of g: ten times Adam's eps
G_EXEMPT = 1e-7
WORDS = ["the", "quick", "brown", "fox", "dog", "cat", "bird", "runs",
         "paris", "france", "london", "capital", "of", "is", "what",
         "river", "city", "north", "south", "old", "a", "b", "c", "d"]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS


def _rel_err(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(),
                                                      1e-30)


def _model(kind, impl, seed=0, **over):
    kw = dict(TINY, attention_impl=impl, **over)
    jcfg, tcfg = jbert.bert_config(**kw), tbert.bert_config(**kw)
    if kind == "classification":
        params = jcls.classification_init(jax.random.PRNGKey(seed), jcfg, 3)
        cls = tcls.ClassificationModel
    else:
        params = jcls.multiple_choice_init(jax.random.PRNGKey(seed), jcfg)
        cls = tcls.MultipleChoiceModel
    model = cls.from_state_dict(tcfg, params_from_numpy(
        params, tcfg, device="cpu", model_cls=cls), trainable=True)
    return jcfg, tcfg, params, model


def _batch(kind, padding, seed=0):
    rs = np.random.RandomState(seed)
    lead = (B,) if kind == "classification" else (B, C)
    batch = {"tokens": rs.randint(0, 300, (*lead, S)),
             "tokentype_ids": np.broadcast_to(
                 (np.arange(S) >= S // 2).astype(np.int64),
                 (*lead, S)).copy(),
             "label": rs.randint(0, 3 if kind == "classification" else C,
                                 (B,))}
    if padding:
        batch["padding_mask"] = (np.arange(S) < rs.randint(
            6, S + 1, (*lead, 1))).astype(np.int64)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


KINDS = {"classification": (jcls.classification_forward,
                            tcls.classification_forward,
                            jcls.classification_loss,
                            tcls.classification_loss),
         "multichoice": (jcls.multiple_choice_forward,
                         tcls.multiple_choice_forward,
                         jcls.multiple_choice_loss,
                         tcls.multiple_choice_loss)}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("impl", ["dot", "flash"])
@pytest.mark.parametrize("padding", [False, True])
def test_head_logits_match_jax(kind, impl, padding):
    jcfg, tcfg, params, model = _model(kind, impl)
    batch = _batch(kind, padding)
    jb, tb = _j(batch), _t(batch)
    jfwd, tfwd = KINDS[kind][:2]
    want = jfwd(params, jb["tokens"], jcfg, tokentype_ids=jb["tokentype_ids"],
                padding_mask=jb.get("padding_mask"))
    with torch.no_grad():
        got = tfwd(model, tb["tokens"], tcfg,
                   tokentype_ids=tb["tokentype_ids"],
                   padding_mask=tb.get("padding_mask"))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel_err(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("kind", list(KINDS))
def test_head_loss_grads_and_trees_match_jax(kind):
    """The padded loss through the flash path and every gradient leaf; the
    tree's names, the options read back off it, and the weight-decay mask
    against JAX's logical axes."""
    jcfg, tcfg, params, model = _model(kind, "flash", seed=2)
    batch = _batch(kind, True, seed=3)
    jloss, tloss = KINDS[kind][2:]
    want, want_g = jax.value_and_grad(jloss)(params, _j(batch), jcfg)
    got = tloss(model, _t(batch), tcfg)
    got.backward()
    assert _rel_err(got.item(), want) < 1e-5
    grads = _flatten(want_g)
    assert sorted(grads) == sorted(
        n.replace(".", "/") for n, _ in model.named_parameters())
    for name, p in model.named_parameters():
        assert _rel_err(p.grad.numpy(), grads[name.replace(".", "/")]) \
            < 1e-4, name
    axes = (jcls.classification_axes if kind == "classification"
            else jcls.multiple_choice_axes)
    want_mask = _flatten(jopt.weight_decay_mask(params, axes(jcfg)))
    assert tts.weight_decay_mask(model) == {
        k.replace("/", "."): bool(v) for k, v in want_mask.items()}
    if kind == "classification":
        assert model.options == {"num_classes": 3}


# --- the datasets ------------------------------------------------------------

def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(b[k], list):
            assert a[k] == b[k], k
            continue
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k])


def _mnli_rows(rs, n):
    labels = ["contradiction", "entailment", "neutral"]
    out = []
    for i in range(n):
        a = " ".join(rs.choice(WORDS, rs.randint(3, 12)))
        b = " ".join(rs.choice(WORDS, rs.randint(2, 8)))
        out.append([str(i)] + [""] * 7 + [a, b + " .", "x",
                                          labels[rs.randint(3)]])
    return out


@pytest.fixture(scope="module")
def task_files(tmp_path_factory):
    """MNLI and QQP TSVs, a RACE directory, an evidence TSV, an NQ
    question TSV and DPR training json, in the published layouts, with a
    WordPiece vocab.txt."""
    tmp = tmp_path_factory.mktemp("tasks")
    rs = np.random.RandomState(0)
    (tmp / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    header = "\t".join(f"c{i}" for i in range(12))
    for split, n in (("train", 8), ("dev", 6)):
        (tmp / f"mnli_{split}.tsv").write_text("\n".join(
            [header] + ["\t".join(r) for r in _mnli_rows(rs, n)]) + "\n")
    qqp = ["id\tqid1\tqid2\tquestion1\tquestion2\tis_duplicate"]
    for i in range(6):
        qqp.append(f"{i}\ta\tb\t{' '.join(rs.choice(WORDS, 5))}\t"
                   f"{' '.join(rs.choice(WORDS, 4))}\t{rs.randint(2)}")
    qqp.append("99\tonly\tthree")
    (tmp / "qqp.tsv").write_text("\n".join(qqp) + "\n")
    for split in ("train", "dev"):
        d = tmp / f"race_{split}"
        d.mkdir()
        lines = []
        for _ in range(2):
            qs = ["what is _ here", "what runs north"]
            lines.append(json.dumps({
                # short articles: the choices' own tokens are most of a
                # row, so their scores are not a near-tie (a tie's softmax
                # gradient is a difference of nearly equal terms)
                "article": " ".join(rs.choice(WORDS, 12)) + " .\n next",
                "questions": qs,
                "options": [list(rs.choice(WORDS, 4)) for _ in qs],
                "answers": [str("ABCD"[rs.randint(4)]) for _ in qs]}))
        (d / "high1.txt").write_text("\n".join(lines) + "\n")
    (tmp / "psgs.tsv").write_text("id\ttext\ttitle\n" + "".join(
        f"{i + 1}\t{' '.join(rs.choice(WORDS, 12))}\t{rs.choice(WORDS)}\n"
        for i in range(10)))
    (tmp / "nq.tsv").write_text(
        "what is the capital of france\t['paris']\n"
        "what runs north\t['fox', 'dog']\nwhat is the zebra\t['zebra']\n")

    def ctx():
        return {"title": str(rs.choice(WORDS)),
                "text": " ".join(rs.choice(WORDS, rs.randint(4, 12)))}
    for split, n in (("train", 4), ("dev", 3)):
        rows = [{"question": " ".join(rs.choice(WORDS, 5)) + "?",
                 "answers": [str(rs.choice(WORDS))],
                 "positive_ctxs": [ctx()],
                 "negative_ctxs": [ctx() for _ in range(rs.randint(0, 3))],
                 "hard_negative_ctxs": [ctx() for _ in range(
                     rs.randint(0, 3))]} for _ in range(n)]
        rows.append({"question": "no positive", "answers": [],
                     "positive_ctxs": []})
        (tmp / f"nq_{split}.json").write_text(json.dumps(rows))
    return {k: str(tmp / v) for k, v in (
        ("vocab", "vocab.txt"), ("mnli_train", "mnli_train.tsv"),
        ("mnli_dev", "mnli_dev.tsv"), ("qqp", "qqp.tsv"),
        ("race_train", "race_train"), ("race_dev", "race_dev"),
        ("psgs", "psgs.tsv"), ("nq", "nq.tsv"),
        ("nq_train", "nq_train.json"), ("nq_dev", "nq_dev.json"))} | {
        "tmp": tmp}


def test_pack_pair_and_clean_text_equal():
    rs = np.random.RandomState(1)
    for _ in range(20):
        a = list(rs.randint(5, 99, rs.randint(0, 30)))
        b = list(rs.randint(5, 99, rs.randint(0, 30))) if rs.rand() < 0.8 \
            else None
        np.testing.assert_array_equal(
            tdu.pack_pair(a, b, 24, 2, 3, 0),
            jdu.pack_pair(a, b, 24, 2, 3, 0))
    text = "a  b\n c . d . e"
    assert tdu.clean_text(text) == jdu.clean_text(text)


def test_glue_and_race_samples_bit_equal(task_files):
    f = task_files
    jtok, ttok = JWP(f["vocab"]), TWP(f["vocab"])
    for read_j, read_t, path in (
            (jglue.read_mnli, tglue.read_mnli, f["mnli_train"]),
            (jglue.read_qqp, tglue.read_qqp, f["qqp"])):
        rows = read_t(path)
        assert rows == read_j(path) and len(rows) >= 6
        want = jglue.GlueDataset(rows, jtok, 16)
        got = tglue.GlueDataset(rows, ttok, 16)
        for i in range(len(want)):
            _same(got[i], want[i])
    rows = trace.read_race(f["race_train"])
    assert rows == jrace.read_race(f["race_train"]) and len(rows) == 4
    want = jrace.RaceDataset(rows, jtok, 32, max_qa_length=6)
    got = trace.RaceDataset(rows, ttok, 32, max_qa_length=6)
    for i in range(len(want)):
        _same(got[i], want[i])


@pytest.mark.parametrize("mode", ["plain", "negatives", "evaluate",
                                  "sampled"])
def test_nq_supervised_samples_bit_equal(task_files, mode):
    """Samples and batches, the negatives' Python-random shuffles taken in
    the reference's order."""
    f = task_files
    kw = {"plain": {}, "negatives": dict(train_with_neg=True,
                                         train_hard_neg=2),
          "evaluate": dict(evaluate=True, val_av_rank_hard_neg=2,
                           val_av_rank_other_neg=1),
          "sampled": dict(sample_rate=0.5, train_with_neg=True,
                          train_hard_neg=1)}[mode]
    want = jnq.NQSupervisedDataset(f["nq_train"], JWP(f["vocab"]), 16, **kw)
    got = tnq.NQSupervisedDataset(f["nq_train"], TWP(f["vocab"]), 16, **kw)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        _same(got[i], want[i])
    for wb, gb in zip(want.batches(3, drop_last=False,
                                   shuffle_rng=np.random.RandomState(4)),
                      got.batches(3, drop_last=False,
                                  shuffle_rng=np.random.RandomState(4))):
        _same(gb, wb)


# --- one finetuning step of each harness -------------------------------------

def _configs(model, lr=1e-3, micro=2):
    opt = dict(lr=lr, clip_grad=1.0)
    tr = dict(micro_batch_size=micro, global_batch_size=micro,
              train_iters=1)
    return (jc.MegatronConfig(model=model[0],
                              optimizer=jc.OptimizerConfig(**opt),
                              training=jc.TrainingConfig(**tr)
                              ).validate(n_devices=1),
            tc.MegatronConfig(model=model[1],
                              optimizer=tc.OptimizerConfig(**opt),
                              training=tc.TrainingConfig(**tr)).validate())


def _recording(module, steps):
    make = module.make_train_step

    def recording_make(*a, **k):
        step = make(*a, **k)

        def recorded(*sa, **sk):
            state, m = step(*sa, **sk)
            steps.append((state, m))
            return state, m
        return recorded
    return recording_make


def _jax_init_checkpoint(root, params, cfg):
    """JAX's initial tree as an npz checkpoint, for the port's
    `pretrained_checkpoint` (its partial restore reads every leaf the
    port's tree shares with it, the head's too)."""
    j_ckpt.save_checkpoint(str(root), JTrainState(params, None,
                                                  jnp.int32(0)),
                           cfg, 0, backend="npz")
    return str(root)


def _check_step(jsteps, tsteps, tcls, norm_tol=1e-5):
    assert len(jsteps) == len(tsteps) == 1
    (jstate, jm), (tstate, tm) = jsteps[0], tsteps[0]
    assert _rel_err(float(tm["lm_loss"]), float(jm["lm_loss"])) < 1e-5
    assert _rel_err(float(tm["grad_norm"]), float(jm["grad_norm"])) \
        < norm_tol
    got, _, iteration = train_state_to_numpy(tstate)
    assert iteration == 1 and type(tstate.params) is tcls
    assert sorted(got) == sorted(_flatten(jstate.params))
    jmu = _flatten(jstate.opt_state.mu)
    for name, want in _flatten(jstate.params).items():
        g = np.asarray(jmu[name]) / 0.1  # mu = (1 - beta1) g
        held = np.abs(g) >= G_EXEMPT
        diff = np.abs(got[name] - np.asarray(want))
        assert diff[held].max(initial=0.0) <= 1e-5, name


@pytest.mark.parametrize("kind", ["classification", "multichoice"])
def test_finetune_and_evaluate_step_matches_jax(task_files, kind,
                                                monkeypatch, tmp_path):
    """One epoch of one batch, then the validation accuracy, from JAX's
    initial weights (its own seed's, carried across as a pretrained
    checkpoint): the step's metrics and parameters, and the accuracies."""
    f = task_files
    jtok, ttok = JWP(f["vocab"]), TWP(f["vocab"])
    seq = 32 if kind == "classification" else 48
    kw = dict(TINY, attention_impl="flash", vocab_size=jtok.vocab_size,
              seq_length=seq, max_position_embeddings=seq)
    jcfg, tcfg = _configs((jbert.bert_config(**kw),
                           tbert.bert_config(**kw)))
    if kind == "classification":
        rows = jglue.read_mnli(f["mnli_train"])[:2]
        valid = jglue.read_mnli(f["mnli_dev"])
        jtrain, jvalid = (jglue.GlueDataset(r, jtok, seq)
                          for r in (rows, valid))
        ttrain, tvalid = (tglue.GlueDataset(r, ttok, seq)
                          for r in (rows, valid))
        params = jcls.classification_init(jax.random.PRNGKey(1234),
                                          jcfg.model, 3)
        cls, opts = tcls.ClassificationModel, dict(num_classes=3)
    else:
        rows = jrace.read_race(f["race_train"])[:2]
        valid = jrace.read_race(f["race_dev"])
        jtrain, jvalid = (jrace.RaceDataset(r, jtok, seq)
                          for r in (rows, valid))
        ttrain, tvalid = (trace.RaceDataset(r, ttok, seq)
                          for r in (rows, valid))
        params = jcls.multiple_choice_init(jax.random.PRNGKey(1234),
                                           jcfg.model)
        cls, opts = tcls.MultipleChoiceModel, {}
    ckpt = _jax_init_checkpoint(tmp_path, params, jcfg)
    jsteps, tsteps = [], []
    monkeypatch.setattr(jts, "make_train_step", _recording(jts, jsteps))
    monkeypatch.setattr(tts, "make_train_step", _recording(tts, tsteps))
    want = jfu.finetune_and_evaluate(jcfg, jtrain, jvalid, kind=kind,
                                     num_classes=3, epochs=1)
    got = tfu.finetune_and_evaluate(tcfg, ttrain, tvalid, kind=kind,
                                    num_classes=3, epochs=1,
                                    pretrained_checkpoint=ckpt,
                                    device="cpu")
    _check_step(jsteps, tsteps, cls)
    assert got["best_accuracy"] == want["best_accuracy"]
    assert got["last_accuracy"] == want["last_accuracy"]
    assert opts == {k: v for k, v in got["params"].options.items()}


def test_retrieval_scores_and_average_rank_match_jax(task_files):
    f = task_files
    jtok, ttok = JWP(f["vocab"]), TWP(f["vocab"])
    kw = dict(TINY, attention_impl="dot", vocab_size=jtok.vocab_size,
              seq_length=16, max_position_embeddings=16)
    jcfg, tcfg = jbert.bert_config(**kw), tbert.bert_config(**kw)
    params = jbi.biencoder_init(jax.random.PRNGKey(3), jcfg,
                                ict_head_size=8)
    model = tbi.BiencoderModel.from_state_dict(tcfg, params_from_numpy(
        params, tcfg, device="cpu", model_cls=tbi.BiencoderModel))
    kw = dict(evaluate=True, val_av_rank_hard_neg=2,
              val_av_rank_other_neg=2)
    jds = jnq.NQSupervisedDataset(f["nq_dev"], jtok, 16, **kw)
    tds = tnq.NQSupervisedDataset(f["nq_dev"], ttok, 16, **kw)
    batch = next(jds.batches(3, drop_last=False))
    dev = {k: jnp.asarray(v) for k, v in batch.items()
           if k not in tret.HOST_KEYS}
    for scaling in (False, True):
        want, want_c = jret.retrieval_ce_loss(params, dev, jcfg,
                                              score_scaling=scaling)
        with torch.no_grad():
            got, got_c = tret.retrieval_ce_loss(
                model, tfu.to_device(batch, "cpu", skip=tret.HOST_KEYS),
                tcfg, score_scaling=scaling)
        assert _rel_err(got.item(), want) < 1e-5
        assert int(got_c) == int(want_c)
        assert tret.average_rank(model, tds, tcfg, 2, scaling) == \
            jret.average_rank(params, jds, jcfg, 2, scaling)


@pytest.mark.parametrize("shared", [False, True])
def test_finetune_retriever_step_matches_jax(task_files, shared,
                                             monkeypatch, tmp_path):
    f = task_files
    jtok, ttok = JWP(f["vocab"]), TWP(f["vocab"])
    kw = dict(TINY, attention_impl="flash", vocab_size=jtok.vocab_size,
              seq_length=16, max_position_embeddings=16)
    jcfg, tcfg = _configs((jbert.bert_config(**kw),
                           tbert.bert_config(**kw)), micro=4)
    tkw = dict(train_with_neg=True, train_hard_neg=1)
    vkw = dict(evaluate=True, val_av_rank_hard_neg=2,
               val_av_rank_other_neg=1)
    jtrain = jnq.NQSupervisedDataset(f["nq_train"], jtok, 16, **tkw)
    ttrain = tnq.NQSupervisedDataset(f["nq_train"], ttok, 16, **tkw)
    jvalid = jnq.NQSupervisedDataset(f["nq_dev"], jtok, 16, **vkw)
    tvalid = tnq.NQSupervisedDataset(f["nq_dev"], ttok, 16, **vkw)
    params = jbi.biencoder_init(jax.random.PRNGKey(1234), jcfg.model,
                                ict_head_size=8, shared=shared)
    ckpt = _jax_init_checkpoint(tmp_path, params, jcfg)
    jsteps, tsteps = [], []
    monkeypatch.setattr(jts, "make_train_step", _recording(jts, jsteps))
    monkeypatch.setattr(tts, "make_train_step", _recording(tts, tsteps))
    want = jret.finetune_retriever(jcfg, jtrain, jvalid, epochs=1,
                                   score_scaling=True, ict_head_size=8,
                                   shared=shared)
    got = tret.finetune_retriever(tcfg, ttrain, tvalid, epochs=1,
                                  score_scaling=True, ict_head_size=8,
                                  shared=shared,
                                  pretrained_checkpoint=ckpt,
                                  device="cpu")
    # the in-batch softmax's gradients at random init are sums that cancel
    # (tests/test_torch_retrieval.py): their norm, ~3e-5, is held to 1e-4
    _check_step(jsteps, tsteps, tbi.BiencoderModel, norm_tol=1e-4)
    assert got["final"] == want["final"]
    assert sorted(got["final"]) == ["average_rank", "top1_accuracy"]


# --- tasks.main --------------------------------------------------------------

SHAPE = ["--num_layers", "2", "--hidden_size", "64",
         "--num_attention_heads", "4"]


def _task_argv(task, f, tmp):
    common = ["--task", task, "--vocab_file", f["vocab"],
              "--tokenizer_type", "BertWordPieceLowerCase",
              "--micro_batch_size", "2", "--epochs", "1", *SHAPE]
    if task == "MNLI":
        return common + ["--train_data", f["mnli_train"], "--valid_data",
                         f["mnli_dev"], "--seq_length", "32"]
    if task == "RACE":
        return common + ["--train_data", f["race_train"], "--valid_data",
                         f["race_dev"], "--seq_length", "48"]
    if task == "RET-FINETUNE-NQ":
        return common + ["--train_data", f["nq_train"], "--valid_data",
                         f["nq_dev"], "--retriever_seq_length", "16",
                         "--train_with_neg", "--train_hard_neg", "1",
                         "--retriever_score_scaling", "--ict_head_size",
                         "8", "--val_av_rank_hard_neg", "2",
                         "--val_av_rank_other_neg", "1"]
    return common + ["--valid_data", f["nq"], "--load", str(tmp / "ict"),
                     "--evidence_data_path", f["psgs"], "--embedding_path",
                     str(tmp / "emb.npz"), "--retriever_seq_length", "16",
                     "--faiss_topk_retrievals", "5", "--ict_head_size", "8"]


def _last_json(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


@pytest.mark.parametrize("task", ["MNLI", "RACE", "NQ", "RET-FINETUNE-NQ"])
def test_tasks_main_prints_the_references_keys(task_files, task, capsys,
                                               monkeypatch):
    """Each task through both entry points (the reference's reads
    sys.argv): the result lines carry the same keys. NQ runs from one npz
    biencoder checkpoint written by JAX, its store built by the port's
    IndexBuilder; the port's evaluator prints the reference's per-k
    line."""
    f, tmp = task_files, task_files["tmp"]
    if task == "NQ" and not (tmp / "emb.npz").exists():
        from megatron_tpu_torch.data.orqa_dataset import \
            OpenRetrievalEvidenceDataset
        from megatron_tpu_torch.indexer import IndexBuilder
        kw = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
                  vocab_size=len(VOCAB), seq_length=16,
                  max_position_embeddings=16)
        cfg = jc.MegatronConfig(model=jbert.bert_config(**kw))
        params = jbi.biencoder_init(jax.random.PRNGKey(5), cfg.model,
                                    ict_head_size=8)
        j_ckpt.save_checkpoint(str(tmp / "ict"),
                               jts.state_from_params(params, cfg), cfg, 1,
                               backend="npz")
        tcfg = tbert.bert_config(**kw)
        model = tbi.BiencoderModel.from_state_dict(tcfg, params_from_numpy(
            params, tcfg, device="cpu", model_cls=tbi.BiencoderModel))
        IndexBuilder(model, tcfg, OpenRetrievalEvidenceDataset(
            f["psgs"], TWP(f["vocab"]), 16), embedding_path=str(
            tmp / "emb.npz"), log_interval=0,
            device="cpu").build_and_save_index()
    argv = _task_argv(task, f, tmp)
    got = tmain.main(argv, device="cpu")
    out = capsys.readouterr().out
    port_line = _last_json(out)
    monkeypatch.setattr(sys, "argv", ["tasks/main.py", *argv])
    jmain.main()
    want_line = _last_json(capsys.readouterr().out)
    assert port_line["task"] == want_line["task"] == task
    assert sorted(port_line) == sorted(want_line)
    if task == "NQ":
        assert sorted(port_line[f["nq"]]) == sorted(want_line[f["nq"]]) \
            == sorted(got[f["nq"]]) == ["top1", "top5"]
        assert "Retriever eval (test): top-1: " in out
    else:
        assert {k: v for k, v in port_line.items() if k != "task"} == got


@pytest.mark.parametrize("task", ["WIKITEXT103", "LAMBADA"])
def test_zero_shot_tasks_raise(task):
    with pytest.raises(NotImplementedError, match="item 8"):
        tmain.main(["--task", task, "--valid_data", "x"], device="cpu")


def test_task_entry_points_raise_without_gpu(monkeypatch, task_files):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(["--task", "MNLI", "--valid_data", "x"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcls.ClassificationModel(tbert.bert_config(**TINY), num_classes=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfu.finetune_and_evaluate(None, [], None, kind="multichoice")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tret.finetune_retriever(None, [], None)
