"""The port's training loop and entry point (megatron_tpu_torch/training/
loop.py, finetune.py, arguments.py) on the CPU, against the JAX package's
`train` on the same tiny fp32 model, the same corpus and the same initial
state (moved across by the bridge).

Tolerances: per-iteration loss, grad norm and eval loss 1e-5 relative, as
tests/test_torch_training.py holds three steps (the same fp32 formulas summed
in another order; measured ~1e-7). Iteration counts, consumed samples,
checkpoint metadata (data state, quarantine windows) are exact, and an
interrupted-then-resumed port run equals an uninterrupted one bit for bit.
"""
import dataclasses
import json
import os
import shutil
import signal

import jax
import numpy as np
import pytest
import torch

from megatron_tpu import config as jc
from megatron_tpu.data import gpt_dataset as j_gpt
from megatron_tpu.data import samplers as j_samp
from megatron_tpu.training import checkpointing as j_ckpt
from megatron_tpu.training import loop as j_loop
from megatron_tpu.training.train_step import init_train_state as j_init
from megatron_tpu_torch import config as tc
from megatron_tpu_torch import finetune
from megatron_tpu_torch.convert.from_jax import (train_state_from_numpy,
                                                 train_state_to_numpy)
from megatron_tpu_torch.data import gpt_dataset as t_gpt
from megatron_tpu_torch.data import samplers as t_samp
from megatron_tpu_torch.tools import preprocess_data as t_pre
from megatron_tpu_torch.tools import synthetic_corpus as sc
from megatron_tpu_torch.training import checkpointing as t_ckpt
from megatron_tpu_torch.training import loop as t_loop

torch.set_num_threads(2)
VOCAB = 2000
SEQ = 32
MODEL = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
             num_kv_heads=2, vocab_size=VOCAB, seq_length=SEQ,
             attention_impl="flash", compute_dtype="float32")
FAST_IO = dict(io_backoff_s=0.01, io_backoff_max_s=0.02)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A preprocessed synthetic corpus, one copy per package (separate
    index-mapping caches)."""
    d = tmp_path_factory.mktemp("loop_corpus")
    vocab_file, merge_file = sc.write_gpt2_vocab(str(d), VOCAB)
    jsonl = sc.write_jsonl(str(d / "c.jsonl"), 80, 2, min_words=5,
                           max_words=40)
    t_pre.main(["--input", jsonl, "--output_prefix", str(d / "c"),
                "--tokenizer_type", "GPT2BPETokenizer", "--vocab_file",
                vocab_file, "--merge_file", merge_file, "--append_eod"])
    out = dict(vocab=vocab_file, merges=merge_file, dir=d)
    for name in ("j", "t", "cli"):
        (d / name).mkdir()
        for ext in (".bin", ".idx"):
            shutil.copy(str(d / "c_document") + ext, d / name / ("c" + ext))
        out[name] = str(d / name / "c")
    return out


def _configs(train_iters=6, family="llama", **tr):
    kw = dict(micro_batch_size=2, global_batch_size=4,
              train_iters=train_iters, seed=11, **tr)
    opt = dict(lr=1e-3, min_lr=1e-4, lr_warmup_iters=1)
    data = dict(reset_attention_mask=True, reset_position_ids=True,
                eod_mask_loss=True)
    if family == "mixtral":
        model = dict(MODEL, ffn_hidden_size=96, num_experts=4,
                     moe_capacity_factor=1.25)
        return (jc.MegatronConfig(
                    model=jc.mixtral_config("tiny", **model),
                    optimizer=jc.OptimizerConfig(**opt),
                    training=jc.TrainingConfig(**kw),
                    data=jc.DataConfig(**data),
                    resilience=jc.ResilienceConfig(**FAST_IO)),
                tc.MegatronConfig(
                    model=tc.mixtral_config("tiny", **model),
                    optimizer=tc.OptimizerConfig(**opt),
                    training=tc.TrainingConfig(**kw),
                    data=tc.DataConfig(**data),
                    resilience=tc.ResilienceConfig(**FAST_IO)))
    return (jc.MegatronConfig(
                model=jc.llama2_config("tiny", **MODEL),
                optimizer=jc.OptimizerConfig(**opt),
                training=jc.TrainingConfig(**kw),
                data=jc.DataConfig(**data),
                resilience=jc.ResilienceConfig(**FAST_IO)),
            tc.MegatronConfig(
                model=tc.llama2_config("tiny", **MODEL),
                optimizer=tc.OptimizerConfig(**opt),
                training=tc.TrainingConfig(**kw),
                data=tc.DataConfig(**data),
                resilience=tc.ResilienceConfig(**FAST_IO)))


def _iterators(gpt, samp, prefix, cfg, consumed=0):
    tr = cfg.training
    train, valid, _ = gpt.build_train_valid_test_datasets(
        [prefix], "85,10,5", SEQ, tr.seed, 64, 16, 8)

    def make(ds, c):
        return samp.BatchIterator(
            ds, tr.micro_batch_size, 1, 2, consumed_samples=c,
            seed=tr.seed, eod_token=VOCAB - 1, reset_position_ids=True,
            reset_attention_mask=True, eod_mask_loss=True)
    return make(train, consumed), make(valid, 0)


def _record_steps(monkeypatch, module, records, poison=()):
    """Wrap `module.make_train_step` so each step appends (iteration before
    it, loss, grad norm) to `records`; at the iterations in `poison` the
    step reports a non-finite loss and found_inf (the divergence guard's
    input), as a poison batch would."""
    orig = module.make_train_step

    def make(*a, **k):
        step = orig(*a, **k)

        def recorded(state, batch, rng):
            it = int(state.iteration)
            state, m = step(state, batch, rng)
            if it in poison:
                m = dict(m, lm_loss=m["lm_loss"] * float("nan"),
                         found_inf=m["found_inf"] * 0 + 1)
            records.append((it, float(m["lm_loss"]),
                            float(m["grad_norm"])))
            return state, m
        return recorded

    monkeypatch.setattr(module, "make_train_step", make)


def _record_evals(monkeypatch, module, records):
    orig = module.evaluate

    def evaluate(*a, **k):
        out = orig(*a, **k)
        records.append(out["lm loss"])
        return out

    monkeypatch.setattr(module, "evaluate", evaluate)


def _save_fns(jcfg, tcfg, tmp_path):
    roots = {"j": str(tmp_path / "j_ckpt"), "t": str(tmp_path / "t_ckpt")}

    def j_save(st, iteration, consumed, data_state=None, quarantine=None):
        j_ckpt.save_checkpoint(roots["j"], st, jcfg, iteration, consumed,
                               backend="npz", data_state=data_state,
                               quarantine=quarantine)

    def t_save(st, iteration, consumed, data_state=None, quarantine=None):
        t_ckpt.save_checkpoint(roots["t"], st, tcfg, iteration, consumed,
                               data_state=data_state, quarantine=quarantine)
    return roots, j_save, t_save


def _meta(root, iteration):
    with open(os.path.join(root, f"iter_{iteration:07d}",
                           "metadata.json")) as f:
        meta = json.load(f)
    meta.pop("format_version")
    meta.pop("has_opt_state")
    return meta


def test_train_matches_jax(corpus, monkeypatch, tmp_path):
    """6 iterations, log 2, eval 3, save 3, with segment ids: per-iteration
    loss and grad norm, eval losses, consumed samples and the checkpoints'
    metadata against JAX's train(mesh=None)."""
    jcfg, tcfg = _configs(log_interval=2, eval_interval=3, eval_iters=2,
                          save_interval=3)
    jstate = j_init(jax.random.PRNGKey(0), jcfg)
    tstate = train_state_from_numpy(jstate.params, jstate.opt_state,
                                    jstate.iteration, tcfg, device="cpu")
    recs = {"j": [], "t": []}
    evals = {"j": [], "t": []}
    _record_steps(monkeypatch, j_loop, recs["j"])
    _record_steps(monkeypatch, t_loop, recs["t"])
    _record_evals(monkeypatch, j_loop, evals["j"])
    _record_evals(monkeypatch, t_loop, evals["t"])
    roots, j_save, t_save = _save_fns(jcfg, tcfg, tmp_path)
    jit, jvalid = _iterators(j_gpt, j_samp, corpus["j"], jcfg)
    tit, tvalid = _iterators(t_gpt, t_samp, corpus["t"], tcfg)
    assert int(next(_iterators(t_gpt, t_samp, corpus["t"], tcfg)[0])[
        "segment_ids"].max()) > 0
    _, jconsumed = j_loop.train(jcfg, jit, jvalid, mesh=None, state=jstate,
                                rng=jax.random.PRNGKey(1), save_fn=j_save)
    tstate, tconsumed = t_loop.train(tcfg, tit, tvalid, state=tstate,
                                     save_fn=t_save, device="cpu")
    assert tconsumed == jconsumed == 24 and tstate.iteration == 6
    assert [r[0] for r in recs["t"]] == [r[0] for r in recs["j"]] == \
        list(range(6))
    for (_, tl, tg), (_, jl, jg) in zip(recs["t"], recs["j"]):
        assert _rel(tl, jl) < 1e-5 and _rel(tg, jg) < 1e-5
    assert len(evals["t"]) == len(evals["j"]) == 2
    for a, b in zip(evals["t"], evals["j"]):
        assert _rel(a, b) < 1e-5
    for it in (3, 6):
        assert _meta(roots["t"], it) == _meta(roots["j"], it)
    assert _meta(roots["t"], 3)["consumed_samples"] == 12


def test_mixtral_train_and_finetune_entry_point(corpus, monkeypatch,
                                               tmp_path):
    """A tiny Mixtral at capacity 1.25 (tokens drop, the router's loss in
    the loss): 4 iterations of the port's train against JAX's, loss and
    grad norm at 1e-5; then finetune.main --model mixtral-tiny with the MoE
    flags runs to its end with finite losses."""
    jcfg, tcfg = _configs(train_iters=4, family="mixtral", log_interval=2)
    jstate = j_init(jax.random.PRNGKey(0), jcfg)
    tstate = train_state_from_numpy(jstate.params, jstate.opt_state,
                                    jstate.iteration, tcfg, device="cpu")
    recs = {"j": [], "t": []}
    _record_steps(monkeypatch, j_loop, recs["j"])
    _record_steps(monkeypatch, t_loop, recs["t"])
    jit, jvalid = _iterators(j_gpt, j_samp, corpus["j"], jcfg)
    tit, tvalid = _iterators(t_gpt, t_samp, corpus["t"], tcfg)
    j_loop.train(jcfg, jit, jvalid, mesh=None, state=jstate,
                 rng=jax.random.PRNGKey(1))
    t_loop.train(tcfg, tit, tvalid, state=tstate, device="cpu")
    assert len(recs["t"]) == len(recs["j"]) == 4
    for (_, tl, tg), (_, jl, jg) in zip(recs["t"], recs["j"]):
        assert _rel(tl, jl) < 1e-5 and _rel(tg, jg) < 1e-5
    monkeypatch.undo()
    recs = []
    _record_steps(monkeypatch, t_loop, recs)
    argv = _argv(corpus, "--train_iters", "2", "--eval_interval", "2")
    argv[argv.index("llama2-tiny")] = "mixtral-tiny"
    argv += ["--ffn_hidden_size", "96", "--num_experts", "4",
             "--moe_capacity_factor", "1.25", "--moe_dispatch", "sort"]
    assert finetune.main(argv, device="cpu") == 0
    assert len(recs) == 2 and all(np.isfinite(r[1]) for r in recs)


def _argv(corpus, *extra):
    return ["--model", "llama2-tiny", "--num_layers", "2", "--hidden_size",
            "64", "--num_attention_heads", "4", "--num_attention_heads_kv",
            "2", "--seq_length", str(SEQ), "--use_flash_attn",
            "--attention_dropout", "0.1", "--data_path", corpus["cli"],
            "--split", "85,10,5", "--tokenizer_type", "GPT2BPETokenizer",
            "--vocab_file", corpus["vocab"], "--merge_file",
            corpus["merges"], "--micro_batch_size", "2",
            "--global_batch_size", "4", "--reset_attention_mask",
            "--reset_position_ids", "--eod_mask_loss", "--log_interval", "2",
            "--eval_interval", "3", "--eval_iters", "1", "--train_iters",
            "6", "--lr", "1e-3", *extra]


def test_finetune_resume_is_bit_exact(corpus, monkeypatch, tmp_path):
    """finetune.main end to end on the CPU with attention dropout: an
    uninterrupted 6-iteration run against one that checkpoints and exits at
    iteration 3 and a second that loads it: the same losses bit for bit,
    and the same final parameters and moments."""
    runs = {}
    for name, argvs in (
            ("whole", [_argv(corpus)]),
            ("split", [_argv(corpus, "--save", str(tmp_path / "d"),
                             "--exit_interval", "3"),
                       _argv(corpus, "--load", str(tmp_path / "d"))])):
        recs, states = [], []
        orig = t_loop.train

        def train(*a, **k):
            out = orig(*a, **k)
            states.append(out[0])
            return out

        monkeypatch.setattr(t_loop, "train", train)
        _record_steps(monkeypatch, t_loop, recs)
        for argv in argvs:
            assert finetune.main(argv, device="cpu") == 0
        monkeypatch.undo()
        runs[name] = (recs, train_state_to_numpy(states[-1]))
    whole, split = runs["whole"][0], runs["split"][0]
    assert [r[0] for r in split] == list(range(6))
    assert split == whole
    meta = _meta(str(tmp_path / "d"), 3)
    assert meta["consumed_samples"] == 12 and meta["data_state"][
        "samples_yielded"] == 12
    (pw, ow, iw), (ps, os_, is_) = runs["whole"][1], runs["split"][1]
    assert iw == is_ == 6 and ow["step"] == os_["step"] == 6
    for k in pw:
        np.testing.assert_array_equal(ps[k], pw[k], err_msg=k)
        np.testing.assert_array_equal(os_["mu"][k], ow["mu"][k], err_msg=k)
        np.testing.assert_array_equal(os_["nu"][k], ow["nu"][k], err_msg=k)


def test_rollback_quarantines_the_same_window_as_jax(corpus, monkeypatch,
                                                     tmp_path):
    """Non-finite steps at iterations 5 and 6 (max 2 in a row), checkpoints
    every 2, metrics fetched every 4: both loops roll back to iteration 4,
    replay the data order and skip the window [5, 6]."""
    jcfg, tcfg = _configs(train_iters=8, log_interval=4, save_interval=2)
    res = dict(max_consecutive_nonfinite=2, **FAST_IO)
    jcfg = dataclasses.replace(jcfg, resilience=jc.ResilienceConfig(**res))
    tcfg = dataclasses.replace(tcfg, resilience=tc.ResilienceConfig(**res))
    jstate = j_init(jax.random.PRNGKey(0), jcfg)
    tstate = train_state_from_numpy(jstate.params, jstate.opt_state,
                                    jstate.iteration, tcfg, device="cpu")
    recs = {"j": [], "t": []}
    _record_steps(monkeypatch, j_loop, recs["j"], poison={4, 5})
    _record_steps(monkeypatch, t_loop, recs["t"], poison={4, 5})
    roots, j_save, t_save = _save_fns(jcfg, tcfg, tmp_path)
    jexample = j_init(jax.random.PRNGKey(0), jcfg)

    def reset(gpt, samp, prefix, cfg):
        def fn(consumed, rollbacks, data_state=None):
            it, _ = _iterators(gpt, samp, prefix, cfg, consumed)
            samp.restore_data_state(it, data_state)
            return it
        return fn

    jit, _ = _iterators(j_gpt, j_samp, corpus["j"], jcfg)
    tit, _ = _iterators(t_gpt, t_samp, corpus["t"], tcfg)
    _, jconsumed = j_loop.train(
        jcfg, jit, None, mesh=None, state=jstate, rng=jax.random.PRNGKey(1),
        save_fn=j_save,
        load_fn=lambda: j_ckpt.load_checkpoint(roots["j"], jexample),
        reset_data_fn=reset(j_gpt, j_samp, corpus["j"], jcfg))
    tstate, tconsumed = t_loop.train(
        tcfg, tit, None, state=tstate, save_fn=t_save,
        load_fn=lambda: t_ckpt.load_checkpoint(roots["t"], tstate),
        reset_data_fn=reset(t_gpt, t_samp, corpus["t"], tcfg), device="cpu")
    assert tconsumed == jconsumed == 32 and tstate.iteration == 8
    assert [r[0] for r in recs["t"]] == [r[0] for r in recs["j"]] == \
        [0, 1, 2, 3, 4, 5, 6, 7]
    for (_, tl, tg), (_, jl, jg) in zip(recs["t"], recs["j"]):
        if np.isfinite(jl):
            assert _rel(tl, jl) < 1e-5 and _rel(tg, jg) < 1e-5
    tmeta, jmeta = _meta(roots["t"], 8), _meta(roots["j"], 8)
    assert tmeta == jmeta
    assert tmeta["quarantine"] == [{"from_iteration": 5, "to_iteration": 6,
                                    "samples": 8, "rollback": 1}]


def test_exit_interval_and_sigterm_match_jax(corpus, monkeypatch, tmp_path):
    """exit_interval 4 stops both loops at iteration 4 with a checkpoint; a
    SIGTERM during step 2 checkpoints and exits at iteration 2, and the
    previous SIGTERM handler is back afterwards."""
    jcfg, tcfg = _configs(train_iters=10, log_interval=3, exit_interval=4)
    jstate = j_init(jax.random.PRNGKey(0), jcfg)
    tstate = train_state_from_numpy(jstate.params, jstate.opt_state,
                                    jstate.iteration, tcfg, device="cpu")
    roots, j_save, t_save = _save_fns(jcfg, tcfg, tmp_path)
    jit, _ = _iterators(j_gpt, j_samp, corpus["j"], jcfg)
    tit, _ = _iterators(t_gpt, t_samp, corpus["t"], tcfg)
    _, jconsumed = j_loop.train(jcfg, jit, None, mesh=None, state=jstate,
                                save_fn=j_save)
    tstate, tconsumed = t_loop.train(tcfg, tit, None, state=tstate,
                                     save_fn=t_save, device="cpu")
    assert tconsumed == jconsumed == 16 and tstate.iteration == 4
    assert t_ckpt.read_tracker(roots["t"]) == "4"
    assert _meta(roots["t"], 4) == _meta(roots["j"], 4)

    before = signal.getsignal(signal.SIGTERM)
    orig = t_loop.make_train_step

    def make(*a, **k):
        step = orig(*a, **k)

        def sigterm_at_1(state, batch, gen):
            if state.iteration == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(state, batch, gen)
        return sigterm_at_1

    monkeypatch.setattr(t_loop, "make_train_step", make)
    _, tcfg = _configs(train_iters=10, log_interval=5)
    tit, _ = _iterators(t_gpt, t_samp, corpus["t"], tcfg)
    root = str(tmp_path / "sigterm")
    state, consumed = t_loop.train(
        tcfg, tit, None, save_fn=lambda st, i, c, **kw: t_ckpt.
        save_checkpoint(root, st, tcfg, i, c, **kw), device="cpu")
    assert state.iteration == 2 and consumed == 8
    assert t_ckpt.read_tracker(root) == "2"
    assert signal.getsignal(signal.SIGTERM) is before


@pytest.mark.parametrize("flags", [
    ["--pipeline_model_parallel_size", "2"],
    ["--context_parallel_size", "2", "--pipeline_model_parallel_size", "2"],
    ["--num_layers_per_virtual_pipeline_stage", "1"],
    ["--expert_axis", "dp", "--pipeline_model_parallel_size", "2"]])
def test_unported_flags_raise(corpus, flags):
    """The pipeline's flags, alone or beside context parallelism or experts
    on dp, reach ParallelConfig as the reference maps them (the virtual
    chunks from the layers a virtual stage holds), dp derived from the
    ranks; with experts on a split dp axis under pp (or dp not known at
    validation) both packages refuse, the port with the reference's
    reason. finetune.main trains the pipeline under torchrun's ranks
    (test_torch_pipeline_train.py)."""
    from megatron_tpu.arguments import parse_cli as j_parse
    from megatron_tpu_torch.arguments import parse_cli as t_parse
    argv = _argv(corpus, *flags)

    def flag(name):
        return int(flags[flags.index(name) + 1]) if name in flags else 1
    n = flag("--pipeline_model_parallel_size") * flag(
        "--context_parallel_size")
    fields = ("pipeline_parallel", "virtual_pipeline_chunks",
              "pipeline_schedule", "pipeline_store_activations",
              "context_parallel", "data_parallel", "expert_axis")
    want = j_parse(argv, n_devices=n)[0].parallel
    got = t_parse(argv, n_devices=n)[0].parallel
    assert [getattr(got, f) for f in fields] == \
        [getattr(want, f) for f in fields]
    if "dp" in flags:
        for devices in (None, 2 * n):
            moe = argv + ["--num_experts", "4"]
            with pytest.raises(AssertionError):
                j_parse(moe, n_devices=devices)
            with pytest.raises(ValueError, match="pipeline_parallel"):
                t_parse(moe, n_devices=devices)


@pytest.mark.parametrize("flags,granularity", [
    (["--recompute_granularity", "full"], "full"),
    (["--recompute_activations"], "selective"),
    (["--recompute_method", "uniform"], "none"),
    (["--recompute_num_layers", "1"], "none"),
    (["--recompute_granularity", "selective"], "selective")])
def test_recompute_flags_train_like_jax(corpus, monkeypatch, flags,
                                        granularity):
    """The recompute flags parse to the reference's granularity
    (--recompute_activations is its alias for selective; --recompute_method
    and --recompute_num_layers change nothing), the port's train at that
    granularity matches JAX's for 2 iterations, and finetune.main with the
    flags runs to its end."""
    from megatron_tpu.arguments import parse_cli as j_parse
    from megatron_tpu_torch.arguments import parse_cli as t_parse
    argv = _argv(corpus, *flags)
    assert (t_parse(argv)[0].model.recompute_granularity
            == j_parse(argv, n_devices=1)[0].model.recompute_granularity
            == granularity)
    jcfg, tcfg = (dataclasses.replace(c, model=dataclasses.replace(
        c.model, recompute_granularity=granularity))
        for c in _configs(train_iters=2, log_interval=2))
    jstate = j_init(jax.random.PRNGKey(0), jcfg)
    tstate = train_state_from_numpy(jstate.params, jstate.opt_state,
                                    jstate.iteration, tcfg, device="cpu")
    recs = {"j": [], "t": []}
    _record_steps(monkeypatch, j_loop, recs["j"])
    _record_steps(monkeypatch, t_loop, recs["t"])
    jit, jvalid = _iterators(j_gpt, j_samp, corpus["j"], jcfg)
    tit, tvalid = _iterators(t_gpt, t_samp, corpus["t"], tcfg)
    j_loop.train(jcfg, jit, jvalid, mesh=None, state=jstate,
                 rng=jax.random.PRNGKey(1))
    t_loop.train(tcfg, tit, tvalid, state=tstate, device="cpu")
    assert len(recs["t"]) == len(recs["j"]) == 2
    for (_, tl, tg), (_, jl, jg) in zip(recs["t"], recs["j"]):
        assert _rel(tl, jl) < 1e-5 and _rel(tg, jg) < 1e-5
    monkeypatch.undo()
    recs = []
    _record_steps(monkeypatch, t_loop, recs)
    argv = _argv(corpus, *flags, "--train_iters", "2", "--eval_interval",
                 "2")
    assert finetune.main(argv, device="cpu") == 0
    assert len(recs) == 2 and all(np.isfinite(r[1]) for r in recs)


@pytest.mark.parametrize("flag,dtype", [("--bf16", torch.bfloat16),
                                        ("--fp16", torch.float16)])
def test_low_precision_flags_train(corpus, monkeypatch, flag, dtype):
    """--bf16 and --fp16 on the flag-built path (no preset) give the
    reference's params and compute dtypes, and finetune.main trains those
    master weights (fp32 moments) to its end with finite losses."""
    from megatron_tpu.arguments import parse_cli as j_parse
    from megatron_tpu_torch.arguments import parse_cli as t_parse
    argv = _argv(corpus, flag, "--train_iters", "2", "--eval_interval",
                 "2")
    i = argv.index("--model")
    del argv[i:i + 2]
    jm, tm = j_parse(argv, n_devices=1)[0].model, t_parse(argv)[0].model
    assert (tm.params_dtype, tm.compute_dtype) == (
        jm.params_dtype, jm.compute_dtype)
    assert tm.params_dtype == str(dtype).split(".")[1]
    seen = []
    orig = t_loop.make_train_step

    def make(*a, **k):
        step = orig(*a, **k)

        def watched(state, batch, gen):
            state, m = step(state, batch, gen)
            seen.append((next(state.params.parameters()).dtype,
                         next(iter(state.opt_state.mu.values())).dtype,
                         float(m["lm_loss"])))
            return state, m
        return watched

    monkeypatch.setattr(t_loop, "make_train_step", make)
    assert finetune.main(argv, device="cpu") == 0
    assert len(seen) == 2
    assert all(p == dtype and mu == torch.float32 and np.isfinite(loss)
               for p, mu, loss in seen)


def test_arguments_follow_jax(corpus):
    """The preset path: an explicit --num_layers beats the preset, the
    other flags keep the reference's defaults."""
    from megatron_tpu.arguments import parse_cli as j_parse
    from megatron_tpu_torch.arguments import parse_cli as t_parse
    argv = ["--model", "llama2-7b", "--num_layers", "2", "--bf16",
            "--use_flash_attn", "--micro_batch_size", "1",
            "--global_batch_size", "2", "--train_iters", "4",
            "--data_path", corpus["cli"], "--reset_attention_mask",
            "--no_masked_softmax_fusion"]
    jcfg, _ = j_parse(argv, n_devices=1)
    tcfg, _ = t_parse(argv)
    assert tcfg.model.num_layers == 2 and tcfg.model.hidden_size == 4096
    for section in ("model", "optimizer", "training", "data", "resilience"):
        want = dataclasses.asdict(getattr(jcfg, section))
        have = dataclasses.asdict(getattr(tcfg, section))
        assert have == {k: want[k] for k in have}, section


def test_main_without_gpu_or_device_raises(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        finetune.main(_argv(corpus))


def test_step_seed_is_a_function_of_seed_and_iteration():
    seeds = {t_loop.step_seed(s, i) for s in (0, 1, 1234) for i in range(50)}
    assert len(seeds) == 150 and all(0 <= x < 2 ** 63 for x in seeds)
    assert t_loop.step_seed(7, 3) == t_loop.step_seed(7, 3)
