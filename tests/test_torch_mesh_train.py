"""The port's sharded step with dropout and recompute against its own
unsharded step, and the sharded trainer's entry point, on gloo ranks
(tests/mesh_pool.py, spawned once for the file).

torch cannot draw jax.random's bits, so dropout is held inside the port
(ROADMAP "What parity means"): with one generator a sharded step must drop
what the unsharded step drops, every rank keeping its slice of the masks,
the attention masks through the flash kernels' dropout index. Limits as
test_torch_mesh_step.py's (SGD lr 0.1; each leaf within 1e-2 of its
largest update; loss and grad norm 1e-5 relative). Read: at most 8.4e-4
of the update (tp 2 with drop path and full recompute; 2.4e-5 in the
other two), and 8.7e-8 on the metrics.

bf16 master weights under the mesh (dp 2 x tp 2, sequence parallelism,
ZeRO-1) against the unsharded bf16 step: the test's docstring states its
limits and readings.

finetune.main under 2 gloo ranks (the torchrun entry point's body):
tp 2 with sequence parallelism and the distributed optimizer, 6
iterations with attention dropout and segment ids (U); the same run
saving at iteration 3 and exiting (A); resumed from A at tp 2 (B1) it
equals U bit for bit; resumed at dp 2 with ZeRO-1 (B2) its losses equal
U's within 1e-5 (read: dp 2 with ZeRO-1 from scratch against the
unsharded entry point, 1.3e-7; the model is flag-built, so fp32); and the
unsharded port loads A's checkpoint, leaves equal to A's gathered ones
byte for byte, and B2's, moments equal to B2's ZeRO-1 shares gathered.
"""
import os

import numpy as np
import pytest
import torch

import mesh_ranks
from megatron_tpu_torch import config as tc
from megatron_tpu_torch.models import language_model as tlm
from megatron_tpu_torch.tools import preprocess_data as t_pre
from megatron_tpu_torch.tools import synthetic_corpus as sc
from megatron_tpu_torch.training import checkpointing as t_ckpt
from megatron_tpu_torch.training import init_train_state
from mesh_pool import RankPool

torch.set_num_threads(2)
PARAM_REL = 1e-2
METRIC_RTOL = 1e-5
BF16_GRAD_NORM_RTOL = 1e-4
BF16_STEPS = 4
SEQ = 16
VOCAB = 250


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def _cfg(family, tp=1, dp=1, sp=False, zero=False, **model_kw):
    kw = dict(num_layers=2, hidden_size=64, vocab_size=VOCAB,
              make_vocab_size_divisible_by=128, seq_length=SEQ,
              compute_dtype="float32", attention_impl="flash",
              hidden_dropout=0.1, attention_dropout=0.1, **model_kw)
    if family == "gpt":
        model = tc.gpt_config(num_attention_heads=4,
                              max_position_embeddings=SEQ, **kw)
    else:
        model = tc.llama2_config("tiny", num_attention_heads=8,
                                 num_kv_heads=2, **kw)
    return tc.MegatronConfig(
        model=model,
        parallel=tc.ParallelConfig(tensor_parallel=tp, sequence_parallel=sp,
                                   use_distributed_optimizer=zero),
        optimizer=tc.OptimizerConfig(lr=0.1, optimizer="sgd",
                                     sgd_momentum=0.0, clip_grad=1.0),
        training=tc.TrainingConfig(micro_batch_size=4 // dp,
                                   global_batch_size=8),
    ).validate(n_devices=tp * dp)


CASES = {
    "tp2_sp_full": ("llama", dict(tp=2, sp=True), dict(
        recompute_granularity="full", drop_path_rate=0.1)),
    "dp2_tp2_sp_zero_selective": ("llama", dict(tp=2, dp=2, sp=True,
                                                zero=True), dict(
        recompute_granularity="selective")),
    "gpt_tp2_sp": ("gpt", dict(tp=2, sp=True), {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_with_dropout_equals_unsharded(pool, case):
    family, mesh_kw, model_kw = CASES[case]
    cfg = _cfg(family, **mesh_kw, **model_kw)
    whole = _cfg(family, **model_kw)
    weights = {k: v.detach().numpy().copy() for k, v in tlm.LanguageModel(
        whole.model, device="cpu", seed=0).state_dict().items()}
    rs = np.random.RandomState(2)
    batches = [{"tokens": rs.randint(0, VOCAB, (2, 4, SEQ + 1)),
                "loss_mask": (rs.rand(2, 4, SEQ) > 0.2).astype(np.float32)}
               for _ in range(2)]
    seeds = [11, 12]
    want = mesh_ranks.train(whole, weights, batches, seeds, sharded=False)
    world = mesh_kw["tp"] * mesh_kw.get("dp", 1)
    got = pool.run(world, mesh_ranks.train, cfg, weights, batches, seeds)[0]
    for g, w in zip(got["metrics"], want["metrics"]):
        for key in ("lm_loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=METRIC_RTOL)
    for k, w in want["params"].items():
        update = np.abs(w - weights[k.replace("/", ".")]).max()
        assert update > 0, k
        np.testing.assert_allclose(got["params"][k], w, rtol=0,
                                   atol=PARAM_REL * update, err_msg=k)


def test_bf16_master_weights_under_a_mesh(pool):
    """bf16 weights keep their fp32 grad buffers and fp32 moments under the
    mesh: at dp 2 x tp 2 with sequence parallelism and ZeRO-1 (each rank
    updating a bf16 share, the shares gathered back), against the
    unsharded step with the same generator.

    Limits, and the readings they were set from: lm_loss within 1e-5 at
    both steps (read 0.0 and 8.6e-7; a missing or halved first update
    moves the second step's loss by ~1%); grad_norm within 1e-4 (read
    1.2e-5 and 3.8e-5: each microbatch's grads come in bf16, rounded at
    2^-8 where the products differ in shape); every weight within
    BF16_STEPS bf16 steps at the larger of the weight and its leaf's
    largest update (read: 2). A bf16 weight cannot be held under a tenth
    of its update: updates under half a step round away (the norm scales'
    all do), so the update is checked through the loss."""
    cfg = _cfg("llama", tp=2, dp=2, sp=True, zero=True,
               params_dtype="bfloat16")
    whole = _cfg("llama", params_dtype="bfloat16")
    weights = {k: v.detach().float().numpy().copy() for k, v in
               tlm.LanguageModel(whole.model, device="cpu",
                                 seed=0).state_dict().items()}
    rs = np.random.RandomState(4)
    batches = [{"tokens": rs.randint(0, VOCAB, (2, 4, SEQ + 1))}
               for _ in range(2)]
    want = mesh_ranks.train(whole, weights, batches, [5, 6], sharded=False)
    got = pool.run(4, mesh_ranks.train, cfg, weights, batches, [5, 6])[0]
    for g, w in zip(got["metrics"], want["metrics"]):
        np.testing.assert_allclose(g["lm_loss"], w["lm_loss"],
                                   rtol=METRIC_RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=BF16_GRAD_NORM_RTOL)
    for k, w in want["params"].items():
        update = np.abs(w - weights[k.replace("/", ".")]).max()
        # one bf16 step: float32's spacing times 2^16
        step = np.spacing(np.maximum(np.abs(w), update)) * 2 ** 16
        assert np.all(np.abs(got["params"][k] - w) <= BF16_STEPS * step), k


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_corpus")
    vocab_file, merge_file = sc.write_gpt2_vocab(str(d), 2000)
    jsonl = sc.write_jsonl(str(d / "c.jsonl"), 80, 2, min_words=5,
                           max_words=40)
    t_pre.main(["--input", jsonl, "--output_prefix", str(d / "c"),
                "--tokenizer_type", "GPT2BPETokenizer", "--vocab_file",
                vocab_file, "--merge_file", merge_file, "--append_eod"])
    return dict(vocab=vocab_file, merges=merge_file,
                data=str(d / "c_document"))


def _argv(corpus, *extra):
    # no preset: the flag-built model computes in fp32
    return ["--num_layers", "2", "--hidden_size", "64",
            "--num_attention_heads", "4", "--num_attention_heads_kv", "2",
            "--seq_length", "32", "--use_rms_norm", "--glu_activation",
            "swiglu", "--use_flash_attn",
            "--attention_dropout", "0.1", "--data_path", corpus["data"],
            "--split", "85,10,5", "--tokenizer_type", "GPT2BPETokenizer",
            "--vocab_file", corpus["vocab"], "--merge_file",
            corpus["merges"], "--micro_batch_size", "2",
            "--global_batch_size", "4", "--reset_attention_mask",
            "--reset_position_ids", "--eod_mask_loss", "--log_interval", "2",
            "--eval_interval", "3", "--eval_iters", "1", "--train_iters",
            "6", "--lr", "1e-3", *extra]


TP2 = ("--tensor_model_parallel_size", "2", "--sequence_parallel",
       "--use_distributed_optimizer")


def test_finetune_on_two_ranks_saves_loads_and_resumes(pool, corpus,
                                                       tmp_path):
    d = str(tmp_path / "ckpt")
    u = pool.run(2, mesh_ranks.finetune_run, _argv(corpus, *TP2))
    a = pool.run(2, mesh_ranks.finetune_run, _argv(
        corpus, *TP2, "--save", d, "--exit_interval", "3"))
    b1 = pool.run(2, mesh_ranks.finetune_run, _argv(corpus, *TP2,
                                                    "--load", d))
    # dp 2 of micro-batch 1: the same microbatches of 2 rows as tp 2's;
    # it saves its ZeRO-1 moments gathered from the ranks' dp shares
    d2 = str(tmp_path / "ckpt_dp2")
    b2 = pool.run(2, mesh_ranks.finetune_run, _argv(
        corpus, "--use_distributed_optimizer", "--micro_batch_size", "1",
        "--load", d, "--save", d2, "--save_interval", "3"))
    assert [r["rc"] for r in u + a + b1 + b2] == [0] * 8
    # every rank reports the global metrics
    assert u[0]["steps"] == u[1]["steps"] and len(u[0]["steps"]) == 6
    assert [s[0] for s in a[0]["steps"]] == [0, 1, 2]
    assert a[0]["steps"] == u[0]["steps"][:3]
    # tp 2 from tp 2: the uninterrupted run, bit for bit
    assert b1[0]["steps"] == u[0]["steps"][3:]
    for group in ("params", "mu", "nu"):
        for k, v in u[0][group].items():
            assert np.array_equal(b1[0][group][k], v), (group, k)
    # dp 2 from tp 2: the same run in another layout
    for (it, loss, gn), (it2, loss2, gn2) in zip(b2[0]["steps"],
                                               u[0]["steps"][3:]):
        assert it == it2
        np.testing.assert_allclose([loss, gn], [loss2, gn2],
                                   rtol=METRIC_RTOL)
    # rank 1 wrote nothing: one checkpoint, as the unsharded format
    assert sorted(os.listdir(d)) == ["iter_0000003",
                                     "latest_checkpointed_iteration.txt"]
    cfg = tc.MegatronConfig.from_dict(__import__("json").load(open(
        os.path.join(d, "iter_0000003", "config.json"))))
    assert cfg.parallel.tensor_parallel == 2
    state = init_train_state(tc.MegatronConfig(
        model=cfg.model, optimizer=cfg.optimizer).validate(), device="cpu")
    loaded = t_ckpt.load_checkpoint(d, state)
    assert loaded.iteration == 3
    for k, v in t_ckpt._param_leaves(state).items():
        assert v.numpy().tobytes() == a[0]["params"][k].tobytes(), k
    assert t_ckpt.load_checkpoint(d2, state).iteration == 6
    for k, v in t_ckpt._opt_leaves(state).items():
        group, _, name = k.partition("/")
        if group in ("mu", "nu"):
            assert v.numpy().tobytes() == b2[0][group][name].tobytes(), k
