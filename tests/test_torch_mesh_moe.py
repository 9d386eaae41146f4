"""Expert parallelism in the port's sharded training step: the MoE decoder
(4 experts, top 2) against the JAX package's sharded step on the
8-device virtual CPU mesh, from the same numpy weights and batches, 2
steps, fp32, at the layouts of the reference's three expert-parallel tests
(tests/test_moe.py:407-495: tp 2 with the experts on tp; dp 2 with the
experts on dp, with and without ZeRO-1), at tp 2 with sequence
parallelism, and at dp 2 x tp 2 with sequence parallelism, the experts on
dp and ZeRO-1 (each tp rank routes the gathered rows of its dp rank);
and under context parallelism with ring attention, where each cp rank
routes the rows gathered over cp: cp 2, cp 2 x tp 2 with sequence
parallelism (experts on tp), dp 2 x cp 2 with the experts on dp and
ZeRO-1.
The port's ranks are gloo processes (tests/mesh_pool.py).
finetune.main takes --expert_axis dp, and trains as with the experts on
tp; a checkpoint saved with the experts on dp loads unsharded and with
them on tp, bit for bit.

The capacity factor 0.5 drops half of the top-2 choices (C = 4 slots an
expert and row for 32 choices a row), so the routing must fill the slots
of whole rows in the reference's order; the aux loss enters the loss at
coefficient 0.1. Each layout's JAX run dispatches by sort; the port's sort
and dense dispatches are both held to it (the reference's sort and dense
dispatches compute the same function, tests/test_moe.py).

Limits: tests/test_torch_mesh_step.py's (parameters within PARAM_REL =
1e-2 of each leaf's largest update; loss, grad norm and params norm within
METRIC_RTOL = 1e-5). Read on this CPU: at most 1.1e-4 of the update and
1.8e-7 relative on the metrics.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_ranks
from megatron_tpu import config as jc
from megatron_tpu.models import moe as jmoe
from megatron_tpu.parallel import sharding as jshd
from megatron_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatron_tpu.training import init_train_state as j_init
from megatron_tpu.training import make_train_step as j_make_step
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tc
from megatron_tpu_torch.models import moe as tmoe
from megatron_tpu_torch.parallel import sharding as tshd
from mesh_pool import RankPool
from test_torch_mesh_step import METRIC_RTOL, check_run
from test_torch_mesh_train import _argv, corpus  # noqa: F401 (fixture)

torch.set_num_threads(2)
STEPS = 2
SEQ = 16
VOCAB = 250


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def configs(*, tp=1, dp=1, cp=1, sp=False, zero=False, expert_axis="tp",
            micro=2, dispatch="sort"):
    """(JAX config, port config) of a tiny MoE Llama on a (dp, cp, tp)
    mesh, with ring attention under cp."""
    kw = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
              num_kv_heads=2, vocab_size=VOCAB,
              make_vocab_size_divisible_by=128, seq_length=SEQ,
              compute_dtype="float32",
              attention_impl="ring" if cp > 1 else "flash",
              num_experts=4, moe_top_k=2, moe_capacity_factor=0.5,
              moe_aux_loss_coeff=0.1, moe_dispatch=dispatch)
    out = []
    for mod in (jc, tc):
        out.append(mod.MegatronConfig(
            model=mod.llama2_config("tiny", **kw),
            parallel=mod.ParallelConfig(tensor_parallel=tp,
                                        context_parallel=cp,
                                        sequence_parallel=sp,
                                        use_distributed_optimizer=zero,
                                        expert_axis=expert_axis),
            optimizer=mod.OptimizerConfig(lr=0.1, optimizer="sgd",
                                          sgd_momentum=0.0,
                                          weight_decay=0.01, clip_grad=1.0),
            training=mod.TrainingConfig(micro_batch_size=micro,
                                        global_batch_size=micro * dp * 2,
                                        log_params_norm=True)
        ).validate(n_devices=tp * dp * cp))
    return out


def batches(cfg, seed=1):
    rs = np.random.RandomState(seed)
    rows = cfg.training.micro_batch_size * cfg.parallel.data_parallel
    return [{"tokens": rs.randint(0, VOCAB, (2, rows, SEQ + 1)),
             "loss_mask": (rs.rand(2, rows, SEQ) > 0.25).astype(np.float32)}
            for _ in range(STEPS)]


def world(cfg):
    p = cfg.parallel
    return p.tensor_parallel * p.data_parallel * p.context_parallel


def jax_run(jcfg, batch_list):
    par = jcfg.parallel
    mesh = j_build_mesh(par, devices=jax.devices()[:world(jcfg)])
    state = j_init(jax.random.PRNGKey(0), jcfg)
    weights = {k.replace("/", "."): np.asarray(v)
               for k, v in _flatten(state.params).items()}
    step = j_make_step(jcfg, mesh=mesh, donate=False)
    metrics = []
    # under cp the reference's own ring path and data-level zigzag run
    # inside its mesh (tests/test_torch_mesh_cp.py)
    with (jax.set_mesh(mesh) if par.context_parallel > 1
          else contextlib.nullcontext()):
        for i, b in enumerate(batch_list):
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                            jax.random.PRNGKey(i))
            metrics.append({k: float(v) for k, v in m.items()})
    return weights, {"metrics": metrics, "params": {
        k: np.asarray(v) for k, v in _flatten(state.params).items()}}


def test_moe_axes_and_rules_match_jax():
    for glu in ("swiglu", "gelu"):
        for bias in (False, True):
            kw = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
                      num_experts=4, activation=glu, use_bias=bias)
            jm = jc.ModelConfig(**kw).derived()
            tm = tc.ModelConfig(**kw).derived()
            assert tmoe.moe_axes(tm) == jmoe.moe_axes(jm)
    for sp in (False, True):
        for axis in ("tp", "dp"):
            assert tshd.make_logical_rules(sp, axis) == \
                jshd.make_logical_rules(sp, expert_axis=axis)


# layout tag -> mesh of configs()
LAYOUTS = {
    "tp2": dict(tp=2),
    "tp2_sp": dict(tp=2, sp=True),
    "dp2_experts_dp": dict(dp=2, expert_axis="dp", micro=1),
    "dp2_experts_dp_zero": dict(dp=2, expert_axis="dp", zero=True,
                                micro=1),
    "dp2_tp2_sp_experts_dp_zero": dict(dp=2, tp=2, sp=True, expert_axis="dp",
                                       zero=True, micro=1),
    "cp2": dict(cp=2),
    "cp2_tp2_sp": dict(cp=2, tp=2, sp=True),
    "dp2_cp2_experts_dp_zero": dict(dp=2, cp=2, expert_axis="dp", zero=True,
                                    micro=1),
}
_JAX_RUNS: dict = {}


def jax_reference(tag: str):
    if tag not in _JAX_RUNS:
        jcfg, tcfg = configs(**LAYOUTS[tag])
        _JAX_RUNS[tag] = jax_run(jcfg, batches(tcfg))
    return _JAX_RUNS[tag]


@pytest.mark.parametrize("dispatch", ["sort", "dense"])
@pytest.mark.parametrize("tag", list(LAYOUTS))
def test_expert_parallel_step_matches_jax(pool, tag, dispatch):
    _, tcfg = configs(dispatch=dispatch, **LAYOUTS[tag])
    weights, want = jax_reference(tag)
    check_run(pool.run(world(tcfg), mesh_ranks.train, tcfg, weights,
                       batches(tcfg)), want, weights)


def test_expert_checkpoints_move_between_layouts(pool, tmp_path):
    """A state trained with the experts on dp (ZeRO-1, Adam) saves the
    unsharded format; it loads unsharded, and at tp 2 with the experts on
    tp, with every parameter and moment as saved."""
    def adam(cfg):
        return dataclasses.replace(cfg, optimizer=dataclasses.replace(
            cfg.optimizer, optimizer="adam", lr=1e-3))
    dp_cfg = adam(configs(**LAYOUTS["dp2_experts_dp_zero"])[1])
    tp_cfg = adam(configs(**LAYOUTS["tp2"])[1])
    one = adam(configs()[1])
    weights, _ = jax_reference("dp2_experts_dp_zero")
    save = str(tmp_path / "ckpt")
    saved = pool.run(2, mesh_ranks.train, dp_cfg, weights, batches(dp_cfg),
                     None, True, "lm", None, save)[0]
    assert saved["mu"] and sorted(saved["mu"]) == sorted(saved["params"])
    for cfg, world, sharded in ((one, 1, False), (tp_cfg, 2, True)):
        got = pool.run(world, mesh_ranks.load_whole, cfg, save, sharded)[0]
        assert got["iteration"] == STEPS
        for group in ("params", "mu", "nu"):
            assert sorted(got[group]) == sorted(saved[group])
            for k, v in saved[group].items():
                np.testing.assert_array_equal(got[group][k], v,
                                              err_msg=f"{group}/{k}")


def test_finetune_takes_the_expert_axis(pool, corpus):
    """finetune.main on 2 ranks trains the flag-built MoE model with its
    experts on dp (--expert_axis dp, dp 2, ZeRO-1) as with them on tp (tp
    2, sequence parallelism): the same run in two layouts."""
    moe = ("--num_experts", "4", "--moe_top_k", "2", "--train_iters", "3")
    runs = [pool.run(2, mesh_ranks.finetune_run, _argv(corpus, *moe, *flags))
            for flags in (("--tensor_model_parallel_size", "2",
                           "--sequence_parallel"),
                          ("--expert_axis", "dp", "--micro_batch_size", "1",
                           "--use_distributed_optimizer"))]
    assert [r["rc"] for ranks in runs for r in ranks] == [0] * 4
    (tp, _), (dp, _) = runs
    assert len(tp["steps"]) == 3
    for (it, *m), (it2, *m2) in zip(dp["steps"], tp["steps"]):
        assert it == it2
        np.testing.assert_allclose(m, m2, rtol=METRIC_RTOL)
