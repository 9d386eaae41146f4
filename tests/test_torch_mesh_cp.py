"""Context parallelism in the port's sharded training step: the decoder
LM's step at cp 2 with ring and Ulysses attention against the JAX
package's sharded step on the 8-device virtual CPU mesh (run under
`jax.set_mesh`, so the reference's own ring path and its data-level zigzag
run), from the same numpy weights and batches, 2 steps, fp32. The port's
ranks are gloo processes (tests/mesh_pool.py).

Meshes: cp 2; cp 2 x tp 2 with sequence parallelism; dp 2 x cp 2 with
ZeRO-1; the port's ring and Ulysses steps on each are held to the one JAX
run of its mesh (ring attention; Ulysses computes the same function).
Also, port against port: the loss's zigzag pre-permutation on and off
(the ring then takes the contiguous split) give the same step, and the cp
step with attention and hidden dropout equals the unsharded step drawn
from the same generator (the flash kernels' dropout hash and the hidden
dropout's whole-step masks place every rank's rows), and finetune.main
takes --context_parallel_size and --context_parallel_algo.

Limits: tests/test_torch_mesh_step.py's (parameters within PARAM_REL =
1e-2 of each leaf's largest update; loss, grad norm and params norm within
METRIC_RTOL = 1e-5). Read on this CPU: at most 2.5e-5 of the update and
1.0e-7 relative on the metrics, against JAX and port against port alike.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_ranks
from megatron_tpu import config as jc
from megatron_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatron_tpu.training import init_train_state as j_init
from megatron_tpu.training import make_train_step as j_make_step
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tc
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


def configs(*, cp=2, tp=1, dp=1, sp=False, zero=False, impl="ring",
            micro=2, **model_kw):
    """(JAX config, port config) of a tiny Llama on a (dp, cp, tp) mesh."""
    kw = dict(num_layers=2, hidden_size=64, num_attention_heads=8,
              num_kv_heads=4, vocab_size=VOCAB,
              make_vocab_size_divisible_by=128, seq_length=SEQ,
              compute_dtype="float32", attention_impl=impl, **model_kw)
    out = []
    for mod in (jc, tc):
        out.append(mod.MegatronConfig(
            model=mod.llama2_config("tiny", **kw),
            parallel=mod.ParallelConfig(tensor_parallel=tp,
                                        context_parallel=cp,
                                        sequence_parallel=sp,
                                        use_distributed_optimizer=zero),
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
    out = []
    for _ in range(STEPS):
        mask = (rs.rand(2, rows, SEQ) > 0.25).astype(np.float32)
        # a cp chunk with no masked token still joins the count's sums
        mask[:, 0, :SEQ // 2] = 0.0
        out.append({"tokens": rs.randint(0, VOCAB, (2, rows, SEQ + 1)),
                    "loss_mask": mask})
    return out


def jax_run(jcfg, batch_list):
    par = jcfg.parallel
    n = par.tensor_parallel * par.data_parallel * par.context_parallel
    mesh = j_build_mesh(par, devices=jax.devices()[:n])
    state = j_init(jax.random.PRNGKey(0), jcfg)
    weights = {k.replace("/", "."): np.asarray(v)
               for k, v in _flatten(state.params).items()}
    step = j_make_step(jcfg, mesh=mesh, donate=False)
    metrics = []
    with jax.set_mesh(mesh):
        for i, b in enumerate(batch_list):
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                            jax.random.PRNGKey(i))
            metrics.append({k: float(v) for k, v in m.items()})
    return weights, {"metrics": metrics, "params": {
        k: np.asarray(v) for k, v in _flatten(state.params).items()}}


def world(cfg):
    p = cfg.parallel
    return p.tensor_parallel * p.data_parallel * p.context_parallel


# mesh tag -> mesh of configs()
MESHES = {"cp2": dict(cp=2), "cp2_tp2_sp": dict(cp=2, tp=2, sp=True),
          "dp2_cp2_zero": dict(cp=2, dp=2, zero=True, micro=1)}
_JAX_RUNS: dict = {}


def jax_reference(tag: str):
    """(weights, JAX's run) of a mesh, with ring attention, run once."""
    if tag not in _JAX_RUNS:
        jcfg, tcfg = configs(**MESHES[tag])
        _JAX_RUNS[tag] = jax_run(jcfg, batches(tcfg))
    return _JAX_RUNS[tag]


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("tag", list(MESHES))
def test_cp_step_matches_jax(pool, tag, impl):
    _, tcfg = configs(impl=impl, **MESHES[tag])
    batch_list = batches(tcfg)
    weights, want = jax_reference(tag)
    check_run(pool.run(world(tcfg), mesh_ranks.train, tcfg, weights,
                       batch_list), want, weights)


def test_zigzag_pre_permutation_on_and_off_agree(pool):
    """The loss's data-level zigzag against the ring's contiguous split."""
    jcfg, tcfg = configs(cp=2)
    batch_list = batches(tcfg, seed=2)
    weights, _ = jax_run(jcfg, batch_list[:0])
    on = pool.run(2, mesh_ranks.train, tcfg, weights, batch_list)[0]
    off = pool.run(2, mesh_ranks.train_without_data_zigzag, tcfg, weights,
                   batch_list)[0]
    # the loss was told to pre-permute, and did not
    assert off["zigzag"] and all(z == 2 for z in off["zigzag"])
    check_run([off], on, weights)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_dropout_cp_step_equals_unsharded_port(pool, impl):
    _, tcfg = configs(cp=2, impl=impl, attention_dropout=0.2,
                      hidden_dropout=0.1)
    _, one = configs(cp=1, impl="flash", attention_dropout=0.2,
                     hidden_dropout=0.1)
    jcfg, _ = configs(cp=1, impl="flash")
    batch_list = batches(tcfg, seed=3)
    weights, _ = jax_run(jcfg, batch_list[:0])
    seeds = [11, 12]
    want = pool.run(1, mesh_ranks.train, one, weights, batch_list, seeds,
                    False)[0]
    check_run(pool.run(2, mesh_ranks.train, tcfg, weights, batch_list,
                       seeds), want, weights)


def test_finetune_takes_the_context_parallel_flags(pool, corpus):
    """finetune.main on 2 ranks with --context_parallel_size 2, ring and
    Ulysses (--context_parallel_algo), trains as the tp 2 run of the same
    flags: the corpus's segment ids and the attention dropout send its
    attention to the cp fallback, and the evaluation runs under cp too."""
    runs = [pool.run(2, mesh_ranks.finetune_run, _argv(
        corpus, *flags, "--train_iters", "3"))
        for flags in (("--tensor_model_parallel_size", "2"),
                      ("--context_parallel_size", "2"),
                      ("--context_parallel_size", "2",
                       "--context_parallel_algo", "ulysses"))]
    assert [r["rc"] for ranks in runs for r in ranks] == [0] * 6
    want = runs[0][0]["steps"]
    assert len(want) == 3
    for ranks in runs[1:]:
        assert ranks[0]["steps"] == ranks[1]["steps"]
        for (it, *m), (it2, *m2) in zip(ranks[0]["steps"], want):
            assert it == it2
            np.testing.assert_allclose(m, m2, rtol=METRIC_RTOL)
