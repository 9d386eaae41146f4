"""The port's sharded training step against the JAX package's sharded step
on the 8-device virtual CPU mesh, from the same numpy weights and batches,
2 steps each, fp32 compute. The port's ranks are gloo processes on the CPU
(tests/mesh_pool.py), spawned once for the file.

Configurations: tp 2 with sequence parallelism off and on (8 q heads, 2
kv heads); tp 4 with 2 kv heads (replicated kv, each rank picking its kv
head); GPT at tp 2 with sequence parallelism (biases, LayerNorm, tied
embeddings, learned positions). tests/test_torch_mesh_zero.py holds the
data-parallel and ZeRO-1 ones.

Limits, and the readings they were set from (fp32, this CPU, all six
configurations of the two files):
- parameters: SGD without momentum (lr 0.1, clip 1.0, wd 0.01), because
  Adam turns reassociation noise on near-zero grads into O(lr) steps (the
  reference's own test_sequence_parallel.py:63-66). Each leaf may differ
  from JAX's by PARAM_REL = 1e-2 of that leaf's largest update over the
  run, max |p2 - p0|: a tenth of a tenth, so a missing or halved update
  fails. Read: at most 3.8e-4 of the update (dp 2 with uneven masks;
  1.7e-4 at tp 4, 2.4e-5 at tp 2), 1.2e-7 absolute; the smallest leaf
  update was 1.45e-5 (GPT's final LayerNorm bias);
- loss, grad norm and params norm: METRIC_RTOL = 1e-5 relative (read: at
  most 1.8e-7); found_inf exact. (The count of zero grads is not compared:
  grads that are zero in exact arithmetic come out 0 or not by the order
  of the sums, and JAX's own sharded and unsharded counts differ, 392
  against 385 on the GPT case; test_torch_mesh.py holds the count's rule.)
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

torch.set_num_threads(2)
PARAM_REL = 1e-2
METRIC_RTOL = 1e-5
STEPS = 2
SEQ = 16
VOCAB = 250  # padded to 256


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def configs(family: str, *, tp=1, dp=1, sp=False, zero=False,
            optimizer="sgd", lr=0.1, micro=2, global_batch=2, **model_kw):
    """(JAX config, port config) of one tiny model on a (dp, tp) mesh."""
    kw = dict(num_layers=2, hidden_size=64, vocab_size=VOCAB,
              make_vocab_size_divisible_by=128, seq_length=SEQ,
              compute_dtype="float32", **model_kw)
    if family == "gpt":
        kw.update(num_attention_heads=4, max_position_embeddings=SEQ)
        models = jc.gpt_config(**kw), tc.gpt_config(**kw)
    else:
        kw.setdefault("num_attention_heads", 8)
        kw.setdefault("num_kv_heads", 2)
        models = (jc.llama2_config("tiny", **kw),
                  tc.llama2_config("tiny", **kw))
    opt = dict(lr=lr, optimizer=optimizer, sgd_momentum=0.0,
               weight_decay=0.01, clip_grad=1.0)
    train = dict(micro_batch_size=micro, global_batch_size=global_batch,
                 log_params_norm=True)
    par = dict(tensor_parallel=tp, sequence_parallel=sp,
               use_distributed_optimizer=zero)
    out = []
    for mod, model in zip((jc, tc), models):
        out.append(mod.MegatronConfig(
            model=model, parallel=mod.ParallelConfig(**par),
            optimizer=mod.OptimizerConfig(**opt),
            training=mod.TrainingConfig(**train)).validate(n_devices=tp * dp))
    return out


def batches(cfg, masks="random", seed=1):
    rs = np.random.RandomState(seed)
    n_micro = cfg.num_microbatches
    rows = cfg.training.micro_batch_size * cfg.parallel.data_parallel
    out = []
    for _ in range(STEPS):
        mask = (rs.rand(n_micro, rows, SEQ) > 0.25).astype(np.float32)
        if masks == "uneven":
            # the dp ranks' rows hold very different mask counts
            mask[:, rows // 2:, 4:] = 0.0
        out.append({"tokens": rs.randint(0, VOCAB, (n_micro, rows, SEQ + 1)),
                    "loss_mask": mask})
    return out


def jax_run(jcfg, batch_list):
    n = jcfg.parallel.tensor_parallel * jcfg.parallel.data_parallel
    mesh = j_build_mesh(jcfg.parallel, devices=jax.devices()[:n])
    state = j_init(jax.random.PRNGKey(0), jcfg)
    weights = {k.replace("/", "."): np.asarray(v)
               for k, v in _flatten(state.params).items()}
    step = j_make_step(jcfg, mesh=mesh, donate=False)
    metrics = []
    for i, b in enumerate(batch_list):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "params": {
        k: np.asarray(v) for k, v in _flatten(state.params).items()}}
    if state.opt_state.nu is not None:
        out["mu"] = {k: np.asarray(v)
                     for k, v in _flatten(state.opt_state.mu).items()}
        out["nu"] = {k: np.asarray(v)
                     for k, v in _flatten(state.opt_state.nu).items()}
    return weights, out


def check_run(ranks, want, weights, zero_grad_atol=0.0):
    """The ranks' run ({"metrics", "params"} from each) held to another
    from the same `weights`: every rank reports the global metrics; loss,
    grad norm and params norm within METRIC_RTOL, found_inf 0; each leaf
    within PARAM_REL of its largest update over the run, or within
    `zero_grad_atol` where that is more. Returns rank 0's run."""
    got = ranks[0]
    for r in ranks[1:]:
        assert r["metrics"] == got["metrics"]
    for g, w in zip(got["metrics"], want["metrics"]):
        for key in ("lm_loss", "grad_norm", "params_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=METRIC_RTOL,
                                       err_msg=key)
        assert g["found_inf"] == w["found_inf"] == 0
    assert sorted(got["params"]) == sorted(want["params"])
    for k, w in want["params"].items():
        update = np.abs(w - weights[k.replace("/", ".")]).max()
        assert update > 0, k
        np.testing.assert_allclose(
            got["params"][k], w, rtol=0,
            atol=max(PARAM_REL * update, zero_grad_atol), err_msg=k)
    return got


def check_against_jax(pool, jcfg, tcfg, batch_list):
    """Both sharded runs; the port's held to the JAX package's."""
    weights, want = jax_run(jcfg, batch_list)
    world = tcfg.parallel.tensor_parallel * tcfg.parallel.data_parallel
    ranks = pool.run(world, mesh_ranks.train, tcfg, weights, batch_list)
    return check_run(ranks, want, weights), want


@pytest.mark.parametrize("sp", [False, True])
def test_tp2_matches_jax(pool, sp):
    jcfg, tcfg = configs("llama", tp=2, sp=sp)
    check_against_jax(pool, jcfg, tcfg, batches(tcfg))


def test_tp4_replicated_kv_matches_jax(pool):
    """tp 4 over 2 kv heads: each rank holds the whole wkv and picks the kv
    head of its 2 q heads; the wkv grads are summed over tp."""
    jcfg, tcfg = configs("llama", tp=4, sp=True)
    check_against_jax(pool, jcfg, tcfg, batches(tcfg))


def test_gpt_tp2_sp_matches_jax(pool):
    """Biases (bo and b2 added after the reduce-scatter), LayerNorm, tied
    embeddings and learned positions, under sequence parallelism."""
    jcfg, tcfg = configs("gpt", tp=2, sp=True)
    check_against_jax(pool, jcfg, tcfg, batches(tcfg))
