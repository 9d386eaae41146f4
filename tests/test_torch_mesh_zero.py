"""Data parallelism and the ZeRO-1 optimizer of the port's sharded step,
against the JAX package's sharded step on the 8-device virtual CPU mesh
(same numpy weights and batches, 2 steps, fp32), and ZeRO-1 against the
replicated optimizer inside the port. The helpers and the parameter limits
are tests/test_torch_mesh_step.py's.

- dp 2 with ZeRO-1, 2 microbatches, loss masks whose counts differ between
  the two dp ranks' rows: the masked mean must divide by the whole
  microbatch's count, not average per-rank means;
- dp 2 x tp 2 with sequence parallelism and ZeRO-1;
- Adam (lr 1e-3) at dp 2 x tp 2 with sequence parallelism and ZeRO-1:
  loss and grad norm as the SGD runs, the moments (gathered whole from
  the ranks' dp shares) within MOMENT_TOL = 1e-4 of each leaf's largest
  |value| (read: at most 2.7e-5, mu of w1);
- ZeRO-1 against the replicated optimizer (port against port, Adam): the
  reference's own test_training.py:276 limits, rtol 1e-6 and atol 1e-7
  (read: no difference at all; the two reduce each grad element in the
  same order over 2 ranks, and the update is elementwise).
"""
import numpy as np
import pytest
import torch

import mesh_ranks
from test_torch_mesh_step import (batches, check_against_jax, configs,
                                  jax_run, pool)  # noqa: F401 (fixture)

torch.set_num_threads(2)
MOMENT_TOL = 1e-4

# (tag, mesh and batch of configs(), masks of batches())
CASES = [
    ("dp2_zero_uneven", dict(dp=2, zero=True, micro=1, global_batch=4),
     "uneven"),
    ("dp2_tp2_sp_zero", dict(dp=2, tp=2, sp=True, zero=True, micro=1,
                             global_batch=4), "random"),
]


@pytest.mark.parametrize("kw,masks", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_data_parallel_matches_jax(pool, kw, masks):
    jcfg, tcfg = configs("llama", **kw)
    check_against_jax(pool, jcfg, tcfg, batches(tcfg, masks))


def test_adam_moments_match_jax(pool):
    jcfg, tcfg = configs("llama", dp=2, tp=2, sp=True, zero=True, micro=1,
                         global_batch=4, optimizer="adam", lr=1e-3)
    batch_list = batches(tcfg, "uneven")
    weights, want = jax_run(jcfg, batch_list)
    got = pool.run(4, mesh_ranks.train, tcfg, weights, batch_list)[0]
    for g, w in zip(got["metrics"], want["metrics"]):
        for key in ("lm_loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5)
    for group in ("mu", "nu"):
        assert sorted(got[group]) == sorted(want[group])
        for k, w in want[group].items():
            scale = max(np.abs(w).max(), 1e-30)
            err = np.abs(got[group][k] - w).max() / scale
            assert err <= MOMENT_TOL, (group, k, err)


def test_zero1_equals_replicated_optimizer(pool):
    """use_distributed_optimizer changes where the moments live, not the
    update (the reference's test_training.py:276)."""
    _, rep = configs("llama", dp=2, micro=1, global_batch=4,
                     optimizer="adam", lr=1e-3)
    _, dist = configs("llama", dp=2, zero=True, micro=1, global_batch=4,
                      optimizer="adam", lr=1e-3)
    jcfg, _ = configs("llama", optimizer="adam", lr=1e-3)
    batch_list = batches(rep, "uneven")
    weights, _ = jax_run(jcfg, batch_list[:0])
    a = pool.run(2, mesh_ranks.train, rep, weights, batch_list)[0]
    b = pool.run(2, mesh_ranks.train, dist, weights, batch_list)[0]
    np.testing.assert_allclose(b["metrics"][-1]["lm_loss"],
                               a["metrics"][-1]["lm_loss"], rtol=1e-6)
    for group in ("params", "mu", "nu"):
        for k, v in a[group].items():
            np.testing.assert_allclose(b[group][k], v, rtol=1e-6, atol=1e-7,
                                       err_msg=f"{group}/{k}")
