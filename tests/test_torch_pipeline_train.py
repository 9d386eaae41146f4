"""The port's pipelined training step end to end: make_train_step at pp 2
against the JAX package's (Adam, 2 steps, fp32, a tiny Llama of 4 layers
on the 8-device virtual CPU mesh), checkpoints across pipeline layouts,
exact resume under pp through finetune.main on 2 gloo ranks, and the two
pipeline tools at a tiny size. The port's ranks are gloo processes
(tests/mesh_pool.py).

Limits, and the readings they were set from (this CPU):
- the step: tests/test_torch_mesh_step.py's check_run: lm_loss, grad norm
  and params norm within 1e-5 relative (read: at most 1.7e-7); each leaf
  within 1e-2 of its largest update over the run (read: at most 2.6e-4
  of it). Adam runs at eps 1e-6: at its default 1e-8 the grads near
  zero turn the order of the float sums into up to 8.7e-3 of the update
  (read), too near the limit to tell a fault from it;
- a checkpoint saved at (pp 2, vpp 2) and loaded at pp 1, and the
  reverse, and the resumed run against the uninterrupted one: bit for
  bit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_ranks
from megatron_tpu.models import language_model as jlm
from megatron_tpu.parallel.mesh import build_mesh as j_build_mesh
from megatron_tpu.training import make_train_step as j_make_step
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu.training.train_step import state_from_params as j_state
from megatron_tpu_torch.models import language_model as tlm
from mesh_pool import RankPool
from test_torch_mesh_step import check_run
from test_torch_mesh_train import _argv, corpus  # noqa: F401 (fixture)
from test_torch_pipeline import configs, make_batch

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def adam(**kw):
    import dataclasses
    out = []
    for cfg in configs(**kw):
        out.append(dataclasses.replace(cfg, optimizer=dataclasses.replace(
            cfg.optimizer, optimizer="adam", lr=1e-3, adam_eps=1e-6)))
    return out


def test_make_train_step_matches_jax(pool):
    """The LM's make_train_step at pp 2 (1F1B, recompute mode) with Adam
    for 2 steps against the reference's pipelined make_train_step."""
    jcfg, tcfg = adam(pp=2)
    mesh = j_build_mesh(jcfg.parallel, devices=jax.devices()[:2])
    params = jlm.model_init(jax.random.PRNGKey(0), jcfg.model)
    weights = {k.replace("/", "."): np.asarray(v)
               for k, v in _flatten(params).items()}
    batches = [make_batch(5), make_batch(6)]
    step = j_make_step(jcfg, mesh=mesh, donate=False)
    state = j_state(params, jcfg)
    metrics = []
    for i, b in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    want = {"metrics": metrics, "params": {
        k: np.asarray(v) for k, v in _flatten(state.params).items()}}
    ranks = pool.run(2, mesh_ranks.train, tcfg, weights, batches)
    check_run(ranks, want, weights)


def test_checkpoints_move_between_pipeline_layouts(pool, tmp_path):
    """A save at (pp 2, vpp 2) writes the unsharded leaves in layer order:
    it loads at pp 1, and a pp 1 save loads at (pp 2, vpp 2), parameters
    and Adam moments bit for bit."""
    _, one = adam()
    _, tcfg = adam(pp=2, vpp=2)
    weights = {k: v.numpy() for k, v in tlm.LanguageModel(
        one.model, device="cpu", seed=3).state_dict().items()}
    batches = [make_batch(7)]
    for src, dst, world_src, world_dst in ((tcfg, one, 2, 1),
                                           (one, tcfg, 1, 2)):
        root = str(tmp_path / f"ckpt_{world_src}")
        saved = pool.run(world_src, mesh_ranks.train, src, weights,
                         batches, None, world_src > 1, "lm", None, root)[0]
        got = pool.run(world_dst, mesh_ranks.load_state, dst, root)
        for r in got:
            assert r["iteration"] == 1
            for group in ("params", "mu", "nu"):
                assert sorted(r[group]) == sorted(saved[group])
                for k, v in saved[group].items():
                    assert r[group][k].tobytes() == v.tobytes(), (group, k)


PP2 = ("--pipeline_model_parallel_size", "2")


def test_finetune_at_pp2_resumes_exactly(pool, corpus, tmp_path):
    """finetune.main on 2 gloo ranks at pp 2, with attention dropout,
    segment ids and evaluation: 6 iterations (U); the same run saving at
    3 and exiting (A); resumed from A (B), equal to U bit for bit."""
    d = str(tmp_path / "ckpt")
    u = pool.run(2, mesh_ranks.finetune_run, _argv(corpus, *PP2))
    a = pool.run(2, mesh_ranks.finetune_run, _argv(
        corpus, *PP2, "--save", d, "--exit_interval", "3"))
    b = pool.run(2, mesh_ranks.finetune_run, _argv(corpus, *PP2,
                                                   "--load", d))
    assert [r["rc"] for r in u + a + b] == [0] * 6
    assert u[0]["steps"] == u[1]["steps"] and len(u[0]["steps"]) == 6
    assert a[0]["steps"] == u[0]["steps"][:3]
    assert b[0]["steps"] == u[0]["steps"][3:]
    for group in ("params", "mu", "nu"):
        for k, v in u[0][group].items():
            assert np.array_equal(b[0][group][k], v), (group, k)


def test_bench_tools_print_their_fields(pool, capsys):
    """bench_bubble on 2 gloo ranks and bench_head, at tiny sizes."""
    from megatron_tpu_torch.tools import bench_head
    rec = pool.run(2, mesh_ranks.bubble_record,
                   ["--smoke", "--vpp", "1", "2"])[0]
    assert rec["backend"] == "gloo"
    assert [a["vpp"] for a in rec["arms"]] == [1, 2]
    for arm in rec["arms"]:
        assert {"t_tick_ms", "intercept_ms", "predicted_fill_drain_ms",
                "points"} <= set(arm)
        for p in arm["points"]:
            P = 2 * arm["vpp"]
            assert p["ticks"] == p["n_micro"] + 2 * (P - 1)
            assert p["predicted_bubble"] == 2 * (P - 1) / p["ticks"]
    assert any("measured_bubble=" in line for line in rec["lines"])
    assert bench_head.main(["--smoke"], device="cpu") == 0
    out = capsys.readouterr().out.strip().splitlines()
    body = json.loads(out[-1])
    assert body["t_layer_ms"] > 0 and body["t_head_ms"] > 0
    assert [(p["pp"], p["L"]) for p in body["points"]] == list(
        bench_head.POINTS)
    assert any("last-stage head overhead" in line for line in out)
