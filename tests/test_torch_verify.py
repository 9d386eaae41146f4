"""The port's verify_correctness (megatron_tpu_torch/verify_correctness.py)
against the JAX package's fixtures and functions.

- The pinned, ordered list of `LlamaForCausalLM.state_dict()` names and
  shapes equals transformers' own; the numpy-seeded state dict built from it
  without transformers equals the JAX tool's seeded HF model bit for bit.
- The golden-logit fixture replays in the port at an average max-abs
  <= 1e-3 (measured 1.3e-7), and so does the Mixtral one (measured
  1.3e-7), whose pinned names and seeded state dict equal the JAX tool's
  synthetic Mixtral.
- The loss-trajectory fixture, run free for 100 steps in fp32: losses at
  rtol 2e-4 / atol 1e-5 and lr at rtol 1e-6 on every step, JAX's
  tolerances; these are the series the command line gates
  (`verify_correctness.GATED`), and it exits 0. (Free-running, the grad-norm series leaves JAX's rtol 1e-3 at
  late steps and the fp16 scaler's sequence parts from JAX's partway: a
  one-ulp change of one weight moves JAX's own run past rtol 1e-3 (the
  test below shows it), so late steps of a free run hold only a
  bit-identical backend. The teacher-forced test holds those series at
  every step.)
- Teacher-forced, the same 100-step run in fp32 and in fp16: at every step
  the port's step starts from JAX's state and must give JAX's loss and grad
  norm (fp32: rtol 1e-5, measured 8e-7; fp16: rtol 2e-3, measured 1e-4 and
  2.7e-4, fp16 rounding after each op against XLA's fused ops), its lr
  (rtol 1e-6) and exactly its loss scale and found_inf.
- compare_llama on transformers' synthetic Llama passes the 1e-3 gate.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import verify_correctness as jvc
from megatron_tpu import config as jc
from megatron_tpu.parallel.mesh import build_mesh
from megatron_tpu.training import make_train_step as jax_train_step
from megatron_tpu.training.train_step import state_from_params
from megatron_tpu_torch import verify_correctness as tvc
from megatron_tpu_torch.convert.from_jax import train_state_from_numpy
from megatron_tpu_torch.training import make_train_step

transformers = pytest.importorskip("transformers")
torch.set_num_threads(2)
GOLDEN = "tests/fixtures/golden_logits_llama_synthetic.npz"
GOLDEN_MIXTRAL = "tests/fixtures/golden_logits_mixtral_synthetic.npz"
TRAJECTORY = "tests/fixtures/golden_loss_trajectory.npz"
STEPS = 100


def test_pinned_names_equal_transformers():
    model, _ = jvc.make_synthetic_hf_llama()
    want = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    dims = {k: v for k, v in tvc.SYNTHETIC.items() if k != "seq"}
    assert tvc.synthetic_hf_llama_names(**dims) == want


def test_seeded_state_dict_equals_jax_tool():
    model, cfg = jvc.make_synthetic_hf_llama(seq=64)
    jvc.seed_hf_llama_numpy(model, seed=0)
    want = {k: v.numpy() for k, v in model.state_dict().items()}
    got = tvc.synthetic_llama_sd(0)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tcfg = tvc.synthetic_config(**tvc.SYNTHETIC)
    assert {k: v for k, v in dataclasses.asdict(cfg).items()
            if k in dataclasses.asdict(tcfg)} == dataclasses.asdict(tcfg)


def test_golden_fixture_replays():
    r = tvc.golden_mode(GOLDEN, device="cpu")
    assert r["ok"] and r["avg_max_abs_err"] <= 1e-3, r
    assert tvc.main(["--golden", GOLDEN], device="cpu") == 0


def test_mixtral_names_and_seeded_state_dict_equal_jax_tool():
    model, cfg = jvc.make_synthetic_hf_mixtral(seq=64)
    dims = {k: v for k, v in tvc.SYNTHETIC_MIXTRAL.items()
            if k not in ("seq", "top_k")}
    assert tvc.synthetic_hf_mixtral_names(**dims) == [
        (k, tuple(v.shape)) for k, v in model.state_dict().items()]
    jvc.seed_hf_llama_numpy(model, seed=0)
    got = tvc.synthetic_mixtral_sd(0)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    tcfg = tvc.synthetic_mixtral_config(**tvc.SYNTHETIC_MIXTRAL)
    assert {k: v for k, v in dataclasses.asdict(cfg).items()
            if k in dataclasses.asdict(tcfg)} == dataclasses.asdict(tcfg)


def test_golden_mixtral_fixture_replays():
    """tests/fixtures/golden_logits_mixtral_synthetic.npz holds the JAX
    package's forward of its `hf_mixtral_to_params` conversion of the seeded
    state dict (recomputed here: bit for bit), and the port replays it at the Llama fixture's tolerance."""
    from megatron_tpu.convert import hf_mixtral_to_params
    from megatron_tpu.models import language_model as jlm
    pinned = np.load(GOLDEN_MIXTRAL)
    _, cfg = jvc.make_synthetic_hf_mixtral(seq=64)
    params = hf_mixtral_to_params(tvc.synthetic_mixtral_sd(0), cfg)
    logits, _ = jlm.model_forward(params, jnp.asarray(pinned["tokens"]), cfg,
                                  logits_dtype=jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(logits)[..., :cfg.vocab_size], pinned["logits"])
    r = tvc.golden_mode(GOLDEN_MIXTRAL, device="cpu", family="mixtral")
    assert r["ok"] and r["avg_max_abs_err"] <= 1e-3, r
    assert tvc.main(["--family", "mixtral", "--golden", GOLDEN_MIXTRAL],
                    device="cpu") == 0


def test_loss_trajectory_fixture_fp32_losses_and_lr():
    pinned = np.load(TRAJECTORY)
    assert int(pinned["steps"]) == STEPS
    got = tvc.run_loss_trajectory(STEPS, "fp32", device="cpu")
    np.testing.assert_allclose(got["losses"], pinned["fp32_losses"],
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got["lr"], pinned["fp32_lr"], rtol=1e-6)
    assert got["losses"][-1] < got["losses"][0] - 0.5  # it trains
    rows = {name: (ok, gated) for name, ok, _, gated in
            tvc.check_trajectory(got, pinned, "fp32")}
    assert rows["fp32 losses"] == (True, True)
    assert rows["fp32 lr"] == (True, True)
    assert rows["fp32 grad_norm"][1] is False  # reported, not gated


def _jax_trajectory_step(mode, perturb=False):
    model, mcfg = jvc.make_synthetic_hf_llama(seq=64)
    jvc.seed_hf_llama_numpy(model, seed=0)
    mcfg = dataclasses.replace(
        mcfg, compute_dtype="float32" if mode == "fp32" else "float16")
    cfg = jc.MegatronConfig(
        model=mcfg, parallel=jc.ParallelConfig(),
        optimizer=jc.OptimizerConfig(
            lr=3e-3, min_lr=3e-4, lr_decay_style="cosine",
            lr_decay_iters=STEPS, lr_warmup_iters=10, weight_decay=0.1,
            clip_grad=1.0, initial_loss_scale=2.0 ** 24,
            loss_scale_window=25, hysteresis=2),
        training=jc.TrainingConfig(micro_batch_size=2, global_batch_size=2,
                                   train_iters=STEPS)).validate(n_devices=1)
    from megatron_tpu.convert import hf_llama_to_params
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = hf_llama_to_params(sd, cfg.model)
    if perturb:  # one ulp of one weight
        wq = params["transformer"]["attention"]["wq"]
        wq[0, 0, 0] = np.nextafter(wq[0, 0, 0], np.float32(1))
    state = state_from_params(jax.tree.map(jnp.asarray, params), cfg)
    mesh = build_mesh(cfg.parallel, devices=jax.devices()[:1])
    return state, jax_train_step(cfg, mesh=mesh, donate=False)


@pytest.mark.parametrize("mode,rtol", [("fp32", 1e-5), ("fp16", 2e-3)])
def test_loss_trajectory_teacher_forced_against_jax(mode, rtol):
    state, jstep = _jax_trajectory_step(mode)
    tcfg = tvc.trajectory_config(STEPS, mode)
    tstep = make_train_step(tcfg, device="cpu")
    data_rng = np.random.default_rng(1)
    cycle = [data_rng.integers(0, 128, (1, 2, 65)).astype(np.int32)
             for _ in range(4)]
    mask = np.ones((1, 2, 64), np.float32)
    for i in range(STEPS):
        ts = train_state_from_numpy(state.params, state.opt_state,
                                    state.iteration, tcfg, device="cpu")
        state, m = jstep(state, {"tokens": jnp.asarray(cycle[i % 4]),
                                 "loss_mask": jnp.asarray(mask)},
                         jax.random.PRNGKey(i))
        _, tm = tstep(ts, {"tokens": torch.from_numpy(
            cycle[i % 4].astype(np.int64)), "loss_mask": torch.from_numpy(
            mask)})
        for key in ("loss_scale", "found_inf"):
            assert float(tm[key]) == float(m[key]), (i, key)
        np.testing.assert_allclose(float(tm["lr"]), float(m["lr"]),
                                   rtol=1e-6, err_msg=str(i))
        # a skipped step's grad norm is not finite
        keys = ("lm_loss",) if float(m["found_inf"]) else ("lm_loss",
                                                           "grad_norm")
        for key in keys:
            np.testing.assert_allclose(float(tm[key]), float(m[key]),
                                       rtol=rtol, err_msg=f"{i} {key}")


def test_jax_trajectory_grad_norm_holds_only_bitwise():
    """Why the free-running grad-norm series is not gated: JAX's own fp32
    run, one weight moved by one ulp, leaves the fixture's rtol 1e-3 late
    in the run although its losses stay inside theirs."""
    pinned = np.load(TRAJECTORY)
    state, jstep = _jax_trajectory_step("fp32", perturb=True)
    data_rng = np.random.default_rng(1)
    cycle = [data_rng.integers(0, 128, (1, 2, 65)).astype(np.int32)
             for _ in range(4)]
    mask = jnp.ones((1, 2, 64), jnp.float32)
    losses, norms = [], []
    for i in range(STEPS):
        state, m = jstep(state, {"tokens": jnp.asarray(cycle[i % 4]),
                                 "loss_mask": mask}, jax.random.PRNGKey(i))
        losses.append(float(m["lm_loss"]))
        norms.append(float(m["grad_norm"]))
    np.testing.assert_allclose(losses, pinned["fp32_losses"], rtol=2e-4,
                               atol=1e-5)
    assert not np.allclose(norms, pinned["fp32_grad_norm"], rtol=1e-3,
                           atol=1e-5)


def test_compare_llama_passes_the_gate():
    model, cfg = jvc.make_synthetic_hf_llama(seq=64)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 48))
    tcfg = tvc.synthetic_config(**tvc.SYNTHETIC)
    r = tvc.compare_llama(model, tcfg, tokens, device="cpu")
    assert r["avg_max_abs_err"] <= 1e-3, r
    assert abs(r["loss_ours"] - r["loss_hf"]) < 1e-3, r


def test_cli_replays_both_fixtures(capsys):
    """The documented command exits 0 on the port: the gated series hold,
    and every other series is printed as reported."""
    assert tvc.main(["--golden", GOLDEN, "--loss_trajectory", TRAJECTORY],
                    device="cpu") == 0
    out = capsys.readouterr().out
    for series in ("fp32 grad_norm", "fp16 loss_scale", "fp16 found_inf",
                   "fp16 losses(applied)"):
        line = next(x for x in out.splitlines() if series in x)
        assert line.endswith(", reported)"), line
    for series in tvc.GATED:
        line = next(x for x in out.splitlines() if series + " " in x)
        assert "PASS" in line and "reported" not in line, line
    assert out.splitlines()[-1] == "PASS"


def test_cli_needs_a_fixture():
    with pytest.raises(SystemExit):
        tvc.main([], device="cpu")
