"""bf16 and fp16 master weights on the CPU against the JAX package: three
`make_train_step` steps on the same numpy weights and batches (2
microbatches), and the npz checkpoints of such a state in both directions.

Tolerances and why:
- loss and grad norm 1e-5 relative: the same fp32 formulas over the same
  bf16 weights, summed in another order;
- the fp32 moments 1e-4 of each leaf's largest magnitude, except in at
  most 0.1% of its elements, which hold 1e-2: each microbatch's grad is
  rounded to bf16 (as the reference's grad of a bf16 leaf is), so a ~1e-6
  difference before that rounding now and then moves a grad element by a
  whole bf16 ulp (2^-8 of it), and a parameter a step rounded the other
  way moves the grads after it (the runs that set this bound: at most 18
  of 65,536 elements of a leaf past 1e-4, none past 1.1e-3);
- the bf16 parameters differ in at most 0.1% of each leaf's elements,
  each by at most one bf16 ulp of the larger of the element and the
  learning rate: the update runs in fp32 and is rounded to bf16, so a
  ~1e-6 difference of the fp32 update flips the rounding of the few
  elements that lie near a rounding boundary; an element within a step
  of zero has ulps finer than the step, so the step's scale bounds it
  (the runs that set this bound: 3 of 200k elements differ, one by 4
  ulps of its own 1e-4 magnitude, 3.8e-6);
- fp16 weights with fp32 compute, the same three steps: loss and grad
  norm 1e-5 (reading 1.9e-7); the moments within 1e-3 of each leaf's
  largest, and within 1e-4 but in at most 0.1% of its elements or 2,
  whichever is more (readings: at most 4.3e-4, and 5 of 65,536 and 2 of
  128 elements past 1e-4); the fp16 parameters differ in at most 0.5% of
  a leaf's elements, each by at most 4 fp16 ulps of the larger of the
  element and the learning rate (readings: 25 of 8,192 elements, by at
  most 4 ulps): fp16 has 3 more mantissa bits than bf16, so the same
  fp32 difference of an update moves it more ulps. A missing or halved
  update moves most elements by tens to thousands of ulps;
- the fp16 run with fp16 compute and the dynamic scaler: its loss-scaler
  sequence (scale, growth tracker, hysteresis, applied steps) exactly (an
  overflow is an overflow in both); the applied steps' loss 1e-5 and grad
  norm 2e-5 relative (readings 1.2e-6 and 1.07e-5); each moment leaf
  within 2e-3 in relative norm (reading at most 1.07e-3: the activations
  and grads are rounded to fp16, whose epsilon is 9.8e-4, after sums in
  another order); each leaf's change over the run within 2e-2 of JAX's in
  relative norm (reading at most 9.3e-3; a halved update reads 0.5, a
  missing one 1.0). Elementwise ulps mean little here: Adam divides an
  element's tiny fp16 grad by its own root moment, so a near-zero grad
  rounded the other way moves its update by a large share of lr.
"""
import importlib
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu import config as jc
from megatron_tpu.training import checkpointing as jckpt
from megatron_tpu.training.checkpointing import _flatten
from megatron_tpu_torch import config as tc
from megatron_tpu_torch.convert.from_jax import (train_state_from_numpy,
                                                 train_state_to_numpy)
from megatron_tpu_torch.training import checkpointing as tckpt

jts = importlib.import_module("megatron_tpu.training.train_step")
tts = importlib.import_module("megatron_tpu_torch.training.train_step")

torch.set_num_threads(2)
SMALL = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
             vocab_size=300, seq_length=32)


def _rel_err(got, want):
    want = np.asarray(want, np.float64)
    return (np.abs(np.asarray(got, np.float64) - want).max()
            / max(np.abs(want).max(), 1e-30))


def _bits(a) -> np.ndarray:
    """The 2-byte words of a bf16 leaf (ml_dtypes or raw "V2")."""
    return np.asarray(a).view(np.uint16)


def _bf16_values(a) -> np.ndarray:
    """A bf16 leaf's values in fp64: its words are the top half of fp32's."""
    return (_bits(a).astype(np.uint32) << 16).view(np.float32).astype(
        np.float64)


def _configs(params_dtype, compute_dtype="float32", **opt_kw):
    kw = dict(SMALL, attention_impl="flash", params_dtype=params_dtype,
              compute_dtype=compute_dtype)
    opt = dict(lr=1e-3, min_lr=1e-4, lr_warmup_iters=1, clip_grad=1.0,
               weight_decay=0.1, **opt_kw)
    tr = dict(micro_batch_size=2, global_batch_size=4, train_iters=10)
    return (jc.MegatronConfig(model=jc.llama2_config("tiny", **kw),
                              optimizer=jc.OptimizerConfig(**opt),
                              training=jc.TrainingConfig(**tr)),
            tc.MegatronConfig(model=tc.llama2_config("tiny", **kw),
                              optimizer=tc.OptimizerConfig(**opt),
                              training=tc.TrainingConfig(**tr)))


def _batches():
    rs = np.random.RandomState(0)
    toks = rs.randint(0, SMALL["vocab_size"], (2, 2, SMALL["seq_length"] + 1))
    mask = (rs.rand(2, 2, SMALL["seq_length"]) > 0.2).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)},
            {"tokens": torch.from_numpy(toks),
             "loss_mask": torch.from_numpy(mask)})


def _states(jcfg, tcfg):
    assert tcfg.num_microbatches == 2
    jstate = jts.init_train_state(jax.random.PRNGKey(0), jcfg)
    tstate = train_state_from_numpy(jstate.params, jstate.opt_state,
                                    jstate.iteration, tcfg, device="cpu")
    return jstate, tstate


def _scaler(s):
    return (float(s.scaler.scale), int(s.scaler.growth_tracker),
            int(s.scaler.hysteresis), int(s.step))


def _values(a) -> np.ndarray:
    a = np.asarray(a)
    return (a.astype(np.float64) if a.dtype == np.float16
            else _bf16_values(a))


def _three_steps_against_jax(params_dtype, mantissa_bits, max_ulps,
                             param_share, moment_cap, moment_few=0):
    """Three steps of both packages at fp32 compute from the same state;
    the weights held by ulps of their dtype (`mantissa_bits`) of the
    larger of the element and lr, the moments at 1e-4 of a leaf's largest
    but in at most 0.1% of its elements or `moment_few`, whichever is
    more, and at `moment_cap`."""
    jcfg, tcfg = _configs(params_dtype)
    jstate, tstate = _states(jcfg, tcfg)
    dtype = getattr(torch, params_dtype)
    assert all(p.dtype == dtype for p in tstate.params.parameters())
    assert all(m.dtype == torch.float32
               for m in tstate.opt_state.mu.values())
    jstep = jts.make_train_step(jcfg, mesh=None, donate=False)
    tstep = tts.make_train_step(tcfg, device="cpu")
    jbatch, tbatch = _batches()
    losses = []
    for _ in range(3):
        jstate, jm = jstep(jstate, jbatch, None)
        tstate, tm = tstep(tstate, tbatch)
        for key in ("lm_loss", "grad_norm"):
            assert _rel_err(float(tm[key]), float(jm[key])) < 1e-5, key
        assert int(tm["found_inf"]) == int(jm["found_inf"]) == 0
        losses.append(float(tm["lm_loss"]))
    assert losses[0] > losses[2]
    params, opt_state, _ = train_state_to_numpy(tstate)
    jmu, jnu = _flatten(jstate.opt_state.mu), _flatten(jstate.opt_state.nu)
    lr = tcfg.optimizer.lr
    for name, want in _flatten(jstate.params).items():
        got, ref = _values(params[name]), _values(want)
        diff = np.abs(got - ref)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), lr)))
                      - mantissa_bits)
        assert (diff <= max_ulps * ulp).all(), name
        assert (diff > 0).sum() <= param_share * diff.size, name
        for got_m, want_m in ((opt_state["mu"][name], jmu[name]),
                              (opt_state["nu"][name], jnu[name])):
            assert got_m.dtype == np.float32
            diff = np.abs(got_m - np.asarray(want_m))
            top = np.abs(np.asarray(want_m)).max()
            assert diff.max() <= moment_cap * top, name
            assert ((diff > 1e-4 * top).sum()
                    <= max(moment_few, 1e-3 * diff.size)), name


def test_bf16_master_weights_three_steps_match_jax():
    _three_steps_against_jax("bfloat16", 7, 1, 1e-3, 1e-2)


def test_fp16_master_weights_three_steps_match_jax():
    _three_steps_against_jax("float16", 10, 4, 5e-3, 1e-3, moment_few=2)


def test_fp16_master_weights_scaler_sequence_matches_jax():
    """fp16 weights and compute seed the dynamic scaler at 2^32: the first
    steps overflow and are skipped, each spending hysteresis then halving
    the scale, until the steps apply; the sequence equals JAX's exactly
    and the applied steps' metrics, moments and updates match."""
    jcfg, tcfg = _configs("float16", "float16",
                          initial_loss_scale=2.0 ** 32, hysteresis=1,
                          loss_scale_window=4)
    jstate, tstate = _states(jcfg, tcfg)
    start = {k: np.asarray(v, np.float64)
             for k, v in _flatten(jstate.params).items()}
    assert _scaler(tstate.opt_state) == _scaler(jstate.opt_state)
    assert float(tstate.opt_state.scaler.scale) == 2.0 ** 32
    jstep = jts.make_train_step(jcfg, mesh=None, donate=False)
    tstep = tts.make_train_step(tcfg, device="cpu")
    jbatch, tbatch = _batches()
    skipped, applied = [], 0
    for i in range(24):
        jstate, jm = jstep(jstate, jbatch, None)
        tstate, tm = tstep(tstate, tbatch)
        assert int(tm["found_inf"]) == int(jm["found_inf"]), i
        assert _scaler(tstate.opt_state) == _scaler(jstate.opt_state), i
        if int(tm["found_inf"]):
            skipped.append(i)
            continue
        applied += 1
        for key, tol in (("lm_loss", 1e-5), ("grad_norm", 2e-5)):
            assert _rel_err(float(tm[key]), float(jm[key])) < tol, key
        if applied == 3:
            break
    assert skipped[0] == 0 and applied == 3, (skipped, applied)
    params, opt_state, _ = train_state_to_numpy(tstate)
    jmu, jnu = _flatten(jstate.opt_state.mu), _flatten(jstate.opt_state.nu)
    for name, want in _flatten(jstate.params).items():
        assert params[name].dtype == np.float16
        moved = np.asarray(want, np.float64) - start[name]
        err = params[name].astype(np.float64) - start[name] - moved
        assert (np.linalg.norm(err)
                <= 2e-2 * np.linalg.norm(moved)), name
        for got_m, want_m in ((opt_state["mu"][name], jmu[name]),
                              (opt_state["nu"][name], jnu[name])):
            want_m = np.asarray(want_m, np.float64)
            assert (np.linalg.norm(got_m - want_m)
                    <= 2e-3 * np.linalg.norm(want_m)), name


# --- npz checkpoints of bf16 and fp16 states ----------------------------------

def _jax_bf16_checkpoint(root):
    jcfg, tcfg = _configs("bfloat16")
    jstate = jts.init_train_state(jax.random.PRNGKey(4), jcfg)
    jckpt.save_checkpoint(root, jstate, jcfg, 5, 40, backend="npz")
    return jcfg, tcfg, jstate


def _members(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def test_jax_bf16_npz_loads_into_the_port_bit_equal(tmp_path):
    _, tcfg, jstate = _jax_bf16_checkpoint(str(tmp_path))
    example = tts.init_train_state(tcfg, device="cpu", seed=9)
    assert next(example.params.parameters()).dtype == torch.bfloat16
    loaded = tckpt.load_checkpoint(str(tmp_path), example)
    assert loaded.iteration == 5 and loaded.consumed_samples == 40
    params, opt_state, _ = train_state_to_numpy(loaded.state)
    for name, want in _flatten(jstate.params).items():
        np.testing.assert_array_equal(_bits(params[name]), _bits(want))
    for name, want in _flatten(jstate.opt_state.mu).items():
        np.testing.assert_array_equal(opt_state["mu"][name],
                                      np.asarray(want))


def test_port_bf16_npz_has_the_reference_keys_descr_and_bytes(tmp_path):
    """The same bf16 state saved by both packages: every params.npz and
    opt_state.npz member (its npy header, "<V2" for a bf16 leaf, and its
    payload) is byte-equal."""
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jcfg, tcfg, jstate = _jax_bf16_checkpoint(jroot)
    tstate = train_state_from_numpy(jstate.params, jstate.opt_state,
                                    jstate.iteration, tcfg, device="cpu")
    tckpt.save_checkpoint(troot, tstate, tcfg, 5, 40)
    for fname in (tckpt.PARAMS_FILE, tckpt.OPT_FILE):
        want = _members(os.path.join(jroot, "iter_0000005", fname))
        got = _members(os.path.join(troot, "iter_0000005", fname))
        assert sorted(got) == sorted(want), fname
        for name, data in want.items():
            assert got[name] == data, name
    member = _members(os.path.join(
        troot, "iter_0000005", tckpt.PARAMS_FILE))[
            "embedding/word_embeddings.npy"]
    assert b"'descr': '<V2'" in member[:128]


@pytest.mark.parametrize("params_dtype", ["bfloat16", "float16"])
def test_low_precision_resume_is_bit_equal(tmp_path, params_dtype):
    """Four steps straight, against two steps, a save, a load into a fresh
    state and two more: the losses and every weight and moment bit for
    bit."""
    compute = "float16" if params_dtype == "float16" else "float32"
    _, tcfg = _configs(params_dtype, compute, initial_loss_scale=2.0 ** 12)
    _, tbatch = _batches()
    step = tts.make_train_step(tcfg, device="cpu")

    def run(state, n):
        return state, [float(step(state, tbatch)[1]["lm_loss"])
                       for _ in range(n)]

    straight, want = run(tts.init_train_state(tcfg, device="cpu"), 4)
    first, got = run(tts.init_train_state(tcfg, device="cpu"), 2)
    tckpt.save_checkpoint(str(tmp_path), first, tcfg, 2, 8)
    fresh = tts.init_train_state(tcfg, device="cpu", seed=3)
    resumed = tckpt.load_checkpoint(str(tmp_path), fresh).state
    resumed, more = run(resumed, 2)
    assert got + more == want
    a, b = train_state_to_numpy(straight), train_state_to_numpy(resumed)
    assert a[1]["scaler"] == b[1]["scaler"] and a[1]["step"] == b[1]["step"]
    for name, want_p in a[0].items():
        assert a[0][name].dtype == b[0][name].dtype
        np.testing.assert_array_equal(b[0][name].view(np.uint16)
                                      if b[0][name].dtype.kind == "V"
                                      else b[0][name],
                                      want_p.view(np.uint16)
                                      if want_p.dtype.kind == "V"
                                      else want_p)
        np.testing.assert_array_equal(b[1]["mu"][name], a[1]["mu"][name])
        np.testing.assert_array_equal(b[1]["nu"][name], a[1]["nu"][name])
