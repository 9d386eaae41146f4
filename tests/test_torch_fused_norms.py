"""The port's fused RMSNorm / LayerNorm against the JAX package's Pallas
kernels (`pallas_rmsnorm` / `pallas_layernorm(..., interpret=True)`, forward
and `jax.grad`), on the same numpy inputs, and the autograd Functions
against torch autograd of their own plain forward.

On the CPU `fused_rmsnorm` / `fused_layernorm` run the plain versions (the
Hopper kernels of csrc/fused_norms.cu run on the card, held against the
plain versions by chip_smoke.py). Tolerances:
- fp32: 1e-5 of the largest value (the same fp32 formulas, summed in
  another order);
- bf16 outputs and dx: within one bf16 step (2^-7 of the largest value),
  and at most 0.1% of the elements may differ at all: both round the fp32
  result once, so only an fp32 sum-order difference at a rounding boundary
  flips one. Casting to bf16 before the scale multiply (the model norm's
  order) makes a large share differ;
- dscale / dbias: fp32 sums over rows in another order, cast to the
  scale's dtype: 1e-5 (fp32) or 2^-7 (bf16) of the largest value.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu.ops.fused_norms import pallas_layernorm, pallas_rmsnorm
from megatron_tpu_torch.models import norms as tnorms
from megatron_tpu_torch.ops import cuda_build, fused_norms_cuda
from megatron_tpu_torch.ops import fused_norms as fn

torch.set_num_threads(2)
EPS = 1e-5
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
MISMATCH_SHARE = 1e-3

# (shape, x dtype, scale/bias dtype): 2-D and 3-D, row counts that no
# multiple of 8 divides, h 64-256; then the widths the backward kernels'
# lane map must handle, with few rows: Falcon-7B's 4544 (568 16-byte chunks,
# ragged over 32 lanes), 8192, 1-row and 7-row inputs, and rows past the
# rows kernel's registers (the wide kernel's): GPT-3 175B's 12288 and 4100
# (8,200-byte rows, scalar loads). Each case is seeded by its place in
# sorted order, so new names sort after the earlier ones and leave their
# inputs as they were.
CASES = {
    "fp32_2d_h64": ((13, 64), "float32", "float32"),
    "fp32_3d_h256": ((3, 7, 256), "float32", "float32"),
    "bf16_2d_h128": ((37, 128), "bfloat16", "bfloat16"),
    "bf16_3d_h256": ((2, 45, 256), "bfloat16", "bfloat16"),
    "bf16_x_fp32_params_h192": ((5, 9, 192), "bfloat16", "float32"),
    "rows_1_bf16_h4096": ((1, 4096), "bfloat16", "bfloat16"),
    "rows_7_bf16_x_fp32_params_h4544": ((7, 4544), "bfloat16", "float32"),
    "wide_bf16_h4544": ((3, 4544), "bfloat16", "bfloat16"),
    "wide_bf16_h8192": ((2, 8192), "bfloat16", "bfloat16"),
    "wide_fp32_h8192": ((2, 8192), "float32", "float32"),
    "wide_rows_bf16_h12288": ((2, 12288), "bfloat16", "bfloat16"),
    "wide_scalar_bf16_h4100": ((3, 4100), "bfloat16", "float32"),
}


def _inputs(name):
    shape, xd, pd = CASES[name]
    rs = np.random.RandomState(sorted(CASES).index(name))
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    h = shape[-1]
    scale = (1 + 0.2 * rs.randn(h)).astype(np.float32)
    bias = (0.3 * rs.randn(h)).astype(np.float32)
    return x, dy, scale, bias, xd, pd


def _j(a, d):
    return jnp.asarray(a, dtype=getattr(jnp, d))


def _t(a, d, grad=False):
    t = torch.from_numpy(a).to(getattr(torch, d))
    return t.requires_grad_(grad)


def _close(got, want, dtype, what):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tol = TOL[dtype] * max(abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)
    return got, want


def _mostly_equal(got, want, what):
    share = float(np.mean(got != want))
    assert share <= MISMATCH_SHARE, f"{what}: {share:.4f} of elements differ"


def _jax_norm(kind):
    if kind == "rms":
        return lambda x, s, b: pallas_rmsnorm(x, s, EPS, True)
    return lambda x, s, b: pallas_layernorm(x, s, b, EPS, True)


def _port_norm(kind):
    if kind == "rms":
        return lambda x, s, b: fn.fused_rmsnorm(x, s, EPS)
    return lambda x, s, b: fn.fused_layernorm(x, s, b, EPS)


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_norm_matches_pallas_forward_and_grads(kind, name):
    x, dy, scale, bias, xd, pd = _inputs(name)
    jx, js, jb = _j(x, xd), _j(scale, pd), _j(bias, pd)
    want = _jax_norm(kind)(jx, js, jb)

    def loss(a, s, b):
        out = _jax_norm(kind)(a, s, b).astype(jnp.float32)
        return jnp.sum(out * dy)
    jgrads = jax.grad(loss, argnums=(0, 1, 2) if kind == "ln" else (0, 1))(
        jx, js, jb)

    tx, ts, tb = _t(x, xd, True), _t(scale, pd, True), _t(bias, pd, True)
    got = _port_norm(kind)(tx, ts, tb)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    g, w = _close(got, want, xd, "out")
    if xd == "bfloat16":
        _mostly_equal(g, w, "out")
    got.float().backward(torch.from_numpy(dy))
    assert tx.grad.dtype == tx.dtype and ts.grad.dtype == ts.dtype
    g, w = _close(tx.grad, jgrads[0], xd, "dx")
    if xd == "bfloat16":
        _mostly_equal(g, w, "dx")
    _close(ts.grad, jgrads[1], pd, "dscale")
    if kind == "ln":
        assert tb.grad.dtype == ts.dtype
        _close(tb.grad, jgrads[2], pd, "dbias")


@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_autograd_matches_autograd_of_the_plain_forward(kind):
    x, dy, scale, bias, _, _ = _inputs("fp32_3d_h256")
    # the plain versions compute in fp32, so both sides are fp32 sums of
    # the same terms in another order
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, scale, bias)]
    if kind == "rms":
        out = fn.fused_rmsnorm(*leaves[:2], EPS)
        ref = fn.rms_fwd_reference(leaves[0].reshape(-1, 256), leaves[1],
                                   EPS).reshape(x.shape)
        n = 2
    else:
        out = fn.fused_layernorm(*leaves, EPS)
        ref = fn.ln_fwd_reference(leaves[0].reshape(-1, 256), *leaves[1:],
                                  EPS).reshape(x.shape)
        n = 3
    d = torch.from_numpy(dy)
    got = torch.autograd.grad(out, leaves[:n], d)
    want = torch.autograd.grad(ref, leaves[:n], d)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=TOL["float32"] * b.abs().max().item())


def test_cast_order_differs_from_the_model_norm():
    # the fused norm casts once after the fp32 affine; the model norm casts
    # the normalised x to bf16 before the scale multiply, so in bf16 they
    # disagree on many elements while the fused one matches Pallas
    x, _, scale, _, _, _ = _inputs("bf16_3d_h256")
    tx, ts = _t(x, "bfloat16"), _t(scale, "bfloat16")
    fused = fn.fused_rmsnorm(tx, ts, EPS).float().numpy()
    model = tnorms.rmsnorm({"scale": ts}, tx, EPS).float().numpy()
    want = np.asarray(pallas_rmsnorm(_j(x, "bfloat16"), _j(scale, "bfloat16"),
                                     EPS, True).astype(jnp.float32))
    _mostly_equal(fused, want, "fused")
    assert np.mean(model != want) > 10 * MISMATCH_SHARE


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA build")
    monkeypatch.setattr(cuda_build, "build", refuse)
    monkeypatch.setattr(cuda_build, "library", refuse)
    for name in ("rms_fwd_cuda", "rms_bwd_cuda", "ln_fwd_cuda",
                 "ln_bwd_cuda"):
        monkeypatch.setattr(fused_norms_cuda, name, refuse)
    x, dy, scale, bias, _, _ = _inputs("fp32_2d_h64")
    tx = torch.tensor(x, requires_grad=True)
    ts = torch.tensor(scale, requires_grad=True)
    tb = torch.tensor(bias, requires_grad=True)
    (fn.fused_rmsnorm(tx, ts) * torch.from_numpy(dy)).sum().backward()
    (fn.fused_layernorm(tx, ts, tb) * torch.from_numpy(dy)).sum().backward()
    assert tx.grad is not None and tb.grad is not None


@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_autograd_casts_the_summed_params_once(kind, monkeypatch):
    # the backward takes the [1, h] fp32 sums as they come and casts them
    # once to the scale's dtype: no further reduction
    x, dy, scale, bias, _, _ = _inputs("bf16_x_fp32_params_h192")
    h = x.shape[-1]
    sums = [torch.from_numpy(np.random.RandomState(3 + i).randn(1, h)
                             .astype(np.float32)) for i in range(2)]
    rows = int(np.prod(x.shape[:-1]))

    def fake(xr, s, d, eps):
        assert xr.shape == (rows, h) and d.shape == (rows, h)
        return (torch.zeros_like(xr), *sums[:2 if kind == "ln" else 1])
    monkeypatch.setitem(fn._CPU, f"{kind}_bwd", fake)
    for pd in ("bfloat16", "float32"):
        tx, ts, tb = (_t(x, "bfloat16", True), _t(scale, pd, True),
                      _t(bias, pd, True))
        out = (fn.fused_layernorm(tx, ts, tb, EPS) if kind == "ln"
               else fn.fused_rmsnorm(tx, ts, EPS))
        out.backward(torch.from_numpy(dy).to(torch.bfloat16))
        grads = [ts.grad, tb.grad] if kind == "ln" else [ts.grad]
        for got, want in zip(grads, sums):
            assert got.dtype == ts.dtype and got.shape == (h,)
            assert torch.equal(got, want[0].to(ts.dtype))


def _norm_case_shapes():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return [(int(np.prod(shape[:-1])), shape[-1], 2 if xd == "bfloat16" else 4)
            for _, shape, xd, _, _ in smoke.NORM_CASES]


PLAN_SHAPES = [(rows, h, item) for rows in (4096,) for h in (4096, 4544,
                                                             5120, 8192)
               for item in (2, 4)]
# rows past 16 values a thread: fp32 and bf16 just past 8192, GPT-3 175B's
# 12288, the widest row the forward takes at 2 bytes (116,224), and rows of
# 4097 and 4100 scalar values
WIDE_SHAPES = [(16, 8196, 4), (16, 8200, 2), (2048, 12288, 2),
               (2048, 12288, 4), (4, 116224, 2), (65, 4097, 2),
               (65, 4100, 2)]


def _check_plan(plan, rows, h, item, sms):
    what = f"rows {rows} h {h} itemsize {item}: {plan}"
    # sm_90's shared memory: a block's opt-in maximum, and an SM's whole
    # with the runtime's 1 KB a resident block
    assert plan.smem <= 232448, what
    assert plan.blocks == sms * plan.resident, what
    assert plan.resident * (plan.smem + 1024) <= 233472, what
    assert plan.rows_per_block * plan.wpr == plan.threads // 32
    # 16 warps an SM: two blocks of 8, or one of 16
    assert plan.resident * plan.threads == 512, what
    cols = [c for t in range(32 * plan.wpr) for c in plan.columns(t)]
    assert sorted(cols) == list(range(h)), what
    if plan.wide:
        # one row a block of 16 warps, nothing in shared memory
        assert plan.wpr == 16 and plan.smem == 0 and plan.in_flight == 0
        # over 8 chunks or 16 values a thread
        assert plan.chunks > 8 or plan.chunks * plan.values > 16, what
        return
    assert plan.chunks in (2, 4, 8), what
    assert plan.chunks * plan.values <= 16, what
    # the ring holds each slot's row in use and its next one; the column
    # sums reuse its shared memory
    stage = plan.rows_per_block * 2 * h * item if plan.vec else 0
    assert plan.smem == max(2 * stage, 2 * plan.rows_per_block * h * 4)
    assert plan.in_flight == stage * plan.resident, what
    if h >= 2048:
        # every SM has the next row of each of its slots in flight: 32 KB
        # at the power-of-two widths, one row's x and dy at least
        assert plan.vec and plan.in_flight >= max(
            2 * h * item, 16 * 1024), what
        if h & (h - 1) == 0:
            assert plan.in_flight >= 32 * 1024, what


@pytest.mark.parametrize("which", ["norm_cases", "wide_rows"])
def test_bwd_plan_fits_the_card_and_owns_every_column(which):
    shapes = _norm_case_shapes() if which == "norm_cases" else PLAN_SHAPES
    assert shapes
    for rows, h, item in shapes:
        for sms in (132, 114):
            plan = fused_norms_cuda.bwd_plan(rows, h, item, sms)
            # the rows kernel takes 8192 values a row, 4096 scalar ones
            assert plan.wide == (h > (8192 if plan.vec else 4096)), plan
            _check_plan(plan, rows, h, item, sms)


def test_bwd_plan_takes_rows_of_any_width():
    # the forward takes rows up to a block's shared memory; the backward
    # takes those and wider ones (the wide kernel), aligned or not
    for rows, h, item in WIDE_SHAPES:
        for aligned in (True, False):
            plan = fused_norms_cuda.bwd_plan(rows, h, item, 132,
                                             aligned=aligned)
            assert plan.wide, plan
            assert plan.vec == (aligned and h * item % 16 == 0), plan
            _check_plan(plan, rows, h, item, 132)
    assert fused_norms_cuda.warps_per_row(116224, 2) == 8  # forward's limit
    assert not fused_norms_cuda.bwd_plan(8, 8192, 2, 132).wide
    assert not fused_norms_cuda.bwd_plan(8, 4096, 2, 132,
                                         aligned=False).wide


def test_bwd_plan_refuses_rows_it_cannot_take():
    plan = fused_norms_cuda.bwd_plan(100, 100, 2, 132)  # 200-byte rows
    assert not plan.vec and plan.values == 1
    assert not fused_norms_cuda.bwd_plan(8, 2048, 2, 132,
                                         aligned=False).vec
    for rows, h, item, sms in ((0, 4096, 2, 132), (8, 0, 2, 132),
                               (8, 4096, 3, 132), (8, 4096, 2, 0)):
        with pytest.raises(ValueError, match="bwd_plan"):
            fused_norms_cuda.bwd_plan(rows, h, item, sms)


def test_norm_bwd_profile_needs_the_card(monkeypatch, capsys):
    from megatron_tpu_torch.tools import norm_bwd_profile
    assert [s[0] for s in norm_bwd_profile.SHAPES][0] == "bench_4x2048x2048"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert norm_bwd_profile.main([]) == 2
    assert "needs a CUDA device" in capsys.readouterr().err


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fused_norms_cuda.rms_fwd_cuda(x, torch.ones(64), EPS)
    assert fused_norms_cuda.warps_per_row(4096, 2) == 8
    assert fused_norms_cuda.warps_per_row(64, 2) == 1


def _check_fwd_plan(plan, rows, h, item, sms):
    what = f"rows {rows} h {h} itemsize {item}: {plan}"
    cols = [c for t in range(32 * plan.wpr) for c in plan.columns(t)]
    assert sorted(cols) == list(range(h)), what
    assert plan.smem <= 232448, what
    if plan.wide:
        # the wide kernel: 8 // wpr rows a block of 8 warps, each row in
        # shared memory, one block a row group (not persistent)
        assert plan.wpr == fused_norms_cuda.warps_per_row(h, item), what
        assert plan.threads == 256 and plan.resident == 0, what
        assert plan.rows_per_block * plan.wpr == 8, what
        assert plan.blocks == -(-rows // plan.rows_per_block), what
        assert plan.smem == plan.rows_per_block * h * item, what
        assert plan.in_flight == 0, what
        return
    # the rows kernel: the backward's layout, a persistent grid of 16 warps
    # an SM, the ring holding x alone (RING rows a slot)
    bwd = fused_norms_cuda.bwd_plan(rows, h, item, sms,
                                    aligned=plan.vec)
    assert (plan.vec, plan.values, plan.wpr, plan.chunks, plan.threads,
            plan.rows_per_block, plan.resident, plan.blocks) == (
        bwd.vec, bwd.values, bwd.wpr, bwd.chunks, bwd.threads,
        bwd.rows_per_block, bwd.resident, bwd.blocks), what
    assert plan.chunks in (2, 4, 8) and plan.chunks * plan.values <= 16
    assert plan.blocks == sms * plan.resident, what
    assert plan.resident * (plan.smem + 1024) <= 233472, what
    assert plan.resident * plan.threads == 512, what
    stage = plan.rows_per_block * h * item if plan.vec else 0
    assert plan.smem == 2 * stage, what
    # the next two rows of every slot in flight while one is reduced
    assert plan.in_flight == 2 * stage * plan.resident, what
    if h >= 2048:
        # two rows of x an SM at least; 32 KB at the power-of-two widths
        assert plan.vec and plan.in_flight >= 2 * h * item, what
        if h & (h - 1) == 0:
            assert plan.in_flight >= 32 * 1024, what


@pytest.mark.parametrize("which", ["norm_cases", "wide_rows"])
def test_fwd_plan_fits_the_card_and_owns_every_column(which):
    shapes = _norm_case_shapes() if which == "norm_cases" else PLAN_SHAPES
    assert shapes
    for rows, h, item in shapes:
        for sms in (132, 114):
            plan = fused_norms_cuda.fwd_plan(rows, h, item, sms)
            # the rows kernel takes 8192 values a row, 4096 scalar ones
            assert plan.wide == (h > (8192 if plan.vec else 4096)), plan
            _check_fwd_plan(plan, rows, h, item, sms)


def test_fwd_plan_takes_the_rows_the_forward_took():
    # rows past the registers take the wide kernel, up to a block's shared
    # memory: 116,224 values at 2 bytes, one row of 8 warps a block
    for rows, h, item in WIDE_SHAPES:
        for aligned in (True, False):
            plan = fused_norms_cuda.fwd_plan(rows, h, item, 132,
                                             aligned=aligned)
            assert plan.wide, plan
            assert plan.vec == (aligned and h * item % 16 == 0), plan
            _check_fwd_plan(plan, rows, h, item, 132)
    widest = fused_norms_cuda.fwd_plan(4, 116224, 2, 132)
    assert widest.wpr == 8 and widest.smem == 232448
    assert fused_norms_cuda.fwd_plan(4, 116232, 2, 132).smem > 232448
    assert not fused_norms_cuda.fwd_plan(8, 8192, 2, 132).wide
    assert not fused_norms_cuda.fwd_plan(8, 4096, 2, 132,
                                         aligned=False).wide


def test_fwd_plan_refuses_rows_it_cannot_take():
    plan = fused_norms_cuda.fwd_plan(100, 100, 2, 132)  # 200-byte rows
    assert not plan.vec and plan.values == 1 and plan.smem == 0
    assert not fused_norms_cuda.fwd_plan(8, 2048, 2, 132,
                                         aligned=False).vec
    for rows, h, item, sms in ((0, 4096, 2, 132), (8, 0, 2, 132),
                               (8, 4096, 3, 132), (8, 4096, 2, 0)):
        with pytest.raises(ValueError, match="fwd_plan"):
            fused_norms_cuda.fwd_plan(rows, h, item, sms)
