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
# multiple of 8 divides, h 64-256
CASES = {
    "fp32_2d_h64": ((13, 64), "float32", "float32"),
    "fp32_3d_h256": ((3, 7, 256), "float32", "float32"),
    "bf16_2d_h128": ((37, 128), "bfloat16", "bfloat16"),
    "bf16_3d_h256": ((2, 45, 256), "bfloat16", "bfloat16"),
    "bf16_x_fp32_params_h192": ((5, 9, 192), "bfloat16", "float32"),
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


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fused_norms_cuda.rms_fwd_cuda(x, torch.ones(64), EPS)
    assert fused_norms_cuda.warps_per_row(4096, 2) == 8
    assert fused_norms_cuda.warps_per_row(64, 2) == 1
