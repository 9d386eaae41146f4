"""Fused RMSNorm and LayerNorm, forward and backward
(megatron_tpu/ops/fused_norms.py `pallas_rmsnorm` / `pallas_layernorm`).

`fused_rmsnorm(x, scale, eps)` and `fused_layernorm(x, scale, bias, eps)`
are `torch.autograd.Function`s over rows [rows, h] (x of any leading
shape). Each dispatches on where x lies:

- a CUDA tensor goes to the hand-written Hopper kernels of
  csrc/fused_norms.cu (ops/fused_norms_cuda.py). They launch or raise;
- a CPU tensor goes to the plain versions below, which compute the Pallas
  kernels' formulas and are what the kernels are held against on the card.

Statistics and the affine run in fp32 and the result is cast once to x's
dtype: (x * r * scale_f32).astype(dtype), as the Pallas kernels do. This
differs from the model norm (models/norms.py), which casts the normalised
x to the input dtype before it multiplies by the scale. The backward
recomputes the row statistics from x and gives dx in x's dtype and fp32
[1, h] sums of dscale (and dbias) over every row: the kernels sum them
inside their launches, the plain versions as one tile. The Function casts
them once to the scale's dtype, as `_rms_bwd` and `_ln_bwd` cast their
summed partials.

The models use models/norms.py, as the reference's models use its jnp
norms; these are the explicit fused path that tools/bench_kernels.py times.
"""
from __future__ import annotations

import torch

from megatron_tpu_torch.ops import fused_norms_cuda as fnc


def rms_fwd_reference(x: torch.Tensor, scale: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """Plain `_rms_fwd_kernel` over rows x [rows, h]."""
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * r * scale.float()).to(x.dtype)


def rms_bwd_reference(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                      eps: float):
    """Plain `_rms_bwd_kernel`: (dx in x's dtype, dscale [1, h] fp32, the
    whole of x as one tile)."""
    xf, dyf = x.float(), dy.float()
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    xh = xf * r
    g = dyf * scale.float()
    c = (g * xh).mean(-1, keepdim=True)
    return (r * (g - xh * c)).to(x.dtype), (dyf * xh).sum(0, keepdim=True)


def ln_fwd_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """Plain `_ln_fwd_kernel` over rows x [rows, h]."""
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    r = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    return (xc * r * scale.float() + bias.float()).to(x.dtype)


def ln_bwd_reference(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                     eps: float):
    """Plain `_ln_bwd_kernel`: (dx, dscale [1, h], dbias [1, h])."""
    xf, dyf = x.float(), dy.float()
    xc = xf - xf.mean(-1, keepdim=True)
    r = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xh = xc * r
    g = dyf * scale.float()
    gm = g.mean(-1, keepdim=True)
    c = (g * xh).mean(-1, keepdim=True)
    dx = (r * (g - gm - xh * c)).to(x.dtype)
    return dx, (dyf * xh).sum(0, keepdim=True), dyf.sum(0, keepdim=True)


_CPU = {"rms_fwd": rms_fwd_reference, "rms_bwd": rms_bwd_reference,
        "ln_fwd": ln_fwd_reference, "ln_bwd": ln_bwd_reference}


def _impl(x: torch.Tensor, name: str):
    """The kernel wrapper for a CUDA tensor, the plain version for a CPU
    one; no fallback between them."""
    if x.is_cuda:
        return getattr(fnc, name + "_cuda")
    if x.device.type == "cpu":
        return _CPU[name]
    raise ValueError(f"fused norms: no kernel for device {x.device}")


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1]).contiguous()


def param_grad(total: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A backward's fp32 [1, h] sum as the parameter's grad [h] in its
    dtype: one cast, no reduction."""
    return total.reshape(-1).to(dtype)


class _FusedRMSNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _impl(x, "rms_fwd")(_rows(x), scale.contiguous(),
                                   eps).reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, ds = _impl(x, "rms_bwd")(
            _rows(x), scale.contiguous(), _rows(dy.to(x.dtype)), ctx.eps)
        return dx.reshape(x.shape), param_grad(ds, scale.dtype), None


class _FusedLayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _impl(x, "ln_fwd")(_rows(x), scale.contiguous(),
                                  bias.contiguous(), eps).reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, ds, db = _impl(x, "ln_bwd")(
            _rows(x), scale.contiguous(), _rows(dy.to(x.dtype)), ctx.eps)
        return (dx.reshape(x.shape), param_grad(ds, scale.dtype),
                param_grad(db, scale.dtype), None)


def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """x [..., h] * rsqrt(mean(x^2, -1) + eps) * scale, fused; fp32
    statistics and affine, one cast to x's dtype."""
    return _FusedRMSNorm.apply(x, scale, float(eps))


def fused_layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Affine LayerNorm of x [..., h] with fp32 statistics, fused. The bias
    grad is cast to the scale's dtype, as the reference casts it."""
    return _FusedLayerNorm.apply(x, scale, bias, float(eps))
