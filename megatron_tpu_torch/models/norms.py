"""RMSNorm / LayerNorm with fp32 statistics (megatron_tpu/models/norms.py).

The cast order is the reference's: statistics and normalisation in fp32,
cast back to the input dtype, then the affine parameters in that dtype.
"""
from __future__ import annotations

import torch


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return xf.to(dtype) * params["scale"].to(dtype)


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf.to(dtype) * params["scale"].to(dtype)
            + params["bias"].to(dtype))


def norm_init(norm_type: str, hidden_size: int) -> dict:
    """Parameter specs of one norm (norms.py norm_init): name -> (shape,
    init), see language_model.LanguageModel for the init kinds."""
    if norm_type == "rmsnorm":
        return {"scale": ((hidden_size,), ("fill", 1.0))}
    if norm_type == "layernorm":
        return {"scale": ((hidden_size,), ("fill", 1.0)),
                "bias": ((hidden_size,), ("fill", 0.0))}
    raise ValueError(norm_type)


def apply_norm(norm_type: str, params, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    if norm_type == "rmsnorm":
        return rmsnorm(params, x, eps)
    if norm_type == "layernorm":
        return layernorm(params, x, eps)
    raise ValueError(norm_type)
