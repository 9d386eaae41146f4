"""Feed-forward / GLU-family MLP (megatron_tpu/models/mlp.py).

GLU variants keep the reference's single h -> [2, ffn] projection with the
gate at index 0 and the value at index 1.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.ops.quantized import qdense, wcast


def activation_fn(name: str, a: torch.Tensor, b=None) -> torch.Tensor:
    """GLU variants take the (gate, value) pair: act(a) * b. gelu is the
    exact erf form."""
    if name == "gelu":
        return F.gelu(a)
    if name == "relu":
        return F.relu(a)
    if name == "squared_relu":
        r = F.relu(a)
        return r * r
    if name == "swiglu":
        return F.silu(a) * b
    if name == "geglu":
        return F.gelu(a) * b
    if name == "reglu":
        return F.relu(a) * b
    if name == "liglu":
        return a * b
    raise ValueError(f"unknown activation {name}")


def mlp_init(cfg: ModelConfig) -> dict:
    """Parameter specs (mlp.py mlp_init): name -> (shape, init)."""
    h, ffn, std = cfg.hidden_size, cfg.ffn_hidden_size, cfg.init_method_std
    out_std = (std / math.sqrt(2.0 * cfg.num_layers) if cfg.use_scaled_init
               else std)
    w1_shape = (h, 2, ffn) if cfg.is_glu else (h, ffn)
    specs = {"w1": (w1_shape, ("normal", std)),
             "w2": ((ffn, h), ("normal", out_std))}
    if cfg.use_bias:
        specs["b1"] = (w1_shape[1:], ("fill", 0.0))
        specs["b2"] = ((h,), ("fill", 0.0))
    return specs


def mlp_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: [b, s, h] -> [b, s, h]."""
    dtype = x.dtype
    y = qdense(x, wcast(params["w1"], dtype), cfg.quantized_gemm)
    if cfg.use_bias:
        y = y + params["b1"].to(dtype)
    if cfg.is_glu:
        y = activation_fn(cfg.activation, y[:, :, 0], y[:, :, 1])
    else:
        y = activation_fn(cfg.activation, y)
    y = qdense(y, wcast(params["w2"], dtype), cfg.quantized_gemm)
    if cfg.use_bias:
        y = y + params["b2"].to(dtype)
    return y
