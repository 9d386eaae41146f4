"""Mixture-of-Experts MLP (megatron_tpu/models/moe.py), on one device.

Every MLP of a model with `num_experts > 1` becomes a top-k-routed bank of
experts:

- router: logits = x @ router in the compute dtype, softmax in fp32, the
  top k of a stable descending sort (ties go to the lower expert index, as
  `jax.lax.top_k` orders them; `torch.topk` promises no order on ties, and
  bf16 logits tie at real widths), gates renormalized by max(sum, 1e-9);
- capacity C = ceil(top_k * s * capacity_factor / E) slots an expert and
  batch row; the k = 0 choices fill slots first, then k = 1, ...; within a
  round earlier positions win; the rest drop (Switch semantics). Mixtral's
  preset sets capacity_factor = E / K, so C = s and nothing drops;
- the Switch load-balancing loss E * sum_e f_e * P_e on the top-1
  assignment before drops, in fp32; `loss_fn` adds
  cfg.moe_aux_loss_coeff times its sum over layers.

Two dispatches with the same routing, as in the reference: "sort" (the
default) orders the (token, k) choices by expert with a stable argsort,
takes each one's slot as its rank minus its expert's segment start, moves
the tokens into the [E, b, C, h] blocks with one accumulating index_put
(dropped choices write exact zeros into slot C-1) and back with one
gather; "dense" builds the [b, s, E, C] one-hot dispatch and combine
tensors (`moe_dispatch`) and contracts against them, the oracle.

The blocks are laid out expert-first, so the two bank products are
`torch.bmm` over views, [E, b*C, h] x [E, h, 2*ffn] and [E, b*C, ffn] x
[E, ffn, h]: no product copies the bank. Like the reference's einsums
outside any Pallas kernel they are library GEMMs (cuBLAS on the card).
With `quantized_gemm == "int8"` both run through
`ops.quantized.int8_expert_matmul`. Expert parallelism (`moe_axes`) is
the multi-device slice's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.models.mlp import activation_fn
from megatron_tpu_torch.ops.quantized import int8_expert_matmul


def moe_capacity(cfg: ModelConfig, seq: int) -> int:
    return int(math.ceil(cfg.moe_top_k * seq * cfg.moe_capacity_factor
                         / cfg.num_experts))


def moe_init(cfg: ModelConfig) -> dict:
    """Parameter specs (moe.py moe_init): router [h, E], w1 [E, h, 2, ffn]
    (GLU) or [E, h, ffn], w2 [E, ffn, h], and b1/b2 with `use_bias`."""
    E, h, ffn = cfg.num_experts, cfg.hidden_size, cfg.ffn_hidden_size
    std = cfg.init_method_std
    out_std = (std / math.sqrt(2.0 * cfg.num_layers) if cfg.use_scaled_init
               else std)
    w1_shape = (E, h, 2, ffn) if cfg.is_glu else (E, h, ffn)
    specs = {"router": ((h, E), ("normal", std)),
             "w1": (w1_shape, ("normal", std)),
             "w2": ((E, ffn, h), ("normal", out_std))}
    if cfg.use_bias:
        specs["b1"] = ((E, 2, ffn) if cfg.is_glu else (E, ffn),
                       ("fill", 0.0))
        specs["b2"] = ((E, h), ("fill", 0.0))
    return specs


def route(x: torch.Tensor, router: torch.Tensor, K: int):
    """(probs [b, s, E] fp32, gates [b, s, K] renormalized, idx [b, s, K])
    of the top K experts a token, ties to the lower index."""
    logits = x @ router.to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[..., :K], order[..., :K]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, idx


def moe_dispatch(idx: torch.Tensor, gates: torch.Tensor, E: int, C: int):
    """The dispatch and combine tensors [b, s, E, C] of a top-k routing:
    each (token, k) choice takes the next free slot of its expert (a
    sequence cumsum offset by the earlier rounds' counts); a choice past
    capacity drops (its row all zero)."""
    slots = torch.arange(C, device=idx.device)
    dispatch = combine = count = 0.0
    for k in range(idx.shape[-1]):
        onek = F.one_hot(idx[..., k], E).float()
        pos = (torch.cumsum(onek, dim=1) - onek) + count
        keep = (pos < C).float() * onek                       # [b, s, E]
        slot = ((pos.long()[..., None] == slots).float()
                * keep[..., None])
        dispatch = dispatch + slot
        combine = combine + slot * gates[..., k][:, :, None, None]
        count = count + onek.sum(dim=1)[:, None, :]
    return dispatch, combine


def _sort_route(idx: torch.Tensor, gates: torch.Tensor, E: int, C: int):
    """Per-row routing by stable sort. idx/gates [b, s, K] -> entry arrays
    [b, K*s] in k-major order (every k = 0 choice first, then sequence
    order): (expert, token, gate, slot, keep). Slot = the entry's rank
    among its row's entries of the same expert: sorted rank minus the
    expert's segment start, scattered back to entry order."""
    b, s, K = idx.shape
    n = K * s
    e = idx.transpose(1, 2).reshape(b, n)
    g = gates.transpose(1, 2).reshape(b, n)
    tok = torch.arange(s, device=idx.device).repeat(K)
    order = torch.argsort(e, dim=-1, stable=True)
    e_sorted = torch.gather(e, 1, order)
    counts = torch.zeros(b, E, dtype=torch.long, device=idx.device)
    counts.scatter_add_(1, e_sorted, torch.ones_like(e_sorted))
    seg_start = torch.cumsum(counts, dim=1) - counts
    pos_sorted = (torch.arange(n, device=idx.device)
                  - torch.gather(seg_start, 1, e_sorted))
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    return e, tok, g, pos, pos < C


def _bank(x: torch.Tensor, w, quantized_gemm: str) -> torch.Tensor:
    """x [E, rows, K] against w [E, K, N] (or with trailing structure after
    K, flattened) -> [E, rows, N...]."""
    wf = w.reshape(w.shape[0], w.shape[1], -1)
    if quantized_gemm == "int8":
        y = int8_expert_matmul(x, wf)
    else:
        y = torch.bmm(x, wf)
    return y.reshape(*y.shape[:-1], *w.shape[2:])


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig):
    """x [b, s, h] -> (y [b, s, h], aux loss, a 0-d fp32 tensor)."""
    b, s, h = x.shape
    E, K = cfg.num_experts, cfg.moe_top_k
    C = moe_capacity(cfg, s)
    dtype = x.dtype
    probs, gates, idx = route(x, params["router"], K)

    top1 = F.one_hot(idx[..., 0], E).float()
    aux = E * (top1.mean(dim=(0, 1)) * probs.mean(dim=(0, 1))).sum()

    if cfg.moe_dispatch == "dense":
        dispatch, combine = moe_dispatch(idx, gates, E, C)
        xin = torch.einsum("bsec,bsh->ebch", dispatch.to(dtype), x)
    else:
        e, tok, g, pos, keep = _sort_route(idx, gates, E, C)
        pos_c = torch.clamp(pos, max=C - 1)   # dropped entries write 0s
        brow = torch.arange(b, device=x.device)[:, None].expand_as(e)
        contrib = x[brow, tok] * keep[..., None].to(dtype)     # [b, KS, h]
        xin = torch.zeros(E, b, C, h, dtype=dtype, device=x.device)
        xin.index_put_((e, brow, pos_c), contrib, accumulate=True)
    xin = xin.reshape(E, b * C, h)
    q = cfg.quantized_gemm
    y1 = _bank(xin, params["w1"].to(dtype), q)
    if cfg.use_bias:
        y1 = y1 + params["b1"].to(dtype)[:, None]
    if cfg.is_glu:
        act = activation_fn(cfg.activation, y1[..., 0, :], y1[..., 1, :])
    else:
        act = activation_fn(cfg.activation, y1)
    y2 = _bank(act, params["w2"].to(dtype), q)
    if cfg.use_bias:
        # dropped (not duplicated) tokens never see the expert's bias
        y2 = y2 + params["b2"].to(dtype)[:, None]
    y2 = y2.reshape(E, b, C, h)
    if cfg.moe_dispatch == "dense":
        y = torch.einsum("ebch,bsec->bsh", y2, combine.to(dtype))
    else:
        out = y2[e, brow, pos_c]                              # [b, KS, h]
        w = (g * keep).to(dtype)
        y = (out * w[..., None]).reshape(b, K, s, h).sum(dim=1)
    return y, aux
