"""Mixture-of-Experts MLP (megatron_tpu/models/moe.py), on one device or
with its experts sharded over a mesh.

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
`ops.quantized.int8_expert_matmul`.

Under a mesh (`moe_apply(..., mesh=)`, the sharded training step) the bank
is cut on its experts dim over `expert_axis` (`moe_axes`, the reference's
rule), and a rank routes whole rows: the sequence is gathered over cp and,
under sequence parallelism, over tp, since capacity is counted and slots
fill along the whole row. Then:

- expert_axis "tp": every tp rank routes the same tokens and runs its
  E/tp experts on them; the combine is a partial sum over the experts,
  reduce-scattered along the sequence under sequence parallelism and
  all-reduced without it. The router's grads are partial over tp;
- expert_axis "dp": each dp rank routes its own rows into [E, b, C, h]
  blocks, an all-to-all over dp sends each expert's blocks to the rank
  that holds it, and the inverse all-to-all brings the outputs back. Its
  bank's grads are whole on their rank and are not reduced over dp.

The aux loss is the whole step's: the token fractions f_e and mean
probabilities P_e are summed over dp (`collectives.sum_axis`) before
their product, and each rank returns its share, aux / (dp x cp), since
the step sums the ranks' losses over dp and cp. Where tp ranks compute the
same aux and their grads are summed over tp, its grad is divided by tp.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.models.mlp import activation_fn
from megatron_tpu_torch.ops.quantized import int8_expert_matmul
from megatron_tpu_torch.parallel import collectives
from megatron_tpu_torch.parallel.mesh import (CONTEXT_AXIS, DATA_AXIS,
                                              TENSOR_AXIS)


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


def moe_axes(cfg: ModelConfig) -> dict:
    """Logical axes of the bank (moe.py moe_axes): the experts dim on the
    expert axis, the ffn dim whole, so one expert's products run whole on
    its rank."""
    axes = {"router": ("embed", None),
            "w1": (("experts", "embed", None, None) if cfg.is_glu
                   else ("experts", "embed", None)),
            "w2": ("experts", None, "embed")}
    if cfg.use_bias:
        axes["b1"] = (("experts", None, None) if cfg.is_glu
                      else ("experts", None))
        axes["b2"] = ("experts", None)
    return axes


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


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor, E: int, mesh):
    """E * sum_e f_e * P_e over the whole step's tokens; under a mesh this
    rank's share (see the module's note)."""
    top1 = F.one_hot(idx[..., 0], E).float()
    if mesh is None:
        return E * (top1.mean(dim=(0, 1)) * probs.mean(dim=(0, 1))).sum()
    n = probs.shape[0] * probs.shape[1] * mesh.shape[DATA_AXIS]
    f_e = collectives.all_reduce(top1.sum(dim=(0, 1)), mesh, DATA_AXIS) / n
    p_e = collectives.sum_axis(probs.sum(dim=(0, 1)), mesh, DATA_AXIS) / n
    share = E * (f_e * p_e).sum() / (mesh.shape[DATA_AXIS]
                                     * mesh.shape[CONTEXT_AXIS])
    tp = mesh.shape[TENSOR_AXIS]
    if tp > 1 and (mesh.parallel.expert_axis == "tp"
                   or mesh.sequence_parallel):
        share = collectives.scale_grad(share, 1.0 / tp)
    return share


def _experts(params, xin: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The bank's products on expert-first blocks [E, rows, h]."""
    dtype = xin.dtype
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
    return y2


def _whole_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """A rank's residual-stream part -> the whole rows it routes (see the
    module's note)."""
    if mesh.parallel.expert_axis == "tp":
        x = collectives.tp_region_in(x, mesh)
    elif mesh.sequence_parallel:
        x = collectives.gather_axis(x, mesh, TENSOR_AXIS, 1)
    return collectives.gather_axis(x, mesh, CONTEXT_AXIS, 1)


def _rank_part(y: torch.Tensor, mesh) -> torch.Tensor:
    """The whole rows' output -> this rank's residual-stream part."""
    cp = mesh.shape[CONTEXT_AXIS]
    if cp > 1:
        per = y.shape[1] // cp
        c = mesh.coords[CONTEXT_AXIS]
        y = y[:, c * per:(c + 1) * per]
    if mesh.parallel.expert_axis == "tp":
        return collectives.tp_region_out(y, mesh)
    if mesh.sequence_parallel:
        per = y.shape[1] // mesh.shape[TENSOR_AXIS]
        t = mesh.coords[TENSOR_AXIS]
        y = y[:, t * per:(t + 1) * per]
    return y


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig, mesh=None):
    """x [b, s, h] -> (y [b, s, h], aux loss, a 0-d fp32 tensor). Under a
    `mesh` x is this rank's residual-stream part, the bank its experts, and
    aux its share (see the module's note)."""
    if mesh is not None:
        x = _whole_rows(x, mesh)
    b, s, h = x.shape
    E, K = cfg.num_experts, cfg.moe_top_k
    C = moe_capacity(cfg, s)
    dtype = x.dtype
    probs, gates, idx = route(x, params["router"], K)
    aux = _aux_loss(probs, idx, E, mesh)

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
    if mesh is None:
        y2 = _experts(params, xin.reshape(E, b * C, h), cfg)
    elif mesh.parallel.expert_axis == "tp":
        # this rank's experts; the others' blocks contribute zeros
        n = E // mesh.shape[TENSOR_AXIS]
        lo = mesh.coords[TENSOR_AXIS] * n
        mine = _experts(params, xin[lo:lo + n].reshape(n, b * C, h), cfg)
        y2 = torch.zeros(E, b * C, h, dtype=dtype, device=x.device)
        y2 = y2.index_copy(0, torch.arange(lo, lo + n, device=x.device),
                           mine)
    else:
        # each expert's blocks to the dp rank that holds it, and back
        dp = mesh.shape[DATA_AXIS]
        blocks = collectives.all_to_all_axis(xin, mesh, DATA_AXIS, 0, 1)
        out = _experts(params, blocks.reshape(E // dp, dp * b * C, h), cfg)
        y2 = collectives.all_to_all_axis(
            out.reshape(E // dp, dp * b, C, h), mesh, DATA_AXIS, 1, 0)
    y2 = y2.reshape(E, b, C, h)
    if cfg.moe_dispatch == "dense":
        y = torch.einsum("ebch,bsec->bsh", y2, combine.to(dtype))
    else:
        out = y2[e, brow, pos_c]                              # [b, KS, h]
        w = (g * keep).to(dtype)
        y = (out * w[..., None]).reshape(b, K, s, h).sum(dim=1)
    if mesh is not None:
        y = _rank_part(y, mesh)
    return y, aux
