"""Logical-axis sharding rules, and the leaves of a sharded model
(megatron_tpu/parallel/sharding.py).

The reference names every parameter's dims with logical axes ("heads",
"mlp", "vocab", ...) and maps them to mesh axes through one rules table;
GSPMD then places each leaf and inserts the collectives. The port keeps
the table (`make_logical_rules`, `logical_to_spec`) and places the leaves
itself: each rank holds its coordinate's part of every dim that the rules
map to tp (`shard_leaf`), and `gather_leaf` puts the parts back together.
The collectives are written by hand (parallel/collectives.py and the model
code), as upstream Megatron's ColumnParallelLinear, RowParallelLinear and
VocabParallelEmbedding write them.

Two layouts are not a plain cut of a dim:
- the fused kv projection's "kv_heads" dim is [2, nkv, hd] (k heads, then
  v heads; attention reshapes it so): a rank takes its kv heads of both
  halves, on the nkv dim of that view;
- with fewer kv heads than tp ranks (MQA, Falcon-7B) the kv leaves are
  replicated and each rank picks the kv head of its q heads
  (models/attention.py); their grads are partial sums over tp.

With `expert_axis="dp"` the rules map a bank's "experts" dim to dp: a
rank holds its dp coordinate's experts, and `shard_leaf`/`gather_leaf` cut
and join that dim over dp as the others over tp. Every leaf is whole over
cp, whose ranks hold the same weights.

Under pipeline parallelism the rules map a stacked leaf's "layers" dim to
pp: a rank holds its stage's layers (`stage_layers`), contiguous for one
virtual chunk and in the interleaved order for vpp > 1 (chunk c of stage
s holds layers (c*pp + s)*Lc onwards, the reference's
`stage_params_chunked`), and `gather_leaf` puts them back in layer order.

`distributed_opt_dim` is the reference's ZeRO-1 dim rule
(`distributed_opt_sharding`): a leaf's fp32 moments are cut over dp on
its first dim that the rules leave unsharded and dp divides; a leaf
without one keeps them whole, and a leaf the rules already cut over dp
(an expert bank on dp) is left as it is. Under pp > 1 only the stacked
leaves are cut (the reference's `pipelined=True`).

`activation_region` places a rank's residual-stream activation in the
whole step's: its dp rows, and along the sequence its cp chunk (the zigzag
chunks when the batch was pre-permuted) and, under sequence parallelism,
its tp part of that.
"""
from __future__ import annotations

from typing import Optional

import torch

from megatron_tpu_torch.parallel import collectives
from megatron_tpu_torch.parallel.mesh import (CONTEXT_AXIS, DATA_AXIS,
                                              PIPELINE_AXIS, TENSOR_AXIS,
                                              Mesh)


def make_logical_rules(sequence_parallel: bool = False,
                       expert_axis: str = "tp"):
    """(logical name, mesh axis or None) pairs; first match wins. The
    reference's table."""
    if expert_axis not in ("tp", "dp"):
        raise ValueError(f"expert_axis={expert_axis!r}")
    return (
        ("batch", DATA_AXIS),
        ("layers", PIPELINE_AXIS),
        ("stage", PIPELINE_AXIS),
        ("microbatch", PIPELINE_AXIS),
        ("heads", TENSOR_AXIS),
        ("kv_heads", TENSOR_AXIS),
        ("mlp", TENSOR_AXIS),
        ("experts", DATA_AXIS if expert_axis == "dp" else TENSOR_AXIS),
        ("vocab", TENSOR_AXIS),
        ("seq", CONTEXT_AXIS),
        ("seq_sp", (CONTEXT_AXIS, TENSOR_AXIS) if sequence_parallel
         else CONTEXT_AXIS),
        ("embed", None),
        ("act_embed", None),
        ("head_dim", None),
        ("qkv", None),
    )


def logical_to_spec(logical_axes: tuple, rules) -> tuple:
    """A tuple of logical axis names -> the mesh axis of each dim (None for
    unsharded), trailing Nones trimmed, as the reference's PartitionSpec."""
    table = dict(rules)
    out = [None if name is None else table.get(name)
           for name in logical_axes]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _rules(mesh: Mesh):
    return make_logical_rules(mesh.parallel.sequence_parallel,
                              mesh.parallel.expert_axis)


def tp_dims(axes: tuple, mesh: Mesh) -> list:
    """The dims of a leaf that the rules cut over tp."""
    spec = logical_to_spec(axes, _rules(mesh))
    return [d for d, ax in enumerate(spec) if ax == TENSOR_AXIS]


def dp_dims(axes: tuple, mesh: Mesh) -> list:
    """The dims of a leaf that the rules cut over dp (an expert bank under
    expert_axis "dp"); none when dp is 1. The batch is the only other
    logical axis on dp, and no parameter has it."""
    if mesh.shape[DATA_AXIS] == 1:
        return []
    spec = logical_to_spec(axes, _rules(mesh))
    return [d for d, ax in enumerate(spec) if ax == DATA_AXIS]


def pp_dims(axes: tuple, mesh: Mesh) -> list:
    """The dims of a leaf that the rules cut over pp (a stacked leaf's
    layers); none when pp is 1."""
    if mesh.shape[PIPELINE_AXIS] == 1:
        return []
    spec = logical_to_spec(axes, _rules(mesh))
    return [d for d, ax in enumerate(spec) if ax == PIPELINE_AXIS]


def stage_layers(num_layers: int, pp: int, vpp: int, stage: int) -> list:
    """The layers `stage` holds, in its order: chunk by chunk, chunk c
    being layers (c*pp + stage)*Lc .. + Lc, Lc = L / (pp*vpp)."""
    if num_layers % (pp * vpp):
        raise ValueError(f"num_layers {num_layers} not divisible by "
                         f"pp*vpp {pp}x{vpp}")
    lc = num_layers // (pp * vpp)
    return [(c * pp + stage) * lc + i for c in range(vpp) for i in range(lc)]


def shard_pp(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This stage's layers of `t` along its layers `dim`."""
    rows = stage_layers(t.shape[dim], mesh.shape[PIPELINE_AXIS],
                        mesh.parallel.virtual_pipeline_chunks,
                        mesh.coords[PIPELINE_AXIS])
    return t.index_select(dim, torch.tensor(rows, device=t.device))


def gather_pp(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The whole layers dim in layer order from every stage's part."""
    pp = mesh.shape[PIPELINE_AXIS]
    whole = collectives.all_gather(t, mesh, PIPELINE_AXIS, dim)
    n = whole.shape[dim]
    order = [r for s in range(pp)
             for r in stage_layers(n, pp,
                                   mesh.parallel.virtual_pipeline_chunks, s)]
    inv = torch.empty(n, dtype=torch.long)
    inv[torch.tensor(order)] = torch.arange(n)
    return whole.index_select(dim, inv.to(whole.device))


def _kv_view(t: torch.Tensor, dim: int, kv_heads: int) -> torch.Tensor:
    """The fused kv dim of `t` viewed as [2, nkv, hd]."""
    return t.reshape(*t.shape[:dim], 2, kv_heads, -1, *t.shape[dim + 1:])


def kv_replicated(kv_heads: Optional[int], mesh: Mesh) -> bool:
    """Fewer kv heads than tp ranks: every rank holds them all."""
    if kv_heads is None:
        raise ValueError("a kv_heads dim needs the kv head count")
    return kv_heads % mesh.shape[TENSOR_AXIS] != 0


def cut_dims(axes: tuple, mesh: Mesh,
             kv_heads: Optional[int] = None) -> list:
    """The dims a rank holds a tp part of: the rules' tp dims but a
    replicated "kv_heads" dim; none when tp is 1."""
    if mesh.shape[TENSOR_AXIS] == 1:
        return []
    return [d for d in tp_dims(axes, mesh)
            if not (axes[d] == "kv_heads" and kv_replicated(kv_heads, mesh))]


def tp_sharded(axes: tuple, mesh: Mesh,
               kv_heads: Optional[int] = None) -> bool:
    """Whether the leaf is cut over tp on this mesh (a replicated kv leaf
    is not)."""
    return bool(cut_dims(axes, mesh, kv_heads))


def shard_leaf(full: torch.Tensor, axes: tuple, mesh: Mesh,
               kv_heads: Optional[int] = None) -> torch.Tensor:
    """This rank's part of a whole leaf: its stage's layers of a dim the
    rules map to pp, its tp coordinate's equal share of every dim they map
    to tp, and its dp coordinate's of a dim they map to dp. A "kv_heads" dim is cut on the nkv dim of its
    [2, nkv, hd] view (`kv_heads` = nkv), and left whole when tp does not
    divide nkv. Returns a contiguous tensor (the leaf itself where nothing
    is cut)."""
    tp, t = mesh.shape[TENSOR_AXIS], mesh.coords[TENSOR_AXIS]
    out = full
    for d in pp_dims(axes, mesh):
        out = shard_pp(out, d, mesh)
    for d in dp_dims(axes, mesh):
        out = shard_dp(out, d, mesh)
    for d in cut_dims(axes, mesh, kv_heads):
        if axes[d] == "kv_heads":
            per = kv_heads // tp
            view = _kv_view(out, d, kv_heads).narrow(d + 1, t * per, per)
            out = view.reshape(*out.shape[:d], -1, *out.shape[d + 1:])
        else:
            size = out.shape[d]
            if size % tp:
                raise ValueError(f"shard_leaf: dim {d} ({axes[d]}) of "
                                 f"{tuple(full.shape)} does not split over "
                                 f"tp={tp}")
            out = out.narrow(d, t * (size // tp), size // tp)
    return out.contiguous()


def gather_leaf(local: torch.Tensor, axes: tuple, mesh: Mesh,
                kv_heads: Optional[int] = None) -> torch.Tensor:
    """The whole leaf from every rank's part (`shard_leaf`'s inverse);
    every rank of the tp, dp and pp groups must call it."""
    out = local
    for d in reversed(cut_dims(axes, mesh, kv_heads)):
        if axes[d] == "kv_heads":
            per = kv_heads // mesh.shape[TENSOR_AXIS]
            whole = collectives.all_gather(_kv_view(out, d, per), mesh,
                                           TENSOR_AXIS, d + 1)
            out = whole.reshape(*out.shape[:d], -1, *out.shape[d + 1:])
        else:
            out = collectives.all_gather(out, mesh, TENSOR_AXIS, d)
    for d in dp_dims(axes, mesh):
        out = gather_dp(out, d, mesh)
    for d in pp_dims(axes, mesh):
        out = gather_pp(out, d, mesh)
    return out


def distributed_opt_dim(axes: tuple, shape: tuple,
                        mesh: Mesh) -> Optional[int]:
    """The dim that ZeRO-1 cuts a leaf's moments on over dp
    (`distributed_opt_sharding`'s rule): the first dim whose logical axis
    the rules map to no mesh axis and whose size dp divides; None when dp
    is 1, the distributed optimizer is off, no dim qualifies, or pp > 1
    and the leaf is not stacked."""
    dp = mesh.shape[DATA_AXIS]
    if dp == 1 or not mesh.use_distributed_optimizer:
        return None
    spec = list(logical_to_spec(axes, _rules(mesh)))
    if mesh.shape[PIPELINE_AXIS] > 1 and PIPELINE_AXIS not in spec:
        # the shared leaves under pp (the reference's pipelined=True)
        return None
    if DATA_AXIS in spec:
        # an expert bank on dp: its moments are cut with it already
        return None
    spec += [None] * (len(shape) - len(spec))
    for d, (ax, size) in enumerate(zip(spec, shape)):
        if ax is None and size % dp == 0:
            return d
    return None


def shard_dp(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's dp share of `t` along `dim` (contiguous); raises when dp
    does not divide the dim."""
    dp, d = mesh.shape[DATA_AXIS], mesh.coords[DATA_AXIS]
    if t.shape[dim] % dp:
        raise ValueError(f"shard_dp: dim {dim} of {tuple(t.shape)} does "
                         f"not split over dp={dp}")
    per = t.shape[dim] // dp
    return t.narrow(dim, d * per, per).contiguous()


def gather_dp(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    return collectives.all_gather(t, mesh, DATA_AXIS, dim)


def cp_positions(seq: int, mesh: Mesh, zigzag: bool = False):
    """The places in the whole sequence of length `seq` of this rank's cp
    chunk, in its order: a slice of the contiguous split, or the index
    tensor of its two zigzag chunks (parallel/ring_attention.py
    `zigzag_permutation`)."""
    cp, c = mesh.shape[CONTEXT_AXIS], mesh.coords[CONTEXT_AXIS]
    per = seq // cp
    if not zigzag:
        return slice(c * per, (c + 1) * per)
    half = per // 2
    head = torch.arange(c * half, (c + 1) * half)
    tail = torch.arange((2 * cp - 1 - c) * half, (2 * cp - c) * half)
    return torch.cat([head, tail])


def activation_region(mesh: Mesh, shape: tuple, per_sample: bool = False,
                      zigzag: bool = False):
    """Where a rank's residual-stream activation [b, s, ...] lies in the
    whole step's [b * dp, s * cp (* tp under SP), ...]: (whole shape,
    index). `per_sample` is the [b, 1, ...] shape of a per-sample draw
    (drop path), cut on the batch dim alone; `zigzag`: the batch was
    pre-permuted for the ring (see the module's note)."""
    b = shape[0]
    d = mesh.coords[DATA_AXIS]
    whole = [b * mesh.shape[DATA_AXIS], *shape[1:]]
    index = [slice(d * b, (d + 1) * b)]
    if per_sample:
        return tuple(whole), tuple(index)
    sp = mesh.sequence_parallel
    cp = mesh.shape[CONTEXT_AXIS]
    if sp or cp > 1:
        tp, t = mesh.shape[TENSOR_AXIS], mesh.coords[TENSOR_AXIS]
        s = shape[1]
        s_cp = s * tp if sp else s
        whole[1] = s_cp * cp
        where = cp_positions(s_cp * cp, mesh, zigzag)
        if sp:
            where = (torch.arange(s_cp * cp)[where][t * s:(t + 1) * s]
                     if zigzag else slice(where.start + t * s,
                                          where.start + (t + 1) * s))
        index.append(where)
    return tuple(whole), tuple(index)
