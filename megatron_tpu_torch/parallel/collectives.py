"""The collectives of the sharded training step, and the autograd mappings
that place them (a module only the port has).

The reference states tensor and sequence parallelism as shardings and lets
GSPMD insert the collectives (megatron_tpu/parallel/sharding.py). The port
writes them by hand, as upstream Megatron's mappings do
(megatron/core/tensor_parallel/mappings.py):

- `copy_to_tp`: identity forward, all-reduce over tp backward (the input of
  a column-parallel product);
- `reduce_from_tp`: all-reduce over tp forward, identity backward (the
  output of a row-parallel product);
- `gather_seq`: all-gather along the sequence over tp forward,
  reduce-scatter backward (the input of a column-parallel product under
  sequence parallelism);
- `reduce_scatter_seq`: reduce-scatter along the sequence forward,
  all-gather backward (the output of a row-parallel product under
  sequence parallelism).

`tp_region_in` and `tp_region_out` pick the pair that the mesh's sequence
parallelism asks for. An axis of size 1 makes every collective over it the
identity, with no call.

Context parallelism and the expert layouts add mappings over any axis:

- `gather_axis`: all-gather along a dim forward, reduce-scatter backward
  (the sequence over cp, the contexts of ICT's in-batch negatives over dp);
- `all_to_all_axis`: split one dim over the axis's ranks and concatenate
  what they send along another (Ulysses' seq <-> head reshards, the expert
  blocks over dp); its backward is the inverse all-to-all;
- `ring_shift`: send to the next rank of the axis and receive from the
  previous one (the reference's `lax.ppermute` with `perm_ring`, through
  `batch_isend_irecv`); its backward shifts the other way;
- `sum_axis`: an all-reduce whose backward is an all-reduce too, for a
  value that every rank's own share of the loss reads (the MoE router's
  token fractions);
- `scale_grad`: the identity forward, the grad times a constant backward.

The pipeline (parallel/pipeline.py) adds point-to-point traffic over pp:

- `exchange`: one tick's sends to and receives from other stages, posted
  as one `batch_isend_irecv` (the reference's one `ppermute` per
  direction per tick); 2-byte floats travel as their int16 bits, which
  every backend moves;
- `broadcast`: a tensor of one stage on every stage (T5's encoder output);
- an all-reduce over pp (the shared leaves' grads, the loss) is
  `all_reduce` over the axis.

`Transport` moves the bytes for one backend, chosen by the backend named at
init (`transport_for`): NCCL takes the tensors where they lie; gloo takes
host copies, because torch's gloo backend runs only `broadcast` and
`all_reduce` on CUDA tensors. A transport counts the bytes it hands to the
backend (`bytes`), the input of every call.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


class Transport:
    """all_reduce, all_gather and reduce_scatter over a process group for
    one backend. Each call returns a new tensor on its input's device and
    leaves the input as it was."""

    def __init__(self, backend: str):
        # gloo runs the collectives on host tensors only
        self.host = backend == "gloo"
        self.bytes = 0
        # whether a group has met before its first point-to-point batch
        # (parallel/pipeline.py `warm_p2p`)
        self.p2p_ready = False

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous private copy of `t` where the backend reads it."""
        t = t.detach()
        self.bytes += t.numel() * t.element_size()
        if self.host:
            return t.to("cpu", copy=True, memory_format=torch.contiguous_format)
        return t.clone(memory_format=torch.contiguous_format)

    def _unstage(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return t.to(like.device) if self.host else t

    def all_reduce(self, t: torch.Tensor, group,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        buf = self._stage(t)
        dist.all_reduce(buf, op=op, group=group)
        return self._unstage(buf, t)

    def all_gather(self, t: torch.Tensor, group, dim: int) -> torch.Tensor:
        """The group's tensors concatenated along `dim` in rank order."""
        n = dist.get_world_size(group)
        x = self._stage(t.movedim(dim, 0))
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return self._unstage(out, t).movedim(0, dim).contiguous()

    def all_to_all(self, t: torch.Tensor, group, split_dim: int,
                   cat_dim: int) -> torch.Tensor:
        """`t` cut along `split_dim` into equal parts in rank order, part i
        sent to rank i; the parts received joined along `cat_dim` in rank
        order."""
        n = dist.get_world_size(group)
        if t.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dim {split_dim} of "
                             f"{tuple(t.shape)} does not split over {n} "
                             "ranks")
        x = self._stage(t.movedim(split_dim, 0))
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        out = self._unstage(out, t)
        k = x.shape[0] // n
        # [source rank, this rank's part of split_dim, the other dims]
        y = out.reshape(n, k, *x.shape[1:]).movedim(1, split_dim + 1)
        y = y.movedim(0, cat_dim)
        shape = list(t.shape)
        shape[split_dim] = k
        shape[cat_dim] *= n
        return y.reshape(shape).contiguous()

    def shift(self, t: torch.Tensor, group, step: int) -> torch.Tensor:
        """What the rank `step` places before this one in the group's ring
        sent: every rank sends `t` to the rank `step` places after it."""
        n = dist.get_world_size(group)
        me = dist.get_group_rank(group, dist.get_rank())
        buf = self._stage(t)
        out = torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, buf,
                          dist.get_global_rank(group, (me + step) % n)),
               dist.P2POp(dist.irecv, out,
                          dist.get_global_rank(group, (me - step) % n))]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._unstage(out, t)

    def exchange(self, sends: list, recvs: list, group) -> list:
        """One batch of point-to-point operations: `sends` [(tensor,
        global rank)], `recvs` [(shape, dtype, device, global rank)], in
        the order both peers list them. Returns the received tensors, in
        `recvs`' order, on their devices."""
        ops, outs = [], []
        for t, peer in sends:
            ops.append(dist.P2POp(dist.isend, _bits(self._stage(t)), peer,
                                  group))
        for shape, dtype, device, peer in recvs:
            buf = torch.empty(shape, dtype=dtype,
                              device="cpu" if self.host else device)
            outs.append((buf, device))
            ops.append(dist.P2POp(dist.irecv, _bits(buf), peer, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [buf.to(device) if self.host else buf for buf, device in outs]

    def broadcast(self, t: torch.Tensor, group, src: int) -> torch.Tensor:
        """Global rank `src`'s `t` on every rank of the group (the others
        pass a tensor of its shape and dtype)."""
        buf = self._stage(t)
        dist.broadcast(_bits(buf), src, group=group)
        return self._unstage(buf, t)

    def reduce_scatter(self, t: torch.Tensor, group, dim: int
                       ) -> torch.Tensor:
        """The sum over the group, cut along `dim` into equal parts in rank
        order; this rank's part."""
        n = dist.get_world_size(group)
        if t.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                             f"does not split over {n} ranks")
        x = self._stage(t.movedim(dim, 0))
        out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
        return self._unstage(out, t).movedim(0, dim).contiguous()


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A 2-byte float tensor as its int16 bits (a view), else itself."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16)
    return t


def transport_for(backend: str) -> Transport:
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"no transport for backend {backend!r} (nccl, "
                         "gloo)")
    return Transport(backend)


# --- collectives over a mesh axis --------------------------------------------

def all_reduce(t: torch.Tensor, mesh, axis: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    if mesh.shape[axis] == 1:
        return t
    return mesh.transport.all_reduce(t, mesh.groups[axis], op)


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    if mesh.shape[axis] == 1:
        return t
    return mesh.transport.all_gather(t, mesh.groups[axis], dim)


def reduce_scatter(t: torch.Tensor, mesh, axis: str,
                   dim: int) -> torch.Tensor:
    if mesh.shape[axis] == 1:
        return t
    return mesh.transport.reduce_scatter(t, mesh.groups[axis], dim)


def all_to_all(t: torch.Tensor, mesh, axis: str, split_dim: int,
               cat_dim: int) -> torch.Tensor:
    if mesh.shape[axis] == 1:
        return t
    return mesh.transport.all_to_all(t, mesh.groups[axis], split_dim,
                                     cat_dim)


def shift(t: torch.Tensor, mesh, axis: str, step: int = 1) -> torch.Tensor:
    if mesh.shape[axis] == 1:
        return t
    return mesh.transport.shift(t, mesh.groups[axis], step)


def exchange(mesh, sends: list, recvs: list) -> list:
    """`Transport.exchange` over the mesh's pp group (pp > 1); peers are
    global ranks."""
    return mesh.transport.exchange(sends, recvs, mesh.groups["pp"])


def broadcast(t: torch.Tensor, mesh, axis: str, src: int) -> torch.Tensor:
    """The tensor of the rank at coordinate `src` of the axis, on every
    rank of the axis (the others pass one of its shape and dtype)."""
    if mesh.shape[axis] == 1:
        return t
    group = mesh.groups[axis]
    return mesh.transport.broadcast(t, group,
                                    dist.get_global_rank(group, src))


def sum_world(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of `t` over every rank of the mesh."""
    if mesh.world_size == 1:
        return t
    return mesh.transport.all_reduce(t, None)


def any_rank(flag: bool, mesh) -> bool:
    """Whether `flag` holds on any rank: a sum over the world's host group,
    which neither waits for nor touches the device."""
    if mesh.world_size == 1:
        return flag
    t = torch.tensor([int(flag)])
    dist.all_reduce(t, group=mesh.host_group)
    return bool(t.item())


# --- autograd mappings over tp ------------------------------------------------

class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, "tp"), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, mesh, "tp")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather(x, mesh, "tp", 1)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, "tp", 1), None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return reduce_scatter(x, mesh, "tp", 1)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, "tp", 1), None


def _tp_map(fn, x, mesh):
    return x if mesh.shape["tp"] == 1 else fn.apply(x, mesh)


def copy_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return _tp_map(_CopyToTP, x, mesh)


def reduce_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return _tp_map(_ReduceFromTP, x, mesh)


def gather_seq(x: torch.Tensor, mesh) -> torch.Tensor:
    """[b, s/tp, ...] -> [b, s, ...]."""
    return _tp_map(_GatherSeq, x, mesh)


def reduce_scatter_seq(x: torch.Tensor, mesh) -> torch.Tensor:
    """[b, s, ...] partial sums -> this rank's [b, s/tp, ...] of the sum."""
    return _tp_map(_ReduceScatterSeq, x, mesh)


def tp_region_in(x: torch.Tensor, mesh) -> torch.Tensor:
    """The residual stream entering a column-parallel product: gathered
    along the sequence under sequence parallelism, else copied."""
    if mesh.sequence_parallel:
        return gather_seq(x, mesh)
    return copy_to_tp(x, mesh)


def from_tp_rank0(x: torch.Tensor, mesh) -> torch.Tensor:
    """`x` as tp rank 0 holds it, on every tp rank: the other ranks' `x`
    counts zero, and the backward hands every rank the grad, which only
    rank 0's `x` takes (BERT's pooler under sequence parallelism, where
    token 0 lies on tp rank 0)."""
    if mesh.shape["tp"] == 1:
        return x
    return reduce_from_tp(x * float(mesh.coords["tp"] == 0), mesh)


def tp_region_out(x: torch.Tensor, mesh) -> torch.Tensor:
    """A row-parallel product's partial sums leaving for the residual
    stream: reduce-scattered along the sequence under sequence
    parallelism, else all-reduced."""
    if mesh.sequence_parallel:
        return reduce_scatter_seq(x, mesh)
    return reduce_from_tp(x, mesh)


# --- autograd mappings over any axis ------------------------------------------

class _GatherAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, *ctx.args), None, None, None


class _AllToAllAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, cat_dim):
        ctx.args = (mesh, axis, cat_dim, split_dim)
        return all_to_all(x, mesh, axis, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), *ctx.args), None, None, None, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, step):
        ctx.args = (mesh, axis, -step)
        return shift(x, mesh, axis, step)

    @staticmethod
    def backward(ctx, g):
        return shift(g.contiguous(), *ctx.args), None, None, None


class _SumAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, *ctx.args), None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def gather_axis(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The axis's parts of `x` joined along `dim`; the backward sums every
    rank's grad of the whole and keeps this rank's part."""
    if mesh.shape[axis] == 1:
        return x
    return _GatherAxis.apply(x, mesh, axis, dim)


def all_to_all_axis(x: torch.Tensor, mesh, axis: str, split_dim: int,
                    cat_dim: int) -> torch.Tensor:
    """`Transport.all_to_all` over the axis, differentiable."""
    if mesh.shape[axis] == 1:
        return x
    return _AllToAllAxis.apply(x, mesh, axis, split_dim, cat_dim)


def ring_shift(x: torch.Tensor, mesh, axis: str, step: int = 1
               ) -> torch.Tensor:
    """The tensor of the rank `step` places before this one on the axis's
    ring, differentiable."""
    if mesh.shape[axis] == 1:
        return x
    return _RingShift.apply(x, mesh, axis, step)


def sum_axis(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of `x` over the axis, where every rank's loss reads the sum:
    the backward sums the ranks' grads."""
    if mesh.shape[axis] == 1:
        return x
    return _SumAxis.apply(x, mesh, axis)


def scale_grad(x: torch.Tensor, factor: float) -> torch.Tensor:
    """`x`, whose grad is multiplied by `factor`."""
    if factor == 1.0:
        return x
    return _ScaleGrad.apply(x, factor)
