"""Pipeline parallelism over the mesh's pp axis
(megatron_tpu/parallel/pipeline.py).

The reference runs its schedules as one jitted SPMD program over 'pp':
every stage executes the same ops each tick, idle slots masked, and the
boundary tensors ride one `ppermute` per direction per tick. The port
keeps that timetable and runs it eagerly, one process per stage:

- `timetable` is the pure timetable: for every stage and tick, the units
  it runs (forward or backward of one chunk on one microbatch) and the
  boundary tensors it sends and receives. Position pos = c*pp + s of the
  P = pp*vpp hops is chunk c of stage s (layers (c*pp + s)*Lc onwards,
  `stage_params_chunked`).
  - 1F1B (vpp 1 or interleaved): at tick t position pos forwards
    microbatch t - pos and backwards microbatch t - 2(P-1) + pos; T =
    n_micro + 2(P-1) ticks and at most 2P - 1 microbatches in flight per
    chunk, whatever n_micro (the reference's `pipeline_train_1f1b` and
    `_pipeline_train_1f1b_interleaved`).
  - gpipe: the lockstep fill-drain forward (microbatch t - pos at tick
    t, T = n_micro + P - 1), then its mirror for the backward, position
    pos taking microbatch m at tick m + P-1 - pos (the reference's
    `pipeline_apply`, whose backward autodiff derives). Its eval pass
    (`pipeline_loss_fn`) is the forward alone.
- `StageRun` runs one stage's column of the timetable. A forward unit
  runs the chunk on its input: the stage-0 intake for position 0, else
  the tensor received; a backward unit calls `torch.autograd.backward`
  on the unit's output with the cotangent received (or the head's, on
  the last position) and sends its input's grad. Each tick ends in one
  `collectives.exchange` of the tick's sends and receives, one
  `batch_isend_irecv` (the reference's per-tick `ppermute`); a stage
  with nothing to do in a slot skips it. Every rank derives the same
  timetable, so every send meets its receive in the same tick.
- Store mode (`store_activations`, and gpipe always) keeps the forward's
  autograd graph until the backward; otherwise a forward runs without
  grad, the stash keeps its input and the backward recomputes the chunk
  (the reference's default, its recompute of the whole chunk under 1F1B;
  the layers' own recompute is then off in that pass).
- The head (final norm, LM head, loss) runs on the last stage alone, in
  the tick of the microbatch's last forward hop, and its input grad feeds
  that microbatch's backward there; the reference runs it masked on every
  stage because its one program must be branch-free. Its cotangent is
  `cotangent_seed / n_micro` (the loss scale), the MoE router loss's that
  times `moe_aux_loss_coeff` on every stage.
- Dropout: the step draws one seed per microbatch (ops/dropout.py
  `draw_seeds`); the intake's generator is seeded with `fold_seed(seed,
  0)`, and each layer's with `fold_seed(fold_seed(seed, 1), layer id)`
  (the reference's `fold_in(rng_mb, 1)` then the layer id), so the masks
  are those of the sequential model under the same seeds, whatever the
  (pp, vpp), the schedule or the mode, and the recompute redraws the
  forward's bit for bit.
- Grads: the stage's stacked leaves are cut into vpp chunk views, each a
  leaf of its own whose grads are summed in fp32 as each backward lands
  (`StageGrads`); every other leaf (embedding, final norm, LM head, the
  BERT and T5 heads) is whole on every stage, its grads summed over the
  pp group in one coalesced all-reduce, zeros counting on the stages that
  do not use it. The loss and the router loss are summed over pp too, so
  every rank reports the same.

Under a (dp, pp, cp, tp) mesh each stage's layers run the sharded forward
of their (dp, cp, tp) coordinate (models/transformer.py) and its
boundary tensors are its own [b, s, h] part (its dp rows, cp chunk and SP
part), sent to the rank of the same (dp, cp, tp) coordinate in the next
stage.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from megatron_tpu_torch.config import ModelConfig, as_dtype
from megatron_tpu_torch.ops.dropout import fold_seed, seeded
from megatron_tpu_torch.parallel import collectives
from megatron_tpu_torch.parallel.mesh import (CONTEXT_AXIS, PIPELINE_AXIS,
                                              TENSOR_AXIS)


# --- the layouts of a stacked leaf --------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stage_params_chunked(stacked, pp: int, vpp: int):
    """[L, ...] -> [pp, vpp, L/(pp*vpp), ...]: element [s, c] holds layers
    (c*pp + s)*Lc onwards, the interleaved assignment."""
    def r(x):
        n = x.shape[0]
        if n % (pp * vpp):
            raise ValueError(f"num_layers {n} not divisible by pp*vpp "
                             f"{pp}x{vpp}")
        lc = n // (pp * vpp)
        return x.reshape(vpp, pp, lc, *x.shape[1:]).transpose(0, 1)
    return _tree_map(r, stacked)


def stage_params_unchunk(chunked):
    """Inverse of stage_params_chunked: [pp, vpp, Lc, ...] -> [L, ...]."""
    return _tree_map(
        lambda x: x.transpose(0, 1).reshape(-1, *x.shape[3:]), chunked)


def stage_params_reshape(stacked, pp: int):
    """[L, ...] -> [pp, L/pp, ...]: contiguous stage slices."""
    return _tree_map(lambda x: x[:, 0], stage_params_chunked(stacked, pp, 1))


def stage_params_flatten(staged):
    """Inverse of stage_params_reshape."""
    return _tree_map(
        lambda x: x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]), staged)


# --- the timetable --------------------------------------------------------------

SCHEDULES = ("1f1b", "gpipe")


@dataclass(frozen=True)
class Tick:
    """One stage's tick: forward units (chunk, microbatch) in chunk order,
    backward units in descending chunk order, and the tick's messages,
    each ((kind, position, microbatch), peer stage), sorted by their key
    on both ends. kind "act" carries a forward output to `position`, kind
    "grad" an input grad back to `position`."""
    fwd: tuple = ()
    bwd: tuple = ()
    sends: tuple = ()
    recvs: tuple = ()


def num_ticks(n_micro: int, pp: int, vpp: int = 1, schedule: str = "1f1b",
              phase: str = "both") -> int:
    """T of the timetable: n_micro + 2(P-1) for 1F1B, n_micro + P-1 a
    pass for gpipe (twice that for both passes)."""
    p = pp * vpp
    if schedule == "1f1b":
        return n_micro + 2 * (p - 1)
    one = n_micro + p - 1
    return 2 * one if phase == "both" else one


def bubble_fraction(n_micro: int, pp: int, vpp: int = 1) -> float:
    """The share of 1F1B ticks a stage idles in: 2(P-1)/T."""
    p = pp * vpp
    return 2 * (p - 1) / num_ticks(n_micro, pp, vpp)


def timetable(pp: int, vpp: int, n_micro: int, schedule: str = "1f1b",
              phase: str = "both") -> list:
    """[stage][tick] -> Tick for the schedule ("1f1b" or "gpipe");
    `phase` "fwd" or "bwd" keeps one pass of gpipe (the eval forward,
    T5's encoder passes)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline_schedule {schedule!r}")
    if phase not in ("both", "fwd", "bwd") or (schedule == "1f1b"
                                               and phase != "both"):
        raise ValueError(f"phase {phase!r} of {schedule}")
    if n_micro < 1:
        raise ValueError("the pipeline needs at least one microbatch")
    p = pp * vpp
    T = num_ticks(n_micro, pp, vpp, schedule, phase)
    if schedule == "1f1b":
        def fwd_at(pos, m):
            return m + pos

        def bwd_at(pos, m):
            return m + 2 * (p - 1) - pos
    else:
        first = n_micro + p - 1 if phase == "both" else 0

        def fwd_at(pos, m):
            return m + pos

        def bwd_at(pos, m):
            return first + m + (p - 1 - pos)
    cols = [[dict(fwd=[], bwd=[], sends=[], recvs=[]) for _ in range(T)]
            for _ in range(pp)]

    def message(key, src, dst, t):
        cols[src][t]["sends"].append((key, dst))
        cols[dst][t]["recvs"].append((key, src))

    for m in range(n_micro):
        for pos in range(p):
            s, c = pos % pp, pos // pp
            if phase in ("both", "fwd"):
                t = fwd_at(pos, m)
                cols[s][t]["fwd"].append((c, m))
                if pos < p - 1:
                    message(("act", pos + 1, m), s, (pos + 1) % pp, t)
            if phase in ("both", "bwd"):
                t = bwd_at(pos, m)
                cols[s][t]["bwd"].append((c, m))
                if pos > 0:
                    message(("grad", pos - 1, m), s, (pos - 1) % pp, t)
    return [[Tick(fwd=tuple(sorted(d["fwd"])),
                  bwd=tuple(sorted(d["bwd"], reverse=True)),
                  sends=tuple(sorted(d["sends"])),
                  recvs=tuple(sorted(d["recvs"])))
             for d in col] for col in cols]


# --- one stage's grads ------------------------------------------------------------

class StageGrads:
    """fp32 grad sums of a model's leaves while a schedule runs on this
    stage. Each stacked subtree named in `stacked` is cut into `vpp` chunk
    trees of views of its leaves (rows c*Lc .. (c+1)*Lc of the stage's
    layers), each view a leaf of its own; every leaf's grad is added to
    an fp32 buffer as soon as a backward lands on it and then freed, so a
    low-precision grad is never summed in its own dtype. `close()`
    returns {name: fp32 grad} of every parameter, the stacked ones joined
    back in the stage's layer order, zeros where nothing landed."""

    def __init__(self, model: torch.nn.Module, stacked: tuple, vpp: int):
        self.model, self.vpp = model, vpp
        self.stacked = tuple(stacked)
        self.buffers: dict = {}
        self.handles: list = []
        self.chunk_trees = {name: [self._chunk(model[name], name, c)
                                   for c in range(vpp)]
                            for name in self.stacked}
        for name, p in model.named_parameters():
            if name.split(".", 1)[0] not in self.stacked:
                self._watch(p, name)

    def _watch(self, leaf: torch.Tensor, key) -> None:
        def hook(t):
            buf = self.buffers.get(key)
            if buf is None:
                self.buffers[key] = t.grad.float().contiguous()
            else:
                buf.add_(t.grad)
            t.grad = None
        leaf.requires_grad_(True)
        self.handles.append(leaf.register_post_accumulate_grad_hook(hook))

    def _chunk(self, tree, prefix: str, c: int) -> dict:
        out = {}
        for k, v in tree.items():
            name = f"{prefix}.{k}"
            if isinstance(v, torch.Tensor):
                lc = v.shape[0] // self.vpp
                view = v.detach()[c * lc:(c + 1) * lc]
                self._watch(view, (name, c))
                out[k] = view
            else:
                out[k] = self._chunk(v, name, c)
        return out

    def chunk(self, name: str, c: int) -> dict:
        return self.chunk_trees[name][c]

    def close(self) -> dict:
        for h in self.handles:
            h.remove()
        self.handles = []
        out = {}
        for name, p in self.model.named_parameters():
            if name.split(".", 1)[0] in self.stacked:
                lc = p.shape[0] // self.vpp
                parts = [self.buffers.get((name, c)) for c in range(self.vpp)]
                out[name] = torch.cat([
                    g if g is not None else torch.zeros(
                        lc, *p.shape[1:], dtype=torch.float32,
                        device=p.device) for g in parts])
            else:
                g = self.buffers.get(name)
                out[name] = (g if g is not None else
                             torch.zeros_like(p, dtype=torch.float32))
        return out


def reduce_shared(grads: dict, stacked: tuple, mesh) -> dict:
    """The grads of the leaves outside `stacked` summed over the pp group,
    in one coalesced all-reduce."""
    if mesh is None or mesh.shape[PIPELINE_AXIS] == 1:
        return grads
    names = [k for k in grads if k.split(".", 1)[0] not in stacked]
    if not names:
        return grads
    flat = collectives.all_reduce(
        torch.cat([grads[k].reshape(-1) for k in names]), mesh,
        PIPELINE_AXIS)
    out = dict(grads)
    at = 0
    for k in names:
        n = grads[k].numel()
        out[k] = flat[at:at + n].view_as(grads[k])
        at += n
    return out


def warm_p2p(mesh, device) -> None:
    """An all-reduce over the pp group before its first point-to-point
    batch: NCCL requires a group's first call to involve all its ranks,
    and a tick's exchange may not. Once per transport."""
    tr = mesh.transport
    if tr is None or mesh.shape[PIPELINE_AXIS] == 1 or tr.p2p_ready:
        return
    collectives.all_reduce(torch.zeros(1, device=device), mesh,
                           PIPELINE_AXIS)
    tr.p2p_ready = True


# --- one stage's run of a timetable ------------------------------------------------

def stream_slice(streams: dict, m: int) -> dict:
    """Microbatch m's slice of every [n_micro, ...] stream."""
    return {k: v[m] for k, v in streams.items() if v is not None}


def _head_sum(model, outputs: dict, streams: dict, head) -> torch.Tensor:
    """The sum of the head's loss over the last stage's `outputs`
    (microbatch -> output; zero on the other stages)."""
    total = torch.zeros((), dtype=torch.float32, device=model.device)
    for m, h in outputs.items():
        total = total + head(model, h, stream_slice(streams, m), None).float()
    return total


def _chunk_ret(ret):
    """A chunk fn's `h` or `(h, aux)` -> (h, aux); aux is None for a dense
    chunk (the stack's float 0.0 or nothing)."""
    if isinstance(ret, tuple):
        h, aux = ret
        return h, aux if isinstance(aux, torch.Tensor) else None
    return ret, None


class StageRun:
    """One stage's part of a pipeline pass over `n_micro` microbatches.

    `intake(model, sl, seed)` -> position 0's input [b, s, h];
    `chunk(chunk_params, h, sl, offset, seed, remat)` -> h or (h, aux);
    `head(model, h, sl, seed)` -> the microbatch's scalar loss, or None
    for a pass whose last outputs are kept (`outputs`) and whose
    cotangents come from outside (`top`). `sl` is microbatch m's slice of
    every stream ([n_micro, ...] tensors), `seed` its dropout seed or
    None. `chunks[c]` is chunk c's parameter tree and `offsets[c]` its
    first layer's id. `act_shape` is the boundary tensor's shape on this
    rank, in the compute dtype. With `train` the forward keeps what the
    backward needs: the graph (`store`) or the input (recompute)."""

    def __init__(self, mesh, *, model, intake: Callable, chunk: Callable,
                 head: Optional[Callable], chunks: list, offsets: list,
                 streams: dict, n_micro: int, act_shape: tuple, act_dtype,
                 device, seeds: Optional[list] = None, train: bool = True,
                 store: bool = False, cotangent: float = 1.0,
                 aux_cotangent: float = 0.0):
        self.mesh = mesh
        self.pp = 1 if mesh is None else mesh.shape[PIPELINE_AXIS]
        self.stage = 0 if mesh is None else mesh.coords[PIPELINE_AXIS]
        self.model, self.intake, self.chunk_fn = model, intake, chunk
        self.head, self.chunks, self.offsets = head, chunks, offsets
        self.streams, self.n_micro, self.seeds = streams, n_micro, seeds
        self.act_shape, self.act_dtype = tuple(act_shape), act_dtype
        self.device, self.train, self.store = device, train, store
        self.vpp = len(chunks)
        self.last = self.pp * self.vpp - 1
        self.stash = [dict() for _ in chunks]
        self.inbox: dict = {}
        self.top: dict = {}       # microbatch -> its last output's grad
        self.outputs: dict = {}   # microbatch -> last output (no head)
        self.loss = torch.zeros((), dtype=torch.float32, device=device)
        self.aux = torch.zeros((), dtype=torch.float32, device=device)
        self.ct = torch.as_tensor(cotangent, dtype=torch.float32,
                                  device=device)
        self.ct_aux = torch.as_tensor(aux_cotangent, dtype=torch.float32,
                                      device=device)
        self.peak_stash = 0

    def _slice(self, m: int) -> dict:
        return stream_slice(self.streams, m)

    def _seed(self, m: int) -> Optional[int]:
        return None if self.seeds is None else self.seeds[m]

    def _apply(self, c: int, m: int, x_in, remat: bool):
        """Chunk c on microbatch m from `x_in`, or from the intake's
        output at position 0 (x_in None). Returns (h_out, aux)."""
        sl, seed = self._slice(m), self._seed(m)
        if x_in is None:
            x_in = self.intake(self.model, sl, seed)
        h, aux = _chunk_ret(self.chunk_fn(self.chunks[c], x_in, sl,
                                          self.offsets[c], seed, remat))
        return h, aux

    def _forward(self, c: int, m: int, out: dict) -> None:
        pos = c * self.pp + self.stage
        h_in = None if pos == 0 else self.inbox.pop(("act", pos, m))
        keep_graph = self.train and self.store
        x = h_in
        if keep_graph and h_in is not None:
            x = h_in.requires_grad_(True)
        with torch.set_grad_enabled(keep_graph):
            h, aux = self._apply(c, m, x, remat=True)
        if self.train:
            self.stash[c][m] = (x, h, aux) if keep_graph else h_in
            self.peak_stash = max(self.peak_stash,
                                  max(len(s) for s in self.stash))
        if aux is not None:
            self.aux = self.aux + aux.detach().float()
        if pos < self.last:
            out[("act", pos + 1, m)] = h.detach()
        elif self.head is not None:
            self._run_head(m, h.detach())
        else:
            self.outputs[m] = h.detach()

    def _run_head(self, m: int, h: torch.Tensor) -> None:
        sl, seed = self._slice(m), self._seed(m)
        if not self.train:
            with torch.no_grad():
                self.loss = self.loss + self.head(self.model, h, sl,
                                                  seed).float()
            return
        h = h.requires_grad_(True)
        with torch.enable_grad():
            loss = self.head(self.model, h, sl, seed)
        torch.autograd.backward(loss, self.ct.to(loss.dtype))
        self.top[m] = h.grad
        self.loss = self.loss + loss.detach().float()

    def _backward(self, c: int, m: int, out: dict) -> None:
        pos = c * self.pp + self.stage
        ct = (self.top.pop(m) if pos == self.last
              else self.inbox.pop(("grad", pos, m)))
        kept = self.stash[c].pop(m)
        if self.store:
            x, h, aux = kept
        else:
            x = None if kept is None else kept.requires_grad_(True)
            with torch.enable_grad():
                h, aux = self._apply(c, m, x, remat=False)
        outs, cts = [h], [ct.to(h.dtype)]
        if aux is not None and aux.requires_grad:
            outs.append(aux)
            cts.append(self.ct_aux.to(aux.dtype))
        torch.autograd.backward(outs, cts)
        if pos > 0:
            out[("grad", pos - 1, m)] = x.grad

    def run(self, ticks: list) -> "StageRun":
        """Run this stage's column of a timetable."""
        for tick in ticks:
            out: dict = {}
            for c, m in tick.fwd:
                self._forward(c, m, out)
            for c, m in tick.bwd:
                self._backward(c, m, out)
            if tick.sends or tick.recvs:
                self._exchange(tick, out)
        return self

    def _exchange(self, tick: Tick, out: dict) -> None:
        mesh = self.mesh
        sends = [out.pop(key).contiguous() for key, _ in tick.sends]
        if self.pp == 1:  # one stage: every message is to itself
            got = sends
        else:
            got = collectives.exchange(
                mesh, [(t, mesh.stage_rank(dst))
                       for t, (_, dst) in zip(sends, tick.sends)],
                [(self.act_shape, self.act_dtype, self.device,
                  mesh.stage_rank(src)) for _, src in tick.recvs])
        for (key, _), t in zip(tick.recvs, got):
            self.inbox[key] = t


def layer_offsets(num_layers: int, pp: int, vpp: int, stage: int) -> list:
    """The first layer of each of the stage's chunks."""
    lc = num_layers // (pp * vpp)
    return [(c * pp + stage) * lc for c in range(vpp)]


def boundary_shape(mesh, rows: int, seq: int, hidden: int) -> tuple:
    """A stage's boundary tensor on this rank: [rows, seq, h], seq cut
    over tp under sequence parallelism (rows and seq already the rank's
    dp rows and cp chunk)."""
    if mesh is not None and mesh.sequence_parallel:
        seq //= mesh.shape[TENSOR_AXIS]
    return (rows, seq, hidden)


def make_stage_run(model, streams: dict, cfg: ModelConfig, mesh, *,
                   intake, chunk, head, act_shape: tuple, vpp: int = 1,
                   seeds: Optional[list] = None,
                   grads: Optional[StageGrads] = None, store: bool = True,
                   cotangent_seed=1.0,
                   stacked: str = "transformer") -> StageRun:
    """This stage's StageRun over the stacked subtree `stacked`: its vpp
    chunks (`grads`' chunk trees when training, plain views otherwise), the
    chunks' first layers, the head's cotangent cotangent_seed / n_micro
    and the router loss's that times moe_aux_loss_coeff."""
    pp = 1 if mesh is None else mesh.shape[PIPELINE_AXIS]
    stage = 0 if mesh is None else mesh.coords[PIPELINE_AXIS]
    n_micro = next(v for v in streams.values() if v is not None).shape[0]
    if mesh is not None:
        warm_p2p(mesh, model.device)
    layers = next(iter(_leaves(model[stacked]))).shape[0] * pp
    coeff = cfg.moe_aux_loss_coeff if cfg.num_experts > 1 else 0.0
    ct = cotangent_seed / n_micro
    return StageRun(
        mesh, model=model, intake=intake, chunk=chunk, head=head,
        chunks=([grads.chunk(stacked, c) for c in range(vpp)]
                if grads is not None else chunk_views(model[stacked], vpp)),
        offsets=layer_offsets(layers, pp, vpp, stage), streams=streams,
        n_micro=n_micro, act_shape=act_shape,
        act_dtype=as_dtype(cfg.compute_dtype), device=model.device,
        seeds=seeds, train=grads is not None, store=store, cotangent=ct,
        aux_cotangent=ct * coeff)


def stage_ticks(run: StageRun, schedule: str, phase: str) -> list:
    """The run's stage's column of the timetable."""
    return timetable(run.pp, run.vpp, run.n_micro, schedule,
                     phase)[run.stage]


def _over_pp(t: torch.Tensor, mesh) -> torch.Tensor:
    return t if mesh is None else collectives.all_reduce(t, mesh,
                                                         PIPELINE_AXIS)


def run_pipeline(model, streams: dict, cfg: ModelConfig, mesh, *, intake,
                 chunk, head, act_shape: tuple, seeds: Optional[list] = None,
                 cotangent_seed=1.0, store_activations: bool = False,
                 vpp: int = 1, schedule: str = "1f1b",
                 stacked: str = "transformer") -> tuple:
    """One training pass of the pipeline over `streams` ([n_micro, ...]
    tensors) on this stage, the 1F1B or gpipe schedule with the head.
    Returns (loss, grads, run): the mean over microbatches of the heads'
    losses plus moe_aux_loss_coeff times the router loss, summed over pp
    (every rank gets it); {name: fp32 grad} of every parameter, the grads
    of cotangent_seed times the loss, the shared leaves' summed over pp;
    and the StageRun."""
    grads = StageGrads(model, (stacked,), vpp)
    try:
        run = make_stage_run(
            model, streams, cfg, mesh, intake=intake, chunk=chunk,
            head=head, act_shape=act_shape, vpp=vpp, seeds=seeds,
            grads=grads, store=store_activations or schedule == "gpipe",
            cotangent_seed=cotangent_seed, stacked=stacked)
        run.run(stage_ticks(run, schedule, "both"))
    finally:
        out = grads.close()
    coeff = cfg.moe_aux_loss_coeff if cfg.num_experts > 1 else 0.0
    both = _over_pp(torch.stack([run.loss, run.aux]), mesh)
    loss = (both[0] + coeff * both[1]) / run.n_micro
    return loss, reduce_shared(out, (stacked,), mesh), run


def pipeline_apply(model, streams: dict, cfg: ModelConfig, mesh, *,
                   intake_fn, chunk_fn, act_shape: tuple, vpp: int = 1,
                   seeds: Optional[list] = None,
                   grads: Optional[StageGrads] = None,
                   stacked: str = "transformer") -> StageRun:
    """The lockstep fill-drain forward over pp (the reference's
    `pipeline_apply`): returns this stage's StageRun, whose `outputs` hold
    the last stage's output of each microbatch (nothing elsewhere) and
    whose `aux` is the router loss of this stage's chunks over the real
    microbatches (sum it over pp). With `grads` the forward keeps its
    graphs: set the run's `top` to the outputs' grads on the last stage
    and run the gpipe backward (`pipeline_backward`)."""
    run = make_stage_run(model, streams, cfg, mesh, intake=intake_fn,
                         chunk=chunk_fn, head=None, act_shape=act_shape,
                         vpp=vpp, seeds=seeds, grads=grads, stacked=stacked)
    with torch.set_grad_enabled(grads is not None):
        return run.run(stage_ticks(run, "gpipe", "fwd"))


def pipeline_backward(run: StageRun) -> StageRun:
    """The gpipe backward of a `pipeline_apply` run with grads."""
    return run.run(stage_ticks(run, "gpipe", "bwd"))


def pipeline_eval_loss(model, streams: dict, cfg: ModelConfig, mesh, *,
                       intake_fn, chunk_fn, head_loss_fn, act_shape: tuple,
                       vpp: int = 1, stacked: str = "transformer"
                       ) -> torch.Tensor:
    """A spec's loss, forward only: `pipeline_apply`, then the head on the
    last stage's outputs; the mean over microbatches plus the router
    loss, on every rank."""
    with torch.no_grad():
        run = pipeline_apply(model, streams, cfg, mesh, intake_fn=intake_fn,
                             chunk_fn=chunk_fn, act_shape=act_shape,
                             vpp=vpp, stacked=stacked)
        total = _head_sum(model, run.outputs, streams, head_loss_fn)
        coeff = cfg.moe_aux_loss_coeff if cfg.num_experts > 1 else 0.0
        both = _over_pp(torch.stack([total, run.aux]), mesh)
    return (both[0] + coeff * both[1]) / run.n_micro


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, torch.Tensor):
            yield v
        else:
            yield from _leaves(v)


def chunk_views(tree, vpp: int) -> list:
    """The chunk trees of a stacked subtree, as plain views (no grad)."""
    def cut(c):
        def walk(node):
            out = {}
            for k, v in node.items():
                if isinstance(v, torch.Tensor):
                    lc = v.shape[0] // vpp
                    out[k] = v.detach()[c * lc:(c + 1) * lc]
                else:
                    out[k] = walk(v)
            return out
        return walk(tree)
    return [cut(c) for c in range(vpp)]


# --- the decoder LM's spec ------------------------------------------------------------

def gpt_1f1b_fns(cfg: ModelConfig, rope=None, deterministic: bool = True,
                 cp_pre_zigzag: bool = False, mesh=None) -> tuple:
    """(intake, chunk, head_loss) of the decoder LM: the embedding intake
    (`lm_intake`, with its dropout), the causal stack, and the final norm,
    LM head and masked-mean cross-entropy of one microbatch, divided by
    the stream's "count" (the whole microbatch's mask count under a mesh)
    or the mask's own. `cp_pre_zigzag`: the streams are in the ring's
    zigzag order (`gpt_1f1b_streams`)."""
    from megatron_tpu_torch.models import language_model as lm
    from megatron_tpu_torch.models import transformer as tfm
    from megatron_tpu_torch.ops.cross_entropy import mesh_cross_entropy

    def intake(model, sl, seed):
        x, _ = lm.lm_intake(
            model, sl["inputs"], cfg, position_ids=sl["position_ids"],
            deterministic=deterministic or seed is None,
            generator=None if seed is None else seeded(fold_seed(seed, 0)),
            mesh=mesh, cp_pre_zigzag=cp_pre_zigzag)
        return x

    def chunk(cp, h, sl, offset, seed, remat=True):
        x, _, aux = tfm.stack_apply(
            cp, h, cfg, rope_cos=rope.cos if rope else None,
            rope_sin=rope.sin if rope else None,
            position_ids=sl["position_ids"],
            segment_ids=sl.get("segment_ids"),
            deterministic=deterministic or seed is None,
            layer_seed=None if seed is None else fold_seed(seed, 1),
            layer_offset=offset, mesh=mesh, cp_pre_zigzag=cp_pre_zigzag,
            remat=remat)
        return x, aux

    def head_loss(model, h, sl, seed):
        logits = lm.head_logits(model, h, cfg, mesh=mesh)
        losses = mesh_cross_entropy(logits, sl["labels"], mesh,
                                    vocab_size=cfg.vocab_size)
        mask = sl["loss_mask"].to(losses.dtype)
        count = sl["count"] if "count" in sl else mask.sum()
        return (losses * mask).sum() / torch.clamp(count, min=1.0)

    return intake, chunk, head_loss


def gpt_1f1b_streams(tokens: torch.Tensor, cfg: ModelConfig, loss_mask=None,
                     position_ids=None, segment_ids=None,
                     zigzag_cp: int = 0, mesh=None, counts=None) -> dict:
    """The decoder LM's streams from [n_micro, b, s+1] token blocks (a
    [n_micro, b, s+1] loss_mask drops its first column): inputs, labels,
    loss_mask, position_ids (made when absent), segment_ids when given,
    and each microbatch's mask count ("count": `counts`, or the mask's
    own). `zigzag_cp > 0` permutes every per-token stream into the ring's
    zigzag order once (positions made first, so RoPE and learned
    positions see the original ones). On a mesh with cp > 1 each stream
    is then cut to the rank's cp chunk."""
    from megatron_tpu_torch.parallel.ring_attention import zigzag_permutation
    from megatron_tpu_torch.parallel.sharding import cp_positions
    inputs, labels = tokens[..., :-1], tokens[..., 1:]
    n_micro, b, s = inputs.shape
    if loss_mask is None:
        loss_mask = torch.ones(n_micro, b, s, dtype=torch.float32,
                               device=tokens.device)
    elif loss_mask.shape[-1] == tokens.shape[-1]:
        loss_mask = loss_mask[..., 1:]
    if counts is None:
        counts = loss_mask.float().sum(dim=(1, 2))
    if position_ids is None:
        position_ids = torch.arange(s, device=tokens.device).expand(
            n_micro, b, s)
    streams = {"inputs": inputs, "labels": labels, "loss_mask": loss_mask,
               "position_ids": position_ids, "segment_ids": segment_ids}
    if zigzag_cp > 0:
        perm = torch.from_numpy(zigzag_permutation(s, zigzag_cp)[0]).to(
            tokens.device)
        streams = {k: None if v is None else v[..., perm]
                   for k, v in streams.items()}
    if mesh is not None and mesh.shape[CONTEXT_AXIS] > 1:
        rows = cp_positions(s, mesh)
        streams = {k: None if v is None else v[..., rows]
                   for k, v in streams.items()}
    streams["count"] = counts
    return streams


def pipeline_train_1f1b(model, streams: dict, cfg: ModelConfig, mesh, *,
                        intake_fn, chunk_fn, head_loss_fn, act_shape: tuple,
                        seeds: Optional[list] = None, cotangent_seed=1.0,
                        store_activations: bool = False, vpp: int = 1,
                        schedule: str = "1f1b",
                        stacked: str = "transformer") -> tuple:
    """The pipelined forward and backward of one step (the reference's
    `pipeline_train_1f1b`, its interleaved variant for vpp > 1, and with
    `schedule` "gpipe" the lockstep schedule with its derived backward).
    Returns (loss, {name: fp32 grad}) on every stage; the grads are this
    rank's parts, the shared leaves' summed over pp, and are the grads of
    `cotangent_seed` times the loss."""
    loss, grads, _ = run_pipeline(
        model, streams, cfg, mesh, intake=intake_fn, chunk=chunk_fn,
        head=head_loss_fn, act_shape=act_shape, seeds=seeds,
        cotangent_seed=cotangent_seed, store_activations=store_activations,
        vpp=vpp, schedule=schedule, stacked=stacked)
    return loss, grads


def pipeline_transformer(model, streams: dict, cfg: ModelConfig, mesh, *,
                         rope=None, vpp: int = 1,
                         cp_pre_zigzag: bool = False) -> tuple:
    """The decoder LM's stack pipelined over pp, forward only (the
    reference's `pipeline_transformer`): `gpt_1f1b_streams`' streams
    through the embedding intake and the causal chunks. Returns (the last
    stage's output of each microbatch, {} elsewhere; the router loss over
    every stage and real microbatch)."""
    intake, chunk, _ = gpt_1f1b_fns(cfg, rope, True, cp_pre_zigzag, mesh)
    with torch.no_grad():
        run = pipeline_apply(
            model, streams, cfg, mesh, intake_fn=intake, chunk_fn=chunk,
            act_shape=boundary_shape(mesh, streams["inputs"].shape[1],
                                     streams["inputs"].shape[-1],
                                     cfg.hidden_size), vpp=vpp)
    return run.outputs, _over_pp(run.aux, mesh)


def pipeline_loss_fn(model, tokens: torch.Tensor, cfg: ModelConfig, mesh, *,
                     vpp: int = 1, loss_mask=None, rope=None,
                     position_ids=None, segment_ids=None,
                     counts=None) -> torch.Tensor:
    """The decoder LM's loss with the stack pipelined over pp, forward
    only (the eval path): `pipeline_transformer`, then the final norm,
    head and masked-mean cross-entropy of each microbatch on the last
    stage; the mean over microbatches plus the router loss, on every
    rank. `tokens` [n_micro, b, s+1] are the rank's dp rows, `counts` each
    microbatch's whole mask count under dp."""
    from megatron_tpu_torch.models import language_model as lm
    from megatron_tpu_torch.parallel.ring_attention import data_zigzag_cp
    if rope is None:
        rope = lm.make_rope(cfg, device=tokens.device)
    zz = data_zigzag_cp(cfg, tokens.shape[-1] - 1, mesh,
                        segment_ids=segment_ids)
    streams = gpt_1f1b_streams(tokens, cfg, loss_mask, position_ids,
                               segment_ids, zz, mesh, counts)
    outputs, aux = pipeline_transformer(model, streams, cfg, mesh,
                                        rope=rope, vpp=vpp,
                                        cp_pre_zigzag=zz > 0)
    _, _, head = gpt_1f1b_fns(cfg, rope, True, zz > 0, mesh)
    with torch.no_grad():
        total = _over_pp(_head_sum(model, outputs, streams, head), mesh)
    coeff = cfg.moe_aux_loss_coeff if cfg.num_experts > 1 else 0.0
    return (total + coeff * aux) / tokens.shape[0]
