"""The training step: microbatch accumulation, then the optimizer
(megatron_tpu/training/train_step.py, the unsharded, unpipelined step).

The reference scans `value_and_grad(lm.loss_fn)` over the microbatches and
sums fp32 grads of `loss * scale / n_micro`. The port runs the same loop on
the host: each microbatch's backward accumulates into the `.grad` of an fp32
master weight, which is that same sum. A bf16 or fp16 master weight's
`.grad` comes in its own dtype, as the reference's per-microbatch grad does;
summing microbatches there would round every partial sum, so a hook adds
each microbatch's grad to an fp32 buffer as soon as it lands and frees it
(`_Fp32Grads`). Then `_finish_step` takes the
lr and wd of the iteration from the scheduler and applies the optimizer in
place (training/optimizer.py). The step makes no host sync of its own;
its metrics are device tensors, except lr and wd, which the host knows.

`make_train_step(cfg)` returns `step(state, batch, generator=None) ->
(state, metrics)`. The batch is a dict of tensors with a leading
microbatch dim: "tokens" [n_micro, b, s+1] and optionally "loss_mask"
[n_micro, b, s], "position_ids" and "segment_ids" [n_micro, b, s].

A custom loss (`make_train_step(cfg, loss_fn=...)`, the BERT and T5 entry
points) takes each microbatch's slice of every batch entry instead:
`loss_fn(model, mb, generator)` returns the microbatch's scalar loss and
decides itself whether dropout runs. The state's model is then any module
whose parameters carry the JAX tree's names (models/bert.py BertModel,
models/t5.py T5Model), and the weight-decay mask comes from that module:
its `stacked_prefixes` name the stacked [L, ...] leaves.

`make_train_step(cfg, mesh=...)` runs the step sharded over the (dp, cp,
tp) mesh (parallel/), on a state whose model was built on that mesh
(`init_train_state(cfg, mesh=...)`, or a BERT, T5 or biencoder module
built with `mesh=`): each rank holds its parts of the weights and takes
its dp rows of the global batch, which every rank is handed alike
(parallel/multihost.py `make_global_batch`), and its cp chunk of the
sequence. The step writes by hand the collectives that GSPMD derives for
the reference (megatron_tpu/training/train_step.py):
- each microbatch's masked-mean LM loss divides by the whole microbatch's
  mask count, so the (dp, cp) ranks' losses sum to the unsharded one. A
  custom `loss_fn` under a mesh returns the same kind of share: the
  rank's part of the global microbatch's loss (models/bert.py, t5.py,
  biencoder.py compute it so), and the loss is summed over dp and cp;
- the grads of replicated leaves whose grads are partial over tp (every
  replicated leaf under sequence parallelism: the norms, the row-parallel
  biases, the position embeddings; the replicated kv leaves when tp > nkv;
  the MoE router when the experts are cut over tp) are all-reduced over
  tp;
- every grad is all-reduced over cp, whose ranks hold the same weights,
  and over dp, or with the distributed optimizer (ZeRO-1)
  reduce-scattered on its ZeRO dim (parallel/sharding.py
  `distributed_opt_dim`): that rank updates its dp share of the leaf with
  its share of the fp32 moments, and the shares are all-gathered back
  into the parameter. A leaf with no ZeRO dim keeps whole moments. An
  expert bank cut over dp holds whole grads of its own experts, which are
  neither reduced over dp nor cut again;
- the grad norm, found_inf and the zero count are taken over the world
  (training/optimizer.py `GradShards`), and lm_loss is summed over dp and
  cp, so every rank reports and decides the same.
Dropout draws the unsharded step's masks from the same generator and
keeps the rank's slice (models/transformer.py), so with one generator the
sharded step equals the unsharded one up to the order of the sums.
Recompute runs under the mesh as without it.

On a mesh with pp > 1 the step is pipelined (parallel/pipeline.py), as
the reference's `make_train_step` dispatches it:
- the LM (`pipelined_train_step`): the 1F1B schedule (interleaved for
  vpp > 1, store or recompute mode) or gpipe, on the streams of the
  rank's dp rows and cp chunk (zigzag-permuted when the ring runs);
- a custom loss with a `pipelined_spec` (`custom_pipelined_train_step`,
  BERT's `bert_1f1b_fns`): the 1F1B core on the batch's streams; gpipe
  raises, as in the reference;
- a custom loss with a `pipelined_loss_fn` (`derived_pipelined_train_step`,
  T5's `t5_pipeline_loss_fn`), which runs its own passes and backward;
- a custom `loss_fn` with neither raises.
The shared leaves' grads are summed over pp (the schedule does it), the
norm counts each shared leaf once (pp coordinate 0) and each stage's
layers on their stage, ZeRO-1 cuts only the stacked leaves (the
reference's `pipelined=True`), and the loss reaches every rank. Dropout
draws one seed per microbatch from the generator and seeds each layer
from it (parallel/pipeline.py), so a pipelined step's masks are the same
at any (pp, vpp) and schedule, but not those of the unpipelined step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.profiler import record_function

from megatron_tpu_torch.config import MegatronConfig
from megatron_tpu_torch.models import language_model as lm
from megatron_tpu_torch.ops.dropout import draw_seeds
from megatron_tpu_torch.parallel import collectives
from megatron_tpu_torch.parallel import sharding as shd
from megatron_tpu_torch.parallel.mesh import (CONTEXT_AXIS, DATA_AXIS,
                                              PIPELINE_AXIS, TENSOR_AXIS,
                                              Mesh)
from megatron_tpu_torch.parallel.multihost import make_global_batch
from megatron_tpu_torch.training import optimizer as opt
from megatron_tpu_torch.training import scheduler
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device


# profiler spans (tools/profile_training.py reads their device time); a
# span costs a few microseconds a step when no profiler runs
SPAN_FORWARD_BACKWARD = "train_step.forward_backward"
SPAN_OPTIMIZER = "train_step.optimizer"


@dataclass
class TrainState:
    # the master weights, trainable, in cfg.model.params_dtype (fp32, bf16
    # or fp16; the optimizer's moments are fp32 whatever it is): a
    # LanguageModel, or another family's module under the JAX tree's names
    params: torch.nn.Module
    opt_state: opt.OptState
    iteration: int  # completed iterations, skipped ones included


def named_params(model: torch.nn.Module) -> dict:
    """name -> parameter, under the state_dict names."""
    return dict(model.named_parameters())


def weight_decay_mask(model: torch.nn.Module) -> dict:
    """The optimizer's weight-decay mask of a model: the leaves under its
    `stacked_prefixes` (a LanguageModel's "transformer.") carry a layers
    dim that does not count toward the >= 2-D rule."""
    return opt.weight_decay_mask(dict(model.state_dict()),
                                 stacked=model.stacked_prefixes)


@dataclass(frozen=True)
class LeafLayout:
    """Where one leaf of a sharded model lies: its logical axes (the
    reference's, the model's `param_axes`), whether its tp part is a cut
    (`tp_cut`), whether its grads are partial sums over tp
    (`tp_partial`), whether it is cut over dp (`dp_cut`, an expert bank on
    dp), its ZeRO-1 dim, whether this rank counts its grad in the norm
    (`owned`, optimizer.GradShards), and whether it is cut over pp
    (`pp_cut`, a stacked leaf under the pipeline)."""
    axes: tuple
    tp_cut: bool
    tp_partial: bool
    zero_dim: Optional[int]
    owned: bool
    dp_cut: bool = False
    pp_cut: bool = False


def state_layout(model: torch.nn.Module) -> dict:
    """name -> LeafLayout of a model built on a mesh (a LanguageModel, or
    another family's module with its `param_axes`)."""
    mesh, cfg = model.mesh, model.cfg
    nkv = cfg.num_kv_heads
    tp = mesh.shape[TENSOR_AXIS]
    experts_on_tp = mesh.parallel.expert_axis == "tp"
    out = {}
    for name, ax in lm.flat_axes(model.param_axes()).items():
        p = model.get_parameter(name)
        cut = shd.tp_sharded(ax, mesh, nkv)
        dp_cut = bool(shd.dp_dims(ax, mesh))
        zero = shd.distributed_opt_dim(ax, tuple(p.shape), mesh)
        router = name.endswith("mlp.router") and cfg.num_experts > 1
        pp_cut = bool(shd.pp_dims(ax, mesh))
        out[name] = LeafLayout(
            axes=ax, tp_cut=cut, dp_cut=dp_cut, pp_cut=pp_cut,
            tp_partial=(not cut and tp > 1
                        and (mesh.sequence_parallel or "kv_heads" in ax
                             or (router and experts_on_tp))),
            zero_dim=zero,
            owned=((cut or mesh.coords[TENSOR_AXIS] == 0)
                   and (zero is not None or dp_cut
                        or mesh.coords[DATA_AXIS] == 0)
                   and (pp_cut or mesh.coords[PIPELINE_AXIS] == 0)
                   and mesh.coords[CONTEXT_AXIS] == 0))
    return out


def replica_owned(layout: dict, mesh: Mesh) -> dict:
    """name -> whether this rank counts its copy of the parameter: one
    replica of each part (the tp parts, an expert bank's dp parts, each
    stage's layers) over the world."""
    return {k: ((leaf.tp_cut or mesh.coords[TENSOR_AXIS] == 0)
                and (leaf.dp_cut or mesh.coords[DATA_AXIS] == 0)
                and (leaf.pp_cut or mesh.coords[PIPELINE_AXIS] == 0)
                and mesh.coords[CONTEXT_AXIS] == 0)
            for k, leaf in layout.items()}


def zero_share(t: torch.Tensor, leaf: LeafLayout, mesh: Mesh
               ) -> torch.Tensor:
    """This rank's ZeRO-1 share of a leaf-shaped tensor (the tensor itself
    when the leaf has no ZeRO dim)."""
    if leaf.zero_dim is None:
        return t
    return shd.shard_dp(t, leaf.zero_dim, mesh)


def sum_loss(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A rank's share of a loss summed over the ranks that split the
    batch: dp and cp."""
    return collectives.all_reduce(collectives.all_reduce(t, mesh, DATA_AXIS),
                                  mesh, CONTEXT_AXIS)


def shard_lm_batch(batch: dict, mesh: Mesh) -> tuple:
    """A global LM batch -> (this rank's dp rows of it, each microbatch's
    whole mask count [n_micro]), a missing loss_mask counting every label.
    Every rank holds the global batch, so the counts take no collective."""
    tokens = batch["tokens"]
    if "loss_mask" not in batch:
        batch = dict(batch, loss_mask=torch.ones(
            *tokens.shape[:2], tokens.shape[2] - 1, dtype=torch.float32,
            device=tokens.device))
    mask = batch["loss_mask"]
    # a [.., s+1] mask drops its first column, as loss_fn drops it
    labels = tokens.shape[2] - 1
    counts = mask[..., mask.shape[-1] - labels:].float().sum(dim=(1, 2))
    return make_global_batch(batch, mesh), counts


class _Fp32Grads:
    """fp32 grad sums of the parameters whose dtype is not fp32, filled
    while it is entered: after each backward reaches a parameter, its hook
    adds the `.grad` (in the parameter's dtype) to the buffer and frees
    it, so no more than one microbatch's low-precision grad of a leaf is
    alive at a time."""

    def __init__(self, params: dict):
        self.params = {k: p for k, p in params.items()
                       if p.dtype != torch.float32}
        self.buffers: dict = {}
        self._handles: list = []

    def _hook(self, name: str):
        def hook(p: torch.Tensor) -> None:
            buf = self.buffers.get(name)
            if buf is None:
                self.buffers[name] = p.grad.float().contiguous()
            else:
                buf.add_(p.grad)
            p.grad = None
        return hook

    def __enter__(self):
        self._handles = [p.register_post_accumulate_grad_hook(
            self._hook(k)) for k, p in self.params.items()]
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        self._handles = []


def state_from_params(params: torch.nn.Module,
                      cfg: MegatronConfig) -> TrainState:
    """A fresh TrainState around a model: its parameters become trainable
    and fp16 compute seeds the dynamic loss scaler. A model built on a
    mesh gets its moments cut to each leaf's ZeRO-1 share."""
    params.requires_grad_(True)
    compute = (torch.float16 if cfg.model.compute_dtype == "float16"
               else torch.float32)
    leaves = named_params(params)
    mesh = getattr(params, "mesh", None)
    if mesh is not None:
        layout = state_layout(params)
        leaves = {k: zero_share(p.detach(), layout[k], mesh)
                  for k, p in leaves.items()}
    return TrainState(params=params,
                      opt_state=opt.init_optimizer(leaves, cfg.optimizer,
                                                   compute),
                      iteration=0)


def init_train_state(cfg: MegatronConfig, *, seed: int = 0,
                     device: DeviceLike = None,
                     mesh: Optional[Mesh] = None) -> TrainState:
    """Random weights from `seed` on `device` (the current CUDA device when
    None; raises without one); on a `mesh`, this rank's parts of them."""
    model = lm.LanguageModel(cfg.model, device=device, seed=seed,
                             trainable=True, mesh=mesh)
    return state_from_params(model, cfg)


def train_step(state: TrainState, batch: dict,
               generator: Optional[torch.Generator] = None, *,
               cfg: MegatronConfig, rope: Optional[lm.RopeTables] = None,
               wd_mask: Optional[dict] = None, loss_fn=None,
               layout: Optional[dict] = None):
    """One iteration over the batch's microbatches. Returns (state, updated
    in place, metrics). `loss_fn(model, mb, generator)`, when given,
    replaces the LM loss on each microbatch slice `mb` of the batch. On a
    sharded state (`layout`, `state_layout`) the batch is the global one
    and the step is the module's sharded step."""
    mcfg = cfg.model
    model = state.params
    params = named_params(model)
    mesh = getattr(model, "mesh", None)
    counts = None
    if mesh is not None:
        if loss_fn is None:
            batch, counts = shard_lm_batch(batch, mesh)
        else:
            batch = make_global_batch(batch, mesh)
    # any entry's leading dim is the microbatch count (T5's batch has no
    # "tokens")
    n_micro = next(iter(batch.values())).shape[0]
    scale = state.opt_state.scaler.scale
    if loss_fn is None:
        tokens = batch["tokens"]
        if rope is None:
            rope = lm.make_rope(mcfg, device=model.device)
        deterministic = (mcfg.hidden_dropout == 0.0
                         and mcfg.attention_dropout == 0.0)
        if not deterministic and generator is None:
            raise ValueError("train_step: dropout needs a generator")
        loss_mask = batch.get("loss_mask")
        if loss_mask is None:
            loss_mask = torch.ones(tokens.shape[0], tokens.shape[1],
                                   tokens.shape[2] - 1, dtype=torch.float32,
                                   device=tokens.device)

    for p in params.values():
        p.grad = None
    loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
    low = _Fp32Grads(params)
    with record_function(SPAN_FORWARD_BACKWARD), low:
        for i in range(n_micro):
            def part(key):
                t = batch.get(key)
                return None if t is None else t[i]
            if loss_fn is not None:
                loss = loss_fn(model, {k: v[i] for k, v in batch.items()},
                               generator)
            else:
                loss = lm.loss_fn(model, tokens[i], mcfg,
                                  loss_mask=loss_mask[i], rope=rope,
                                  generator=generator,
                                  deterministic=deterministic,
                                  position_ids=part("position_ids"),
                                  segment_ids=part("segment_ids"),
                                  denominator=(None if counts is None
                                               else counts[i]))
            (loss * scale / n_micro).backward()
            loss_sum += loss.detach()

    def grad(k, p):
        g = low.buffers.get(k) if k in low.params else p.grad
        return (g if g is not None
                else torch.zeros_like(p, dtype=torch.float32))
    grads = {k: grad(k, p) for k, p in params.items()}
    if mesh is not None:
        loss_sum = sum_loss(loss_sum, mesh)
        grads = _reduce_grads(grads, layout, mesh)
    with record_function(SPAN_OPTIMIZER):
        out = _finish_step(state, grads, loss_sum / n_micro, cfg, wd_mask,
                           layout)
    for p in params.values():
        p.grad = None
    return out


def _deterministic(mcfg) -> bool:
    return mcfg.hidden_dropout == 0.0 and mcfg.attention_dropout == 0.0


def _microbatch_seeds(batch: dict, generator, mcfg) -> Optional[list]:
    """One dropout seed per microbatch from the step's generator (None
    when the model drops nothing)."""
    if _deterministic(mcfg):
        return None
    if generator is None:
        raise ValueError("train_step: dropout needs a generator")
    return draw_seeds(generator, next(iter(batch.values())).shape[0])


def _pipelined_finish(state: TrainState, loss, grads: dict,
                      cfg: MegatronConfig, wd_mask, layout: dict):
    mesh = state.params.mesh
    for p in state.params.parameters():
        p.grad = None
    loss = sum_loss(loss, mesh)
    grads = _reduce_grads(grads, layout, mesh)
    with record_function(SPAN_OPTIMIZER):
        return _finish_step(state, grads, loss, cfg, wd_mask, layout)


def pipelined_train_step(state: TrainState, batch: dict,
                         generator: Optional[torch.Generator] = None, *,
                         cfg: MegatronConfig,
                         rope: Optional[lm.RopeTables] = None,
                         wd_mask: Optional[dict] = None,
                         layout: Optional[dict] = None):
    """The LM step with the stack pipelined over pp: the 1F1B schedule
    (interleaved for vpp > 1) or, with pipeline_schedule "gpipe", the
    lockstep one (see the module's note)."""
    with record_function(SPAN_FORWARD_BACKWARD):
        loss, grads = pipelined_lm_grads(
            state.params, batch, generator, cfg, rope=rope,
            cotangent=state.opt_state.scaler.scale)
    return _pipelined_finish(state, loss, grads, cfg, wd_mask, layout)


def pipelined_lm_grads(model, batch: dict, generator, cfg: MegatronConfig,
                       *, rope: Optional[lm.RopeTables] = None,
                       cotangent=1.0, schedule: Optional[str] = None,
                       store: Optional[bool] = None) -> tuple:
    """The forward and backward of `pipelined_train_step` on a model built
    on a pipeline mesh, from the global batch: (loss, {name: fp32 grad})
    before the reductions over dp, cp and tp, the shared leaves' summed
    over pp. `schedule` and `store` override the config's."""
    from megatron_tpu_torch.parallel import pipeline as pl
    from megatron_tpu_torch.parallel.ring_attention import data_zigzag_cp
    mcfg, par = cfg.model, cfg.parallel
    mesh = model.mesh
    batch, counts = shard_lm_batch(batch, mesh)
    tokens = batch["tokens"]
    if rope is None:
        rope = lm.make_rope(mcfg, device=model.device)
    zz = data_zigzag_cp(mcfg, tokens.shape[2] - 1, mesh,
                        segment_ids=batch.get("segment_ids"))
    intake, chunk, head = pl.gpt_1f1b_fns(
        mcfg, rope, deterministic=_deterministic(mcfg),
        cp_pre_zigzag=zz > 0, mesh=mesh)
    streams = pl.gpt_1f1b_streams(
        tokens, mcfg, loss_mask=batch.get("loss_mask"),
        position_ids=batch.get("position_ids"),
        segment_ids=batch.get("segment_ids"), zigzag_cp=zz, mesh=mesh,
        counts=counts)
    return pl.pipeline_train_1f1b(
        model, streams, mcfg, mesh, intake_fn=intake, chunk_fn=chunk,
        head_loss_fn=head,
        act_shape=pl.boundary_shape(mesh, tokens.shape[1],
                                    streams["inputs"].shape[-1],
                                    mcfg.hidden_size),
        seeds=_microbatch_seeds(batch, generator, mcfg),
        cotangent_seed=cotangent,
        store_activations=(par.pipeline_store_activations if store is None
                           else store),
        vpp=par.virtual_pipeline_chunks,
        schedule=schedule or par.pipeline_schedule)


def custom_pipelined_train_step(state: TrainState, batch: dict,
                                generator: Optional[torch.Generator] = None,
                                *, cfg: MegatronConfig, spec,
                                wd_mask: Optional[dict] = None,
                                layout: Optional[dict] = None):
    """A custom-loss model (BERT) pipelined through the 1F1B core:
    `spec(model_cfg, deterministic, mesh)` -> (intake, chunk, head_loss);
    the batch's [n_micro, ...] entries, the rank's dp rows of them, are
    the streams."""
    from megatron_tpu_torch.parallel import pipeline as pl
    mcfg, par = cfg.model, cfg.parallel
    model = state.params
    mesh = model.mesh
    batch = make_global_batch(batch, mesh)
    intake, chunk, head = spec(mcfg, _deterministic(mcfg), mesh)
    tokens = batch["tokens"]
    with record_function(SPAN_FORWARD_BACKWARD):
        loss, grads = pl.pipeline_train_1f1b(
            model, batch, mcfg, mesh, intake_fn=intake, chunk_fn=chunk,
            head_loss_fn=head,
            act_shape=pl.boundary_shape(mesh, tokens.shape[1],
                                        tokens.shape[2], mcfg.hidden_size),
            seeds=_microbatch_seeds(batch, generator, mcfg),
            cotangent_seed=state.opt_state.scaler.scale,
            store_activations=par.pipeline_store_activations,
            vpp=par.virtual_pipeline_chunks)
    return _pipelined_finish(state, loss, grads, cfg, wd_mask, layout)


def derived_pipelined_train_step(state: TrainState, batch: dict,
                                 generator: Optional[torch.Generator] = None,
                                 *, cfg: MegatronConfig, pipelined_loss_fn,
                                 wd_mask: Optional[dict] = None,
                                 layout: Optional[dict] = None):
    """A model that pipelines inside its own loss (T5's two passes):
    `pipelined_loss_fn(model, batch, seeds, cotangent)` -> (loss, grads),
    the grads those of `cotangent` times the loss with the shared leaves'
    summed over pp (models/t5.py `t5_pipeline_loss_fn`)."""
    model = state.params
    batch = make_global_batch(batch, model.mesh)
    with record_function(SPAN_FORWARD_BACKWARD):
        loss, grads = pipelined_loss_fn(
            model, batch, _microbatch_seeds(batch, generator, cfg.model),
            state.opt_state.scaler.scale)
    return _pipelined_finish(state, loss, grads, cfg, wd_mask, layout)


def _reduce_grads(grads: dict, layout: dict, mesh: Mesh) -> dict:
    """A sharded step's local grads -> what this rank's optimizer takes:
    partial sums over tp all-reduced, every grad all-reduced over cp, then
    over dp (an expert bank on dp excepted), or reduce-scattered to the
    rank's share on its ZeRO dim."""
    out = {}
    for k, g in grads.items():
        leaf = layout[k]
        if leaf.tp_partial:
            g = collectives.all_reduce(g, mesh, TENSOR_AXIS)
        g = collectives.all_reduce(g, mesh, CONTEXT_AXIS)
        if leaf.dp_cut:
            pass
        elif leaf.zero_dim is None:
            g = collectives.all_reduce(g, mesh, DATA_AXIS)
        else:
            g = collectives.reduce_scatter(g, mesh, DATA_AXIS,
                                           leaf.zero_dim)
        out[k] = g.contiguous()
    return out


def _finish_step(state: TrainState, grads: dict, loss: torch.Tensor,
                 cfg: MegatronConfig, wd_mask: Optional[dict],
                 layout: Optional[dict] = None):
    """The optimizer tail: lr/wd schedule, apply, metrics. On a sharded
    state (`layout`) a ZeRO-1 leaf is updated as its dp share (a copy) and
    the shares are all-gathered back into the parameter."""
    lr = scheduler.learning_rate(state.iteration, cfg.optimizer,
                                 cfg.training)
    wd = scheduler.weight_decay(state.iteration, cfg.optimizer, cfg.training)
    params = named_params(state.params)
    mesh = getattr(state.params, "mesh", None)
    shards = None
    updated = params
    if mesh is not None:
        updated = {k: zero_share(p.detach(), layout[k], mesh)
                   for k, p in params.items()}
        shards = opt.GradShards(
            owned={k: leaf.owned for k, leaf in layout.items()},
            sum_world=lambda t: collectives.sum_world(t, mesh))
    state.opt_state, ometrics = opt.apply_optimizer(
        updated, grads, state.opt_state, cfg.optimizer, lr, wd,
        wd_mask=wd_mask, shards=shards)
    if mesh is not None:
        with torch.no_grad():
            for k, p in params.items():
                dim = layout[k].zero_dim
                if dim is not None:
                    p.copy_(shd.gather_dp(updated[k], dim, mesh))
    state.iteration += 1
    metrics = {"lm_loss": loss, "lr": lr, "wd": wd, **ometrics}
    if cfg.training.log_params_norm:
        with torch.no_grad():
            if shards is None:
                metrics["params_norm"] = opt.global_grad_norm(params)
            else:
                metrics["params_norm"] = opt.sharded_grad_norm(
                    params, opt.GradShards(
                        owned=replica_owned(layout, mesh),
                        sum_world=lambda t: collectives.sum_world(
                            t, mesh)))[0]
    return state, metrics


def make_train_step(cfg: MegatronConfig, mesh=None, *, loss_fn=None,
                    init_params_fn=None, axes_fn=None, pipelined_spec=None,
                    pipelined_loss_fn=None, device: DeviceLike = None):
    """The training step of `cfg` on `device` (the current CUDA device when
    None; raises without one): `step(state, batch, generator=None) ->
    (state, metrics)`, updating the state in place. `loss_fn(model, mb,
    generator)` replaces the LM loss (see the module's note). With a
    `mesh` (parallel/mesh.py `build_mesh`) the step is the sharded one of
    the module's note, on a state built on that mesh; with pp > 1 it is
    pipelined, a custom loss through `pipelined_spec(model_cfg,
    deterministic, mesh)` (BERT's `bert_1f1b_fns`) or
    `pipelined_loss_fn(model, batch, seeds, cotangent)` (T5's). The
    reference's
    `init_params_fn` and `axes_fn` give its weight-decay mask and its
    shardings the model's tree; the port reads both off the state's module
    (`stacked_prefixes`, `param_axes`), so the keywords are accepted, for
    the reference's signature, and ignored."""
    del init_params_fn, axes_fn
    par = cfg.parallel
    asked = (par.tensor_parallel, par.pipeline_parallel,
             par.context_parallel, par.sequence_parallel,
             par.use_distributed_optimizer, par.expert_axis)
    if mesh is None and (par.tensor_parallel > 1 or par.pipeline_parallel > 1
                         or par.context_parallel > 1):
        raise ValueError(f"make_train_step: cfg asks for tp "
                         f"{par.tensor_parallel} x pp "
                         f"{par.pipeline_parallel} x cp "
                         f"{par.context_parallel} and no mesh was given")
    custom = (loss_fn is not None or pipelined_spec is not None
              or pipelined_loss_fn is not None)
    if mesh is not None and custom and mesh.shape[CONTEXT_AXIS] > 1:
        raise NotImplementedError(
            "make_train_step: a custom loss_fn (BERT, T5, ICT) under "
            "context parallelism is not ported (ROADMAP Queue 1 item 7 "
            "(g))")
    if mesh is not None and asked != (
            mesh.shape[TENSOR_AXIS], mesh.shape[PIPELINE_AXIS],
            mesh.shape[CONTEXT_AXIS], mesh.parallel.sequence_parallel,
            mesh.use_distributed_optimizer, mesh.parallel.expert_axis):
        raise ValueError("make_train_step: the mesh was built for another "
                         "parallel config than cfg's")
    pipelined = mesh is not None and mesh.shape[PIPELINE_AXIS] > 1
    if pipelined:
        if pipelined_spec is not None:
            if par.pipeline_schedule != "1f1b":
                raise ValueError("pipelined_spec models run the 1F1B core "
                                 "only; drop --pipeline_schedule gpipe")
        elif pipelined_loss_fn is None and loss_fn is not None:
            raise ValueError(
                "pp>1 with a custom loss needs pipelined_spec (single-stack "
                "models, see models/bert.py bert_1f1b_fns) or "
                "pipelined_loss_fn (encoder-decoder, see models/t5.py "
                "t5_pipeline_loss_fn)")
    device = resolve_device(device)
    rope = (None if custom else lm.make_rope(cfg.model, device=device))
    masks: dict = {}
    layouts: list = []  # the sharded state's, made at the first step

    def step(state: TrainState, batch: dict,
             generator: Optional[torch.Generator] = None):
        if state.params.device != device:
            raise ValueError(f"train step built for {device}, state on "
                             f"{state.params.device}")
        if getattr(state.params, "mesh", None) is not mesh:
            raise ValueError("train step built for another mesh than the "
                             "state's model (build it with "
                             "init_train_state(cfg, mesh=mesh))")
        family = type(state.params)
        if family not in masks:
            masks[family] = weight_decay_mask(state.params)
        layout = None
        if mesh is not None:
            if not layouts:
                layouts.append(state_layout(state.params))
            layout = layouts[0]
        common = dict(cfg=cfg, wd_mask=masks[family], layout=layout)
        if not pipelined:
            return train_step(state, batch, generator, rope=rope,
                              loss_fn=loss_fn, **common)
        if pipelined_spec is not None:
            return custom_pipelined_train_step(
                state, batch, generator, spec=pipelined_spec, **common)
        if pipelined_loss_fn is not None:
            return derived_pipelined_train_step(
                state, batch, generator,
                pipelined_loss_fn=pipelined_loss_fn, **common)
        return pipelined_train_step(state, batch, generator, rope=rope,
                                    **common)

    return step
