"""The training step: microbatch accumulation, then the optimizer
(megatron_tpu/training/train_step.py, the unsharded, unpipelined step).

The reference scans `value_and_grad(lm.loss_fn)` over the microbatches and
sums fp32 grads of `loss * scale / n_micro`. The port runs the same loop on
the host: each microbatch's backward accumulates into the fp32 `.grad` of
the master weights, which is that same sum. Then `_finish_step` takes the
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
its `stacked_prefixes` name the stacked [L, ...] leaves. A mesh and the
pipelined steps belong to the multi-device slice and raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.profiler import record_function

from megatron_tpu_torch.config import MegatronConfig, as_dtype
from megatron_tpu_torch.models import language_model as lm
from megatron_tpu_torch.training import optimizer as opt
from megatron_tpu_torch.training import scheduler
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device


# profiler spans (tools/profile_training.py reads their device time); a
# span costs a few microseconds a step when no profiler runs
SPAN_FORWARD_BACKWARD = "train_step.forward_backward"
SPAN_OPTIMIZER = "train_step.optimizer"


@dataclass
class TrainState:
    # fp32 master weights, trainable: a LanguageModel, or another family's
    # module under the JAX tree's names
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


def state_from_params(params: torch.nn.Module,
                      cfg: MegatronConfig) -> TrainState:
    """A fresh TrainState around a model: its parameters become trainable
    and fp16 compute seeds the dynamic loss scaler."""
    params.requires_grad_(True)
    compute = (torch.float16 if cfg.model.compute_dtype == "float16"
               else torch.float32)
    return TrainState(params=params,
                      opt_state=opt.init_optimizer(named_params(params),
                                                   cfg.optimizer, compute),
                      iteration=0)


def init_train_state(cfg: MegatronConfig, *, seed: int = 0,
                     device: DeviceLike = None) -> TrainState:
    """Random weights from `seed` on `device` (the current CUDA device when
    None; raises without one)."""
    model = lm.LanguageModel(cfg.model, device=device, seed=seed,
                             trainable=True)
    return state_from_params(model, cfg)


def train_step(state: TrainState, batch: dict,
               generator: Optional[torch.Generator] = None, *,
               cfg: MegatronConfig, rope: Optional[lm.RopeTables] = None,
               wd_mask: Optional[dict] = None, loss_fn=None):
    """One iteration over the batch's microbatches. Returns (state, updated
    in place, metrics). `loss_fn(model, mb, generator)`, when given,
    replaces the LM loss on each microbatch slice `mb` of the batch."""
    mcfg = cfg.model
    model = state.params
    params = named_params(model)
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
    with record_function(SPAN_FORWARD_BACKWARD):
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
                                  segment_ids=part("segment_ids"))
            (loss * scale / n_micro).backward()
            loss_sum += loss.detach()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in params.items()}
    with record_function(SPAN_OPTIMIZER):
        out = _finish_step(state, grads, loss_sum / n_micro, cfg, wd_mask)
    for p in params.values():
        p.grad = None
    return out


def _finish_step(state: TrainState, grads: dict, loss: torch.Tensor,
                 cfg: MegatronConfig, wd_mask: Optional[dict]):
    """The optimizer tail: lr/wd schedule, apply, metrics."""
    lr = scheduler.learning_rate(state.iteration, cfg.optimizer,
                                 cfg.training)
    wd = scheduler.weight_decay(state.iteration, cfg.optimizer, cfg.training)
    params = named_params(state.params)
    state.opt_state, ometrics = opt.apply_optimizer(
        params, grads, state.opt_state, cfg.optimizer, lr, wd,
        wd_mask=wd_mask)
    state.iteration += 1
    metrics = {"lm_loss": loss, "lr": lr, "wd": wd, **ometrics}
    if cfg.training.log_params_norm:
        with torch.no_grad():
            metrics["params_norm"] = opt.global_grad_norm(params)
    return state, metrics


def make_train_step(cfg: MegatronConfig, mesh=None, *, loss_fn=None,
                    init_params_fn=None, pipelined_spec=None,
                    pipelined_loss_fn=None, device: DeviceLike = None):
    """The training step of `cfg` on `device` (the current CUDA device when
    None; raises without one): `step(state, batch, generator=None) ->
    (state, metrics)`, updating the state in place. `loss_fn(model, mb,
    generator)` replaces the LM loss (see the module's note). The
    reference's `init_params_fn` gives its weight-decay mask the model's
    tree; the port reads the mask off the state's module, so the keyword
    is accepted, for the reference's signature, and ignored."""
    del init_params_fn
    if mesh is not None:
        raise NotImplementedError("make_train_step: a mesh (tensor, "
                                  "pipeline, data parallelism) is ported "
                                  "with the multi-device slice")
    if pipelined_spec is not None or pipelined_loss_fn is not None:
        raise NotImplementedError("make_train_step: pipelined steps are "
                                  "ported with the multi-device slice")
    if as_dtype(cfg.model.params_dtype) != torch.float32:
        raise NotImplementedError("make_train_step: the port trains fp32 "
                                  "master weights (params_dtype float32)")
    device = resolve_device(device)
    rope = (None if loss_fn is not None
            else lm.make_rope(cfg.model, device=device))
    masks: dict = {}

    def step(state: TrainState, batch: dict,
             generator: Optional[torch.Generator] = None):
        if state.params.device != device:
            raise ValueError(f"train step built for {device}, state on "
                             f"{state.params.device}")
        family = type(state.params)
        if family not in masks:
            masks[family] = weight_decay_mask(state.params)
        return train_step(state, batch, generator, cfg=cfg, rope=rope,
                          wd_mask=masks[family], loss_fn=loss_fn)

    return step
