"""Adam/SGD with the reference's step semantics
(megatron_tpu/training/optimizer.py).

Parameters are fp32 master weights that the model casts to the compute
dtype at use; grads arrive in fp32. The state keeps mu and nu as dicts keyed
by the model's state_dict names ("transformer.attention.wq"). One step:

  1. unscale grads by the loss scale;
  2. global L2 norm; found_inf = the norm is not finite;
  3. clip by the global norm (coeff = min(max_norm / (norm + 1e-6), 1));
  4. Adam (AdamW-style decoupled decay) or SGD with momentum; on found_inf
     the whole update is skipped;
  5. one tick of the dynamic loss-scale automaton.

Unlike the reference, which builds new arrays, the port updates in place:
the grads are unscaled and clipped where they lie, and every parameter and
moment is overwritten, a flat chunk at a time so that no temporary exceeds
CHUNK elements. The skip is a device-side `torch.where` against the
found_inf flag, so the step makes no host sync.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import torch

from megatron_tpu_torch.config import OptimizerConfig

# elements per in-place update chunk (64 MB of fp32)
CHUNK = 1 << 24

# Names that never take weight decay: biases and norm parameters, whatever
# their rank (GLU biases are [2, ffn]); optimizer.py:84-85
_NO_DECAY_NAMES = frozenset(
    {"b1", "b2", "bq", "bkv", "bo", "bias", "scale", "offset"})
# state_dict prefix of the stacked [num_layers, ...] leaves
STACKED_PREFIX = "transformer."


@dataclass
class ScalerState:
    """Dynamic loss-scale automaton: fp32 scale, int32 growth tracker and
    hysteresis, as 0-d device tensors."""
    scale: torch.Tensor
    growth_tracker: torch.Tensor
    hysteresis: torch.Tensor


@dataclass
class OptState:
    step: torch.Tensor  # int32: count of applied steps (Adam's t)
    mu: dict            # name -> fp32 first moment
    nu: Optional[dict]  # name -> fp32 second moment (Adam only)
    scaler: ScalerState


def init_scaler(cfg: OptimizerConfig, compute_dtype=torch.float32,
                device=None) -> ScalerState:
    if cfg.loss_scale is not None:
        scale = float(cfg.loss_scale)
    elif compute_dtype == torch.float16:
        scale = float(cfg.initial_loss_scale)
    else:
        scale = 1.0  # bf16/fp32 train unscaled
    return ScalerState(
        scale=torch.tensor(scale, dtype=torch.float32, device=device),
        growth_tracker=torch.zeros((), dtype=torch.int32, device=device),
        hysteresis=torch.tensor(cfg.hysteresis, dtype=torch.int32,
                                device=device))


def init_optimizer(params: Mapping[str, torch.Tensor], cfg: OptimizerConfig,
                   compute_dtype=torch.float32) -> OptState:
    device = next(iter(params.values())).device
    mu = {k: torch.zeros_like(p, dtype=torch.float32)
          for k, p in params.items()}
    nu = ({k: torch.zeros_like(p, dtype=torch.float32)
           for k, p in params.items()} if cfg.optimizer == "adam" else None)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=mu, nu=nu,
                    scaler=init_scaler(cfg, compute_dtype, device))


def weight_decay_mask(params: Mapping[str, torch.Tensor],
                      stacked=(STACKED_PREFIX,)) -> dict:
    """name -> True where weight decay applies: named biases and norm
    parameters never, otherwise leaves that are >= 2-D per layer. The
    leading [num_layers] dim of the stacked leaves (names starting with a
    prefix of `stacked`: a LanguageModel's transformer, T5's encoder and
    decoder) does not count, so a stacked norm scale [L, h] stays
    exempt."""
    prefixes = tuple(stacked)
    mask = {}
    for name, p in params.items():
        if name.rsplit(".", 1)[-1] in _NO_DECAY_NAMES:
            mask[name] = False
        else:
            mask[name] = p.dim() - (1 if name.startswith(prefixes)
                                    else 0) >= 2
    return mask


def _chunks(t: torch.Tensor):
    return t.view(-1).split(CHUNK)


def global_grad_norm(grads) -> torch.Tensor:
    """Global L2 norm over every leaf: the square root of the summed fp32
    squares, on the device, a chunk at a time."""
    leaves = list(grads.values()) if isinstance(grads, Mapping) else grads
    squares = [c.float().square().sum() for g in leaves for c in _chunks(g)]
    return torch.stack(squares).sum().sqrt()


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None):
    """Scales the grads in place by min(max_norm / (norm + 1e-6), 1);
    returns (grads, norm)."""
    if norm is None:
        norm = global_grad_norm(grads)
    coeff = torch.clamp(max_norm / (norm + 1.0e-6), max=1.0)
    for g in grads.values():
        g.mul_(coeff)
    return grads, norm


def count_zeros(grads) -> torch.Tensor:
    leaves = list(grads.values()) if isinstance(grads, Mapping) else grads
    return torch.stack([(g == 0.0).sum() for g in leaves]).sum().to(
        torch.int32)


def _update_scaler(s: ScalerState, cfg: OptimizerConfig,
                   found_inf: torch.Tensor) -> ScalerState:
    """One tick of the reference's automaton: an overflow zeroes the growth
    tracker and spends hysteresis, backing off the scale once it is spent
    (it is restored only by a growth); `loss_scale_window` good steps in a
    row double the scale. A constant `loss_scale` never changes."""
    if cfg.loss_scale is not None:
        return s
    hys = torch.where(found_inf, s.hysteresis - 1, s.hysteresis)
    do_backoff = found_inf & (hys <= 0)
    new_scale = torch.where(
        do_backoff, torch.clamp(s.scale * 0.5, min=cfg.min_loss_scale),
        s.scale)
    tracker = torch.where(found_inf, torch.zeros_like(s.growth_tracker),
                          s.growth_tracker + 1)
    do_grow = ~found_inf & (tracker >= cfg.loss_scale_window)
    new_scale = torch.where(do_grow, new_scale * 2.0, new_scale)
    hys = torch.where(do_grow, torch.full_like(hys, cfg.hysteresis), hys)
    tracker = torch.where(do_grow, torch.zeros_like(tracker), tracker)
    return ScalerState(new_scale, tracker, hys)


@torch.no_grad()
def apply_optimizer(params: Mapping[str, torch.Tensor],
                    grads: Mapping[str, torch.Tensor], opt_state: OptState,
                    cfg: OptimizerConfig, lr: float, wd: float,
                    wd_mask: Optional[Mapping[str, bool]] = None):
    """One Megatron optimizer step, in place on `params`, `grads` and the
    moments of `opt_state`. params and grads are name -> tensor dicts with
    the same names; grads are fp32 and contiguous. Returns (opt_state with
    the new step and scaler, metrics {grad_norm, found_inf (0/1 int32),
    loss_scale, and num_zeros when cfg.log_num_zeros_in_grad}), all device
    tensors."""
    for g in grads.values():
        g.mul_(1.0 / opt_state.scaler.scale)
    norm = global_grad_norm(grads)
    found_inf = ~torch.isfinite(norm)
    if cfg.clip_grad > 0.0:
        clip_by_global_norm(grads, cfg.clip_grad, norm)
    step = opt_state.step + (~found_inf).to(torch.int32)
    if wd_mask is None:
        wd_mask = weight_decay_mask(params)

    if cfg.optimizer == "adam":
        b1, b2, eps = cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps
        t = step.float()
        bc1 = 1.0 - torch.pow(torch.tensor(b1, device=t.device), t)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, device=t.device), t)
        for name, p in params.items():
            decay = wd_mask[name]
            for pc, gc, mc, vc in zip(_chunks(p), _chunks(grads[name]),
                                      _chunks(opt_state.mu[name]),
                                      _chunks(opt_state.nu[name])):
                m_new = b1 * mc + (1.0 - b1) * gc
                v_new = b2 * vc + (1.0 - b2) * gc.square()
                delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
                if decay:
                    delta = delta + wd * pc
                p_new = pc - lr * delta
                pc.copy_(torch.where(found_inf, pc, p_new))
                mc.copy_(torch.where(found_inf, mc, m_new))
                vc.copy_(torch.where(found_inf, vc, v_new))
    elif cfg.optimizer == "sgd":
        mom = cfg.sgd_momentum
        for name, p in params.items():
            decay = wd_mask[name]
            for pc, gc, mc in zip(_chunks(p), _chunks(grads[name]),
                                  _chunks(opt_state.mu[name])):
                g = gc + wd * pc if decay else gc
                m_new = mom * mc + g
                p_new = pc - lr * m_new
                pc.copy_(torch.where(found_inf, pc, p_new))
                mc.copy_(torch.where(found_inf, mc, m_new))
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")

    metrics = {"grad_norm": norm, "found_inf": found_inf.to(torch.int32),
               "loss_scale": opt_state.scaler.scale}
    if cfg.log_num_zeros_in_grad:
        metrics["num_zeros"] = count_zeros(grads)
    new_state = OptState(step=step, mu=opt_state.mu, nu=opt_state.nu,
                         scaler=_update_scaler(opt_state.scaler, cfg,
                                               found_inf))
    return new_state, metrics
