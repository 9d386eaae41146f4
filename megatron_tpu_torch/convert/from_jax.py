"""Weight bridge from the JAX package's parameters and checkpoints.

The port keeps the reference's leaf names and its stacked [L, ...] layer
layout, so moving weights across is a renaming ("a/b/c" -> "a.b.c") plus
`torch.from_numpy`, with the keys and shapes checked against the model the
config describes. Nothing is reordered: the fused wkv splits into k and v
inside attention exactly as in the reference.

`train_state_from_numpy` carries a JAX training state across: the params,
the optimizer's mu, nu and step, the loss-scaler automaton and the
iteration. `train_state_to_numpy` is its inverse, under the JAX names.
Both take the model family's class (`model_cls`: LanguageModel by default,
models/bert.py BertModel, models/t5.py T5Model, models/classification.py
ClassificationModel and MultipleChoiceModel, models/biencoder.py
BiencoderModel) whose tree the keys and shapes are checked against; a
family with options (the classes, the biencoder's shared tower and
ict_head) reads them off the tree's names and shapes.

`load_npz_checkpoint` reads the weights of a checkpoint either package saved
in the npz format, through the port's training/checkpointing.py: the tracker
file, the manifest's SHA-256 digests, then `config.json` and `params.npz`.
It needs no JAX. Orbax checkpoints raise there.
"""
from __future__ import annotations

import json
import os
from typing import Mapping, Optional

import numpy as np
import torch

from megatron_tpu_torch.config import MegatronConfig, ModelConfig
from megatron_tpu_torch.models.language_model import LanguageModel
from megatron_tpu_torch.ops.quantized import QUANTIZABLE, W8
from megatron_tpu_torch.resilience import integrity
from megatron_tpu_torch.training import checkpointing
from megatron_tpu_torch.training.optimizer import OptState, ScalerState
from megatron_tpu_torch.training.train_step import TrainState
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device

def _flatten(tree: Mapping, prefix: str = "") -> dict:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        elif getattr(v, "_fields", None) == W8._fields:
            # an int8-resident weight (the JAX W8 NamedTuple), flattened as
            # checkpointing._flatten flattens it
            flat[f"{key}/q"], flat[f"{key}/scale"] = v.q, v.scale
        else:
            flat[key] = v
    return flat


def _take_w8(got: dict, expected: dict) -> dict:
    """Pop the "<name>.q" / "<name>.scale" pairs of quantizable transformer
    projections out of `got`: {name: {"q": array, "scale": array}}."""
    w8: dict = {}
    for key in list(got):
        base, _, part = key.rpartition(".")
        if (part in W8._fields and base in expected
                and base.startswith("transformer.")
                and base.rsplit(".", 1)[-1] in QUANTIZABLE):
            w8.setdefault(base, {})[part] = got.pop(key)
    return w8


def params_from_numpy(tree_or_flat: Mapping, cfg: ModelConfig,
                      device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None, *,
                      model_cls=LanguageModel) -> dict:
    """The JAX parameter tree (nested dict of arrays, or the flat "a/b/c"
    keys of checkpointing._flatten) -> the port's state_dict on `device`,
    cast to `dtype` when given. Raises on a missing, extra or misshapen
    leaf. `model_cls` names the family whose tree is expected:
    LanguageModel (GPT, Llama, Falcon, Mixtral), models.bert.BertModel,
    models.t5.T5Model or a models.classification.EncoderTree family
    (classification, multiple choice, the biencoder), whose options come
    from the tree.

    A tree that `quantize_weights` made carries its W8 leaves (as W8
    objects, or flat ".../q" and ".../scale" keys): they come across
    unchanged, int8 values and fp32 scales, as the port's W8 under the
    weight's own key. Such a state is no LanguageModel's state_dict:
    `language_model.params_tree` nests it for `Generator`."""
    device = resolve_device(device)
    flat = _flatten(tree_or_flat)
    got = {k.replace("/", "."): v for k, v in flat.items()}
    options = {}
    if hasattr(model_cls, "options_from_tree"):
        options = model_cls.options_from_tree(
            {k: tuple(np.shape(v)) for k, v in got.items()})
    expected = {k: tuple(t.shape) for k, t in model_cls(
        cfg, device="meta", **options).state_dict().items()}
    w8 = _take_w8(got, expected)
    missing = sorted(set(expected) - set(got) - set(w8))
    extra = sorted(set(got) - set(expected))
    missing += sorted(f"{k}.{part}" for k, parts in w8.items()
                      for part in W8._fields if part not in parts)
    if missing or extra:
        raise KeyError(f"parameter tree does not match the config: missing "
                       f"{missing}, unexpected {extra}")
    state = {}
    for key, parts in w8.items():
        q, scale = (np.asarray(parts[f]) for f in W8._fields)
        want = expected[key]
        if (tuple(q.shape) != want or q.dtype != np.int8
                or tuple(scale.shape) != want[:1] + want[2:]):
            raise ValueError(f"W8 leaf {key}: q {q.dtype} {q.shape}, scale "
                             f"{scale.shape} for a weight of {want}")
        state[key] = W8(*(torch.from_numpy(np.require(
            a, requirements=["C", "W"])).to(device) for a in (q, scale)))
    for key, arr in got.items():
        arr = np.asarray(arr)
        if tuple(arr.shape) != expected[key]:
            raise ValueError(f"shape mismatch for {key}: got {arr.shape}, "
                             f"model {expected[key]}")
        t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
        state[key] = t.to(device=device, dtype=dtype or t.dtype)
    return state


def train_state_from_numpy(params: Mapping, opt_state, iteration,
                           cfg: MegatronConfig,
                           device: DeviceLike = None, *,
                           model_cls=LanguageModel) -> TrainState:
    """A JAX training state -> the port's. `params` is the parameter tree
    (nested or flat), `opt_state` the JAX OptState or anything with its
    fields `step`, `mu`, `nu` (None for SGD) and `scaler` = (scale,
    growth_tracker, hysteresis), holding arrays; `iteration` an int or a
    0-d array. `model_cls` as `params_from_numpy` takes it."""
    device = resolve_device(device)
    model = model_cls.from_state_dict(
        cfg.model, params_from_numpy(params, cfg.model, device,
                                     model_cls=model_cls),
        trainable=True)

    def moments(tree):
        if tree is None:
            return None
        return params_from_numpy(tree, cfg.model, device, torch.float32,
                                 model_cls=model_cls)

    scale, tracker, hysteresis = opt_state.scaler
    scaler = ScalerState(
        scale=torch.tensor(float(np.asarray(scale)), dtype=torch.float32,
                           device=device),
        growth_tracker=torch.tensor(int(np.asarray(tracker)),
                                    dtype=torch.int32, device=device),
        hysteresis=torch.tensor(int(np.asarray(hysteresis)),
                                dtype=torch.int32, device=device))
    return TrainState(
        params=model,
        opt_state=OptState(
            step=torch.tensor(int(np.asarray(opt_state.step)),
                              dtype=torch.int32, device=device),
            mu=moments(opt_state.mu), nu=moments(opt_state.nu),
            scaler=scaler),
        iteration=int(np.asarray(iteration)))


def train_state_to_numpy(state: TrainState):
    """The inverse of `train_state_from_numpy`: (params, opt_state,
    iteration) with params, mu and nu as flat {"a/b/c": array} dicts under
    the JAX names and opt_state a dict of step, mu, nu and scaler =
    {scale, growth_tracker, hysteresis}."""
    def flat(tensors):
        if tensors is None:
            return None
        return {k.replace(".", "/"): t.detach().cpu().numpy()
                for k, t in tensors.items()}

    o = state.opt_state
    scaler = {"scale": o.scaler.scale.item(),
              "growth_tracker": int(o.scaler.growth_tracker.item()),
              "hysteresis": int(o.scaler.hysteresis.item())}
    return (flat(state.params.state_dict()),
            {"step": int(o.step.item()), "mu": flat(o.mu), "nu": flat(o.nu),
             "scaler": scaler},
            state.iteration)


def load_npz_checkpoint(root: str, device: DeviceLike = None,
                        dtype: Optional[torch.dtype] = None):
    """Load the parameters of the checkpoint the tracker under `root` names,
    through training/checkpointing's reader, once its files match their
    manifest (as the JAX package's server and export load them). Returns
    (LanguageModel, ModelConfig); raises on a torn or corrupt checkpoint."""
    d = checkpointing.tracked_dir(root)
    ok, why = integrity.verify_checkpoint(d)
    if not ok:
        raise ValueError(f"checkpoint {d} failed integrity verification "
                         f"({why})")
    flat = checkpointing.read_params(d, verified=why == "ok")
    with open(os.path.join(d, "config.json")) as f:
        cfg = MegatronConfig.from_dict(json.load(f)).model.derived()
    state = params_from_numpy(flat, cfg, device, dtype)
    return LanguageModel.from_state_dict(cfg, state), cfg
