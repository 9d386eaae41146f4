"""Embedding, LM head and the causal language model
(megatron_tpu/models/language_model.py).

`LanguageModel` holds the reference's parameter tree under the same names,
with the stacked [L, ...] layer layout, so its state_dict keys are the
reference's flattened paths with "." for "/" ("transformer.attention.wq").
`model_forward`, `head_logits` and `loss_fn` are plain functions over that
tree, as in the reference; the head runs in the compute dtype and is cast
up to fp32 logits, and `loss_fn` is the masked-mean cross-entropy the
training step differentiates.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
from torch import nn

from megatron_tpu_torch.config import ModelConfig, as_dtype
from megatron_tpu_torch.models import transformer as tfm
from megatron_tpu_torch.models.attention import BlockKVCache, KVCache
from megatron_tpu_torch.models.norms import apply_norm, norm_init
from megatron_tpu_torch.models.rope import precompute_freqs
from megatron_tpu_torch.ops.cross_entropy import cross_entropy_loss
from megatron_tpu_torch.ops.dropout import dropout
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device


def model_init(cfg: ModelConfig) -> dict:
    """Parameter specs of the whole model (language_model.py model_init):
    a nested dict whose leaves are (shape, init), init being
    ("normal", std) or ("fill", value)."""
    v, h = cfg.padded_vocab_size, cfg.hidden_size
    specs = {
        "embedding": {"word_embeddings": ((v, h),
                                          ("normal", cfg.init_method_std))},
        "transformer": tfm.stack_init(cfg),
        "final_norm": norm_init(cfg.norm_type, h),
    }
    if cfg.use_position_embedding:
        specs["embedding"]["position_embeddings"] = (
            (cfg.max_position_embeddings, h), ("normal", cfg.init_method_std))
    if not cfg.tie_embed_logits:
        specs["lm_head"] = ((h, v), ("normal", cfg.init_method_std))
    return specs


def param_maker(cfg: ModelConfig, device: DeviceLike,
                dtype: Optional[torch.dtype], seed: int, trainable: bool):
    """spec (shape, init) -> nn.Parameter on `device` (the current CUDA
    device when None) in `dtype` (cfg.params_dtype when None), drawn in
    call order from one generator seeded with `seed`; empty on "meta"."""
    device = resolve_device(device)
    dtype = dtype or as_dtype(cfg.params_dtype)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))

    def make(spec):
        shape, (kind, value) = spec
        if gen is None:
            t = torch.empty(shape, dtype=dtype, device=device)
        elif kind == "normal":
            t = torch.randn(shape, generator=gen, dtype=dtype,
                            device=device).mul_(value)
        else:
            t = torch.full(shape, value, dtype=dtype, device=device)
        return nn.Parameter(t, requires_grad=trainable)
    return make


class ParamTree(nn.Module):
    """A parameter tree node whose children are parameters and subtrees
    alike (BERT's lm_head holds dense/, norm/ and a bias leaf), indexed as
    a dict; `named_parameters` gives the tree's "a.b.c" paths."""

    def __init__(self, children: dict):
        super().__init__()
        self._keys = list(children)
        for k, v in children.items():
            if isinstance(v, nn.Parameter):
                self.register_parameter(k, v)
            else:
                self.add_module(k, v)

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._keys

    def keys(self):
        return list(self._keys)

    def items(self):
        return [(k, self[k]) for k in self._keys]

    def values(self):
        return [self[k] for k in self._keys]

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)


def build_param_tree(specs: dict, make) -> dict:
    """Nested specs -> the children of a ParamTree: `make(spec)` leaves and
    ParamTree subtrees, made in spec order."""
    return {k: make(v) if isinstance(v, tuple)
            else ParamTree(build_param_tree(v, make))
            for k, v in specs.items()}


class LanguageModel(ParamTree):
    """The reference's parameter tree as a module.

    Weights are drawn from a `torch.Generator` seeded with `seed`, on
    `device` (the current CUDA device when None; raises without one), in
    `dtype` (cfg.params_dtype when None). On the "meta" device nothing is
    allocated, for loading a state_dict with `assign=True`. Parameters
    require grad only when `trainable`: serving builds frozen models."""

    stacked_prefixes = ("transformer.",)

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0,
                 trainable: bool = False):
        super().__init__(build_param_tree(
            model_init(cfg), param_maker(cfg, device, dtype, seed,
                                         trainable)))
        self.cfg = cfg

    @classmethod
    def from_state_dict(cls, cfg: ModelConfig, state_dict: dict, *,
                        trainable: bool = False):
        """A model holding exactly these tensors (no copy, no init)."""
        model = cls(cfg, device="meta", trainable=trainable)
        model.load_state_dict(state_dict, strict=True, assign=True)
        return model

    @property
    def device(self) -> torch.device:
        return self.embedding["word_embeddings"].device

    def tree(self) -> dict:
        """The parameter tree in the reference's nesting."""
        return dict(self.items())

    def forward(self, tokens, **kwargs):
        return model_forward(self, tokens, self.cfg, **kwargs)


class RopeTables(NamedTuple):
    cos: torch.Tensor
    sin: torch.Tensor


def make_rope(cfg: ModelConfig, max_len: Optional[int] = None, *,
              device=None) -> Optional[RopeTables]:
    if not cfg.use_rotary_emb:
        return None
    cos, sin = precompute_freqs(
        cfg.kv_channels, max_len or cfg.max_position_embeddings,
        theta=cfg.rope_theta, scaling_factor=cfg.rope_scaling_factor,
        device=device)
    return RopeTables(cos, sin)


def _tree(params):
    return params.tree() if isinstance(params, LanguageModel) else params


def params_device(params) -> torch.device:
    """The device of a LanguageModel's or a parameter tree's weights."""
    return _tree(params)["embedding"]["word_embeddings"].device


def params_tree(state: dict) -> dict:
    """A state dict ("a.b.c" keys, as `params_from_numpy` returns) as the
    nested parameter tree `model_forward` takes. Use it for a state that
    holds W8 (int8-resident) weights, which a LanguageModel cannot hold."""
    tree: dict = {}
    for key, value in state.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def model_forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                  position_ids=None,
                  kv_caches: Union[KVCache, BlockKVCache, None] = None,
                  rope: Optional[RopeTables] = None,
                  logits_dtype=torch.float32, segment_ids=None,
                  deterministic: bool = True,
                  generator: Optional[torch.Generator] = None,
                  head_positions: Optional[torch.Tensor] = None,
                  adapters=None, return_aux: bool = False):
    """Forward to logits [b, s, padded_vocab]. Returns (logits, kv_caches),
    or with `return_aux` (logits, kv_caches, aux): the MoE router's
    load-balancing loss summed over layers, a 0-d fp32 tensor (zero for a
    dense model).
    With `head_positions` [b], only row i's position head_positions[i]
    reaches the LM head and the logits are [b, 1, padded_vocab] (a
    prefill needs only each prompt's last position).
    `params` is a LanguageModel or its tree (whose transformer weights may
    be W8, `ops.quantized.quantize_weights`). With `kv_caches` (a KVCache,
    whose offset may be per row, or the serving engine's BlockKVCache),
    positions continue from the cache offset and the caches are written in
    place.
    `segment_ids` [b, s] mask attention across documents; with
    `deterministic` False, `generator` seeds the embedding's and the
    stack's dropout.
    `adapters` is (a stacked LoraAdapter bank, adapter_idx int [b]): each
    row adds its adapter's low-rank deltas to the attention projections."""
    params = _tree(params)
    compute_dtype = as_dtype(cfg.compute_dtype)
    emb = params["embedding"]["word_embeddings"]
    x = emb[tokens].to(compute_dtype)
    if cfg.use_position_embedding:
        if position_ids is None:
            pos = torch.arange(tokens.shape[1], device=tokens.device)[None]
            if kv_caches is not None:
                off = kv_caches.offset
                pos = pos + (off.long()[:, None]
                             if isinstance(off, torch.Tensor) else off)
        else:
            pos = position_ids
        x = x + params["embedding"]["position_embeddings"][pos].to(
            compute_dtype)
    if rope is None:
        rope = make_rope(cfg, device=tokens.device)
    if not deterministic:
        x = dropout(generator, x, cfg.hidden_dropout)
    x, kv_caches, aux = tfm.stack_apply(
        params["transformer"], x, cfg,
        rope_cos=rope.cos if rope else None,
        rope_sin=rope.sin if rope else None,
        position_ids=position_ids, kv_caches=kv_caches,
        segment_ids=segment_ids, deterministic=deterministic,
        generator=generator, adapters=adapters)
    if head_positions is not None:
        x = x[torch.arange(x.shape[0], device=x.device),
              head_positions.long()][:, None]
    logits = head_logits(params, x, cfg, logits_dtype=logits_dtype)
    if return_aux:
        if not isinstance(aux, torch.Tensor):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits, kv_caches, aux
    return logits, kv_caches


def head_logits(params, x: torch.Tensor, cfg: ModelConfig, *,
                logits_dtype=torch.float32) -> torch.Tensor:
    """Final norm + tied/untied LM head in the compute dtype, cast up."""
    params = _tree(params)
    compute_dtype = as_dtype(cfg.compute_dtype)
    x = apply_norm(cfg.norm_type, params["final_norm"], x, cfg.norm_epsilon)
    if cfg.tie_embed_logits:
        w_out = params["embedding"]["word_embeddings"].T
    else:
        w_out = params["lm_head"]
    return (x @ w_out.to(compute_dtype)).to(logits_dtype)


def loss_fn(params, tokens, cfg: ModelConfig, *, loss_mask=None,
            rope: Optional[RopeTables] = None,
            generator: Optional[torch.Generator] = None,
            deterministic: bool = True, position_ids=None, segment_ids=None,
            adapters=None):
    """Causal LM loss (language_model.py loss_fn): the mean cross-entropy
    over unmasked positions, plus cfg.moe_aux_loss_coeff times the router
    loss when `num_experts > 1`. `tokens` is [b, s+1] (inputs and labels
    shifted by one; a [b, s+1] loss_mask drops its first column) or an
    (inputs, labels) pair of [b, s]. `adapters` threads LoRA factors into
    the forward (training/lora.py differentiates through them). The
    context-parallel zigzag is the multi-device slice's."""
    if cfg.recompute_granularity != "none":
        raise NotImplementedError(
            f"recompute_granularity={cfg.recompute_granularity!r}: "
            "activation recompute is ported in a later slice")
    if isinstance(tokens, tuple):
        inputs, labels = tokens
    else:
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        if loss_mask is not None and loss_mask.shape[1] == tokens.shape[1]:
            loss_mask = loss_mask[:, 1:]
    logits, _, aux = model_forward(params, inputs, cfg, rope=rope,
                                   position_ids=position_ids,
                                   segment_ids=segment_ids,
                                   deterministic=deterministic,
                                   generator=generator, adapters=adapters,
                                   return_aux=True)
    losses = cross_entropy_loss(logits, labels, vocab_size=cfg.vocab_size)
    if loss_mask is None:
        loss = losses.mean()
    else:
        loss_mask = loss_mask.to(losses.dtype)
        loss = ((losses * loss_mask).sum()
                / torch.clamp(loss_mask.sum(), min=1.0))
    if cfg.num_experts > 1:
        loss = loss + cfg.moe_aux_loss_coeff * aux
    return loss
