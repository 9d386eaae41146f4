"""Embedding, LM head and the causal language model
(megatron_tpu/models/language_model.py).

`LanguageModel` holds the reference's parameter tree under the same names,
with the stacked [L, ...] layer layout, so its state_dict keys are the
reference's flattened paths with "." for "/" ("transformer.attention.wq").
`model_forward`, `head_logits` and `loss_fn` are plain functions over that
tree, as in the reference; the head runs in the compute dtype and is cast
up to fp32 logits, and `loss_fn` is the masked-mean cross-entropy the
training step differentiates.

`LanguageModel(cfg, mesh=...)` holds this rank's tp parts of every leaf
(parallel/sharding.py, the logical axes of `model_axes`) and remembers its
mesh; `model_forward` and `loss_fn` of such a model run the sharded
forward: the vocab-parallel embedding (ids outside the rank's vocab rows
read zeros; the partial sums are all-reduced, or reduce-scattered to the
rank's [b, s/tp, h] under sequence parallelism, learned positions added
after that, on the rank's positions), the sharded stack, and the
column-parallel LM head whose logits stay vocab-sharded, fed to the
vocab-parallel cross-entropy (ops/cross_entropy.py). Built on a mesh with
pp > 1 the model holds its stage's layers of the stack and the whole of
every other leaf; it runs through parallel/pipeline.py, whose GPT spec
takes `model_forward`'s pieces apart: `lm_intake` (embedding), the stack,
`head_logits`. With cp > 1 `loss_fn`
gives each cp rank its chunk of the sequence: in the ring's zigzag order
when `data_zigzag_cp` says the ring runs (tokens, labels, mask and
position ids ride one permutation, so RoPE and learned positions see the
original positions, and the masked-mean loss is unchanged), else the
contiguous chunk. The rank's masked sum divides by the whole microbatch's
count, so the (dp, cp) ranks' losses sum to the unsharded one; a rank
whose chunk holds no masked token still takes its part in every
collective.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
from torch import nn

from megatron_tpu_torch.config import ModelConfig, as_dtype
from megatron_tpu_torch.models import transformer as tfm
from megatron_tpu_torch.models.attention import BlockKVCache, KVCache
from megatron_tpu_torch.models.norms import apply_norm, norm_axes, norm_init
from megatron_tpu_torch.models.rope import precompute_freqs
from megatron_tpu_torch.ops.cross_entropy import mesh_cross_entropy
from megatron_tpu_torch.ops.dropout import dropout
from megatron_tpu_torch.parallel import collectives
from megatron_tpu_torch.parallel.mesh import (CONTEXT_AXIS, PIPELINE_AXIS,
                                              TENSOR_AXIS)
from megatron_tpu_torch.parallel.ring_attention import (data_zigzag_cp,
                                                        zigzag_permutation)
from megatron_tpu_torch.parallel.sharding import (activation_region,
                                                  cp_positions, shard_leaf)
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


def model_axes(cfg: ModelConfig) -> dict:
    """Logical axes of the parameters (language_model.py model_axes)."""
    axes = {
        "embedding": {"word_embeddings": ("vocab", "embed")},
        "transformer": tfm.stack_axes(cfg),
        "final_norm": norm_axes(cfg.norm_type),
    }
    if cfg.use_position_embedding:
        axes["embedding"]["position_embeddings"] = (None, "embed")
    if not cfg.tie_embed_logits:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def flat_axes(axes: dict, prefix: str = "") -> dict:
    """A nested axes tree -> {state_dict name: axes}."""
    out = {}
    for k, v in axes.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat_axes(v, name + "."))
        else:
            out[name] = v
    return out


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


def shard_children(children: dict, axes: dict, mesh, kv_heads: int,
                   trainable: bool) -> dict:
    """ParamTree children -> the same tree of this rank's tp parts."""
    out = {}
    for k, v in children.items():
        if isinstance(v, nn.Parameter):
            out[k] = nn.Parameter(shard_leaf(v.detach(), axes[k], mesh,
                                             kv_heads),
                                  requires_grad=trainable)
        else:
            out[k] = ParamTree(shard_children(dict(v.items()), axes[k],
                                              mesh, kv_heads, trainable))
    return out


class LanguageModel(ParamTree):
    """The reference's parameter tree as a module.

    Weights are drawn from a `torch.Generator` seeded with `seed`, on
    `device` (the current CUDA device when None; raises without one), in
    `dtype` (cfg.params_dtype when None). On the "meta" device nothing is
    allocated, for loading a state_dict with `assign=True`. Parameters
    require grad only when `trainable`: serving builds frozen models.
    With a `mesh` (parallel/mesh.py) the model draws the whole tree from
    `seed` and keeps this rank's tp parts (see the module's note)."""

    stacked_prefixes = ("transformer.",)

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0,
                 trainable: bool = False, mesh=None):
        children = build_param_tree(
            model_init(cfg), param_maker(cfg, device, dtype, seed,
                                         trainable))
        if mesh is not None:
            children = shard_children(children, model_axes(cfg), mesh,
                                      cfg.num_kv_heads, trainable)
        super().__init__(children)
        self.cfg = cfg
        self.mesh = mesh

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

    def param_axes(self) -> dict:
        return model_axes(self.cfg)

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
                  adapters=None, return_aux: bool = False,
                  cp_pre_zigzag: bool = False):
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
    row adds its adapter's low-rank deltas to the attention projections.
    A LanguageModel built on a mesh runs the sharded forward (the module's
    note): tokens are the rank's dp rows (its cp chunk of them, in zigzag
    order with `cp_pre_zigzag`), and the logits its vocab columns."""
    mesh = params.mesh if isinstance(params, LanguageModel) else None
    params = _tree(params)
    if mesh is not None:
        if (kv_caches is not None or head_positions is not None
                or adapters is not None):
            raise NotImplementedError(
                "a sharded model runs the training forward; caches, head "
                "positions and adapters are not ported under a mesh "
                "(ROADMAP Queue 1 item 7)")
        if mesh.shape[PIPELINE_AXIS] > 1:
            raise ValueError("a model built on a pipeline mesh holds one "
                             "stage's layers: run it through "
                             "parallel/pipeline.py")
    x, position_ids = lm_intake(params, tokens, cfg,
                                position_ids=position_ids,
                                kv_caches=kv_caches,
                                deterministic=deterministic,
                                generator=generator, mesh=mesh,
                                cp_pre_zigzag=cp_pre_zigzag)
    if rope is None:
        rope = make_rope(cfg, device=tokens.device)
    x, kv_caches, aux = tfm.stack_apply(
        params["transformer"], x, cfg,
        rope_cos=rope.cos if rope else None,
        rope_sin=rope.sin if rope else None,
        position_ids=position_ids, kv_caches=kv_caches,
        segment_ids=segment_ids, deterministic=deterministic,
        generator=generator, adapters=adapters, mesh=mesh,
        cp_pre_zigzag=cp_pre_zigzag)
    if head_positions is not None:
        x = x[torch.arange(x.shape[0], device=x.device),
              head_positions.long()][:, None]
    logits = head_logits(params, x, cfg, logits_dtype=logits_dtype,
                         mesh=mesh)
    if return_aux:
        if not isinstance(aux, torch.Tensor):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits, kv_caches, aux
    return logits, kv_caches


def lm_intake(params, tokens: torch.Tensor, cfg: ModelConfig, *,
              position_ids=None, kv_caches=None, deterministic: bool = True,
              generator: Optional[torch.Generator] = None, mesh=None,
              cp_pre_zigzag: bool = False) -> tuple:
    """The embedding half of `model_forward` (a pipeline's stage-0
    intake): the token rows (vocab-parallel on a `mesh`), the learned
    positions, the embedding dropout. Returns (x, position_ids), the
    latter made for the rank's cp chunk when cp > 1 leaves it None."""
    compute_dtype = as_dtype(cfg.compute_dtype)
    emb = params["embedding"]["word_embeddings"]
    if mesh is None:
        x = emb[tokens].to(compute_dtype)
    else:
        x = vocab_parallel_embedding(emb, tokens, mesh, compute_dtype)
        if position_ids is None and mesh.shape[CONTEXT_AXIS] > 1:
            s = tokens.shape[1]
            position_ids = torch.arange(s * mesh.shape[CONTEXT_AXIS],
                                        device=tokens.device)[
                cp_positions(s * mesh.shape[CONTEXT_AXIS], mesh,
                             cp_pre_zigzag)][None].expand(tokens.shape)
    if cfg.use_position_embedding:
        if position_ids is None:
            pos = torch.arange(tokens.shape[1], device=tokens.device)[None]
            if kv_caches is not None:
                off = kv_caches.offset
                pos = pos + (off.long()[:, None]
                             if isinstance(off, torch.Tensor) else off)
        else:
            pos = position_ids
        if mesh is not None and mesh.sequence_parallel:
            s = x.shape[1]
            t = mesh.coords[TENSOR_AXIS]
            pos = pos[:, t * s:(t + 1) * s]
        x = x + params["embedding"]["position_embeddings"][pos].to(
            compute_dtype)
    if not deterministic:
        x = dropout(generator, x, cfg.hidden_dropout,
                    None if mesh is None
                    else activation_region(mesh, tuple(x.shape),
                                           zigzag=cp_pre_zigzag))
    return x, position_ids


def vocab_parallel_embedding(emb: torch.Tensor, tokens: torch.Tensor, mesh,
                              dtype) -> torch.Tensor:
    """This rank's vocab rows of the embedding looked up (ids outside them
    read zeros), then summed over tp: all-reduced, or reduce-scattered to
    this rank's [b, s/tp, h] under sequence parallelism. Each id's row
    comes from one rank and the others add zeros, so the sum is exact."""
    rows = emb.shape[0]
    local = tokens - mesh.coords[TENSOR_AXIS] * rows
    inside = (local >= 0) & (local < rows)
    x = emb[local.clamp(0, rows - 1)].to(dtype)
    x = x.masked_fill(~inside[..., None], 0.0)
    return collectives.tp_region_out(x, mesh)


def head_logits(params, x: torch.Tensor, cfg: ModelConfig, *,
                logits_dtype=torch.float32, mesh=None) -> torch.Tensor:
    """Final norm + tied/untied LM head in the compute dtype, cast up.
    Under a `mesh` the head is column-parallel over the vocab: x enters
    through `tp_region_in` and the logits are this rank's vocab
    columns."""
    params = _tree(params)
    compute_dtype = as_dtype(cfg.compute_dtype)
    x = apply_norm(cfg.norm_type, params["final_norm"], x, cfg.norm_epsilon)
    if mesh is not None:
        x = collectives.tp_region_in(x, mesh)
    if cfg.tie_embed_logits:
        w_out = params["embedding"]["word_embeddings"].T
    else:
        w_out = params["lm_head"]
    return (x @ w_out.to(compute_dtype)).to(logits_dtype)


def loss_fn(params, tokens, cfg: ModelConfig, *, loss_mask=None,
            rope: Optional[RopeTables] = None,
            generator: Optional[torch.Generator] = None,
            deterministic: bool = True, position_ids=None, segment_ids=None,
            adapters=None, denominator: Optional[torch.Tensor] = None):
    """Causal LM loss (language_model.py loss_fn): the mean cross-entropy
    over unmasked positions, plus cfg.moe_aux_loss_coeff times the router
    loss when `num_experts > 1`. `tokens` is [b, s+1] (inputs and labels
    shifted by one; a [b, s+1] loss_mask drops its first column) or an
    (inputs, labels) pair of [b, s]. `adapters` threads LoRA factors into
    the forward (training/lora.py differentiates through them).
    `denominator` replaces the mask's own count in the masked mean: the
    sharded step passes the whole microbatch's count, since `tokens` are
    one dp rank's rows of it. A model built on a mesh takes the
    vocab-parallel cross-entropy, and with cp > 1 each rank its chunk of
    the sequence (the module's note; `denominator` is then required)."""
    if isinstance(tokens, tuple):
        inputs, labels = tokens
    else:
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        if loss_mask is not None and loss_mask.shape[1] == tokens.shape[1]:
            loss_mask = loss_mask[:, 1:]
    mesh = params.mesh if isinstance(params, LanguageModel) else None
    zigzag = False
    if mesh is not None and mesh.shape[CONTEXT_AXIS] > 1:
        if denominator is None:
            raise ValueError("loss_fn under context parallelism needs the "
                             "whole microbatch's mask count (denominator)")
        b, S = inputs.shape
        if loss_mask is None:
            loss_mask = torch.ones(b, S, dtype=torch.float32,
                                   device=inputs.device)
        if position_ids is None:
            position_ids = torch.arange(
                S, device=inputs.device)[None].expand(b, S)
        zigzag = bool(data_zigzag_cp(cfg, S, mesh,
                                     segment_ids=segment_ids))
        rows = cp_positions(S, mesh)
        if zigzag:
            rows = torch.from_numpy(zigzag_permutation(
                S, mesh.shape[CONTEXT_AXIS])[0])[rows]
        inputs, labels, loss_mask, position_ids = (
            t[:, rows] for t in (inputs, labels, loss_mask, position_ids))
        if segment_ids is not None:
            segment_ids = segment_ids[:, rows]
    logits, _, aux = model_forward(params, inputs, cfg, rope=rope,
                                   position_ids=position_ids,
                                   segment_ids=segment_ids,
                                   deterministic=deterministic,
                                   generator=generator, adapters=adapters,
                                   return_aux=True, cp_pre_zigzag=zigzag)
    losses = mesh_cross_entropy(logits, labels, mesh,
                                vocab_size=cfg.vocab_size)
    if loss_mask is None and denominator is None:
        loss = losses.mean()
    else:
        loss_mask = (torch.ones_like(losses) if loss_mask is None
                     else loss_mask.to(losses.dtype))
        count = loss_mask.sum() if denominator is None else denominator
        loss = (losses * loss_mask).sum() / torch.clamp(count, min=1.0)
    if cfg.num_experts > 1:
        loss = loss + cfg.moe_aux_loss_coeff * aux
    return loss
