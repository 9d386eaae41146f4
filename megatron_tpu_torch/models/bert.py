"""BERT: a bidirectional encoder with the masked-LM and next-sentence heads
(megatron_tpu/models/bert.py).

`BertModel` holds the reference's parameter tree under its names
(`named_parameters` gives "embedding.word_embeddings",
"transformer.attention.wq", "lm_head.dense.w", ...), the layer stack in the
stacked [L, ...] layout. The functions are the reference's, over that tree:

- embeddings: word + learned position + token type, cast to the compute
  dtype, then the embedding LayerNorm and (training) hidden dropout;
- encoder: the post-LN stack, bidirectional; a padding mask isolates each
  pad position in a segment of its own (`bert_pad_segments`), which the
  flash kernels take as segment ids;
- pooler: dense + tanh over [CLS];
- MLM head: dense + exact GELU + LayerNorm, then the tied decode against
  the word embeddings, cast to fp32, plus an fp32 bias;
- NSP head: a binary dense over the pooled output.

`BertModel(cfg, mesh=...)` holds this rank's parts of the tree under
`bert_axes` (the reference's) and runs the sharded forward of the (dp,
tp) mesh, as the decoder LM does (models/language_model.py): the
vocab-parallel word embedding in the parameters' dtype, whose sum over tp
is reduce-scattered to the rank's [b, s/tp, h] under sequence parallelism
before the position and token-type rows of its positions are added; the
sharded stack; the MLM head on the rank's rows, entering the tied decode
through `tp_region_in`, with the logits and the bias vocab-sharded, into
the vocab-parallel cross-entropy. Under sequence parallelism token 0 lies
on tp rank 0 alone: the pooler and the NSP head run there, and their
output reaches the other tp ranks through `collectives.from_tp_rank0`.
`bert_loss` then returns the rank's share of the global microbatch's
loss: its masked sum over the whole microbatch's mask count, and its NSP
sum over the whole microbatch's rows.

`bert_1f1b_fns` is BERT's spec for the pipelined step
(parallel/pipeline.py): the embedding intake (`bert_embed`: rows, norm,
dropout), a chunk of the stack over the pad segments, and the MLM + NSP
head loss (`bert_head_loss`, the tail `bert_loss` runs too).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from megatron_tpu_torch.config import ModelConfig, as_dtype
from megatron_tpu_torch.models import transformer as tfm
from megatron_tpu_torch.models.language_model import (
    ParamTree, build_param_tree, param_maker, shard_children,
    vocab_parallel_embedding)
from megatron_tpu_torch.models.norms import apply_norm, norm_axes, norm_init
from megatron_tpu_torch.ops.cross_entropy import (cross_entropy_loss,
                                                  mesh_cross_entropy)
from megatron_tpu_torch.ops.dropout import dropout
from megatron_tpu_torch.parallel import collectives
from megatron_tpu_torch.parallel.mesh import DATA_AXIS, TENSOR_AXIS
from megatron_tpu_torch.parallel.sharding import activation_region
from megatron_tpu_torch.utils.device import DeviceLike


def bert_config(**overrides) -> ModelConfig:
    """BERT-base: google-research/bert uncased_L-12_H-768_A-12's widths
    (bert.py bert_config)."""
    base = dict(
        num_layers=12, hidden_size=768, num_attention_heads=12,
        vocab_size=30522, seq_length=512, use_rotary_emb=False,
        use_position_embedding=True, norm_type="layernorm",
        activation="gelu", use_bias=True, use_post_ln=True,
        tie_embed_logits=True,
    )
    base.update(overrides)
    return ModelConfig(**base).derived()


def bert_init(cfg: ModelConfig, num_tokentypes: int = 2) -> dict:
    """Parameter specs of the whole model (bert.py bert_init)."""
    h, v, std = cfg.hidden_size, cfg.padded_vocab_size, cfg.init_method_std
    normal = ("normal", std)
    zeros = ("fill", 0.0)
    return {
        "embedding": {
            "word_embeddings": ((v, h), normal),
            "position_embeddings": ((cfg.max_position_embeddings, h),
                                    normal),
            "tokentype_embeddings": ((num_tokentypes, h), normal),
        },
        "embedding_norm": norm_init(cfg.norm_type, h),
        "transformer": tfm.stack_init(cfg),
        "pooler": {"w": ((h, h), normal), "b": ((h,), zeros)},
        "lm_head": {
            "dense": {"w": ((h, h), normal), "b": ((h,), zeros)},
            "norm": norm_init(cfg.norm_type, h),
            "bias": ((v,), zeros),
        },
        "binary_head": {"w": ((h, 2), normal), "b": ((2,), zeros)},
    }


def bert_axes(cfg: ModelConfig) -> dict:
    """Logical axes of the parameters (bert.py bert_axes)."""
    return {
        "embedding": {
            "word_embeddings": ("vocab", "embed"),
            "position_embeddings": (None, "embed"),
            "tokentype_embeddings": (None, "embed"),
        },
        "embedding_norm": norm_axes(cfg.norm_type),
        "transformer": tfm.stack_axes(cfg),
        "pooler": {"w": ("embed", "embed"), "b": ("embed",)},
        "lm_head": {
            "dense": {"w": ("embed", "embed"), "b": ("embed",)},
            "norm": norm_axes(cfg.norm_type),
            "bias": ("vocab",),
        },
        "binary_head": {"w": ("embed", None), "b": (None,)},
    }


def shard_tree(children: dict, axes: dict, cfg: ModelConfig, mesh,
               trainable: bool) -> dict:
    """A family's tree children -> this rank's parts on `mesh` (the tree
    itself without one)."""
    if mesh is None:
        return children
    return shard_children(children, axes, mesh, cfg.num_kv_heads, trainable)


class BertModel(ParamTree):
    """BERT's parameter tree as a module, built as `LanguageModel` builds
    its own: weights from a generator seeded with `seed` on `device` (the
    current CUDA device when None; raises without one), empty on "meta";
    parameters require grad only when `trainable`; on a `mesh`, this
    rank's parts of them (see the module's note)."""

    # state_dict prefixes of the stacked [num_layers, ...] leaves
    stacked_prefixes = ("transformer.",)

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0,
                 trainable: bool = False, num_tokentypes: int = 2,
                 mesh=None):
        super().__init__(shard_tree(build_param_tree(
            bert_init(cfg, num_tokentypes),
            param_maker(cfg, device, dtype, seed, trainable)),
            bert_axes(cfg), cfg, mesh, trainable))
        self.cfg = cfg
        self.mesh = mesh

    def param_axes(self) -> dict:
        return bert_axes(self.cfg)

    @classmethod
    def from_state_dict(cls, cfg: ModelConfig, state_dict: dict, *,
                        trainable: bool = False, num_tokentypes: int = 2):
        """A model holding exactly these tensors (no copy, no init)."""
        model = cls(cfg, device="meta", trainable=trainable,
                    num_tokentypes=num_tokentypes)
        model.load_state_dict(state_dict, strict=True, assign=True)
        return model

    @property
    def device(self) -> torch.device:
        return self.embedding["word_embeddings"].device

    def forward(self, tokens, **kwargs):
        return bert_forward(self, tokens, self.cfg, **kwargs)


def strip_pretraining_heads(tree) -> dict:
    """The encoder and pooler without the MLM and NSP heads: the base of the
    classification and biencoder towers."""
    items = tree.items() if hasattr(tree, "items") else tree
    return {k: v for k, v in items if k not in ("lm_head", "binary_head")}


def bert_pad_segments(padding_mask: torch.Tensor) -> torch.Tensor:
    """padding_mask [.., s] (1 = real) -> int32 segment ids: real tokens 0,
    the pad at position i segment 2 + i, so that it sees only itself."""
    s = padding_mask.shape[-1]
    pads = 2 + torch.arange(s, device=padding_mask.device)
    return torch.where(padding_mask > 0, torch.zeros_like(pads),
                       pads).to(torch.int32)


def sp_part(t: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """This rank's part of a whole-sequence tensor under sequence
    parallelism (the tensor itself without it)."""
    if mesh is None or not mesh.sequence_parallel:
        return t
    per = t.shape[dim] // mesh.shape[TENSOR_AXIS]
    return t.narrow(dim, mesh.coords[TENSOR_AXIS] * per, per)


def bert_encode(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                tokentype_ids=None, padding_mask=None,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True, mesh=None):
    """tokens [b, s] -> (hidden [b, s, h], pooled [b, h]). With
    `deterministic` False the generator draws the embedding's and the
    stack's dropout. On a `mesh` (the weights this rank's parts, tokens
    its dp rows) hidden is [b, s/tp, h] under sequence parallelism, and
    pooled is tp rank 0's there (see the module's note)."""
    x = bert_embed(params, tokens, cfg, tokentype_ids=tokentype_ids,
                   generator=generator, deterministic=deterministic,
                   mesh=mesh)
    if deterministic:
        generator = None
    seg = None if padding_mask is None else bert_pad_segments(padding_mask)
    x, _, _ = tfm.stack_apply(params["transformer"], x, cfg, causal=False,
                              segment_ids=seg, generator=generator,
                              deterministic=deterministic, mesh=mesh)
    return x, bert_pool(params, x, as_dtype(cfg.compute_dtype))


def bert_embed(params, tokens: torch.Tensor, cfg: ModelConfig, *,
               tokentype_ids=None,
               generator: Optional[torch.Generator] = None,
               deterministic: bool = True, mesh=None) -> torch.Tensor:
    """The embedding half of `bert_encode`: word + position + token-type
    rows, the embedding norm, the hidden dropout."""
    if cfg.num_experts != 1:
        raise ValueError("MoE's router loss is only wired into the GPT loss")
    compute_dtype = as_dtype(cfg.compute_dtype)
    s = tokens.shape[1]
    emb = params["embedding"]
    word = emb["word_embeddings"]
    if mesh is None:
        x = word[tokens]
    else:
        x = vocab_parallel_embedding(word, tokens, mesh, word.dtype)
    x = x + sp_part(emb["position_embeddings"][
        torch.arange(s, device=tokens.device)][None], mesh)
    if tokentype_ids is not None:
        x = x + emb["tokentype_embeddings"][sp_part(tokentype_ids, mesh)]
    x = x.to(compute_dtype)
    x = apply_norm(cfg.norm_type, params["embedding_norm"], x,
                   cfg.norm_epsilon)
    if deterministic:
        generator = None
    if deterministic:
        return x
    return dropout(generator, x, cfg.hidden_dropout,
                   None if mesh is None
                   else activation_region(mesh, tuple(x.shape)))


def bert_pool(params, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """dense + tanh over [CLS]."""
    pool = params["pooler"]
    return torch.tanh(x[:, 0] @ pool["w"].to(compute_dtype)
                      + pool["b"].to(compute_dtype))


def bert_lm_logits(params, x: torch.Tensor, cfg: ModelConfig,
                   compute_dtype, mesh=None) -> torch.Tensor:
    """MLM head: dense + exact GELU + LayerNorm, then the tied decode in the
    compute dtype, cast to fp32, plus the fp32 bias; on a `mesh` the
    rank's vocab columns."""
    lh = params["lm_head"]
    y = x @ lh["dense"]["w"].to(compute_dtype) + \
        lh["dense"]["b"].to(compute_dtype)
    y = F.gelu(y)
    y = apply_norm(cfg.norm_type, lh["norm"], y, cfg.norm_epsilon)
    if mesh is not None:
        y = collectives.tp_region_in(y, mesh)
    w_out = params["embedding"]["word_embeddings"].T.to(compute_dtype)
    return (y @ w_out).float() + lh["bias"].float()


def bert_nsp_logits(params, pooled: torch.Tensor,
                    compute_dtype) -> torch.Tensor:
    """NSP binary head over the pooled output, in fp32."""
    bh = params["binary_head"]
    return (pooled @ bh["w"].to(compute_dtype)
            + bh["b"].to(compute_dtype)).float()


def pooled_everywhere(t: torch.Tensor, mesh) -> torch.Tensor:
    """What a head computed from `bert_encode`'s pooled output, on every tp
    rank (tp rank 0's under sequence parallelism)."""
    if mesh is None or not mesh.sequence_parallel:
        return t
    return collectives.from_tp_rank0(t, mesh)


def bert_forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                 tokentype_ids=None, padding_mask=None,
                 generator: Optional[torch.Generator] = None,
                 deterministic: bool = True):
    """tokens [b, s] -> (lm_logits [b, s, V] fp32, nsp_logits [b, 2] fp32).
    `padding_mask` [b, s] (1 = real) keeps pads out of the real tokens'
    attention. A BertModel built on a mesh runs the sharded forward: the
    lm logits are the rank's vocab columns."""
    mesh = getattr(params, "mesh", None)
    compute_dtype = as_dtype(cfg.compute_dtype)
    x, pooled = bert_encode(params, tokens, cfg, tokentype_ids=tokentype_ids,
                            padding_mask=padding_mask, generator=generator,
                            deterministic=deterministic, mesh=mesh)
    return (bert_lm_logits(params, x, cfg, compute_dtype, mesh),
            pooled_everywhere(bert_nsp_logits(params, pooled,
                                              compute_dtype), mesh))


def bert_loss(params, batch: dict, cfg: ModelConfig, *,
              generator: Optional[torch.Generator] = None,
              deterministic: bool = True) -> torch.Tensor:
    """The masked-LM mean over `loss_mask` plus, with "is_random", the mean
    NSP cross-entropy. batch: tokens, labels, loss_mask [b, s] and
    optionally tokentype_ids, padding_mask [b, s] and is_random [b]. On a
    mesh, the rank's share (see the module's note)."""
    mesh = getattr(params, "mesh", None)
    x, _ = bert_encode(params, batch["tokens"], cfg,
                       tokentype_ids=batch.get("tokentype_ids"),
                       padding_mask=batch.get("padding_mask"),
                       generator=generator, deterministic=deterministic,
                       mesh=mesh)
    return bert_head_loss(params, x, batch, cfg, mesh)


def bert_head_loss(params, x: torch.Tensor, batch: dict, cfg: ModelConfig,
                   mesh=None) -> torch.Tensor:
    """`bert_loss` from the encoder's output x: the MLM head's masked mean
    plus, with "is_random", the NSP head's mean over the pooled [CLS]; on
    a mesh the rank's share."""
    compute_dtype = as_dtype(cfg.compute_dtype)
    losses = mesh_cross_entropy(
        bert_lm_logits(params, x, cfg, compute_dtype, mesh),
        batch["labels"], mesh, vocab_size=cfg.vocab_size)
    mask = batch["loss_mask"].float()
    total = (losses * mask).sum() / torch.clamp(
        global_sum(mask.sum(), mesh), min=1.0)
    if "is_random" in batch:
        nsp_logits = pooled_everywhere(bert_nsp_logits(
            params, bert_pool(params, x, compute_dtype), compute_dtype),
            mesh)
        nsp = cross_entropy_loss(nsp_logits, batch["is_random"])
        total = total + (nsp.mean() if mesh is None else
                         nsp.sum() / global_rows(nsp.shape[0], mesh))
    return total


def bert_1f1b_fns(cfg: ModelConfig, deterministic: bool = True,
                  mesh=None) -> tuple:
    """(intake, chunk, head_loss) pipelining BERT through the 1F1B core
    (parallel/pipeline.py): the batch's entries are the streams. Dropout
    seeds as the GPT spec's: the intake's generator from fold_seed(seed,
    0), the layers' from fold_seed(seed, 1)."""
    from megatron_tpu_torch.ops.dropout import fold_seed, seeded
    if cfg.num_experts != 1:
        raise ValueError("BERT pipeline spec has no MoE router-aux "
                         "threading")

    def intake(model, sl, seed):
        return bert_embed(
            model, sl["tokens"], cfg, tokentype_ids=sl.get("tokentype_ids"),
            generator=None if seed is None else seeded(fold_seed(seed, 0)),
            deterministic=deterministic or seed is None, mesh=mesh)

    def chunk(cp, h, sl, offset, seed, remat=True):
        seg = (bert_pad_segments(sl["padding_mask"])
               if "padding_mask" in sl else None)
        return tfm.stack_apply(
            cp, h, cfg, causal=False, segment_ids=seg,
            deterministic=deterministic or seed is None,
            layer_seed=None if seed is None else fold_seed(seed, 1),
            layer_offset=offset, mesh=mesh, remat=remat)[0]

    def head_loss(model, h, sl, seed):
        return bert_head_loss(model, h, sl, cfg, mesh)

    return intake, chunk, head_loss


def global_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """A count summed over the dp ranks' rows (no grad)."""
    if mesh is None:
        return t
    return collectives.all_reduce(t.detach(), mesh, DATA_AXIS)


def global_rows(rows: int, mesh) -> int:
    """The global microbatch's rows from a dp rank's."""
    return rows if mesh is None else rows * mesh.shape[DATA_AXIS]
