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

The pipelined BERT step (`bert_1f1b_fns`) belongs to the multi-device
slice.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from megatron_tpu_torch.config import ModelConfig, as_dtype
from megatron_tpu_torch.models import transformer as tfm
from megatron_tpu_torch.models.language_model import (ParamTree,
                                                      build_param_tree,
                                                      param_maker)
from megatron_tpu_torch.models.norms import apply_norm, norm_init
from megatron_tpu_torch.ops.cross_entropy import cross_entropy_loss
from megatron_tpu_torch.ops.dropout import dropout
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


class BertModel(ParamTree):
    """BERT's parameter tree as a module, built as `LanguageModel` builds
    its own: weights from a generator seeded with `seed` on `device` (the
    current CUDA device when None; raises without one), empty on "meta";
    parameters require grad only when `trainable`."""

    # state_dict prefixes of the stacked [num_layers, ...] leaves
    stacked_prefixes = ("transformer.",)

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0,
                 trainable: bool = False, num_tokentypes: int = 2):
        super().__init__(build_param_tree(
            bert_init(cfg, num_tokentypes),
            param_maker(cfg, device, dtype, seed, trainable)))
        self.cfg = cfg

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


def bert_encode(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                tokentype_ids=None, padding_mask=None,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True):
    """tokens [b, s] -> (hidden [b, s, h], pooled [b, h]). With
    `deterministic` False the generator draws the embedding's and the
    stack's dropout."""
    if cfg.num_experts != 1:
        raise ValueError("MoE's router loss is only wired into the GPT loss")
    compute_dtype = as_dtype(cfg.compute_dtype)
    s = tokens.shape[1]
    emb = params["embedding"]
    x = emb["word_embeddings"][tokens]
    x = x + emb["position_embeddings"][
        torch.arange(s, device=tokens.device)][None]
    if tokentype_ids is not None:
        x = x + emb["tokentype_embeddings"][tokentype_ids]
    x = x.to(compute_dtype)
    x = apply_norm(cfg.norm_type, params["embedding_norm"], x,
                   cfg.norm_epsilon)
    if deterministic:
        generator = None
    x = dropout(generator, x, cfg.hidden_dropout)
    seg = None if padding_mask is None else bert_pad_segments(padding_mask)
    x, _, _ = tfm.stack_apply(params["transformer"], x, cfg, causal=False,
                              segment_ids=seg, generator=generator,
                              deterministic=deterministic)
    return x, bert_pool(params, x, compute_dtype)


def bert_pool(params, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """dense + tanh over [CLS]."""
    pool = params["pooler"]
    return torch.tanh(x[:, 0] @ pool["w"].to(compute_dtype)
                      + pool["b"].to(compute_dtype))


def bert_lm_logits(params, x: torch.Tensor, cfg: ModelConfig,
                   compute_dtype) -> torch.Tensor:
    """MLM head: dense + exact GELU + LayerNorm, then the tied decode in the
    compute dtype, cast to fp32, plus the fp32 bias."""
    lh = params["lm_head"]
    y = x @ lh["dense"]["w"].to(compute_dtype) + \
        lh["dense"]["b"].to(compute_dtype)
    y = F.gelu(y)
    y = apply_norm(cfg.norm_type, lh["norm"], y, cfg.norm_epsilon)
    w_out = params["embedding"]["word_embeddings"].T.to(compute_dtype)
    return (y @ w_out).float() + lh["bias"].float()


def bert_nsp_logits(params, pooled: torch.Tensor,
                    compute_dtype) -> torch.Tensor:
    """NSP binary head over the pooled output, in fp32."""
    bh = params["binary_head"]
    return (pooled @ bh["w"].to(compute_dtype)
            + bh["b"].to(compute_dtype)).float()


def bert_forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                 tokentype_ids=None, padding_mask=None,
                 generator: Optional[torch.Generator] = None,
                 deterministic: bool = True):
    """tokens [b, s] -> (lm_logits [b, s, V] fp32, nsp_logits [b, 2] fp32).
    `padding_mask` [b, s] (1 = real) keeps pads out of the real tokens'
    attention."""
    compute_dtype = as_dtype(cfg.compute_dtype)
    x, pooled = bert_encode(params, tokens, cfg, tokentype_ids=tokentype_ids,
                            padding_mask=padding_mask, generator=generator,
                            deterministic=deterministic)
    return (bert_lm_logits(params, x, cfg, compute_dtype),
            bert_nsp_logits(params, pooled, compute_dtype))


def bert_loss(params, batch: dict, cfg: ModelConfig, *,
              generator: Optional[torch.Generator] = None,
              deterministic: bool = True) -> torch.Tensor:
    """The masked-LM mean over `loss_mask` plus, with "is_random", the mean
    NSP cross-entropy. batch: tokens, labels, loss_mask [b, s] and
    optionally tokentype_ids, padding_mask [b, s] and is_random [b]."""
    lm_logits, nsp_logits = bert_forward(
        params, batch["tokens"], cfg,
        tokentype_ids=batch.get("tokentype_ids"),
        padding_mask=batch.get("padding_mask"), generator=generator,
        deterministic=deterministic)
    losses = cross_entropy_loss(lm_logits, batch["labels"],
                                vocab_size=cfg.vocab_size)
    mask = batch["loss_mask"].float()
    total = (losses * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    if "is_random" in batch:
        total = total + cross_entropy_loss(nsp_logits,
                                           batch["is_random"]).mean()
    return total
