"""T5: an encoder-decoder transformer with cross-attention
(megatron_tpu/models/t5.py).

This is the repo's (Megatron's) T5: pre-LN LayerNorm, learned positions,
GELU and biases, a bidirectional encoder stack and a causal decoder stack
whose layers attend the normed encoder output, one shared embedding and
a tied LM head with its own bias. `T5Model` holds the reference's
parameter tree under its names ("encoder.attention.wq",
"decoder.inter_attention.wkv", "lm_head_bias", ...). Encoder padding
isolates each pad position in a segment of its own; the cross-attention
takes no segment ids, so the decoder attends encoder pads, as the
reference's does. The pipelined T5 loss (`t5_pipeline_loss_fn`) belongs to
the multi-device slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from megatron_tpu_torch.config import ModelConfig, as_dtype
from megatron_tpu_torch.models import transformer as tfm
from megatron_tpu_torch.models.bert import bert_pad_segments
from megatron_tpu_torch.models.language_model import (ParamTree,
                                                      build_param_tree,
                                                      param_maker)
from megatron_tpu_torch.models.norms import apply_norm, norm_init
from megatron_tpu_torch.ops.cross_entropy import cross_entropy_loss
from megatron_tpu_torch.utils.device import DeviceLike


def t5_config(**overrides) -> ModelConfig:
    """T5-base's widths (t5.py t5_config): 12 + 12 layers, h 768, 12 heads,
    ffn 3072, vocab 32128, encoder seq 512."""
    base = dict(
        num_layers=12, hidden_size=768, num_attention_heads=12,
        vocab_size=32128, seq_length=512, use_rotary_emb=False,
        use_position_embedding=True, norm_type="layernorm",
        activation="gelu", use_bias=True, use_post_ln=False,
        tie_embed_logits=True,
    )
    base.update(overrides)
    return ModelConfig(**base).derived()


def t5_init(cfg: ModelConfig, decoder_layers: Optional[int] = None) -> dict:
    """Parameter specs of the whole model (t5.py t5_init)."""
    h, v, std = cfg.hidden_size, cfg.padded_vocab_size, cfg.init_method_std
    return {
        "embedding": {
            "word_embeddings": ((v, h), ("normal", std)),
            "position_embeddings": ((cfg.max_position_embeddings, h),
                                    ("normal", std)),
        },
        "encoder": tfm.stack_init(cfg),
        "encoder_norm": norm_init(cfg.norm_type, h),
        "decoder": tfm.stack_init(cfg, num_layers=decoder_layers,
                                  cross_attn=True),
        "decoder_norm": norm_init(cfg.norm_type, h),
        "lm_head_bias": ((v,), ("fill", 0.0)),
    }


class T5Model(ParamTree):
    """T5's parameter tree as a module, built as `LanguageModel` builds its
    own (see models/bert.py BertModel)."""

    stacked_prefixes = ("encoder.", "decoder.")

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0,
                 trainable: bool = False,
                 decoder_layers: Optional[int] = None):
        super().__init__(build_param_tree(
            t5_init(cfg, decoder_layers),
            param_maker(cfg, device, dtype, seed, trainable)))
        self.cfg = cfg

    @classmethod
    def from_state_dict(cls, cfg: ModelConfig, state_dict: dict, *,
                        trainable: bool = False):
        """A model holding exactly these tensors (no copy, no init); the
        decoder's depth is read off the state."""
        layers = state_dict["decoder.attention.wq"].shape[0]
        model = cls(cfg, device="meta", trainable=trainable,
                    decoder_layers=layers)
        model.load_state_dict(state_dict, strict=True, assign=True)
        return model

    @property
    def device(self) -> torch.device:
        return self.embedding["word_embeddings"].device

    def forward(self, enc_tokens, dec_tokens, **kwargs):
        return t5_forward(self, enc_tokens, dec_tokens, self.cfg, **kwargs)


def _embed(params, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    emb = params["embedding"]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = emb["word_embeddings"][tokens] + emb["position_embeddings"][pos][None]
    return x.to(compute_dtype)


def t5_forward(params, enc_tokens: torch.Tensor, dec_tokens: torch.Tensor,
               cfg: ModelConfig, *, enc_padding_mask=None,
               generator: Optional[torch.Generator] = None,
               deterministic: bool = True) -> torch.Tensor:
    """-> lm_logits [b, s_dec, V] fp32."""
    if cfg.num_experts != 1:
        raise ValueError("MoE's router loss is only wired into the GPT loss")
    compute_dtype = as_dtype(cfg.compute_dtype)
    seg = (None if enc_padding_mask is None
           else bert_pad_segments(enc_padding_mask))
    x = _embed(params, enc_tokens, compute_dtype)
    enc, _, _ = tfm.stack_apply(params["encoder"], x, cfg, causal=False,
                                segment_ids=seg, generator=generator,
                                deterministic=deterministic)
    enc = apply_norm(cfg.norm_type, params["encoder_norm"], enc,
                     cfg.norm_epsilon)
    y = _embed(params, dec_tokens, compute_dtype)
    dec, _, _ = tfm.stack_apply(params["decoder"], y, cfg, causal=True,
                                encoder_output=enc, generator=generator,
                                deterministic=deterministic)
    return t5_lm_logits(params, dec, cfg, compute_dtype)


def t5_lm_logits(params, dec: torch.Tensor, cfg: ModelConfig,
                 compute_dtype) -> torch.Tensor:
    """Decoder-final norm, tied decode in the compute dtype, cast to fp32,
    plus the fp32 bias."""
    dec = apply_norm(cfg.norm_type, params["decoder_norm"], dec,
                     cfg.norm_epsilon)
    w_out = params["embedding"]["word_embeddings"].T.to(compute_dtype)
    return (dec @ w_out).float() + params["lm_head_bias"].float()


def t5_loss(params, batch: dict, cfg: ModelConfig, *,
            generator: Optional[torch.Generator] = None,
            deterministic: bool = True) -> torch.Tensor:
    """The decoder's masked-mean cross-entropy. batch: text_enc [b, s_enc],
    text_dec, labels, loss_mask [b, s_dec] and optionally enc_mask."""
    logits = t5_forward(params, batch["text_enc"], batch["text_dec"], cfg,
                        enc_padding_mask=batch.get("enc_mask"),
                        generator=generator, deterministic=deterministic)
    losses = cross_entropy_loss(logits, batch["labels"],
                                vocab_size=cfg.vocab_size)
    mask = batch["loss_mask"].float()
    return (losses * mask).sum() / torch.clamp(mask.sum(), min=1.0)
