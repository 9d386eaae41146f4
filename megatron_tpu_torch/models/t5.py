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
reference's does.

`T5Model(cfg, mesh=...)` holds this rank's parts of the tree under
`t5_axes` and runs the sharded forward of the (dp, tp) mesh as BERT's
(models/bert.py): the vocab-parallel shared embedding, both sharded
stacks, the decoder's cross-attention over the encoder output entered
through `tp_region_in` (sequence-gathered under sequence parallelism), and
the tied head with its vocab-sharded bias into the vocab-parallel
cross-entropy; `t5_loss` returns the rank's share of the global
microbatch's loss.

`t5_pipeline_loss_fn` pipelines both stacks over pp (the reference's two
`pipeline_apply` passes over the same axis, each stage holding its
chunks of the encoder and of the decoder): a gpipe forward of the
encoder, whose last stage norms the outputs and broadcasts them to every
stage; the decoder's gpipe pass with the head on its last stage, each
stage's cross-attention reading the broadcast tensor; the tensor's grads
summed over pp and taken back through the norm on the last stage; then
the encoder's gpipe backward.
"""
from __future__ import annotations

from typing import Optional

import torch

from megatron_tpu_torch.config import ModelConfig, as_dtype
from megatron_tpu_torch.models import transformer as tfm
from megatron_tpu_torch.models.bert import (bert_pad_segments, global_sum,
                                            shard_tree, sp_part)
from megatron_tpu_torch.models.language_model import (
    ParamTree, build_param_tree, param_maker, vocab_parallel_embedding)
from megatron_tpu_torch.models.norms import apply_norm, norm_axes, norm_init
from megatron_tpu_torch.ops.cross_entropy import mesh_cross_entropy
from megatron_tpu_torch.parallel import collectives
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


def t5_axes(cfg: ModelConfig) -> dict:
    """Logical axes of the parameters (t5.py t5_axes)."""
    return {
        "embedding": {"word_embeddings": ("vocab", "embed"),
                      "position_embeddings": (None, "embed")},
        "encoder": tfm.stack_axes(cfg),
        "encoder_norm": norm_axes(cfg.norm_type),
        "decoder": tfm.stack_axes(cfg, cross_attn=True),
        "decoder_norm": norm_axes(cfg.norm_type),
        "lm_head_bias": ("vocab",),
    }


class T5Model(ParamTree):
    """T5's parameter tree as a module, built as `LanguageModel` builds its
    own (see models/bert.py BertModel), on a `mesh` this rank's parts."""

    stacked_prefixes = ("encoder.", "decoder.")

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0,
                 trainable: bool = False,
                 decoder_layers: Optional[int] = None, mesh=None):
        super().__init__(shard_tree(build_param_tree(
            t5_init(cfg, decoder_layers),
            param_maker(cfg, device, dtype, seed, trainable)),
            t5_axes(cfg), cfg, mesh, trainable))
        self.cfg = cfg
        self.mesh = mesh

    def param_axes(self) -> dict:
        return t5_axes(self.cfg)

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


def _embed(params, tokens: torch.Tensor, compute_dtype,
           mesh=None) -> torch.Tensor:
    emb = params["embedding"]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    word = emb["word_embeddings"]
    x = (word[tokens] if mesh is None
         else vocab_parallel_embedding(word, tokens, mesh, word.dtype))
    x = x + sp_part(emb["position_embeddings"][pos][None], mesh)
    return x.to(compute_dtype)


def t5_forward(params, enc_tokens: torch.Tensor, dec_tokens: torch.Tensor,
               cfg: ModelConfig, *, enc_padding_mask=None,
               generator: Optional[torch.Generator] = None,
               deterministic: bool = True) -> torch.Tensor:
    """-> lm_logits [b, s_dec, V] fp32 (the rank's vocab columns of a
    T5Model built on a mesh)."""
    if cfg.num_experts != 1:
        raise ValueError("MoE's router loss is only wired into the GPT loss")
    mesh = getattr(params, "mesh", None)
    compute_dtype = as_dtype(cfg.compute_dtype)
    seg = (None if enc_padding_mask is None
           else bert_pad_segments(enc_padding_mask))
    x = _embed(params, enc_tokens, compute_dtype, mesh)
    enc, _, _ = tfm.stack_apply(params["encoder"], x, cfg, causal=False,
                                segment_ids=seg, generator=generator,
                                deterministic=deterministic, mesh=mesh)
    enc = apply_norm(cfg.norm_type, params["encoder_norm"], enc,
                     cfg.norm_epsilon)
    y = _embed(params, dec_tokens, compute_dtype, mesh)
    dec, _, _ = tfm.stack_apply(params["decoder"], y, cfg, causal=True,
                                encoder_output=enc, generator=generator,
                                deterministic=deterministic, mesh=mesh)
    return t5_lm_logits(params, dec, cfg, compute_dtype, mesh)


def t5_lm_logits(params, dec: torch.Tensor, cfg: ModelConfig,
                 compute_dtype, mesh=None) -> torch.Tensor:
    """Decoder-final norm, tied decode in the compute dtype, cast to fp32,
    plus the fp32 bias; on a `mesh` the rank's vocab columns."""
    dec = apply_norm(cfg.norm_type, params["decoder_norm"], dec,
                     cfg.norm_epsilon)
    if mesh is not None:
        dec = collectives.tp_region_in(dec, mesh)
    w_out = params["embedding"]["word_embeddings"].T.to(compute_dtype)
    return (dec @ w_out).float() + params["lm_head_bias"].float()


def t5_loss(params, batch: dict, cfg: ModelConfig, *,
            generator: Optional[torch.Generator] = None,
            deterministic: bool = True) -> torch.Tensor:
    """The decoder's masked-mean cross-entropy. batch: text_enc [b, s_enc],
    text_dec, labels, loss_mask [b, s_dec] and optionally enc_mask. On a
    mesh, the rank's share: its masked sum over the whole microbatch's
    count."""
    mesh = getattr(params, "mesh", None)
    logits = t5_forward(params, batch["text_enc"], batch["text_dec"], cfg,
                        enc_padding_mask=batch.get("enc_mask"),
                        generator=generator, deterministic=deterministic)
    losses = mesh_cross_entropy(logits, batch["labels"], mesh,
                                vocab_size=cfg.vocab_size)
    mask = batch["loss_mask"].float()
    return (losses * mask).sum() / torch.clamp(
        global_sum(mask.sum(), mesh), min=1.0)


def t5_pipeline_loss_fn(model, batch: dict, cfg: ModelConfig, *,
                        vpp: int = 1, seeds: Optional[list] = None,
                        deterministic: bool = True,
                        cotangent=None) -> tuple:
    """T5's loss with both stacks pipelined over the pp axis of the model's
    mesh (see the module's note), from the batch's [n_micro, ...] entries
    (the rank's dp rows): the mean over microbatches of each one's
    masked mean, on every rank. With a `cotangent` (the loss scale) the
    backward runs too: returns (loss, {name: fp32 grad} of cotangent times
    the loss, the shared leaves' summed over pp), else (loss, None).
    `seeds` are the microbatches' dropout seeds (the encoder's layers from
    fold_seed(seed, 1), the decoder's from fold_seed(seed, 2))."""
    from megatron_tpu_torch.ops.dropout import fold_seed
    from megatron_tpu_torch.parallel import pipeline as pl
    from megatron_tpu_torch.parallel.mesh import PIPELINE_AXIS
    if cfg.num_experts != 1:
        raise ValueError("T5 pipeline path has no MoE router-aux threading")
    mesh = model.mesh
    pp, stage = mesh.shape[PIPELINE_AXIS], mesh.coords[PIPELINE_AXIS]
    last = stage == pp - 1
    train = cotangent is not None
    compute_dtype = as_dtype(cfg.compute_dtype)
    n_micro, b, s_enc = batch["text_enc"].shape
    s_dec = batch["text_dec"].shape[-1]
    det = deterministic or seeds is None

    def intake(key):
        def fn(m, sl, seed):
            return _embed(m, sl[key], compute_dtype, mesh)
        return fn

    def enc_chunk(cp, h, sl, offset, seed, remat=True):
        seg = (bert_pad_segments(sl["enc_mask"]) if "enc_mask" in sl
               else None)
        return tfm.stack_apply(
            cp, h, cfg, causal=False, segment_ids=seg, deterministic=det,
            layer_seed=None if det else fold_seed(seed, 1),
            layer_offset=offset, mesh=mesh, remat=remat)[0]

    def dec_chunk(cp, h, sl, offset, seed, remat=True):
        return tfm.stack_apply(
            cp, h, cfg, causal=True, encoder_output=sl["enc"],
            deterministic=det,
            layer_seed=None if det else fold_seed(seed, 2),
            layer_offset=offset, mesh=mesh, remat=remat)[0]

    def head(m, h, sl, seed):
        losses = mesh_cross_entropy(
            t5_lm_logits(m, h, cfg, compute_dtype, mesh), sl["labels"],
            mesh, vocab_size=cfg.vocab_size)
        mask = sl["loss_mask"].float()
        return (losses * mask).sum() / torch.clamp(
            global_sum(mask.sum(), mesh), min=1.0)

    grads = (pl.StageGrads(model, ("encoder", "decoder"), vpp) if train
             else None)

    def stack_kw(stack, seq):
        return dict(act_shape=pl.boundary_shape(mesh, b, seq,
                                                cfg.hidden_size),
                    vpp=vpp, seeds=None if det else seeds, grads=grads,
                    stacked=stack)

    try:
        with torch.set_grad_enabled(train):
            enc_run = pl.pipeline_apply(
                model, {"text_enc": batch["text_enc"],
                        "enc_mask": batch.get("enc_mask")}, cfg, mesh,
                intake_fn=intake("text_enc"), chunk_fn=enc_chunk,
                **stack_kw("encoder", s_enc))
            if last:
                outs = [enc_run.outputs[m].requires_grad_(train)
                        for m in range(n_micro)]
                normed = apply_norm(cfg.norm_type, model["encoder_norm"],
                                    torch.stack(outs), cfg.norm_epsilon)
                enc = normed.detach()
            else:
                enc = torch.empty((n_micro, *enc_run.act_shape),
                                  dtype=compute_dtype, device=model.device)
            enc = collectives.broadcast(enc, mesh, PIPELINE_AXIS, pp - 1)
            enc.requires_grad_(train)
            dec_run = pl.make_stage_run(
                model, {"text_dec": batch["text_dec"],
                        "labels": batch["labels"],
                        "loss_mask": batch["loss_mask"], "enc": enc}, cfg,
                mesh, intake=intake("text_dec"), chunk=dec_chunk, head=head,
                cotangent_seed=1.0 if cotangent is None else cotangent,
                **stack_kw("decoder", s_dec))
            dec_run.run(pl.stage_ticks(dec_run, "gpipe",
                                       "both" if train else "fwd"))
            if train:
                d_enc = (enc.grad if enc.grad is not None
                         else torch.zeros_like(enc))
                d_enc = collectives.all_reduce(d_enc, mesh, PIPELINE_AXIS)
                if last:
                    torch.autograd.backward(normed, d_enc.to(normed.dtype))
                    enc_run.top = {m: o.grad for m, o in enumerate(outs)}
                pl.pipeline_backward(enc_run)
    finally:
        out = grads.close() if train else None
    loss = collectives.all_reduce(dec_run.loss, mesh,
                                  PIPELINE_AXIS) / n_micro
    if train:
        out = pl.reduce_shared(out, ("encoder", "decoder"), mesh)
    return loss, out
