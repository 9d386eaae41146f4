"""Classification and multiple-choice heads over the BERT encoder
(megatron_tpu/models/classification.py).

Both models are the BERT encoder and pooler without the pretraining heads
(`bert.strip_pretraining_heads`) plus a dense head over the pooled output,
after the hidden dropout:

- `ClassificationModel`: "classification_head" [h, num_classes]; tokens
  [b, s] -> fp32 logits [b, num_classes];
- `MultipleChoiceModel`: "multichoice_head" [h, 1]; tokens [b, c, s] are
  scored as b * c rows and reshaped back to fp32 logits [b, c].

`EncoderTree` is the ParamTree base of every model over BERT towers here
and in models/biencoder.py: built from parameter specs as `BertModel` is
(weights from a generator seeded with `seed` on `device`, the current CUDA
device when None, empty on "meta"), under the JAX tree's names.
"""
from __future__ import annotations

from typing import Optional

import torch

from megatron_tpu_torch.config import ModelConfig, as_dtype
from megatron_tpu_torch.models.bert import (bert_encode, bert_init,
                                            shard_tree,
                                            strip_pretraining_heads)
from megatron_tpu_torch.models.language_model import (ParamTree,
                                                      build_param_tree,
                                                      param_maker)
from megatron_tpu_torch.ops.cross_entropy import cross_entropy_loss
from megatron_tpu_torch.ops.dropout import dropout
from megatron_tpu_torch.utils.device import DeviceLike


def dense_spec(cfg: ModelConfig, out: int) -> dict:
    """A dense head [h, out] drawn like the encoder's weights, zero bias."""
    return {"w": ((cfg.hidden_size, out), ("normal", cfg.init_method_std)),
            "b": ((out,), ("fill", 0.0))}


def dense(head, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    return x @ head["w"].to(compute_dtype) + head["b"].to(compute_dtype)


class EncoderTree(ParamTree):
    """A model over BERT towers: `specs(cfg, **options)` gives its tree;
    `options_from_tree` reads the options back off a state_dict's names
    and shapes (the weight bridge needs them)."""

    stacked_prefixes = ("transformer.",)

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0,
                 trainable: bool = False, mesh=None, **options):
        children = build_param_tree(
            self.specs(cfg, **options),
            param_maker(cfg, device, dtype, seed, trainable))
        if mesh is not None:  # only a model with `axes` has a sharded layout
            children = shard_tree(children, self.axes(cfg, **options), cfg,
                                  mesh, trainable)
        super().__init__(children)
        self.cfg = cfg
        self.options = options
        self.mesh = mesh

    @staticmethod
    def specs(cfg: ModelConfig, **options) -> dict:
        raise NotImplementedError

    @staticmethod
    def axes(cfg: ModelConfig, **options) -> dict:
        """The tree's logical axes, for a model built on a mesh."""
        raise NotImplementedError(
            "this model has no sharded layout (ROADMAP Queue 1 item 7)")

    def param_axes(self) -> dict:
        return self.axes(self.cfg, **self.options)

    @classmethod
    def options_from_tree(cls, shapes: dict) -> dict:
        """{name: shape} of a state_dict -> the constructor's options."""
        return {}

    @classmethod
    def from_state_dict(cls, cfg: ModelConfig, state_dict: dict, *,
                        trainable: bool = False, **options):
        """A model holding exactly these tensors (no copy, no init); the
        options default to what the tensors show."""
        options = {**cls.options_from_tree(
            {k: tuple(v.shape) for k, v in state_dict.items()}), **options}
        model = cls(cfg, device="meta", trainable=trainable, **options)
        model.load_state_dict(state_dict, strict=True, assign=True)
        return model

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


class ClassificationModel(EncoderTree):
    """BERT encoder + pooler + "classification_head" [h, num_classes]."""

    @staticmethod
    def specs(cfg: ModelConfig, *, num_classes: int) -> dict:
        tree = strip_pretraining_heads(bert_init(cfg))
        tree["classification_head"] = dense_spec(cfg, num_classes)
        return tree

    @classmethod
    def options_from_tree(cls, shapes: dict) -> dict:
        return {"num_classes": shapes["classification_head.w"][1]}

    def forward(self, tokens, **kwargs):
        return classification_forward(self, tokens, self.cfg, **kwargs)


class MultipleChoiceModel(EncoderTree):
    """BERT encoder + pooler + "multichoice_head" [h, 1]."""

    @staticmethod
    def specs(cfg: ModelConfig) -> dict:
        tree = strip_pretraining_heads(bert_init(cfg))
        tree["multichoice_head"] = dense_spec(cfg, 1)
        return tree

    def forward(self, tokens, **kwargs):
        return multiple_choice_forward(self, tokens, self.cfg, **kwargs)


def _pooled_head(params, head: str, tokens, cfg: ModelConfig, *,
                 tokentype_ids, padding_mask, generator, deterministic):
    """pooled -> hidden dropout -> the dense head, in the compute dtype."""
    compute_dtype = as_dtype(cfg.compute_dtype)
    if deterministic:
        generator = None
    _, pooled = bert_encode(params, tokens, cfg, tokentype_ids=tokentype_ids,
                            padding_mask=padding_mask, generator=generator,
                            deterministic=deterministic)
    pooled = dropout(generator, pooled, cfg.hidden_dropout)
    return dense(params[head], pooled, compute_dtype)


def classification_forward(params, tokens: torch.Tensor, cfg: ModelConfig,
                           *, tokentype_ids=None, padding_mask=None,
                           generator: Optional[torch.Generator] = None,
                           deterministic: bool = True) -> torch.Tensor:
    """tokens [b, s] -> fp32 logits [b, num_classes]. With `deterministic`
    False the generator draws the encoder's and the pooled dropout."""
    return _pooled_head(params, "classification_head", tokens, cfg,
                        tokentype_ids=tokentype_ids,
                        padding_mask=padding_mask, generator=generator,
                        deterministic=deterministic).float()


def multiple_choice_forward(params, tokens: torch.Tensor, cfg: ModelConfig,
                            *, tokentype_ids=None, padding_mask=None,
                            generator: Optional[torch.Generator] = None,
                            deterministic: bool = True) -> torch.Tensor:
    """tokens [b, c, s] -> fp32 logits [b, c]: each choice a row of the
    encoder's batch."""
    b, c, s = tokens.shape

    def flat(x):
        return None if x is None else x.reshape(b * c, s)
    scores = _pooled_head(params, "multichoice_head", flat(tokens), cfg,
                          tokentype_ids=flat(tokentype_ids),
                          padding_mask=flat(padding_mask),
                          generator=generator, deterministic=deterministic)
    return scores.reshape(b, c).float()


def _loss(forward, params, batch: dict, cfg: ModelConfig, generator,
          deterministic) -> torch.Tensor:
    logits = forward(params, batch["tokens"], cfg,
                     tokentype_ids=batch.get("tokentype_ids"),
                     padding_mask=batch.get("padding_mask"),
                     generator=generator, deterministic=deterministic)
    return cross_entropy_loss(logits, batch["label"]).mean()


def classification_loss(params, batch: dict, cfg: ModelConfig, *,
                        generator: Optional[torch.Generator] = None,
                        deterministic: bool = True) -> torch.Tensor:
    """Mean cross-entropy of the class logits. batch: tokens [b, s], label
    [b] and optionally tokentype_ids, padding_mask [b, s]."""
    return _loss(classification_forward, params, batch, cfg, generator,
                 deterministic)


def multiple_choice_loss(params, batch: dict, cfg: ModelConfig, *,
                         generator: Optional[torch.Generator] = None,
                         deterministic: bool = True) -> torch.Tensor:
    """Mean cross-entropy over the choices. batch: tokens [b, c, s], label
    [b] and optionally tokentype_ids, padding_mask [b, c, s]."""
    return _loss(multiple_choice_forward, params, batch, cfg, generator,
                 deterministic)
