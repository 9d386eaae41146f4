"""GPT zero-shot evaluation: WikiText-style perplexity and LAMBADA accuracy
(tasks/zeroshot_gpt/evaluate.py).

- 'loss' (WIKITEXT103): the sum of the per-token cross-entropy over the
  pad mask, divided by num_tokenized_tokens - 1; ppl = exp(min(20, loss));
  the adjusted ppl rescales by the original-token ratio so that numbers
  compare across tokenizers.
- 'accuracy' (LAMBADA): a sample counts as correct only if every masked
  target token is the argmax prediction.

One forward gives both statistics, on the model's `attention_impl` (the
real-model presets take the flash kernels). The sums stay on the device
until the dataset ends: one host read for the whole run.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from megatron_tpu_torch.config import MegatronConfig
from megatron_tpu_torch.models import language_model as lm
from megatron_tpu_torch.ops.cross_entropy import cross_entropy_loss
from megatron_tpu_torch.tasks.zeroshot_gpt.datasets import iterate_batches
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device


def _make_forward(cfg: MegatronConfig, device: torch.device):
    mcfg = cfg.model
    rope = lm.make_rope(mcfg, device=device)

    @torch.inference_mode()
    def fwd(params, text, pad_mask, valid):
        tokens, labels = text[:, :-1], text[:, 1:]
        logits, _ = lm.model_forward(params, tokens, mcfg, rope=rope)
        losses = cross_entropy_loss(logits, labels,
                                    vocab_size=mcfg.vocab_size)
        loss_sum = (losses * pad_mask).sum()
        # a padded vocabulary's columns never win the argmax
        preds = logits[..., :mcfg.vocab_size].argmax(dim=-1)
        tok_ok = torch.where(pad_mask > 0, preds == labels,
                             torch.ones_like(preds, dtype=torch.bool))
        sample_ok = tok_ok.all(dim=-1).float() * valid
        return loss_sum, sample_ok.sum()

    return fwd


def evaluate_dataset(params, dataset, cfg: MegatronConfig, *,
                     batch_size: int = 8, mesh=None,
                     device: DeviceLike = None,
                     log_every: Optional[int] = None) -> dict:
    """Run the whole dataset through `params` (a LanguageModel or its tree,
    whose weights lie on `device`: the current CUDA device when None);
    returns both raw statistics."""
    if mesh is not None:
        raise NotImplementedError(
            "evaluate_dataset: a mesh (tensor, pipeline, data parallelism) "
            "is ported with the multi-device slice (ROADMAP Queue 1 item 7 "
            "(e))")
    device = resolve_device(device)
    where = lm.params_device(params)
    if where != device:
        raise ValueError(f"model weights lie on {where}, the evaluation "
                         f"runs on {device}")
    fwd = _make_forward(cfg, device)
    # each batch's fp32 sums added in float64, as the reference adds them
    # on the host
    loss_sum = torch.zeros((), dtype=torch.float64, device=device)
    correct = torch.zeros((), dtype=torch.float64, device=device)
    for i, batch in enumerate(iterate_batches(dataset, batch_size)):
        ls, ok = fwd(params,
                     torch.from_numpy(batch["text"]).to(device),
                     torch.from_numpy(batch["pad_mask"]).to(device),
                     torch.from_numpy(batch["valid"]).to(device))
        loss_sum += ls.double()
        correct += ok.double()
        if log_every and i % log_every == 0:
            print(f"> zeroshot eval: batch {i}", flush=True)
    return {"loss_sum": float(loss_sum), "correct": float(correct),
            "num_examples": len(dataset)}


def wikitext_metrics(stats: dict, dataset) -> dict:
    """The reference's WIKITEXT103 schema."""
    val_loss = stats["loss_sum"] / (dataset.num_tokenized_tokens - 1)
    ratio = ((dataset.num_tokenized_tokens - 1)
             / (dataset.num_original_tokens - 1))
    return {
        "avg loss": val_loss,
        "ppl": math.exp(min(20, val_loss)),
        "adjusted ppl": math.exp(min(20, val_loss * ratio)),
        "token ratio": ratio,
    }


def lambada_metrics(stats: dict) -> dict:
    """The reference's LAMBADA schema."""
    return {
        "number correct": stats["correct"],
        "total examples": float(stats["num_examples"]),
        "avg accuracy": stats["correct"] / max(stats["num_examples"], 1),
    }
