"""Token sampling: temperature / top-k / top-p
(megatron_tpu/inference/sampling.py `sample`, the per-row filters
`_top_k_filter_rows` / `_top_p_filter_rows`, the serving engine's
`sample_batched` and speculative decoding's `verify_draft_probs`; the
reference's scalar filters are these at one k or p for every row).

Random draws take an explicit `torch.Generator`; they cannot reproduce the
reference's `jax.random` bits, so seeded sampling is deterministic within
the port only.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def _processed(logits: torch.Tensor, temperature: torch.Tensor,
               top_k: Optional[torch.Tensor],
               top_p: Optional[torch.Tensor]) -> torch.Tensor:
    """Temperature, then top-k, then top-p, with per-row knobs; a filter
    given as None is off on every row and skips its sort. `sample` and
    `sample_batched` both draw from this, so a row's processed logits are
    the same arithmetic at any batch size (a row whose filter is off keeps
    its logits exactly, whether the filter ran for other rows or not)."""
    x = logits / torch.clamp(temperature, min=1e-6)[:, None]
    if top_k is not None:
        x = _top_k_filter_rows(x, top_k)
    if top_p is not None:
        x = _top_p_filter_rows(x, top_p)
    return x


def sample(generator: Optional[torch.Generator], logits: torch.Tensor, *,
           top_k: int = 0, top_p: float = 0.0, temperature: float = 1.0,
           vocab_size: Optional[int] = None) -> torch.Tensor:
    """One sampling step over [batch, vocab] logits. Returns int64 [batch].
    Greedy (argmax, first index on ties) when temperature == 0 or
    top_k == 1; the padded vocab tail is never drawn."""
    logits = logits.float()
    if vocab_size is not None and vocab_size < logits.shape[-1]:
        logits = logits.clone()
        logits[..., vocab_size:] = float("-inf")
    if temperature == 0.0 or top_k == 1:
        return torch.argmax(logits, dim=-1)
    b, dev = logits.shape[0], logits.device
    x = _processed(
        logits,
        torch.full((b,), temperature, dtype=torch.float32, device=dev),
        (torch.full((b,), top_k, dtype=torch.int64, device=dev)
         if top_k > 0 else None),
        (torch.full((b,), top_p, dtype=torch.float32, device=dev)
         if 0.0 < top_p < 1.0 else None))
    probs = torch.softmax(x, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _top_k_filter_rows(logits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Keep the k[i] largest logits of row i (k [b]; 0 disables the
    row)."""
    V = logits.shape[-1]
    srt = torch.sort(logits, dim=-1).values  # ascending
    # sorted[V - k] == sorted[-k], the serial filter's threshold
    idx = torch.clamp(V - torch.clamp(k, min=1), 0, V - 1).long()
    kth = torch.gather(srt, -1, idx[:, None])
    filtered = logits.masked_fill(logits < kth, float("-inf"))
    return torch.where((k > 0)[:, None], filtered, logits)


def _top_p_filter_rows(logits: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Nucleus filtering with a per-row p [b] (<= 0 or >= 1 disables the
    row): a sorted position is kept while the probability mass before it is
    < p, so the top token always stays."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p[:, None]
    min_kept = torch.where(keep_sorted, sorted_logits,
                           torch.full_like(sorted_logits, float("inf"))
                           ).amin(dim=-1, keepdim=True)
    filtered = logits.masked_fill(logits < min_kept, float("-inf"))
    return torch.where(((p > 0.0) & (p < 1.0))[:, None], filtered, logits)


def sample_batched(generators: Sequence[Optional[torch.Generator]],
                   logits: torch.Tensor, *, temperature: torch.Tensor,
                   top_k: Optional[torch.Tensor],
                   top_p: Optional[torch.Tensor],
                   vocab_size: Optional[int] = None,
                   banned: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One sampling step with per-row knobs: the continuous-batching
    engine's path, where one decode step serves slots carrying different
    requests. logits [b, vocab]; temperature / top_p float32 [b]; top_k
    int [b]; `generators[i]` draws row i. Returns int64 [b]. A caller that
    knows a filter is off on every row passes None for its knob and skips
    its [b, vocab] sort.

    A row with no generator takes the argmax and draws nothing: the caller
    gives greedy rows (temperature 0 or top_k 1) none, as the serial path
    draws nothing for them, and greedy rows return the argmax whatever
    they are given. Every other row is filtered and drawn as its own
    [1, vocab] call with its own generator, the call `sample` makes at
    batch 1, so a row's stream equals the serial path's for the same seed;
    with no such row nothing is filtered. Nothing here reads a tensor back
    to the host, with a mask or without. `banned` [b] (< 0 off)
    masks one token of the processed distribution, `mask` [b, vocab]
    (True = allowed) a set of them; greedy rows obey `mask` but not
    `banned`, and a row whose mask allows nothing returns -1
    (sampling.py sample_batched): a drawing row still draws there (from
    the uniform distribution, below) and the draw is discarded, since its
    request fails and its generator with it. An all-True mask row is
    bit-identical to mask=None. A drawing row whose logits are not finite
    draws a token uniformly (the reference draws garbage there too)
    instead of raising."""
    logits = logits.float()
    if vocab_size is not None and vocab_size < logits.shape[-1]:
        logits = logits.clone()
        logits[..., vocab_size:] = float("-inf")
    gated = logits if mask is None else logits.masked_fill(~mask,
                                                           float("-inf"))
    greedy = torch.argmax(gated, dim=-1)
    out = greedy.clone()
    live = None if mask is None else mask.any(dim=-1)
    rows = [i for i, gen in enumerate(generators) if gen is not None]
    if rows:
        x = _processed(logits, temperature, top_k, top_p)
        if banned is not None:
            iota = torch.arange(x.shape[-1], device=x.device)[None]
            x = x.masked_fill(
                (banned[:, None] >= 0) & (iota == banned[:, None]),
                float("-inf"))
        if mask is not None:
            x = x.masked_fill(~mask, float("-inf"))
        for i in rows:
            probs = torch.softmax(x[i:i + 1], dim=-1)
            # a poisoned row (non-finite logits) draws from the uniform
            # distribution instead of raising, with no host read; its
            # non-finite logprob fails it in the engine
            probs = torch.where(torch.isfinite(probs).all(), probs,
                                torch.ones_like(probs))
            out[i] = torch.multinomial(probs, 1,
                                       generator=generators[i])[0, 0]
        is_greedy = temperature == 0.0
        if top_k is not None:
            is_greedy = is_greedy | (top_k == 1)
        out = torch.where(is_greedy, greedy, out)
    if live is not None:
        out = torch.where(live, out, torch.full_like(out, -1))
    return out


def verify_draft_probs(logits: torch.Tensor, drafts: torch.Tensor, *,
                       temperature: torch.Tensor,
                       top_k: Optional[torch.Tensor],
                       top_p: Optional[torch.Tensor],
                       vocab_size: Optional[int] = None,
                       mask: Optional[torch.Tensor] = None):
    """Acceptance inputs of a speculative verify window
    (sampling.py verify_draft_probs). logits [b, w, vocab]: position j
    holds the model's distribution for the token drafts[:, j] claims;
    drafts [b, w]; temperature / top_p [b], top_k [b] (None: off on every
    row), one set of knobs a row. Returns (probs [b, w] fp32, targets
    [b, w] int64): the processed probability of each draft under the
    pipeline `sample_batched` draws from (`_processed`, with each row's
    knobs repeated over its positions), which point-mass rejection
    sampling accepts against, and the plain argmax, which greedy rows
    accept by exact match. A negative draft (a filler) reads its row's
    last vocabulary entry, as the reference's index wraps.

    `mask` [b, w, vocab] (True = allowed) holds a grammar-constrained
    row's legal tokens at each position: an illegal draft's probability
    is 0 (never accepted, the uniform lying in [0, 1)), the greedy target
    is the masked argmax, -1 at a position that allows nothing, and an
    all-True position is bit-identical to mask=None."""
    b, w, V = logits.shape
    x = logits.float().reshape(b * w, V)
    if vocab_size is not None and vocab_size < V:
        x = x.clone()
        x[:, vocab_size:] = float("-inf")
    m = None if mask is None else mask.reshape(b * w, V)
    if m is None:
        targets = torch.argmax(x, dim=-1)
    else:
        targets = torch.argmax(x.masked_fill(~m, float("-inf")), dim=-1)
        targets = torch.where(m.any(dim=-1), targets,
                              torch.full_like(targets, -1))
    x = _processed(
        x, temperature.repeat_interleave(w),
        None if top_k is None else top_k.repeat_interleave(w),
        None if top_p is None else top_p.repeat_interleave(w))
    if m is not None:
        x = x.masked_fill(~m, float("-inf"))
    p = torch.softmax(x, dim=-1)
    idx = drafts.reshape(b * w, 1).long().remainder(V)
    return (p.gather(-1, idx)[:, 0].reshape(b, w),
            targets.reshape(b, w))
