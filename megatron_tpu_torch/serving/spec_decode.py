"""Draft proposal for speculative decoding on the slot grid
(megatron_tpu/serving/spec_decode.py).

The engine (`ServingConfig.speculative_k`) proposes k draft tokens per
running slot on the host and verifies every slot's drafts in one
[slots, k+1]-token forward (inference/generation.py `verify_tokens`). This
module owns the draft side. It is stateless between engine iterations, so
a preempted, parked or restarted slot carries only committed tokens and
the next window proposes again from them.

`Drafter` is the seam: anything with `propose(tokens, n) -> list[int]`
(`ServingEngine(drafter=...)`). The default `NGramDrafter` is
prompt-lookup self-drafting: match the history's trailing n-gram against
the request's own earlier tokens and propose what followed its most recent
occurrence. A bad draft is rejected by the verify step, never committed.
"""
from __future__ import annotations

from typing import List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np


@runtime_checkable
class Drafter(Protocol):
    """`propose(tokens, n)` returns up to `n` guesses for the tokens that
    follow the committed history `tokens` (an empty list: no proposal).
    It runs on the engine thread once per sync window per running slot."""

    def propose(self, tokens: Sequence[int], n: int) -> List[int]:
        ...


class NGramDrafter:
    """Match the last `max_ngram` (down to `min_ngram`) committed tokens
    against the history and propose the continuation of the most recent
    earlier occurrence; longer patterns are tried first. One pass over at
    most the last `scan_window` tokens builds an ngram -> last-start table,
    so a proposal costs O(scan_window * max_ngram) on the host."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 scan_window: int = 1024):
        if not 1 <= min_ngram <= max_ngram < scan_window:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram < "
                             f"scan_window, got {min_ngram}, {max_ngram}, "
                             f"{scan_window}")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.scan_window = scan_window

    def propose(self, tokens: Sequence[int], n: int) -> List[int]:
        toks = list(tokens[-self.scan_window:])
        L = len(toks)
        if n <= 0 or L < self.min_ngram + 1:
            return []
        hi = min(self.max_ngram, L - 1)
        # the last start of every ngram, excluding the trailing pattern
        # itself (start + size == L)
        last: dict = {}
        for size in range(self.min_ngram, hi + 1):
            for start in range(0, L - size):
                last[(size, tuple(toks[start:start + size]))] = start
        for size in range(hi, self.min_ngram - 1, -1):
            start = last.get((size, tuple(toks[-size:])))
            if start is not None:
                cont = toks[start + size:start + size + n]
                if cont:
                    return cont
        return []


NO_DRAFT = -1  # filler: never accepted, never sets the residual carry


def build_draft_rounds(histories: List[Optional[Sequence[int]]],
                       drafter: Drafter, k: int, rounds: int):
    """Draft grids for one sync window of `rounds` verify rounds.
    `histories[s]` is slot s's committed tokens (None: an idle row).
    Returns (grids, any_real, guesses): `grids` holds `rounds` int32
    [slots, k] arrays, `any_real[r]` whether round r carries a real draft
    (an all-filler round runs the plain decode step instead), `guesses[r]`
    the int32 [slots] token each round's drafts were proposed after.

    One continuation of rounds * (k+1) tokens is proposed per slot under
    the assumption that every earlier round accepts in full: round r takes
    C[r(k+1)+1 : r(k+1)+1+k], index r(k+1) being the round's own sampled
    first token, which the host cannot know. A wrong guess costs
    acceptance, never correctness. Empty proposals, idle rows and the tail
    of a short proposal fill with NO_DRAFT."""
    S = len(histories)
    need = rounds * (k + 1)
    conts = [[] if hist is None else list(drafter.propose(hist, need))
             for hist in histories]
    grids, any_real, guesses = [], [], []
    for r in range(rounds):
        grid = np.full((S, k), NO_DRAFT, np.int32)
        g0 = np.full((S,), NO_DRAFT, np.int32)
        real = False
        lo = r * (k + 1) + 1
        for s, cont in enumerate(conts):
            piece = cont[lo:lo + k]
            if piece:
                grid[s, :len(piece)] = piece
                real = True
            if lo - 1 < len(cont):
                g0[s] = cont[lo - 1]
        grids.append(grid)
        any_real.append(real)
        guesses.append(g0)
    return grids, any_real, guesses
