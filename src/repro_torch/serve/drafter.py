"""Draft-token proposers for self-speculative decoding.

Speculative decoding splits each decode iteration into *draft* (cheap,
host-side guesses for the next K tokens) and *verify* (one batched
multi-token step through the real model that scores all K+1 positions at
once). Any guess is *correct* — the verify step only emits tokens the
model itself would have produced greedily — so a drafter trades nothing
but wasted compute for its misses. The engine consumes drafters through
the ``Drafter`` protocol, so a small-model drafter can slot in later
without touching the engine; the default is prompt-lookup/n-gram
drafting (Saxena-style), which needs no extra model at all.

Drafting runs on the decode-loop thread against the slot's *host*
context (prompt + accepted tokens, appended by the verify continuation
when the device step actually finishes — the same completion-driven
bookkeeping the rest of the engine uses).
"""
from __future__ import annotations

from typing import List, Protocol, Sequence, runtime_checkable

import numpy as np


@runtime_checkable
class Drafter(Protocol):
    """Proposes up to ``k`` draft tokens given the decoded-so-far context.

    ``context`` is the request's prompt followed by every token emitted
    so far (host ints, in order). Implementations may return fewer than
    ``k`` tokens (including none) when they have no confident guess —
    the engine pads the verify batch and masks the missing positions.
    """

    def draft(self, context: Sequence[int], k: int) -> List[int]:
        ...


class NgramDrafter:
    """Prompt-lookup drafting: match the context's trailing n-gram
    against its own history and propose the tokens that followed the
    most recent previous occurrence.

    Tries ``max_ngram`` down to ``min_ngram`` (longer matches are more
    specific, so they win); within one n, the *most recent* prior
    occurrence wins, which makes cyclic generations — the repetition
    regime speculative decoding targets — accept near-K runs.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1) -> None:
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def draft(self, context: Sequence[int], k: int) -> List[int]:
        ctx = np.asarray(context, np.int64).reshape(-1)
        n_ctx = ctx.shape[0]
        if k <= 0 or n_ctx < self.min_ngram + 1:
            return []
        # longest n-gram wins; within one n, the most recent hit with a
        # FULL k-token continuation wins (the verify window is statically
        # k wide, so shorter proposals waste free lanes — a truncated
        # match near the end of context, e.g. a constant run, only beats
        # falling through to a shorter n that can fill the window)
        best: List[int] = []
        for n in range(min(self.max_ngram, n_ctx - 1), self.min_ngram - 1, -1):
            pat = ctx[n_ctx - n:]
            wins = np.lib.stride_tricks.sliding_window_view(ctx, n)
            # exclude the trailing window (the pattern matching itself)
            hits = np.nonzero((wins[:-1] == pat).all(axis=1))[0]
            for h in hits[::-1]:
                cont = ctx[int(h) + n:int(h) + n + k]
                if cont.size == k:
                    return [int(t) for t in cont]
                if cont.size > len(best):
                    best = [int(t) for t in cont]
        return best


class RepeatDrafter:
    """Degenerate drafter: propose the last token k times. Exists mainly
    to exercise the protocol (stutter-heavy outputs accept on it)."""

    def draft(self, context: Sequence[int], k: int) -> List[int]:
        if k <= 0 or not len(context):
            return []
        return [int(context[-1])] * k
