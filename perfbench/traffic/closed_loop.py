"""The one generator of serving traffic: a closed loop of ``clients``
callers, each sending its next request when the last one has finished.

A cell's traffic is data (``workloads/<cell>.json``, key ``traffic``):

* ``clients``: the concurrency the loop keeps;
* ``prompt_len`` / ``output_len``: inclusive ``[lo, hi]`` of bounded-Pareto
  draws with ``prompt_alpha`` / ``output_alpha`` (``bounded_pareto``, a
  frozen copy of ``repro_torch/bench/trace.py``'s);
* ``max_total``: the most tokens (prompt + output) one request may hold;
  an output that would pass it is cut to fit;
* ``pool``: how many (prompt, output) length pairs are drawn, once, from
  ``size_seed``.

Every run seed serves the same pool of lengths, in an order drawn from
the seed, so seeds differ in order and in token ids, never in the work
(a run reaches only some hundreds of the pool's entries, so the order
decides which; the pool is large enough that no run wraps it). Token ids
are drawn from the seed, uniformly over the configuration's vocabulary.
"""
from __future__ import annotations

import random
from typing import Any, List, Mapping, Tuple

import numpy as np


def bounded_pareto(rng: random.Random, *, alpha: float, lo: int,
                   hi: int) -> int:
    """Heavy-tailed integer draw in ``[lo, hi]`` — inverse-CDF sampling
    of a Pareto truncated at both ends. Small ``alpha`` (~1-1.5) gives
    the many-short/few-huge shape real prompt/output lengths follow."""
    if not (0 < lo <= hi):
        raise ValueError(f"need 0 < lo <= hi, got lo={lo} hi={hi}")
    if alpha <= 0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    if lo == hi:
        return lo
    u = rng.random()
    l_a, h_a = float(lo) ** -alpha, float(hi) ** -alpha
    x = (l_a - u * (l_a - h_a)) ** (-1.0 / alpha)
    return max(lo, min(hi, int(x)))


def length_pool(traffic: Mapping[str, Any]) -> List[Tuple[int, int]]:
    """The cell's fixed (prompt, output) lengths, the same for every
    seed."""
    rng = random.Random(int(traffic.get("size_seed", 0)))
    plo, phi = traffic["prompt_len"]
    olo, ohi = traffic["output_len"]
    cap = int(traffic.get("max_total", 1 << 30))
    pool = []
    for _ in range(int(traffic["pool"])):
        plen = bounded_pareto(rng, alpha=float(traffic["prompt_alpha"]),
                              lo=int(plo), hi=int(phi))
        olen = bounded_pareto(rng, alpha=float(traffic["output_alpha"]),
                              lo=int(olo), hi=int(ohi))
        pool.append((plen, max(1, min(olen, cap - plen))))
    return pool


class ClosedLoop:
    """The seed's sequence of requests: ``next()`` gives the prompt (int32
    array) and output length of the next request any client sends."""

    def __init__(self, traffic: Mapping[str, Any], seed: int,
                 vocab_size: int) -> None:
        self.clients = int(traffic["clients"])
        self.pool = length_pool(traffic)
        order = list(range(len(self.pool)))
        random.Random(seed).shuffle(order)
        self._order = order
        self._tokens = np.random.default_rng(seed)
        self._vocab = int(vocab_size)
        self.sent = 0

    def next(self) -> Tuple[np.ndarray, int]:
        if self.sent >= len(self._order):
            raise RuntimeError(
                f"the traffic pool of {len(self._order)} requests ran out; "
                "give the cell a larger pool")
        plen, olen = self.pool[self._order[self.sent]]
        self.sent += 1
        prompt = self._tokens.integers(0, self._vocab, plen, dtype=np.int32)
        return prompt, olen
