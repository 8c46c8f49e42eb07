"""Operations and bytes of the SSD scan's forward and backward, copied
from ``check_ssd`` and ``check_ssd_bwd`` of ``chip_smoke.py``: the
inputs read once, the outputs written once, and the products the
algorithm needs per (batch, head, chunk of q real rows)."""
from __future__ import annotations

from typing import List, Tuple


def _rows(T: int, Q: int) -> List[int]:
    return [min(Q, T - t0) for t0 in range(0, T, Q)]


def forward(B: int, T: int, H: int, P: int, G: int, N: int, Q: int,
            item: int, final: bool) -> Tuple[float, float]:
    """(bytes, flops) of one forward call: x, B, C, dt (and A, D) read, y
    (and with ``final`` the fp32 final state) written; C B^T and the
    scores' product with x over the q x q pairs, the inter-chunk term and
    the state update."""
    x, bm = B * T * H * P, B * T * G * N
    n_bytes = (2 * x + 2 * bm) * item + 4 * B * T * H + 8 * H \
        + (4 * B * H * P * N if final else 0)
    flops = B * H * sum(2 * q * q * N + 2 * q * q * P + 4 * q * P * N
                        for q in _rows(T, Q))
    return float(n_bytes), float(flops)


def backward(B: int, T: int, H: int, P: int, G: int, N: int, Q: int,
             item: int, dfinal: bool = False) -> Tuple[float, float]:
    """(bytes, flops) of one backward call: x, dy, B, C, dt read and dx,
    dB, dC, ddt written; dE, dS B, x^T dS and dy E (q P N each) and five
    products over the q (q + 1) / 2 causal pairs, without recomputing the
    states."""
    x, bm = B * T * H * P, B * T * G * N
    n_bytes = (3 * x + 4 * bm) * item + 8 * B * T * H + 16 * H \
        + (4 * B * H * P * N if dfinal else 0)
    flops = B * H * sum(8 * q * P * N + q * (q + 1) * (3 * N + 2 * P)
                        for q in _rows(T, Q))
    return float(n_bytes), float(flops)
