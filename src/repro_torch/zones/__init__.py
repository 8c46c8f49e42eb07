"""The NPB BT-MZ analogue (paper §5.2) on device tensors: a ring of
unevenly sized zones, halos exchanged between rank threads, in a
fork-join and a continuation-driven variant.

    from repro_torch.zones import distributed_solve, make_zones

    zones = make_zones(64, 1024, 256, seed=3)            # on the card
    out, timings = distributed_solve(zones, 4, 30, "continuations", 2)
"""
from repro_torch.zones.solver import (distributed_solve, make_zones,
                                      reference_solve)

__all__ = ["distributed_solve", "make_zones", "reference_solve"]
