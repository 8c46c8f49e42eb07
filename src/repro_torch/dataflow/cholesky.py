"""Tiled Cholesky factorization over the dataflow runtime — the DPLASMA/QR
weak-scaling analogue of paper §5.3.2 (same DAG structure class: panel
factorization + trailing updates; Cholesky chosen for its compact task set).

Tiles are distributed 2-D block-cyclic. Tile names are versioned
("A[i,j]v{k}") so every task reads/writes unique dataflow objects.

Tiles are float64 tensors on the matrix's device, and the four tasks are
single library calls that queue work without waiting for it: POTRF is
``torch.linalg.cholesky_ex(check_errors=False)`` (``cholesky`` would wait
to check ``info``; the ``info`` tensors are kept in the graph's metadata
and checked once after the run, ``potrf_failures``), TRSM is
``solve_triangular`` and SYRK/GEMM one product each.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.dataflow.runtime import DataflowGraph
from repro_torch.util import resolve_device


def make_spd_matrix(n: int, seed: int = 0,
                    device: Any = "cuda") -> torch.Tensor:
    """``a @ a.T + n·I`` on ``device``, ``a`` drawn by numpy as the
    reference draws it."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((n, n))).to(dev)
    return a @ a.T + n * torch.eye(n, dtype=a.dtype, device=dev)


def _owner(i: int, j: int, n_ranks: int) -> int:
    return (i * 31 + j) % n_ranks          # 2-D cyclic-ish distribution


def build_cholesky_graph(A: torch.Tensor, nb: int, tile: int,
                         n_ranks: int) -> Tuple[DataflowGraph, Dict]:
    """nb × nb tiles of size tile × tile; returns (graph, tile name map)."""
    g = DataflowGraph(n_ranks)
    name = lambda i, j, v: f"A[{i},{j}]v{v}"
    version = {}
    infos = []                  # POTRF's info tensors, one per task run
    for i in range(nb):
        for j in range(i + 1):
            version[(i, j)] = 0
            g.add_tile(name(i, j, 0),
                       A[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile],
                       _owner(i, j, n_ranks))

    def potrf(inputs):
        (a,) = inputs.values()
        L, info = torch.linalg.cholesky_ex(a, check_errors=False)
        infos.append(info)
        return L

    def trsm(ins):
        return lambda inputs: torch.linalg.solve_triangular(
            inputs[ins[1]].mT, inputs[ins[0]], upper=True,
            left=False)                           # A · L^{-T}

    def syrk(ins):
        def fn(inputs):
            return inputs[ins[0]] - inputs[ins[1]] @ inputs[ins[1]].mT
        return fn

    def gemm(ins):
        def fn(inputs):
            return inputs[ins[0]] - inputs[ins[1]] @ inputs[ins[2]].mT
        return fn

    for k in range(nb):
        vk = version[(k, k)]
        lkk = name(k, k, vk + 1)
        g.add_task(f"POTRF({k})", potrf, [name(k, k, vk)], lkk,
                   _owner(k, k, n_ranks))
        version[(k, k)] = vk + 1
        for i in range(k + 1, nb):
            vik = version[(i, k)]
            ins = [name(i, k, vik), lkk]
            g.add_task(f"TRSM({i},{k})", trsm(ins), ins,
                       name(i, k, vik + 1), _owner(i, k, n_ranks))
            version[(i, k)] = vik + 1
        for i in range(k + 1, nb):
            lik = name(i, k, version[(i, k)])
            for j in range(k + 1, i + 1):
                ljk = name(j, k, version[(j, k)])
                vij = version[(i, j)]
                if i == j:
                    ins = [name(i, i, vij), lik]
                    g.add_task(f"SYRK({i},{k})", syrk(ins), ins,
                               name(i, i, vij + 1), _owner(i, i, n_ranks))
                else:
                    ins = [name(i, j, vij), lik, ljk]
                    g.add_task(f"GEMM({i},{j},{k})", gemm(ins), ins,
                               name(i, j, vij + 1), _owner(i, j, n_ranks))
                version[(i, j)] = vij + 1
    return g, {"name": name, "version": version, "nb": nb, "tile": tile,
               "info": infos}


def potrf_failures(meta: Dict) -> int:
    """How many POTRF tasks found a tile not positive definite (nonzero
    ``info``). Reads the device's ``info`` tensors: call after the run."""
    if not meta["info"]:
        return 0
    return int((torch.stack(meta["info"]) != 0).sum())


def assemble_result(tiles: Dict[str, torch.Tensor], meta: Dict
                    ) -> torch.Tensor:
    nb, tile = meta["nb"], meta["tile"]
    name, version = meta["name"], meta["version"]
    some = next(iter(tiles.values()))
    L = torch.zeros((nb * tile, nb * tile), dtype=some.dtype,
                    device=some.device)
    for i in range(nb):
        for j in range(i + 1):
            L[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile] = \
                tiles[name(i, j, version[(i, j)])]
    return L
