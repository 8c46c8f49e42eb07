"""The PaRSEC analogue (paper §5.3) on device tensors: a distributed
dataflow runtime over rank threads, with continuation- and
Testsome-driven completion, and tiled Cholesky built on it.

    from repro_torch.dataflow import (ContinuationBackend,
                                      build_cholesky_graph, make_spd_matrix,
                                      run_dataflow)

    A = make_spd_matrix(16 * 512, seed=5)                # on the card
    graph, meta = build_cholesky_graph(A, 16, 512, 4)
    tiles, stats = run_dataflow(graph, ContinuationBackend)
"""
from repro_torch.dataflow.cholesky import (assemble_result,
                                           build_cholesky_graph,
                                           make_spd_matrix, potrf_failures)
from repro_torch.dataflow.runtime import (ContinuationBackend, DataflowGraph,
                                          DataflowRank, TestsomeBackend,
                                          run_dataflow)

__all__ = ["assemble_result", "build_cholesky_graph", "make_spd_matrix",
           "potrf_failures", "ContinuationBackend", "DataflowGraph",
           "DataflowRank", "TestsomeBackend", "run_dataflow"]
