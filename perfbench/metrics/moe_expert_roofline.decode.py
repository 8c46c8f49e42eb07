"""The routed experts' grouped products against their bound in the
profiled slice: the launches of the grouped GEMM kernel (matched by the
name the trace prints, ``KERNEL``) times the mean bound of a launch, over
those launches' device time.

The mean bound comes from the window's counters of the MoE block
(``ServeEngine.stats``), per kind of call (decode step, prefill): a
call's mean rows and experts hit give its bytes and operations
(``counts.moe.call``), its bound the larger of the bytes at 3.35 TB/s and
the operations at bf16's peak; a call is ``LAUNCHES_PER_CALL`` launches.
None where no launch matched or the program keeps no such counters."""
from perfbench.counts.moe import LAUNCHES_PER_CALL, call
from perfbench.counts.peaks import bound_s

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decode_tokens_per_s"

#: a substring of the grouped GEMM's kernel name in the trace
KERNEL = "GroupProblemShape"


def read(run):
    tl = run.timeline
    if tl is None or "moe.decode.calls" not in run.stats1:
        return None
    launches, secs = 0, 0.0
    for name, (n, s) in tl.by_name().items():
        if KERNEL in name:
            launches += n
            secs += s
    total_s, calls = 0.0, 0
    for kind in ("decode", "prefill"):
        n = run.delta(f"moe.{kind}.calls")
        if n:
            n_bytes, flops = call(run.model, run.dtype,
                                  run.delta(f"moe.{kind}.rows") / n,
                                  run.delta(f"moe.{kind}.experts_hit") / n)
            total_s += n * bound_s(n_bytes, flops, run.dtype)
            calls += n
    if not launches or secs <= 0 or not calls:
        return None
    return 100.0 * launches * total_s / (calls * LAUNCHES_PER_CALL) / secs
