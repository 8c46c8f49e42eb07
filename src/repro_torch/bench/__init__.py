"""Load-generation and measurement subsystem for the serving stack.

The paper's claims are quantitative; this package is how the repo's own
serving claims earn the same trust — seeded replayable workloads,
multi-sample variance, SLO-style reporting, and saturation sweeps, all
speaking to any tier through ``serve.protocol.EngineLike``.

* ``bench.trace``  — workload models: arrival processes (open-loop
  Poisson, bursty on/off, closed-loop), heavy-tailed length
  distributions, shared-prefix mixtures, tenant/priority mixes — frozen
  into a serializable, byte-deterministic ``Trace``.
* ``bench.runner`` — ``Replayer``: replays a trace against
  ``ServeEngine`` / ``DisaggServer`` / ``Router`` through the
  ``ServeClient`` streaming surface, recording per-request TTFT,
  inter-token latencies, completion status and deadline outcomes.
* ``bench.stats``  — multi-sample summaries (mean / 95% CI /
  coefficient-of-variation) and the instability predicate the
  variance-aware regression gate uses.
* ``bench.report`` — ``SLO`` bounds + ``slo_report``: goodput under
  deadline, p50/p99/p99.9 TTFT and ITL, pass/fail verdicts, markdown.
* ``bench.sweep``  — binary-search the max sustainable QPS per config
  where the SLO still holds.

Counterpart of ``repro/bench``: the same pure-Python modules over the
port's serving tiers (``repro_torch.serve``) and ``obs.Recorder``; a
trace serializes byte-identically to the reference's.
"""
from repro_torch.bench.report import SLO, slo_report, to_markdown
from repro_torch.bench.runner import Replayer, RequestRecord, RunResult, replay
from repro_torch.bench.stats import (UNSTABLE_CV, Summary, is_unstable,
                               percentile, summarize, summarize_metrics,
                               variance_fields)
from repro_torch.bench.sweep import (SweepPoint, SweepResult, saturation_sweep,
                               sweep_tier)
from repro_torch.bench.trace import (Trace, TraceRequest, bounded_pareto,
                               micro_trace, onoff_arrivals,
                               poisson_arrivals, rescale_qps,
                               synthetic_trace)

__all__ = [
    "Trace", "TraceRequest", "synthetic_trace", "micro_trace",
    "rescale_qps", "poisson_arrivals", "onoff_arrivals", "bounded_pareto",
    "Replayer", "RequestRecord", "RunResult", "replay",
    "Summary", "summarize", "summarize_metrics", "variance_fields",
    "percentile", "is_unstable", "UNSTABLE_CV",
    "SLO", "slo_report", "to_markdown",
    "SweepPoint", "SweepResult", "saturation_sweep", "sweep_tier",
]
