"""SLO evaluation and reporting over replayed samples.

An ``SLO`` is the service contract a config is measured against —
tail-latency ceilings (p99/p99.9 TTFT and inter-token latency) and
goodput floors (tokens per second from requests that finished within
deadline). ``slo_report`` folds one or more ``RunResult`` samples into a
JSON-safe report: per-metric mean / CI / coefficient-of-variation via
``bench.stats``, plus a pass/fail verdict per SLO bound. The saturation
sweep (``bench.sweep``) asks exactly one question of this module —
"does the SLO hold at this load?" — and the markdown renderer feeds CI
job summaries.

Verdicts are evaluated on the per-sample **worst** value, not the mean:
an SLO is a ceiling, and a config that blows p99.9 every third run does
not meet it. (The mean/cv still appear in the report for trend-reading.)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.bench.runner import RunResult
from repro_torch.bench.stats import variance_fields

# (slo_field, metric_key, kind): ceilings bound the metric from above,
# floors from below
_BOUNDS: Tuple[Tuple[str, str, str], ...] = (
    ("ttft_p50_s", "ttft_p50_s", "ceiling"),
    ("ttft_p99_s", "ttft_p99_s", "ceiling"),
    ("ttft_p999_s", "ttft_p999_s", "ceiling"),
    ("itl_p99_s", "itl_p99_s", "ceiling"),
    ("itl_p999_s", "itl_p999_s", "ceiling"),
    ("min_goodput_tokens_per_s", "goodput_tokens_per_s", "floor"),
    ("min_finished_frac", "finished_frac", "floor"),
    ("min_deadline_met_frac", "deadline_met_frac", "floor"),
)


@dataclasses.dataclass(frozen=True)
class SLO:
    """Service-level objective: unset fields are unchecked."""

    ttft_p50_s: Optional[float] = None
    ttft_p99_s: Optional[float] = None
    ttft_p999_s: Optional[float] = None
    itl_p99_s: Optional[float] = None
    itl_p999_s: Optional[float] = None
    min_goodput_tokens_per_s: Optional[float] = None
    min_finished_frac: Optional[float] = None
    min_deadline_met_frac: Optional[float] = None

    def to_dict(self) -> Dict[str, float]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}


def slo_report(results: Sequence[RunResult],
               slo: Optional[SLO] = None) -> Dict[str, Any]:
    """Fold replay samples into one report dict.

    ``metrics`` carries ``{name: {mean, cv, ci95, values}}`` over the
    samples; ``slo`` (when given) carries the verdict: ``ok`` plus a
    violation list of ``{metric, bound, kind, worst}``.
    """
    if not results:
        raise ValueError("slo_report needs at least one RunResult")
    samples = [r.metrics() for r in results]
    report: Dict[str, Any] = {
        "tier": results[0].tier,
        "trace": results[0].trace_name,
        "samples": len(results),
        "requests": len(results[0].records),
        "metrics": variance_fields(samples),
    }
    if slo is not None:
        violations: List[Dict[str, Any]] = []
        for field, key, kind in _BOUNDS:
            bound = getattr(slo, field)
            if bound is None:
                continue
            vals = [s[key] for s in samples if key in s]
            if not vals:
                violations.append({"metric": key, "bound": bound,
                                   "kind": kind, "worst": None,
                                   "reason": "metric not measured"})
                continue
            worst = max(vals) if kind == "ceiling" else min(vals)
            ok = worst <= bound if kind == "ceiling" else worst >= bound
            if not ok:
                violations.append({"metric": key, "bound": bound,
                                   "kind": kind,
                                   "worst": round(worst, 6)})
        report["slo"] = {"ok": not violations,
                         "checked": slo.to_dict(),
                         "violations": violations}
    return report


def to_markdown(report: Dict[str, Any]) -> str:
    """Render one report as a compact markdown table (CI job summaries)."""
    lines = [f"#### {report['tier']} · trace `{report['trace']}` · "
             f"{report['samples']} sample(s), {report['requests']} requests",
             "", "| metric | mean | cv | ci95 |", "| --- | ---: | ---: | ---: |"]
    for name, s in sorted(report["metrics"].items()):
        lines.append(f"| {name} | {s['mean']:.4g} | {s['cv']:.3f} "
                     f"| ±{s['ci95']:.4g} |")
    if "slo" in report:
        verdict = "✅ SLO holds" if report["slo"]["ok"] else "❌ SLO violated"
        lines += ["", verdict]
        for v in report["slo"]["violations"]:
            worst = "n/a" if v.get("worst") is None else f"{v['worst']:.4g}"
            op = "<=" if v["kind"] == "ceiling" else ">="
            lines.append(f"- `{v['metric']}` worst {worst} "
                         f"(needs {op} {v['bound']:.4g})")
    return "\n".join(lines)
