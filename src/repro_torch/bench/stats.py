"""Multi-sample statistics — the variance layer under every bench claim.

Single-shot timings on a shared 2-core box are the reason this repo's
regression gates carried 30-45% tolerances. The fix is not wider bands
but *measured dispersion*: run each scenario ``samples`` times, report
per-metric mean / confidence interval / coefficient of variation, and
let the gate distinguish "stable metric, tight tolerance" from
"unstable metric, record-only".

No scipy/numpy dependency: sample standard deviation and a normal-
approximation 95% CI are all the gate needs. Counterpart of
``repro/bench/stats.py``, kept pure Python as it is.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence

# coefficient-of-variation threshold above which a metric is treated as
# too noisy to gate (recorded-only, flagged "unstable" in summaries)
UNSTABLE_CV = 0.15


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile (q in [0, 1]) — stable for the
    small sample counts benches produce; 0.0 on empty input."""
    if not values:
        return 0.0
    s = sorted(values)
    if len(s) == 1:
        return float(s[0])
    pos = q * (len(s) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(s) - 1)
    frac = pos - lo
    return float(s[lo] * (1.0 - frac) + s[hi] * frac)


@dataclasses.dataclass(frozen=True)
class Summary:
    """Dispersion summary of one metric over n samples."""

    n: int
    mean: float
    std: float          # sample std (ddof=1); 0.0 when n < 2
    cv: float           # std / |mean|; 0.0 when mean == 0
    ci95: float         # 1.96 * std / sqrt(n) (normal approximation)
    lo: float
    hi: float
    values: tuple = ()

    @property
    def unstable(self) -> bool:
        """True when run-to-run dispersion is too high to gate on."""
        return self.cv > UNSTABLE_CV

    def to_dict(self) -> Dict[str, float]:
        return {"n": self.n, "mean": self.mean, "std": self.std,
                "cv": self.cv, "ci95": self.ci95,
                "lo": self.lo, "hi": self.hi,
                "values": list(self.values)}


def summarize(values: Sequence[float]) -> Summary:
    """Mean / std / cv / 95% CI over a sample list (>= 1 value)."""
    vals = [float(v) for v in values]
    if not vals:
        raise ValueError("summarize needs at least one sample")
    n = len(vals)
    mean = sum(vals) / n
    if n > 1:
        var = sum((v - mean) ** 2 for v in vals) / (n - 1)
        std = math.sqrt(var)
    else:
        std = 0.0
    cv = std / abs(mean) if mean else 0.0
    ci95 = 1.96 * std / math.sqrt(n) if n > 1 else 0.0
    return Summary(n=n, mean=mean, std=std, cv=cv, ci95=ci95,
                   lo=min(vals), hi=max(vals), values=tuple(vals))


def summarize_metrics(samples: Sequence[Mapping[str, float]]
                      ) -> Dict[str, Summary]:
    """Per-key summaries over a list of metric dicts (one per sample).
    Keys missing from some samples are summarized over the samples that
    have them; non-numeric values are skipped."""
    by_key: Dict[str, List[float]] = {}
    for sample in samples:
        for k, v in sample.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            by_key.setdefault(k, []).append(float(v))
    return {k: summarize(vs) for k, vs in by_key.items()}


def variance_fields(samples: Sequence[Mapping[str, float]]
                    ) -> Dict[str, Dict[str, float]]:
    """The compact ``{metric: {mean, cv, ci95, values}}`` mapping bench
    blocks embed in BENCH_serve.json so the regression gate (and the
    history log) can see measured dispersion, not just a point value."""
    return {k: {"mean": round(s.mean, 6), "cv": round(s.cv, 6),
                "ci95": round(s.ci95, 6),
                "values": [round(v, 6) for v in s.values]}
            for k, s in summarize_metrics(samples).items()}


def is_unstable(cv: Optional[float],
                threshold: float = UNSTABLE_CV) -> bool:
    """The gate's stability predicate: an unknown cv is treated as
    stable (legacy baselines without variance data keep gating)."""
    return cv is not None and float(cv) > threshold
