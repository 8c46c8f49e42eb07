"""Workload models — seeded, replayable request traces for every tier.

The paper defends its completion-notification claims with message-rate
and latency microbenchmarks; this repo's serving claims need the same
discipline at the request level. A ``Trace`` is the unit of measurement:
a frozen, seeded sequence of (arrival time, prompt, generation config)
tuples that any serving tier can replay (``bench.runner``), so

* the SAME workload drives ``ServeEngine``, ``DisaggServer`` and
  ``Router`` — tier comparisons are apples-to-apples;
* reruns are deterministic at the trace level (same seed ⇒ byte-identical
  serialized trace), so run-to-run variance is *measurement* variance,
  never workload variance;
* a trace survives in a JSON artifact next to the numbers it produced.

Workload models (all driven by one ``random.Random(seed)`` — Python's
Mersenne Twister is stable across versions, so no numpy dependency in
the determinism contract):

* **arrival processes** — open-loop Poisson (exponential gaps at a
  target QPS), bursty on/off (geometric bursts at a high in-burst rate
  separated by exponential quiet gaps), and closed-loop (all arrivals at
  t=0; ``meta["closed_loop"]`` holds the concurrency the runner
  maintains).
* **length distributions** — heavy-tailed bounded Pareto for prompt and
  output lengths (the LLM-serving regime: many short, few very long).
* **shared-prefix mixtures** — N prefix groups, each with a common
  prompt prefix and per-request unique tails, so prefix caches and
  affinity routers see realistic hit structure.
* **multi-tenant / priority mixes** — weighted tenant and priority
  assignment per request (drives the router's fairness lanes and the
  strict priority classes).
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

TRACE_FORMAT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One request of a trace: when it arrives and what it asks for."""

    arrival_s: float                 # offset from trace start (0 = closed loop)
    prompt: Tuple[int, ...]          # token ids
    max_tokens: int
    tenant: str = "default"
    priority: int = 0
    deadline_s: Optional[float] = None
    prefix_group: Optional[int] = None   # which shared-prefix group (metadata)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "arrival_s": round(float(self.arrival_s), 6),
            "prompt": list(self.prompt),
            "max_tokens": int(self.max_tokens),
            "tenant": self.tenant,
            "priority": int(self.priority),
            "deadline_s": (None if self.deadline_s is None
                           else round(float(self.deadline_s), 6)),
            "prefix_group": self.prefix_group,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TraceRequest":
        return cls(arrival_s=float(d["arrival_s"]),
                   prompt=tuple(int(t) for t in d["prompt"]),
                   max_tokens=int(d["max_tokens"]),
                   tenant=d.get("tenant", "default"),
                   priority=int(d.get("priority", 0)),
                   deadline_s=(None if d.get("deadline_s") is None
                               else float(d["deadline_s"])),
                   prefix_group=d.get("prefix_group"))


@dataclasses.dataclass(frozen=True)
class Trace:
    """A frozen, replayable workload: requests plus generator metadata.

    ``meta`` records how the trace was made (generator name, seed,
    parameters) and the replay mode: ``meta["closed_loop"]`` is ``None``
    for open-loop traces (the runner paces arrivals) or an int
    concurrency for closed-loop traces (the runner keeps that many
    requests outstanding and ignores arrival times).
    """

    requests: Tuple[TraceRequest, ...]
    meta: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.requests)

    def __iter__(self):
        return iter(self.requests)

    @property
    def name(self) -> str:
        return str(self.meta.get("name", "trace"))

    @property
    def closed_loop(self) -> Optional[int]:
        cl = self.meta.get("closed_loop")
        return None if cl is None else int(cl)

    @property
    def total_output_tokens(self) -> int:
        return sum(r.max_tokens for r in self.requests)

    @property
    def offered_qps(self) -> Optional[float]:
        """Offered arrival rate over the trace span (None: closed loop
        or a single-request trace, where a rate is meaningless)."""
        if self.closed_loop is not None or len(self.requests) < 2:
            return None
        span = self.requests[-1].arrival_s - self.requests[0].arrival_s
        if span <= 0.0:
            return None
        return (len(self.requests) - 1) / span

    # -------------------------------------------------------- serialization
    def to_json(self) -> str:
        """Canonical JSON — sorted keys, fixed separators, rounded floats
        — so equal traces serialize byte-identically (the determinism
        contract tests assert on)."""
        doc = {"format_version": TRACE_FORMAT_VERSION,
               "meta": dict(self.meta),
               "requests": [r.to_dict() for r in self.requests]}
        return json.dumps(doc, sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, text: str) -> "Trace":
        doc = json.loads(text)
        ver = doc.get("format_version")
        if ver != TRACE_FORMAT_VERSION:
            raise ValueError(f"unsupported trace format_version {ver!r} "
                             f"(this build reads {TRACE_FORMAT_VERSION})")
        return cls(requests=tuple(TraceRequest.from_dict(d)
                                  for d in doc["requests"]),
                   meta=doc.get("meta", {}))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls.from_json(f.read())


# ============================================================ arrival models
def poisson_arrivals(rng: random.Random, n: int,
                     rate_qps: float) -> List[float]:
    """Open-loop Poisson process: exponential inter-arrival gaps at
    ``rate_qps``; first arrival at t=0 so replay starts immediately."""
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
    t, out = 0.0, []
    for i in range(n):
        out.append(t)
        t += rng.expovariate(rate_qps)
    return out


def onoff_arrivals(rng: random.Random, n: int, *, burst_rate_qps: float,
                   mean_burst: float = 4.0,
                   mean_off_s: float = 0.2) -> List[float]:
    """Bursty on/off process: geometric-length bursts at
    ``burst_rate_qps`` separated by exponential quiet gaps of mean
    ``mean_off_s`` — the flash-crowd regime tail-latency SLOs exist for."""
    if burst_rate_qps <= 0 or mean_burst < 1.0 or mean_off_s <= 0:
        raise ValueError("onoff_arrivals needs burst_rate_qps > 0, "
                         "mean_burst >= 1, mean_off_s > 0")
    # geometric with mean ``mean_burst`` (support >= 1)
    p_stop = 1.0 / mean_burst
    t, out = 0.0, []
    while len(out) < n:
        out.append(t)
        if rng.random() < p_stop:        # burst ends: quiet gap
            t += rng.expovariate(1.0 / mean_off_s)
        else:                            # stay in burst: fast gap
            t += rng.expovariate(burst_rate_qps)
    return out


# ============================================================ length models
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


def _weighted_choice(rng: random.Random,
                     weights: Mapping[Any, float]) -> Any:
    keys = list(weights.keys())          # insertion order: deterministic
    total = float(sum(weights.values()))
    if total <= 0:
        raise ValueError("weights must sum to > 0")
    u = rng.random() * total
    acc = 0.0
    for k in keys:
        acc += float(weights[k])
        if u < acc:
            return k
    return keys[-1]


# ========================================================= trace generators
def synthetic_trace(n_requests: int, *, seed: int,
                    vocab_size: int = 512,
                    arrival: str = "poisson",
                    rate_qps: float = 50.0,
                    mean_burst: float = 4.0,
                    mean_off_s: float = 0.2,
                    closed_loop: Optional[int] = None,
                    prompt_len: Tuple[int, int] = (8, 24),
                    prompt_alpha: float = 1.5,
                    output_len: Tuple[int, int] = (4, 24),
                    output_alpha: float = 1.2,
                    n_prefix_groups: int = 0,
                    shared_len: int = 0,
                    tenants: Optional[Mapping[str, float]] = None,
                    priorities: Optional[Mapping[int, float]] = None,
                    deadline_s: Optional[float] = None,
                    name: str = "synthetic") -> Trace:
    """The one-stop seeded generator composing every workload model.

    * ``arrival``: ``"poisson"`` | ``"onoff"`` | ``"closed"`` (with
      ``closed_loop`` concurrency; also selected implicitly whenever
      ``closed_loop`` is given).
    * ``prompt_len`` / ``output_len``: inclusive ``(lo, hi)`` bounds of
      the bounded-Pareto length draws (``*_alpha`` sets tail weight).
    * ``n_prefix_groups`` + ``shared_len``: shared-prefix mixture — each
      request joins a uniformly drawn group whose first ``shared_len``
      prompt tokens are common; ``0`` disables (fully unique prompts).
    * ``tenants`` / ``priorities``: weighted mixes (default: single
      tenant ``"default"``, priority 0).
    * ``deadline_s``: per-request QoS deadline stamped on every request
      (``None``: no deadlines — goodput equals throughput).

    Same arguments + same seed ⇒ byte-identical ``Trace.to_json()``.
    """
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    if n_prefix_groups > 0 and not (0 < shared_len <= prompt_len[0]):
        raise ValueError(
            f"shared_len must be in (0, min prompt_len] when prefix "
            f"groups are on, got shared_len={shared_len} "
            f"prompt_len={prompt_len}")
    rng = random.Random(seed)
    if closed_loop is not None:
        arrival = "closed"
    if arrival == "poisson":
        arrivals = poisson_arrivals(rng, n_requests, rate_qps)
    elif arrival == "onoff":
        arrivals = onoff_arrivals(rng, n_requests,
                                  burst_rate_qps=rate_qps,
                                  mean_burst=mean_burst,
                                  mean_off_s=mean_off_s)
    elif arrival == "closed":
        if closed_loop is None or int(closed_loop) < 1:
            raise ValueError("closed-loop traces need closed_loop >= 1")
        arrivals = [0.0] * n_requests
    else:
        raise ValueError(f"unknown arrival model {arrival!r}")

    # shared-prefix groups: the group prefixes are drawn FIRST (before
    # per-request randomness) so trimming n_requests never changes them
    prefixes: List[Tuple[int, ...]] = []
    for _ in range(max(0, n_prefix_groups)):
        prefixes.append(tuple(rng.randrange(vocab_size)
                              for _ in range(shared_len)))

    tenants = tenants or {"default": 1.0}
    priorities = priorities or {0: 1.0}
    reqs: List[TraceRequest] = []
    for i in range(n_requests):
        plen = bounded_pareto(rng, alpha=prompt_alpha,
                              lo=prompt_len[0], hi=prompt_len[1])
        olen = bounded_pareto(rng, alpha=output_alpha,
                              lo=output_len[0], hi=output_len[1])
        group: Optional[int] = None
        if prefixes:
            group = rng.randrange(len(prefixes))
            tail = tuple(rng.randrange(vocab_size)
                         for _ in range(plen - shared_len))
            prompt = prefixes[group] + tail
        else:
            prompt = tuple(rng.randrange(vocab_size) for _ in range(plen))
        reqs.append(TraceRequest(
            arrival_s=arrivals[i], prompt=prompt, max_tokens=olen,
            tenant=str(_weighted_choice(rng, tenants)),
            priority=int(_weighted_choice(rng, priorities)),
            deadline_s=deadline_s, prefix_group=group))

    meta = {"name": name, "seed": seed, "generator": "synthetic_trace",
            "arrival": arrival, "rate_qps": rate_qps,
            "closed_loop": closed_loop, "vocab_size": vocab_size,
            "prompt_len": list(prompt_len), "output_len": list(output_len),
            "n_prefix_groups": n_prefix_groups, "shared_len": shared_len,
            "deadline_s": deadline_s}
    return Trace(requests=tuple(reqs), meta=meta)


def rescale_qps(trace: Trace, target_qps: float) -> Trace:
    """The same requests at a different offered rate: arrival offsets are
    scaled uniformly so the trace's offered QPS becomes ``target_qps``.
    Prompt content, ordering, lengths and configs are untouched — this is
    how the saturation sweep probes one workload across load levels
    without re-rolling its randomness."""
    if target_qps <= 0:
        raise ValueError(f"target_qps must be > 0, got {target_qps}")
    cur = trace.offered_qps
    if cur is None:
        raise ValueError("rescale_qps needs an open-loop trace with a "
                         "measurable rate (>= 2 spread-out arrivals)")
    scale = cur / target_qps
    reqs = tuple(dataclasses.replace(r, arrival_s=r.arrival_s * scale)
                 for r in trace.requests)
    meta = dict(trace.meta)
    meta["rate_qps"] = target_qps
    meta["rescaled_from_qps"] = cur
    return Trace(requests=reqs, meta=meta)


def micro_trace(seed: int = 0, *, n_requests: int = 4,
                vocab_size: int = 512, max_tokens: int = 4,
                prompt_len: int = 8, rate_qps: float = 200.0,
                **kwargs: Any) -> Trace:
    """A seconds-not-minutes trace for CI and unit tests: few requests,
    short prompts, tiny budgets, fast arrivals."""
    return synthetic_trace(
        n_requests, seed=seed, vocab_size=vocab_size, rate_qps=rate_qps,
        prompt_len=(prompt_len, prompt_len),
        output_len=(max_tokens, max_tokens),
        name=kwargs.pop("name", "micro"), **kwargs)
