"""The port's bench subsystem (``repro_torch.bench``) against the JAX
package's on the CPU: byte-identical traces, the same statistics, SLO
reports and sweep verdicts on the same inputs, and a seeded micro-trace
replayed through the port's engine, disaggregated server and router,
each request's tokens the JAX ``greedy_generate``'s (float32, reduced
``paper_demo``, the JAX package's own weights carried over)."""
import random
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import bench as jbench
from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.serve import steps as jsteps
from repro_torch import bench, obs
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import DisaggServer, RequestState, Router, ServeEngine

MARGIN = 1e-3      # top-2 logit gap below which greedy tokens may flip
KW = dict(max_batch=2, max_cache_len=64, page_size=4, max_seq_len=48)

TRACES = {
    "poisson": dict(n_requests=24, seed=3, rate_qps=37.5,
                    prompt_len=(8, 40), output_len=(2, 30)),
    "onoff": dict(n_requests=30, seed=4, arrival="onoff", rate_qps=200.0,
                  mean_burst=3.0, mean_off_s=0.05),
    "closed": dict(n_requests=10, seed=5, closed_loop=3, vocab_size=1000),
    "shared_prefix": dict(n_requests=40, seed=9, n_prefix_groups=3,
                          shared_len=6, prompt_len=(6, 20)),
    "tenants": dict(n_requests=60, seed=11,
                    tenants={"gold": 3.0, "free": 1.0, "batch": 0.5},
                    priorities={0: 4.0, 2: 1.0}, deadline_s=1.25),
}


@pytest.mark.parametrize("mix", sorted(TRACES))
def test_trace_json_byte_identical_to_the_reference(mix):
    """``Trace.to_json()`` byte-equal for every workload model, also after
    ``rescale_qps``; each package reads the other's JSON back to the same
    bytes."""
    kw = TRACES[mix]
    ours = bench.synthetic_trace(**kw)
    theirs = jbench.synthetic_trace(**kw)
    assert ours.to_json() == theirs.to_json()
    assert bench.Trace.from_json(theirs.to_json()).to_json() == \
        theirs.to_json()
    assert (ours.offered_qps, ours.total_output_tokens, ours.closed_loop) \
        == (theirs.offered_qps, theirs.total_output_tokens,
            theirs.closed_loop)
    if ours.closed_loop is None:
        assert bench.rescale_qps(ours, 12.5).to_json() == \
            jbench.rescale_qps(theirs, 12.5).to_json()


def test_generators_and_micro_trace_match_the_reference():
    draws = []
    for mod in (bench, jbench):
        rng = random.Random(17)
        draws.append((mod.poisson_arrivals(rng, 20, 40.0),
                      mod.onoff_arrivals(rng, 20, burst_rate_qps=300.0),
                      [mod.bounded_pareto(rng, alpha=a, lo=4, hi=400)
                       for a in (0.7, 1.2, 2.5) for _ in range(30)],
                      mod.micro_trace(seed=6, n_requests=5).to_json()))
    assert draws[0] == draws[1]


def test_stats_match_the_reference():
    rng = np.random.default_rng(0)
    samples = [[3.0], [1.0, 1.0, 1.0], rng.exponential(2.0, 7).tolist(),
               [0.0, 0.0], [-2.0, 5.0, 1e-3]]
    for vals in samples:
        assert bench.summarize(vals).to_dict() == \
            jbench.summarize(vals).to_dict()
        for q in (0.0, 0.37, 0.5, 0.99, 0.999, 1.0):
            assert bench.percentile(vals, q) == jbench.percentile(vals, q)
    rows = [{"a": 1.0, "b": 2, "flag": True, "s": "x"}, {"a": 1.5},
            {"a": 0.9, "b": 3}]
    assert {k: v.to_dict() for k, v in bench.summarize_metrics(rows).items()} \
        == {k: v.to_dict() for k, v in jbench.summarize_metrics(rows).items()}
    assert bench.variance_fields(rows) == jbench.variance_fields(rows)
    for cv in (None, 0.0, 0.15, 0.151, 2.0):
        assert bench.is_unstable(cv) == jbench.is_unstable(cv)
    assert bench.UNSTABLE_CV == jbench.UNSTABLE_CV
    with pytest.raises(ValueError):
        bench.summarize([])


def _results(mod, seed, n_samples=3):
    """The same fabricated samples as each package's ``RunResult``: mixed
    statuses, deadlines met and missed, a refusal, speculative bursts
    (zero inter-token gaps)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_samples):
        recs = []
        for j in range(6):
            status = ["finished", "finished", "expired", "finished",
                      "refused", "cancelled"][j]
            gaps = rng.exponential(0.01, 4).round(6).tolist() + [0.0]
            recs.append(mod.RequestRecord(
                index=j, tenant="t%d" % (j % 2), priority=j % 3,
                status=status, arrival_s=0.01 * j,
                ttft_s=None if status == "refused"
                else float(rng.uniform(0.01, 0.5)),
                latency_s=float(rng.uniform(0.5, 1.0)),
                n_tokens=0 if status == "refused" else 6, itl_s=gaps,
                deadline_s=0.8, deadline_met=status == "finished"
                and j != 3))
        out.append(mod.RunResult(trace_name="t", tier="engine", sample=i,
                                 duration_s=1.0 + 0.1 * i, records=recs))
    return out


@pytest.mark.parametrize("slo", [
    None,
    dict(ttft_p99_s=10.0, min_finished_frac=0.1),
    dict(ttft_p50_s=0.01, itl_p99_s=1e-4, min_goodput_tokens_per_s=1e3,
         min_deadline_met_frac=0.9, ttft_p999_s=0.2, itl_p999_s=1.0),
])
def test_slo_report_and_markdown_match_the_reference(slo):
    ours, theirs = _results(bench, 1), _results(jbench, 1)
    assert [r.metrics() for r in ours] == [r.metrics() for r in theirs]
    a = bench.slo_report(ours, None if slo is None else bench.SLO(**slo))
    b = jbench.slo_report(theirs, None if slo is None else jbench.SLO(**slo))
    assert a == b
    assert bench.to_markdown(a) == jbench.to_markdown(b)
    if slo and "itl_p99_s" in slo:
        assert not a["slo"]["ok"] and len(a["slo"]["violations"]) >= 3


class _Stub:
    """Duck-typed ``Replayer``: one fabricated sample per run whose TTFT
    grows with the probe rate, the first attempt at ``flaky`` failing."""

    def __init__(self, mod, flaky=()):
        self.mod, self.flaky, self.runs = mod, set(flaky), []

    def run(self, trace, *, samples=1, timeout=300.0, warmup=2):
        qps = round(trace.offered_qps, 4)
        ttft = 10.0 if qps in self.flaky else 0.001 * qps
        self.flaky.discard(qps)
        self.runs.append(qps)
        rec = self.mod.RequestRecord(index=0, tenant="default", priority=0,
                                     status="finished", arrival_s=0.0,
                                     ttft_s=ttft, n_tokens=4,
                                     itl_s=[0.001] * 3)
        return [self.mod.RunResult(trace_name=trace.name, tier="stub",
                                   sample=i, duration_s=1.0, records=[rec])
                for i in range(samples)]


@pytest.mark.parametrize("boundary", [0.0, 57.3, 1e9])
def test_sweeps_match_the_reference(boundary):
    """``saturation_sweep`` under the same evaluate, and ``sweep_tier``
    through the same stub tier: the same probes and verdicts."""
    def evaluate(qps):
        return qps <= boundary, {"slo": {"violations": [
            {"metric": "ttft_p99_s", "bound": 1.0, "worst": qps,
             "kind": "ceiling"}] if qps > boundary else []}}

    a = bench.saturation_sweep(evaluate, lo_qps=1.0, hi_qps=100.0, iters=5)
    b = jbench.saturation_sweep(evaluate, lo_qps=1.0, hi_qps=100.0, iters=5)
    assert a.to_dict() == b.to_dict()
    trace = bench.micro_trace(seed=0, n_requests=8, rate_qps=50.0)
    jtrace = jbench.micro_trace(seed=0, n_requests=8, rate_qps=50.0)
    stubs = (_Stub(bench, flaky=(10.0,)), _Stub(jbench, flaky=(10.0,)))
    got = [mod.sweep_tier(stub, t, mod.SLO(ttft_p99_s=0.1), lo_qps=10.0,
                          hi_qps=400.0, iters=4, retries=1).to_dict()
           for mod, stub, t in zip((bench, jbench), stubs, (trace, jtrace))]
    assert got[0] == got[1] and stubs[0].runs == stubs[1].runs


# --------------------------------------------------- replay on each tier
@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("paper_demo", reduced=True, dtype=jnp.float32,
                          param_dtype=jnp.float32)
    tcfg = get_config("paper_demo", reduced=True, dtype=torch.float32,
                      param_dtype=torch.float32)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           "cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def oracle(model):
    """The JAX ``greedy_generate`` of a prompt, and how many of its tokens
    come before its first near tie; memoised per prompt."""
    jcfg, _, jp, _ = model
    memo = {}

    def want(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            p = np.asarray(prompt, np.int32)
            toks = np.asarray(jsteps.greedy_generate(
                jcfg, jp, jnp.asarray(p[None]), n, 64))[0]
            seq = np.concatenate([p, toks])
            logits = np.asarray(jlm.lm_forward(
                jp, {"tokens": jnp.asarray(seq[None])}, jcfg))[0]
            top2 = np.sort(logits[len(p) - 1:len(seq) - 1], axis=-1)[:, -2:]
            small = np.nonzero(top2[:, 1] - top2[:, 0] < MARGIN)[0]
            memo[key] = (toks.tolist(),
                         n if len(small) == 0 else int(small[0]))
        return memo[key]
    return want


TRACE = dict(seed=31, n_requests=4, prompt_len=12, max_tokens=6,
             n_prefix_groups=2, shared_len=8, rate_qps=100.0,
             deadline_s=60.0)


@pytest.mark.parametrize("tier", ["engine", "disagg", "router"])
def test_micro_trace_replays_greedy_tokens_on_each_tier(model, oracle, tier):
    """The reference's micro-trace through the port's ``Replayer`` on each
    tier, traced by a ``Recorder``: every request finishes within its
    deadline with the JAX greedy tokens (up to the first near tie), the
    report holds every headline metric, and the recorder saw only the
    measured sample."""
    _, tcfg, _, tp = model
    made = {"engine": lambda: ServeEngine(tcfg, tp, device="cpu", **KW),
            "disagg": lambda: DisaggServer(tcfg, tp, device="cpu", **KW),
            "router": lambda: Router(tcfg, tp, n_replicas=2, device="cpu",
                                     **KW)}[tier]()
    trace = bench.micro_trace(**TRACE)
    assert trace.to_json() == jbench.micro_trace(**TRACE).to_json()
    rec = obs.Recorder()
    with bench.Replayer(made, name=tier, recorder=rec) as rp:
        results = rp.run(trace, samples=1, timeout=120.0)
        # a request completes before the tier's continuation that lists it
        # as retired runs on the client's loop thread
        deadline = time.monotonic() + 60.0
        while not made.idle and time.monotonic() < deadline:
            time.sleep(0.01)
        retired = list(made.retired)
    report = bench.slo_report(results, bench.SLO(
        ttft_p99_s=60.0, min_finished_frac=1.0, min_deadline_met_frac=1.0))
    assert report["tier"] == tier and report["requests"] == 4
    assert report["slo"]["ok"], report["slo"]["violations"]
    for key in ("tokens_per_s", "goodput_tokens_per_s", "ttft_p50_s",
                "ttft_p99_s", "itl_p99_s", "deadline_met_frac"):
        assert key in report["metrics"], key
    assert "SLO holds" in bench.to_markdown(report)
    # warm requests, the throwaway replay and the sample: each trace
    # prompt was served twice, every request with greedy's tokens
    prompts = {tuple(r.prompt) for r in trace}
    served = [r for r in retired
              if tuple(np.asarray(r.prompt).tolist()) in prompts]
    assert len(served) == 2 * len(trace) and len(retired) > len(served)
    for r in retired:
        assert r.req_state is RequestState.FINISHED
        p = np.asarray(r.prompt).tolist()
        toks, near = oracle(p, len(r.tokens))
        assert r.tokens[:near] == toks[:near]
    causes = rec.cause_summary()
    assert causes["compute_ms_mean"] > 0 and rec.dropped == 0
    assert (causes["shipping_ms_mean"] > 0) == (tier == "disagg")
    if tier != "router":              # router shadows carry ids of their own
        assert causes["requests"] == len(trace)
