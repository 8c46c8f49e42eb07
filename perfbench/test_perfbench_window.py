"""The window arithmetic: every token over the whole window, tails over
every request, a stall counted in full."""
import types

import pytest

from perfbench.serve_cell import ServeRun
from perfbench.train_cell import TrainRun


def _req(arrival, first, times, prompt=10):
    return types.SimpleNamespace(arrival_time=arrival,
                                 first_token_time=first,
                                 token_times=list(times), prompt=[0] * prompt)


def _run(reqs, t_open=0.0, t_close=10.0):
    r = ServeRun({"engine": {"max_batch": 4}}, {}, "bfloat16")
    r.t_open, r.t_close, r.requests = t_open, t_close, reqs
    return r


def test_tokens_per_second_take_every_token_over_the_whole_window():
    # 100 tokens a second for 10 s but a 2 s stall in the middle
    times = [i / 100 for i in range(400)] + \
        [6 + i / 100 for i in range(400)]
    r = _run([_req(-1.0, 0.0, times), _req(-1.0, 0.0, [-0.5, 10.5])])
    assert r.end_to_end()["decode_tokens_per_s"] == pytest.approx(80.0)


def test_the_gap_tail_holds_a_stall_a_median_of_chunks_hides():
    # 20 requests step every 10 ms, but every 10th step of the loop
    # stalls for 100 ms (a prefill): a median over 1 s chunks reads 10 ms
    t, times = 0.0, []
    for i in range(200):
        t += 0.1 if i % 10 == 9 else 0.01
        times.append(t)
    reqs = [_req(-1.0, 0.0, times) for _ in range(20)]
    r = _run(reqs)
    gaps = r.gaps_ms()
    assert len(gaps) == 20 * 199
    chunks = {}
    for a, b in zip(times, times[1:]):
        chunks.setdefault(int(a), []).append((b - a) * 1e3)
    medians = [sorted(c)[len(c) // 2] for c in chunks.values()]
    assert max(medians) == pytest.approx(10.0)
    assert r.end_to_end()["itl_p95_ms"] == pytest.approx(100.0)


def test_ttft_tail_over_every_request_sent_in_the_window():
    reqs = [_req(1.0 + i * 0.01, 1.0 + i * 0.01 + 0.1, [2.0])
            for i in range(95)]
    reqs += [_req(5.0, 7.0, [7.0]) for _ in range(5)]      # five stalls
    reqs += [_req(-1.0, 50.0, [])]                         # sent before
    ttft = _run(reqs).ttfts_ms()
    assert len(ttft) == 100
    assert _run(reqs).end_to_end()["ttft_p95_ms"] > 100.0


def _train_run(done_times, t_close=10.0):
    r = TrainRun({"job": {"batch": 2, "seq_len": 8}}, {}, "float32")
    r.t_open, r.t_close, r.done_times = 0.0, t_close, done_times
    return r


def test_train_rate_is_every_step_over_the_span_to_the_last():
    # a step every 1.5 s: six back inside, the seventh at 10.5 ends the span
    r = _train_run([1.5 * (i + 1) for i in range(8)])
    assert r.steps_done == 7 and r.window_s == pytest.approx(10.5)
    assert r.end_to_end()["train_tokens_per_s"] == pytest.approx(
        7 * 16 / 10.5)


def test_train_rate_holds_a_stall_after_the_last_step_inside():
    # steps every 1.5 s up to t = 19.5, then none until 52.5, past the
    # close at 51: the stall is in the span, not cut off at 19.5
    times = [1.5 * (i + 1) for i in range(13)] + [52.5, 54.0]
    r = _train_run(times, t_close=51.0)
    assert r.steps_done == 14 and r.window_s == pytest.approx(52.5)
    rate = r.end_to_end()["train_tokens_per_s"]
    assert rate == pytest.approx(14 * 16 / 52.5)
    assert rate < 0.5 * 13 * 16 / 19.5      # the rate before the stall


def test_train_rate_runs_to_the_close_where_no_step_came_after_it():
    r = _train_run([1.5 * (i + 1) for i in range(4)])
    assert r.steps_done == 4 and r.window_s == pytest.approx(10.0)
