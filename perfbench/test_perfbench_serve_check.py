"""A serve cell's output check, driven through the whole harness on the
CPU at a reduced size (every part of a run but the look for a card): a
sound run is correct, and each fault a serve cell can have, planted in
the program underneath, comes out not correct."""
import pytest

from perfbench.testing import run_small

CELLS = ["mamba2-gen", "zamba2-longctx"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res = run_small(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["metrics"]["decode_tokens_per_s"]["value"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_a_token_altered_where_it_is_produced_fails(cell, monkeypatch):
    from repro_torch.serve.request import Request
    deliver = Request.deliver

    def altered(self, toks):
        return deliver(self, [(int(t) + 1) % 512 for t in toks])
    monkeypatch.setattr(Request, "deliver", altered)
    assert not run_small(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_decode_step_that_leaves_its_state_unchanged_fails(cell,
                                                             monkeypatch):
    from repro_torch.models import lm
    step = lm._block_ssm_decode

    def frozen(lp, x, cache, cfg):
        return step(lp, x, {k: v.clone() for k, v in cache.items()}, cfg)
    monkeypatch.setattr(lm, "_block_ssm_decode", frozen)
    assert not run_small(cell)["correct"]


def test_the_traced_run_reports_the_per_layer_metrics():
    res = run_small("mamba2-gen", seconds=1.5, trace=True)
    got = set(res["metrics"])
    assert {"slot_occupancy.decode", "host_dispatch_ms.decode",
            "decode_bytes_roofline", "mfu.decode", "ttft_p95_ms.decode",
            "itl_p95_ms.decode", "admit_ms_p95.decode",
            "prefill_ms_p95.decode", "notify_us_p95.decode"} <= got
    assert "decode_tokens_per_s" not in got
    assert "busy_s" in res["device"] and "window_s" in res["device"]
