"""Without a CUDA card a run fails and prints no result: no CPU
fallback."""
import pytest


def test_a_run_without_a_card_fails_and_prints_nothing(capsys,
                                                        monkeypatch):
    import torch
    from perfbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        run.main(["--workload", "mamba2-gen", "--seed", "3000000000",
                  "--seconds", "1", "--trace", "0"])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_a_run_with_too_few_cards_fails(monkeypatch):
    import torch
    from perfbench import harness
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit):
        harness.device_for(1)
