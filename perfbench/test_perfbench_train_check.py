"""A train cell's output check, driven through the whole harness on the
CPU at a reduced size: a sound run is correct, and each fault a train
cell can have, planted in the program underneath, comes out not
correct."""
import pytest

from perfbench.testing import run_small

CELLS = ["mamba2-train", "zamba2-train"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res = run_small(cell)
    assert res["correct"], res["checks"]
    assert res["metrics"]["train_tokens_per_s"]["value"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_returns_its_state_unchanged_fails(cell, monkeypatch):
    from repro_torch.train import train_step
    monkeypatch.setattr(train_step, "adamw_update",
                        lambda grads, opt, params, lr, cfg: (params, opt))
    res = run_small(cell)
    assert not res["correct"]
    assert res["checks"]["update"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", CELLS)
def test_half_of_the_batch_left_out_fails(cell, monkeypatch):
    from repro_torch.models import lm
    loss = lm.lm_loss

    def half(params, batch, cfg):
        rows = batch["tokens"].shape[0] // 2
        return loss(params, {"tokens": batch["tokens"][:rows]}, cfg)
    monkeypatch.setattr(lm, "lm_loss", half)
    assert not run_small(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_loss_altered_where_it_is_read_back_fails(cell, monkeypatch):
    from repro_torch.launch import train
    readback = train.loss_readback
    monkeypatch.setattr(train, "loss_readback",
                        lambda loss: readback(loss * 1.01))
    assert not run_small(cell)["correct"]
