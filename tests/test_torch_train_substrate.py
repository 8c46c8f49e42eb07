"""The trainer's substrate against the JAX package on the CPU: the
synthetic token source (byte-equal batches), the continuation-driven
prefetch, and the asynchronous checkpointer (the reference's on-disk
layout, commit, gc, crash-safety and a bit-exact restart), mirroring
``tests/substrate/test_substrate.py``."""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.async_ckpt import AsyncCheckpointer as JCheckpointer
from repro.configs import get_config as jax_get_config
from repro.core import Engine as JEngine
from repro.data.pipeline import SyntheticTokenSource as JSource
from repro_torch.checkpoint.async_ckpt import (AsyncCheckpointer,
                                               flatten_with_paths)
from repro_torch.configs import get_config
from repro_torch.core import Engine
from repro_torch.data.pipeline import PrefetchPipeline, SyntheticTokenSource
from repro_torch.launch.train import train
from repro_torch.optim import OptConfig
from repro_torch.optim.tree import tree_leaves
from repro_torch.train.train_step import init_train_state, make_train_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def engine():
    eng = Engine()
    yield eng
    eng.shutdown()


def _batch_tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", ["paper_demo", "whisper_large_v3",
                                  "internvl2_26b"])
def test_synthetic_batches_are_byte_equal_to_the_reference(name):
    cfg = get_config(name, reduced=True)
    jcfg = jax_get_config(name, reduced=True)
    ours = SyntheticTokenSource(cfg, global_batch=3, seq_len=40, seed=7)
    theirs = JSource(jcfg, global_batch=3, seq_len=40, seed=7)
    for i in (0, 1, 5):
        a, b = ours.make_batch(i), theirs.make_batch(i)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes()


def test_prefetch_pipeline_produces_all_batches_in_order(engine):
    cfg = get_config("paper_demo", reduced=True)
    src = SyntheticTokenSource(cfg, global_batch=2, seq_len=16,
                               fill_latency_s=0.002)
    pipe = PrefetchPipeline(src, engine, depth=3, max_batches=10)
    seen = [b["tokens"].copy() for b in pipe]
    assert len(seen) == 10
    for i in (0, 3, 9):
        np.testing.assert_array_equal(seen[i], src.make_batch(i)["tokens"])
    assert pipe.stats["fills"] == 10
    pipe.close()


def _state():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(4), "h": torch.ones(2).bfloat16()},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip_and_the_reference_layout(tmp_path, engine):
    """A save restores bit-exact (bf16 leaves too), and writes the files,
    names and manifest the reference writes for the same tree."""
    ckpt = AsyncCheckpointer(str(tmp_path / "port"), engine, keep=2)
    state = _state()
    handle = ckpt.save_async(7, state)
    assert handle.wait(timeout=30)
    assert handle.promise.result(timeout=30).endswith("step-00000007")
    assert ckpt.latest_step() == 7
    restored = ckpt.restore(7, state)
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ckpt.close()
    # the reference's checkpointer on the same (fp32) tree
    fp32 = {"params": {"w": state["params"]["w"], "b": state["params"]["b"]},
            "step": state["step"]}
    jeng = JEngine()
    jck = JCheckpointer(str(tmp_path / "ref"), jeng)
    assert jck.save_async(7, jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), fp32)).wait(timeout=30)
    jck.close()
    jeng.shutdown()
    ours = AsyncCheckpointer(str(tmp_path / "port32"), engine)
    assert ours.save_async(7, fp32).wait(timeout=30)
    ours.close()
    ref_dir, our_dir = (tmp_path / "ref" / "step-00000007",
                        tmp_path / "port32" / "step-00000007")
    assert sorted(os.listdir(ref_dir)) == sorted(os.listdir(our_dir))
    assert json.loads((ref_dir / "MANIFEST.json").read_text()) == \
        json.loads((our_dir / "MANIFEST.json").read_text())
    for f in os.listdir(ref_dir):
        if f.endswith(".npy"):
            a, b = np.load(ref_dir / f), np.load(our_dir / f)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert [n for n, _ in flatten_with_paths(fp32)] == \
        ["params/b", "params/w", "step"]


def test_checkpoint_uncommitted_invisible(tmp_path, engine):
    """A crash mid-save (no manifest) must not be restorable."""
    ckpt = AsyncCheckpointer(str(tmp_path), engine)
    assert ckpt.save_async(3, {"w": torch.ones(4)}).wait(timeout=30)
    os.makedirs(str(tmp_path / "step-00000009"))
    np.save(str(tmp_path / "step-00000009" / "w.npy"), np.zeros(4))
    assert ckpt.latest_step() == 3     # torn step invisible
    ckpt.close()


def test_checkpoint_gc_keeps_recent(tmp_path, engine):
    ckpt = AsyncCheckpointer(str(tmp_path), engine, keep=2)
    for s in [1, 2, 3, 4]:
        assert ckpt.save_async(s, {"w": torch.ones(2)}).wait(timeout=30)
    assert ckpt.all_steps() == [3, 4]
    ckpt.close()


def test_train_crash_restart_resumes_bit_exact(tmp_path, engine):
    """Save at step k, keep training, 'crash', restore, re-train: the
    states match bit-exactly (the reference's fault-tolerance test)."""
    cfg = get_config("paper_demo", reduced=True, dtype=torch.float32,
                     param_dtype=torch.float32)
    opt = OptConfig(lr=1e-3)
    step = make_train_step(cfg, opt)
    src = SyntheticTokenSource(cfg, 2, 16)
    state = init_train_state(cfg, opt, seed=0, device="cpu")
    ckpt = AsyncCheckpointer(str(tmp_path), engine)
    for i in range(3):
        state, _ = step(state, _batch_tensors(src.make_batch(i)))
    handle = ckpt.save_async(3, state)
    cont = state
    for i in range(3, 5):                      # training continues async
        cont, _ = step(cont, _batch_tensors(src.make_batch(i)))
    assert handle.wait(timeout=30)
    restored = ckpt.restore(3, state)
    for i in range(3, 5):
        restored, _ = step(restored, _batch_tensors(src.make_batch(i)))
    for a, b in zip(tree_leaves(cont), tree_leaves(restored)):
        assert torch.equal(a, b)
    ckpt.close()


def test_cpu_trainer_restarts_from_the_last_commit(tmp_path):
    """``launch.train`` resumes from its latest committed step: a run
    restarted from the uninterrupted run's step-4 checkpoint ends, at step
    6, with that run's state, bit for bit."""
    kw = dict(steps=6, global_batch=2, seq_len=16, lr=3e-3, reduced=True,
              device="cpu", log_every=100, ckpt_every=4)
    train("paper_demo", ckpt_dir=str(tmp_path / "a"), **kw)
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "step-00000004",
                    tmp_path / "b" / "step-00000004")
    out = train("paper_demo", ckpt_dir=str(tmp_path / "b"), **kw)
    assert [r["step"] for r in out["rows"]] == [4, 5]
    a, b = (tmp_path / d / "step-00000006" for d in ("a", "b"))
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        if f.endswith(".npy"):
            assert np.load(a / f).tobytes() == np.load(b / f).tobytes()
