"""A train cell: ``repro_torch.train.train_step.make_train_step`` on a
state of the benchmark's weights and zeroed AdamW moments, driven as
``repro_torch.launch.train.train`` drives it, for a timed window.

Each iteration takes the next batch from ``PrefetchPipeline`` (fed by the
benchmark's own token source), uploads it, dispatches the step, reads its
loss back through a continuation (``loss_readback``) and polls the
metrics CR (``cr.test()``): the loop of ``train()`` without its schedule
(the learning rate is constant), its checkpoints and its step count (the
window bounds it). Set-up drives the same object through the cell's first
``check.steps`` steps by that same loop, keeping what the output check
needs: a host copy of the weights before step 1, each step's loss, the
first gradient's per-leaf norms (the first moment after step 1 over
1 - b1) and the change of every leaf after the last. Those steps also warm
every shape. The window's rate is the tokens of the steps whose loss came
back inside it, and of the first one to come back at or after its close,
over the span from its opening to that one: a step is seconds long, so
the span holds a whole number of steps and every second of the window,
a stall before the close included.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from perfbench import devtrace
from perfbench.reference.train import (compare, flat, leaf_norms,
                                       reference_steps)
from perfbench.weights import make_params


class TokenSource:
    """Batch ``i`` of a seed: uniform token ids ``(batch, seq_len)`` int32
    drawn from ``(seed, i)``, so every row of every batch differs.

    ``PrefetchPipeline`` posts its next fill when a fill completes, not
    when a batch is taken, so left alone its fill threads would make
    batches as fast as they can for the whole window. The source keeps
    them at most ``ahead`` batches past the ones the loop has taken
    (``took``); ``close`` releases a fill still waiting."""

    def __init__(self, vocab: int, batch: int, seq_len: int,
                 seed: int, ahead: int = 2) -> None:
        self.vocab, self.batch, self.seq_len = vocab, batch, seq_len
        self.seed = int(seed)
        self.ahead = ahead
        self._cv = threading.Condition()
        self._taken = 0
        self._closed = False

    def took(self) -> None:
        with self._cv:
            self._taken += 1
            self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def make_batch(self, index: int) -> Dict[str, np.ndarray]:
        with self._cv:
            self._cv.wait_for(lambda: self._closed
                              or index < self._taken + self.ahead)
        return {"tokens": self.tokens(index)}

    def tokens(self, index: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, index])
        return rng.integers(0, self.vocab, (self.batch, self.seq_len),
                            dtype=np.int32)


class TrainRun:
    """What a train run leaves for the metric readers."""

    def __init__(self, cell: Mapping[str, Any], model: Mapping[str, Any],
                 dtype: str) -> None:
        self.cell, self.model, self.dtype = cell, model, dtype
        job = cell["job"]
        self.batch, self.seq_len = int(job["batch"]), int(job["seq_len"])
        self.t_open = self.t_close = 0.0
        self.done_times: List[float] = []     # loss back, window's steps
        self.host_s: List[float] = []         # host seconds an iteration
        self.pending = 0                      # readbacks pending at poll
        self.timeline: Optional[devtrace.Timeline] = None

    def counted(self) -> List[float]:
        """The completions counted: every one before the close and the
        first at or after it."""
        times = sorted(self.done_times)
        late = [i for i, t in enumerate(times) if t >= self.t_close]
        return times[:late[0] + 1] if late else times

    @property
    def window_s(self) -> float:
        """From the opening to the first completion at or after the close,
        or to the close where none came after it."""
        times = self.counted()
        end = times[-1] if times else self.t_close
        return max(end, self.t_close) - self.t_open

    @property
    def steps_done(self) -> int:
        return len(self.counted())

    def end_to_end(self) -> Dict[str, float]:
        n = self.steps_done
        if not n:
            return {}
        return {"train_tokens_per_s": n * self.batch * self.seq_len
                / self.window_s}


def _host_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def _change_norms(new: Any, old_host: Any) -> Dict[str, float]:
    old = flat(old_host)
    return {k: float((v.float() - old[k].to(v.device).float()).norm())
            for k, v in flat(new).items()}


def hyper(opt: Any) -> Dict[str, float]:
    """The optimizer's settings, for the reference."""
    return {"b1": opt.b1, "b2": opt.b2, "eps": opt.eps, "lr": opt.lr,
            "weight_decay": opt.weight_decay, "grad_clip": opt.grad_clip}


def run(cell: Mapping[str, Any], conf: Mapping[str, Any], cfg: Any,
        seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float) -> Dict[str, Any]:
    from repro_torch.core import Engine
    from repro_torch.data.pipeline import PrefetchPipeline
    from repro_torch.launch.train import loss_readback, upload
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.train.train_step import make_train_step

    r = TrainRun(cell, conf["model"], conf["train"]["dtype"])
    check = cell["check"]
    n_check = int(check["steps"])
    opt = OptConfig(lr=float(conf["train"]["lr"]))
    step_fn = make_train_step(cfg, opt)
    params = make_params(cfg, seed, device)
    state = {"params": params, "opt": adamw_init(params, opt),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    del params
    source = TokenSource(cfg.vocab_size, r.batch, r.seq_len, seed)
    engine = Engine()
    pipeline = PrefetchPipeline(source, engine, depth=2)
    metrics_cr = engine.continue_init(
        {"mpi_continue_enqueue_complete": True})
    losses: Dict[int, float] = {}
    stamps: Dict[int, float] = {}

    def on_loss(statuses, idx):
        losses[idx] = float(statuses[0].payload)
        stamps[idx] = time.monotonic()

    def iteration(idx: int) -> None:
        nonlocal state
        t0 = time.perf_counter()
        batch = upload(pipeline.get_next(), device)
        source.took()
        state, metrics = step_fn(state, batch)
        op = loss_readback(metrics["loss"])
        engine.continue_when(op, on_loss, idx, status=[None],
                             cr=metrics_cr)
        if not op.done():                   # its first poll
            r.pending += 1
        metrics_cr.test()
        r.host_s.append(time.perf_counter() - t0)

    # set-up: the checked steps, through the window's own loop
    params0 = _host_tree(state["params"])
    batches = [source.tokens(i) for i in range(n_check)]
    prog: Dict[str, Any] = {}
    for idx in range(n_check):
        iteration(idx)
        if idx == 0:
            prog["grad"] = {k: v / (1 - opt.b1) for k, v in
                            leaf_norms(state["opt"]["m"]).items()}
    prog["update"] = _change_norms(state["params"], params0)
    metrics_cr.wait(timeout=600)
    prog["loss"] = [losses[i] for i in range(n_check)]
    r.host_s.clear()
    r.pending = 0
    if device.type == "cuda":
        torch.cuda.synchronize()

    r.t_open = time.monotonic()
    setup_s = r.t_open - t_start
    r.t_close = r.t_open + seconds
    idx = n_check
    while time.monotonic() < r.t_close:
        iteration(idx)
        idx += 1
    n_close = idx
    slice_ = None
    if trace:
        # the profiled slice: the same loop for two steps or more, after
        # the window
        n_window, pending = len(r.host_s), r.pending
        slice_ = devtrace.Slice(cell["name"])
        slice_.prepare()
        iteration(idx)              # the step the start-up held back
        idx += 1
        slice_.start()
        t_end = time.monotonic() + min(4.0, seconds / 3)
        while time.monotonic() < t_end:
            iteration(idx)
            idx += 1
        slice_.stop()
        del r.host_s[n_window:]
        r.pending = pending
    metrics_cr.wait(timeout=600)
    r.done_times = [stamps[i] for i in range(n_check, n_close)]
    source.close()
    pipeline.close()
    engine.shutdown()
    if device.type == "cuda":
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    if slice_ is not None:
        r.timeline = slice_.read()
    del state, pipeline, step_fn
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_steps(conf["model"], params0, batches, hyper(opt),
                          device, block_rows=int(check["block_rows"]))
    got = compare(prog, ref)
    limits = check["limits"]
    checks = {k: {"value": got[k], "limit": float(limits[k])}
              for k in ("loss", "grad", "update")}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return {"run": r, "setup_s": setup_s, "peak": peak,
            "attempted": idx, "failed": 0, "correct": correct,
            "checks": checks, "prog": prog, "ref": ref,
            "params0": params0, "batches": batches, "opt": opt}
