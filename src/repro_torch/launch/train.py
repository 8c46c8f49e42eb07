"""Training launcher: the continuation engine orchestrating a real run.

Counterpart of ``repro/launch/train.py``, with its arguments and control
flow, on the card (``device="cuda"``, the default) or the CPU. Every
asynchronous subsystem of the trainer is a continuation client:

* input pipeline: depth-N prefetch, fills re-posted from continuations;
  each batch is uploaded from pinned memory without a wait;
* metrics: the step's loss is copied into a pinned host tensor behind the
  step, and a continuation on a ``TensorOp`` after that copy reads it, so
  the loop never waits on the card;
* checkpointing: ``AsyncCheckpointer.save_async`` snapshots the state on a
  side stream and commits through continuations; the loop polls
  ``cr.test()`` at step boundaries (the paper's Listing-2 pattern);
* restart: on launch, the latest *committed* checkpoint is restored.

Usage:  PYTHONPATH=src python -m repro_torch.launch.train --arch paper_demo \
            --steps 300 --global-batch 4 --seq-len 256 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.async_ckpt import AsyncCheckpointer
from repro_torch.configs import get_config
from repro_torch.core import Engine, TensorOp
from repro_torch.data.pipeline import PrefetchPipeline, SyntheticTokenSource
from repro_torch.optim import OptConfig, warmup_cosine
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.util import resolve_device


def upload(batch: Dict[str, np.ndarray],
           device: torch.device) -> Dict[str, torch.Tensor]:
    """A numpy batch on ``device``: through pinned memory and a
    non-blocking copy on the card (no wait), as it is on the CPU."""
    out = {}
    for k, arr in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def loss_readback(loss: torch.Tensor) -> TensorOp:
    """An op that completes once ``loss`` has reached a host tensor (its
    payload): a non-blocking copy into pinned memory, then an event."""
    if loss.is_cuda:
        host = torch.empty((), dtype=loss.dtype, pin_memory=True)
        host.copy_(loss, non_blocking=True)
    else:
        host = loss.detach().clone()
    return TensorOp(loss, payload=host)


def train(arch: str = "paper_demo", steps: int = 100, global_batch: int = 4,
          seq_len: int = 256, lr: float = 3e-4, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, log_every: int = 10, reduced: bool = False,
          num_microbatches: int = 1, log_path: Optional[str] = None,
          seed: int = 0, device: Any = "cuda", *,
          n_layers: Optional[int] = None, remat: str = "none",
          before_step: Optional[Callable[[int], None]] = None,
          sync_debug_mode: Optional[str] = None) -> Dict[str, Any]:
    """Train ``arch`` in fp32 with the reference's loop (its remat policy
    ``"none"`` unless ``remat`` says otherwise; ``n_layers`` cuts the
    depth, widths kept). ``before_step(i)``
    runs ahead of step ``i`` (the card checks queue a sleep there);
    ``sync_debug_mode`` (a card run) is set for the step loop alone. The
    result adds to the reference's: the host's ms a step over the loop and
    each iteration's, the card's ms each step (timing events around it on
    the card), how many loss readbacks were still pending at their first
    poll, and whether each checkpoint's copy was still running when
    ``save_async`` returned."""
    dev = resolve_device(device)
    engine = Engine()
    overrides = {"n_layers": n_layers} if n_layers else {}
    cfg = get_config(arch, reduced=reduced, remat=remat,
                     dtype=torch.float32, param_dtype=torch.float32,
                     **overrides)
    opt = OptConfig(lr=lr)
    sched = warmup_cosine(lr, warmup_steps=max(1, steps // 20),
                          total_steps=steps)
    step_fn = make_train_step(cfg, opt, lr_schedule=sched,
                              num_microbatches=num_microbatches)

    ckpt = AsyncCheckpointer(ckpt_dir, engine) if ckpt_dir else None
    state = init_train_state(cfg, opt, seed=seed, device=dev)
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        start_step = ckpt.latest_step()
        state = ckpt.restore(start_step, state)
        print(f"[train] restored committed checkpoint at step {start_step}")

    source = SyntheticTokenSource(cfg, global_batch, seq_len, seed=seed)
    # bounded at the run's batches: the pipeline re-posts a fill from each
    # fill's continuation, and unbounded it keeps two threads busy making
    # batches no step takes, against the eager step for the interpreter
    pipeline = PrefetchPipeline(source, engine, depth=2, max_batches=steps)
    # skip batches already consumed before the restart (deterministic
    # resume): indices are absolute
    pipeline._posted = start_step
    pipeline._next_deliver = start_step

    metrics_cr = engine.continue_init({"mpi_continue_enqueue_complete": True})
    log_rows = []
    t_start = time.time()

    def log_metrics(statuses, step_idx):
        loss = float(statuses[0].payload)
        row = {"step": step_idx, "loss": loss,
               "elapsed_s": round(time.time() - t_start, 2)}
        log_rows.append(row)
        if step_idx % log_every == 0 or step_idx == steps - 1:
            print(f"[train] step {step_idx:5d} loss {loss:.4f} "
                  f"({row['elapsed_s']:.1f}s)", flush=True)

    handles = []
    events = []
    host_s = []
    loss_pending = 0
    cuda = dev.type == "cuda"
    prev_mode = torch.cuda.get_sync_debug_mode() if cuda else 0
    if cuda and sync_debug_mode is not None:
        torch.cuda.set_sync_debug_mode(sync_debug_mode)
    t_loop = time.perf_counter()
    try:
        for step_idx in range(start_step, steps):
            t_step = time.perf_counter()
            batch = upload(pipeline.get_next(), dev)
            if before_step is not None:
                before_step(step_idx)
            if cuda:
                events.append((torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True)))
                events[-1][0].record()
            state, metrics = step_fn(state, batch)
            if events:
                events[-1][1].record()
            # completion-driven metric readback: the callback runs when
            # the loss has reached the host; the loop never blocks on it
            op = loss_readback(metrics["loss"])
            engine.continue_when(op, log_metrics, step_idx, status=[None],
                                 cr=metrics_cr)
            loss_pending += not op.done()       # its first poll
            if ckpt is not None and (step_idx + 1) % ckpt_every == 0:
                handles.append(ckpt.save_async(step_idx + 1, state))
            metrics_cr.test()    # Listing-2 polling service at step boundary
            host_s.append(time.perf_counter() - t_step)
    finally:
        loop_s = time.perf_counter() - t_loop
        if cuda:
            torch.cuda.set_sync_debug_mode(prev_mode)

    metrics_cr.wait(timeout=600)
    copy_pending = [h.copy_pending_at_return for h in handles]
    if ckpt is not None:
        # the final save, unless the loop's last one was at this step: two
        # saves of one step would share (and race on) one staging directory
        if not handles or handles[-1].step != steps:
            handles.append(ckpt.save_async(steps, state))
        for h in handles:
            h.wait(timeout=600)
        ckpt.close()
    pipeline.close()
    engine.shutdown()
    log_rows.sort(key=lambda r: r["step"])
    n = steps - start_step
    result = {"arch": cfg.name, "steps": steps,
              "first_loss": log_rows[0]["loss"] if log_rows else None,
              "final_loss": log_rows[-1]["loss"] if log_rows else None,
              "elapsed_s": round(time.time() - t_start, 1),
              "rows": log_rows,
              "host_ms_per_step": loop_s / max(n, 1) * 1e3,
              "host_ms_each": [t * 1e3 for t in host_s],
              "loss_ops": n, "loss_pending_at_first_poll": loss_pending,
              "ckpt_copy_pending_at_return": copy_pending}
    if events:
        result["card_ms_per_step"] = [s.elapsed_time(e) for s, e in events]
        result["card_ms_median"] = statistics.median(
            result["card_ms_per_step"])
    if log_path:
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        with open(log_path, "w") as f:
            json.dump(result, f, indent=2)
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper_demo")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--log-path", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    result = train(arch=args.arch, steps=args.steps,
                   global_batch=args.global_batch, seq_len=args.seq_len,
                   lr=args.lr, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every, reduced=args.reduced,
                   num_microbatches=args.microbatches,
                   log_path=args.log_path, device=args.device)
    print(f"[train] done: loss {result['first_loss']:.4f} → "
          f"{result['final_loss']:.4f} in {result['elapsed_s']}s")


if __name__ == "__main__":
    main()
