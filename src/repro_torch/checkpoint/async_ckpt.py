"""Asynchronous checkpointing with continuation-based commit.

Counterpart of ``repro/checkpoint/async_ckpt.py``, with the same on-disk
layout: one ``.npy`` per leaf (named by its key path, ``/`` as ``__``), a
``MANIFEST.json``, and the atomic rename of ``.tmp-step-N`` to
``step-N`` as the commit.

``save_async`` is three continuation stages, and the trainer never waits
on any of them:

1. it starts the device→host copies of every leaf on a side stream (the
   checkpointer's own, ordered after the work queued so far), into pinned
   buffers, and marks each snapshotted tensor with ``record_stream`` so its
   memory is not reused while the copy reads it; a ``TensorOp`` on that
   stream wraps the copies' completion;
2. that op's continuation posts one write a leaf to the I/O pool, each a
   ``HostTaskOp``;
3. the commit continuation runs over ``when_all`` of the writes, as in the
   reference (``enqueue_complete``: it always goes through the continuation
   path; ``thread=any``: an I/O thread may run it).

A CPU state (``device="cpu"`` runs) is snapshotted by a copy at once. The
state is never written by the trainer after it is snapshotted: AdamW
returns new tensors (``optim.adamw``). A checkpoint without a committed
manifest is invisible to ``latest_step``/``restore``, so a crash during a
save resumes from the previous committed step. ``restore`` loads onto the
device of the ``like`` tree it is given (the trainer's).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import (THREAD_ANY, ContinueFlags, Engine, HostTaskOp,
                              Promise, TensorOp, when_all)

# registration flags of the copy and commit continuations (module docstring)
_COMMIT_FLAGS = ContinueFlags(enqueue_complete=True, thread=THREAD_ANY)


def flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(key path, leaf)`` of a nested dict, keys in sorted order, paths
    joined by ``/`` (the reference's names for the same tree)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_paths(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy; bf16 (which numpy lacks) as its uint16
    bits, which ``restore`` views back by the ``like`` leaf's dtype."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


class CheckpointHandle:
    """Handle on an in-flight save: pollable (``cr``), blockable
    (``wait``), and awaitable (``promise`` resolves with the committed
    directory once the manifest is in place, rejects on write errors).
    ``copy_op`` completes when the device→host copies have run;
    ``copy_pending_at_return`` says whether they were still running when
    ``save_async`` returned (its first poll)."""

    def __init__(self, step: int, directory: str, cr, copy_op: TensorOp,
                 promise: Promise) -> None:
        self.step = step
        self.directory = directory
        self.cr = cr
        self.copy_op = copy_op
        self.copy_pending_at_return: Optional[bool] = None
        self.promise = promise
        self.committed = threading.Event()
        self.error: Optional[BaseException] = None

    def wait(self, timeout: float = 120.0) -> bool:
        self.cr.wait(timeout=timeout)
        ok = self.committed.wait(timeout=timeout)
        if self.error is not None:
            raise self.error
        return ok


class AsyncCheckpointer:
    def __init__(self, base_dir: str, engine: Engine, *,
                 io_workers: int = 4, keep: int = 3) -> None:
        self.base_dir = base_dir
        self.engine = engine
        self.keep = keep
        os.makedirs(base_dir, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=io_workers,
                                        thread_name_prefix="ckpt-io")
        self._streams: Dict[torch.device, Any] = {}
        self.stats = {"saves": 0, "commits": 0, "bytes": 0}

    # ------------------------------------------------------------------ save
    def _snapshot(self, leaves: List[Tuple[str, Any]]
                  ) -> Tuple[TensorOp, List[torch.Tensor]]:
        """Start the host copies of ``leaves``; returns the op that
        completes when they ran, and the host tensors they fill."""
        tensors = [leaf for _, leaf in leaves]
        cuda = [t for t in tensors if t.is_cuda]
        if not cuda:
            return TensorOp(None), [t.detach().clone() for t in tensors]
        dev = cuda[0].device
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        hosts = []
        with torch.cuda.stream(stream):
            for t in tensors:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t.detach(), non_blocking=True)
                t.record_stream(stream)
                hosts.append(host)
            # recorded on the side stream: complete once every copy ran
            op = TensorOp(cuda[0], payload=hosts)
        return op, hosts

    def save_async(self, step: int, state: Any) -> CheckpointHandle:
        tmp_dir = os.path.join(self.base_dir, f".tmp-step-{step:08d}")
        final_dir = os.path.join(self.base_dir, f"step-{step:08d}")
        os.makedirs(tmp_dir, exist_ok=True)
        leaves = flatten_with_paths(state)
        manifest = {"step": step, "leaves": {}}
        fnames = []
        for name, _ in leaves:
            fname = name.replace("/", "__") + ".npy"
            manifest["leaves"][name] = fname
            fnames.append(fname)
        cr = self.engine.continue_init()

        copy_op, hosts = self._snapshot(leaves)

        def write(host: torch.Tensor, fname: str) -> int:
            arr = _to_numpy(host)
            with open(os.path.join(tmp_dir, fname), "wb") as f:
                np.save(f, arr)
            return arr.nbytes

        def post_writes(_payload) -> Promise:
            # the copies ran: one write a leaf on the I/O pool, and the
            # commit's registration over all of them
            ops = [HostTaskOp(self._pool.submit(write, h, f))
                   for h, f in zip(hosts, fnames)]
            return Promise.of(self.engine, when_all(ops), cr=cr,
                              flags=_COMMIT_FLAGS)

        copied = Promise.of(self.engine, copy_op, cr=cr, flags=_COMMIT_FLAGS)
        writes = copied.then(post_writes)
        handle = CheckpointHandle(step, final_dir, cr, copy_op, writes)

        def commit(nbytes: List[int]) -> str:
            # the pinned buffers go back to the caching host allocator
            # (the handle keeps this closure): the next save reuses them
            hosts.clear()
            self.stats["bytes"] += sum(n or 0 for n in nbytes)
            with open(os.path.join(tmp_dir, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final_dir):
                shutil.rmtree(final_dir)
            os.rename(tmp_dir, final_dir)       # atomic commit
            self.stats["commits"] += 1
            handle.committed.set()
            self._gc()
            return final_dir

        def failed(exc: BaseException):
            hosts.clear()
            handle.error = exc
            shutil.rmtree(tmp_dir, ignore_errors=True)
            handle.committed.set()
            raise exc                           # keep the promise rejected

        def commit_failed(exc: BaseException):
            # a failure in commit itself (manifest write, rename, gc) must
            # still surface through handle.wait(), not just the promise
            if handle.error is None:
                handle.error = exc
            handle.committed.set()
            raise exc

        handle.promise = writes.then(commit, failed).catch(commit_failed)
        self.stats["saves"] += 1
        handle.copy_pending_at_return = not copy_op.done()
        return handle

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.base_dir, f"step-{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.base_dir):
            if d.startswith("step-") and os.path.exists(
                    os.path.join(self.base_dir, d, "MANIFEST.json")):
                out.append(int(d.split("-")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any) -> Any:
        """Rebuild the tree of ``like``'s structure from disk, each leaf on
        its ``like`` leaf's device and in its dtype."""
        d = os.path.join(self.base_dir, f"step-{step:08d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)

        def load(name: str, ref: torch.Tensor) -> torch.Tensor:
            arr = np.load(os.path.join(d, manifest["leaves"][name]))
            # ascontiguousarray makes a 0-d array 1-d: keep the shape
            t = torch.from_numpy(
                np.ascontiguousarray(arr).reshape(arr.shape))
            if ref.dtype == torch.bfloat16:
                t = t.view(torch.int16).view(torch.bfloat16)
            return t.to(device=ref.device, dtype=ref.dtype)

        def rebuild(tree: Any, prefix: str = "") -> Any:
            if isinstance(tree, dict):
                return {k: rebuild(v, f"{prefix}{k}/")
                        for k, v in tree.items()}
            return load(prefix[:-1], tree)

        return rebuild(like)

    def close(self) -> None:
        self._pool.shutdown(wait=True)
