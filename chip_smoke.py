"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. environment — torch / CUDA versions, the card's name and power limit;
   no CUDA means exit 1 with no result;
2. build — compile the kernels of ``src/repro_torch/csrc`` with nvcc;
3. kernels — each kernel against its plain PyTorch version on the card at
   the main path's shapes, in fp32 (TF32 off) and bf16, with its median
   time over CUDA-event-timed runs beside its bound and, where one PyTorch
   call computes the same function, that call's time and the ratio of the
   two; rmsnorm and ``F.rms_norm`` also by their ``torch.profiler``
   device time (median of 50 calls); paged attention at decode (one idle
   slot, and all 8 slots at 900-1023 positions) and at suffix windows of
   16 and 256 rows; the SSD scan at B=1 and T = 512, 509, 64, 2048 and at
   B=4, T=256, with the device time of each of its three grids;
4. fp32 identity — ``paper_demo`` at full width in fp32 served by the
   engine (paged kernel) must emit the tokens of the port's
   ``greedy_generate`` oracle (dense decode, no paged kernel) up to the
   first near tie;
5. bf16 serve — 24 requests at full width in bf16 through
   ``ServeEngine.submit``/``run``, 8 of them sharing a 256-token prefix;
   every request must finish, the pool must drain, the prefix cache must
   hit and every kernel must have launched. The loop runs under
   ``torch.cuda`` sync debug mode "error" (``.item()``, a blocking copy or
   a stream sync raises). Where the host is the slower side, as on the
   H100 hosts measured so far, a step is usually done by its first poll;
5b. card-bound loop — the same engine path with a ``torch.cuda._sleep``
   queued ahead of every decode step, holding the card several times
   longer than the host takes to enqueue a step: nearly every step must
   still be running when its ``TensorOp`` is first polled
   (``TensorOp.PENDING_AT_FIRST_POLL``): the host reached the poll before
   the card finished the step, so it had not waited for it;
6. profile — the bf16 workload again, with ``torch.profiler`` over a
   window of decode steps: the card's busy share and its time by kernel
   family;
7. mamba2 fp32 identity — ``mamba2_370m`` at full width (48 layers) in
   fp32, served by the engine in dense mode (chosen automatically: the
   SSM family has no paged cache), must emit the tokens of
   ``greedy_generate`` up to the first near tie, on prompts of prime
   lengths among others; ``lm_forward``'s last row on a 512-token prompt
   must equal ``lm_prefill``'s logits to 1e-3;
8. mamba2 bf16 serve — 16 requests of 64–512 prompt tokens (two of
   prime length) and 32–64 new tokens through ``ServeEngine`` in dense
   mode under sync debug mode "error"; every prefill must have launched
   the SSD kernel once a layer (48 × prefills) and rmsnorm 49 times a
   prefill and a decode step;
8b. its card-bound loop, as 5b but with the sleep queued behind each
   step's kernels: a mamba2 decode step launches more kernels than the
   card's launch queue holds, so with the sleep ahead of them the host's
   enqueue stalls until the card has nearly caught up, and the steps are
   not pending at their first poll (5b's check in 5b's form fails for
   mamba2). With the sleep behind, the phase checks the poll and
   continuation path only; it prints the host's stall on the full launch
   queue (its enqueue time a step beyond phase 8's);
9. its profile, as 6.

Each serve phase sets the kernels' launch counts to 0 just before it
drives its path and reads them just after. The kernels JSON reports
``launches`` from the path that runs the kernel (phase 5 for
``paper_demo``'s kernels, phase 8 for the SSD scan). The next-to-last
line is the kernels JSON, the last line the device JSON.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,      # dense tensor-core bf16
              torch.float32: 67e12}        # fp32 outside the tensor cores
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the SSD scan's final state is fp32 on both sides, from the same inputs
STATE_TOL = 1e-4
TIMED_RUNS = 50
SOURCES = {
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:41"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:105"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention/kernel.py:141"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:68"),
}


def log(*args) -> None:
    print(*args, flush=True)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
def median_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median device time of ``fn`` over ``runs`` event-bracketed calls.
    A sleep kernel queued ahead keeps the card busy while the host
    enqueues the calls, so host launch gaps fall outside the events (unless
    ``fn`` itself synchronises): one sleep ahead of all runs when their
    enqueue is short, else one ahead of each run."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    each = runs * host_s > 0.01
    if not each:
        torch.cuda._sleep(50_000_000)
    for start, end in events:
        if each:
            torch.cuda._sleep(int(4e9 * host_s) + 1_000_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_ms(fn, runs: int = TIMED_RUNS):
    """Median device time of one call of ``fn`` under ``torch.profiler``:
    the summed durations of the kernels the call runs (a call's kernels
    are consecutive on the stream), over ``runs`` calls; and the median
    duration of each kernel, by name. Unlike events around a call, this
    leaves out the launch gaps between calls and inside one."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a profiling session now and then delivers no device events at all:
    # take the first of three that saw every call's kernels
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        kernels = sorted(
            (e.time_range.start, e.time_range.elapsed_us(), e.name)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
        if kernels and len(kernels) % runs == 0:
            break
    else:
        raise AssertionError(f"device_ms: {len(kernels)} kernels in "
                             f"{runs} calls")
    per = len(kernels) // runs
    calls = [kernels[i * per:(i + 1) * per] for i in range(runs)]
    by_name = {name: statistics.median(c[k][1] for c in calls) / 1e3
               for k, (_, _, name) in enumerate(calls[0])}
    return statistics.median(sum(d for _, d, _ in c) for c in calls) / 1e3, \
        by_name


def bound_ms(n_bytes: float, flops: float, dtype: torch.dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# ----------------------------------------------------------------- kernels
def check_rmsnorm(dtype, rows, D, gen, dev):
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as K
    x = torch.randn((rows, D), generator=gen, device=dev).to(dtype)
    scale = (1 + 0.1 * torch.randn((D,), generator=gen, device=dev))
    out = K.rmsnorm(x, scale)
    ref = K.rmsnorm_plain(x, scale)
    err = max_err(out, ref)
    item = x.element_size()
    scale_lib = scale.to(dtype)
    kernel = lambda: K.rmsnorm(x, scale)                       # noqa: E731
    library = lambda: F.rms_norm(x, (D,), scale_lib, 1e-5)     # noqa: E731
    return dict(err=err, ms=median_ms(kernel),
                plain_ms=median_ms(lambda: K.rmsnorm_plain(x, scale)),
                library_ms=median_ms(library),
                device=(device_ms(kernel)[0], device_ms(library)[0]),
                bound=bound_ms(2 * rows * D * item + 4 * D, 4 * rows * D,
                               dtype),
                shape=f"({rows}, {D})")


def check_flash(dtype, gen, dev):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as K
    B, S, H, KV, D = 1, 512, 12, 4, 64
    q = torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, KV, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, KV, D), generator=gen, device=dev).to(dtype)
    out = K.attention(q, k, v, causal=True)
    ref = K.attention_plain(q, k, v, causal=True)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    err = max_err(out, ref)
    item = q.element_size()
    pairs = S * (S + 1) // 2
    return dict(err=err,
                ms=median_ms(lambda: K.attention(q, k, v, causal=True)),
                plain_ms=median_ms(
                    lambda: K.attention_plain(q, k, v, causal=True)),
                library_ms=median_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)),
                bound=bound_ms((2 * B * S * H * D + 2 * B * S * KV * D)
                               * item, 4 * B * H * D * pairs, dtype),
                shape=f"B={B} Sq=Sk={S} H={H} KV={KV} D={D} causal")


def paged_case(kind, dtype, gen, dev):
    """Main-path paged shapes: ``decode`` S=8, W=1, mixed positions, one
    idle slot; ``decode_full`` all 8 slots live at 900-1023 positions
    (where splitting positions over blocks pays most); ``suffix`` S=1,
    W=16 over 16 shared prefix pages; ``suffix256`` S=1, W=256 (a long
    page-padded tail, 250 rows valid) over the same 16 prefix pages."""
    ps, T, KV, G, hd = 16, 64, 4, 3, 64
    H = KV * G
    P = 512
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(7))
    if kind in ("decode", "decode_full"):
        S, W = 8, 1
        if kind == "decode":
            positions = [17, 100, 255, 300, 511, 640, 1000, 0]
            n_valid = [1, 1, 1, 1, 1, 1, 1, 0]
        else:
            positions = [900, 917, 934, 951, 968, 985, 1002, 1023]
            n_valid = [1] * S
        tables = np.full((S, T), P, np.int32)
        nxt = 0
        for s in range(S):
            need = -(-(positions[s] + W) // ps) if n_valid[s] else 0
            tables[s, :need] = perm[nxt:nxt + need].numpy()
            nxt += need
    else:
        S, W, nv = (1, 16, 13) if kind == "suffix" else (1, 256, 250)
        positions, n_valid = [256], [nv]
        tables = np.full((S, T), P, np.int32)
        need = -(-(256 + W) // ps)       # 16 shared pages + the tail's
        tables[0, :need] = perm[:need].numpy()
    q = torch.randn((S, W, H, hd), generator=gen, device=dev).to(dtype)
    kn = torch.randn((S, W, KV, hd), generator=gen, device=dev).to(dtype)
    vn = torch.randn((S, W, KV, hd), generator=gen, device=dev).to(dtype)
    kp = torch.randn((P + 1, ps, KV, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P + 1, ps, KV, hd), generator=gen, device=dev).to(dtype)
    i32 = dict(dtype=torch.int32, device=dev)
    args = (q, kn, vn, kp, vp, torch.as_tensor(tables, **i32),
            torch.as_tensor(positions, **i32), torch.as_tensor(n_valid, **i32))
    # bytes this call needs: q, new rows, out, the cached rows each live
    # slot reads (positions before its window), the rows it writes
    item = q.element_size()
    read_rows = sum(p for p, n in zip(positions, n_valid) if n)
    written = sum(n_valid)
    visible = sum(p + min(j, n - 1) + 1 for p, n in zip(positions, n_valid)
                  if n for j in range(W))
    n_bytes = (2 * q.numel() + kn.numel() + vn.numel()) * item \
        + 2 * (read_rows + written) * KV * hd * item
    flops = 4 * KV * G * hd * visible
    shape = (f"S={S} W={W} ps={ps} T={T} KV={KV} G={G} hd={hd} "
             f"positions={positions} n_valid={n_valid}")
    return args, tables, P, (n_bytes, flops), shape


def check_paged(kind, dtype, gen, dev):
    from repro_torch.kernels import paged_attention as K
    args, tables, null, (n_bytes, flops), shape = paged_case(kind, dtype,
                                                             gen, dev)
    q, kn, vn, kp, vp, tab, pos, nv = args
    kp_k, vp_k = kp.clone(), vp.clone()
    kp_p, vp_p = kp.clone(), vp.clone()
    out, _, _ = K.paged_attention(q, kn, vn, kp_k, vp_k, tab, pos, nv,
                                  page_size=16)
    ref, _, _ = K.paged_attention_plain(q, kn, vn, kp_p, vp_p, tab, pos, nv,
                                        page_size=16)
    err = max_err(out, ref)
    # pools bit-exact on every real page (the null page is excluded by
    # contract); pages nobody wrote must be untouched
    pools_exact = bool(torch.equal(kp_k[:null], kp_p[:null])
                       and torch.equal(vp_k[:null], vp_p[:null]))
    untouched = torch.ones(null, dtype=torch.bool)
    for s in range(tables.shape[0]):
        for j in range(int(nv[s])):
            untouched[tables[s, (int(pos[s]) + j) // 16]] = False
    untouched = untouched.to(kp.device)
    pools_exact &= bool(torch.equal(kp_k[:null][untouched],
                                    kp[:null][untouched]))
    if int(nv.min()) == 0:
        idle = int(torch.nonzero(nv == 0)[0, 0])
        if bool(out[idle].abs().max() != 0):
            raise AssertionError("paged_attention: idle slot output not 0")
    return dict(err=err, pools_exact=pools_exact,
                ms=median_ms(lambda: K.paged_attention(
                    q, kn, vn, kp_k, vp_k, tab, pos, nv, page_size=16)),
                plain_ms=median_ms(lambda: K.paged_attention_plain(
                    q, kn, vn, kp_p, vp_p, tab, pos, nv, page_size=16)),
                library_ms=None, bound=bound_ms(n_bytes, flops, dtype),
                shape=shape)


def busy_ms(fn, runs: int = 5):
    """The card's busy time for one call of ``fn``: the sum of the device
    times of the kernels it ran, under ``torch.profiler``, over ``runs``
    calls, and its split by kernel family (shares). For calls that launch
    more kernels than the launch queue holds, where events around the call
    (``median_ms``) measure the host's pace past the queue's depth."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    by_family: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            fam = kernel_family(e.name)
            by_family[fam] = by_family.get(fam, 0.0) \
                + e.time_range.elapsed_us()
    us = sum(by_family.values())
    if us <= 0:
        raise AssertionError("busy_ms: the profiler saw no device time")
    return us / runs / 1e3, {f: t / us for f, t in sorted(
        by_family.items(), key=lambda kv: -kv[1])}


def ssd_inputs(gen, dev, B, T, dtype, H=32, P=64, G=1, N=128):
    """mamba2-370m's SSD shapes with inputs distributed like the model's:
    dt ~ softplus(N(-3, 0.5)), A = -linspace(1, 16) (the init's A_log),
    |y| below 4 so one bf16 rounding step stays within the tolerance; D
    differs per head, so a kernel reading another head's D disagrees."""
    import torch.nn.functional as F
    x = (0.5 * torch.randn((B, T, H, P), generator=gen, device=dev)
         ).to(dtype)
    dt = F.softplus(0.5 * torch.randn((B, T, H), generator=gen, device=dev)
                    - 3)
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    Bm = (torch.randn((B, T, G, N), generator=gen, device=dev)
          * N ** -0.25).to(dtype)
    Cm = (torch.randn((B, T, G, N), generator=gen, device=dev)
          * N ** -0.25).to(dtype)
    D = 1 + 0.1 * torch.randn((H,), generator=gen, device=dev)
    return x, dt, A, Bm, Cm, D


def check_ssd(dtype, B, T, gen, dev):
    from repro_torch.kernels import ssd_scan as K
    args = ssd_inputs(gen, dev, B, T, dtype)
    x, dt, _, Bm, _, _ = args
    H, P, N, Q = x.shape[2], x.shape[3], Bm.shape[3], K.CHUNK
    y, final = K.ssd_scan(*args, return_state=True)
    y_ref, final_ref = K.ssd_scan_plain(*args, return_state=True)
    err_y, err_state = max_err(y, y_ref), max_err(final, final_ref)
    item = x.element_size()
    # x, B, C, dt (and A, D) read once; y and the fp32 state written once
    n_bytes = (2 * x.numel() + 2 * Bm.numel()) * item + 4 * dt.numel() \
        + 8 * H + 4 * final.numel()
    # per (batch, head) and chunk of q real rows: C.B^T and scores.x over
    # the q x q products, the inter-chunk term and the state update
    rows = [min(Q, T - t0) for t0 in range(0, T, Q)]
    flops = B * H * sum(2 * q * q * N + 2 * q * q * P + 4 * q * P * N
                        for q in rows)
    kernel = lambda: K.ssd_scan(*args, return_state=True)      # noqa: E731
    return dict(err=max(err_y, err_state), err_y=err_y, err_state=err_state,
                ms=median_ms(kernel), grids=device_ms(kernel)[1],
                plain_ms=median_ms(lambda: K.ssd_scan_plain(
                    *args, return_state=True)),
                library_ms=None, bound=bound_ms(n_bytes, flops, dtype),
                shape=f"B={B} T={T} H={H} P={P} G=1 N={N} (y, final state)")


def phase_kernels(dev, label):
    from repro_torch.kernels import (flash_attention, paged_attention,
                                     rmsnorm, ssd_scan)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("phase 3: kernels vs plain versions; fp32 with TF32 off "
        f"(matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}), "
        f"times on {label}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        # rmsnorm at paper_demo's width (768) and mamba2's (1024)
        cases = [("rmsnorm", check_rmsnorm(dtype, 8, 768, gen, dev)),
                 ("rmsnorm", check_rmsnorm(dtype, 512, 768, gen, dev)),
                 ("rmsnorm", check_rmsnorm(dtype, 8, 1024, gen, dev)),
                 ("rmsnorm", check_rmsnorm(dtype, 512, 1024, gen, dev)),
                 ("flash_attention", check_flash(dtype, gen, dev)),
                 ("paged_attention", check_paged("decode", dtype, gen, dev)),
                 ("paged_attention", check_paged("suffix", dtype, gen, dev)),
                 ("paged_attention", check_paged("decode_full", dtype, gen,
                                                 dev)),
                 ("paged_attention", check_paged("suffix256", dtype, gen,
                                                 dev)),
                 ("ssd_scan", check_ssd(dtype, 1, 512, gen, dev)),
                 ("ssd_scan", check_ssd(dtype, 1, 509, gen, dev)),
                 ("ssd_scan", check_ssd(dtype, 4, 256, gen, dev)),
                 ("ssd_scan", check_ssd(dtype, 1, 64, gen, dev)),
                 ("ssd_scan", check_ssd(dtype, 1, 2048, gen, dev))]
        for name, r in cases:
            tol = TOL[dtype]
            ok = r.get("err_y", r["err"]) <= tol \
                and r.get("err_state", 0.0) <= STATE_TOL \
                and r.get("pools_exact", True)
            lib = r["library_ms"]
            log(f"  {name:16s} {str(dtype):15s} {r['shape']}: max_abs_err "
                + (f"y {r['err_y']:.3g} (tol {tol:g}), final state "
                   f"{r['err_state']:.3g} (tol {STATE_TOL:g})"
                   if "err_y" in r else f"{r['err']:.3g} (tol {tol:g})")
                + (f" pools_exact={r['pools_exact']}"
                   if "pools_exact" in r else "")
                + f" | kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
                + (f", library {lib:.4f} ms (kernel/library "
                   f"{r['ms'] / lib:.2f}x)" if lib is not None else "")
                + f", bound {r['bound'][0]:.5f} ms ({r['bound'][1]})"
                + (" | device time (torch.profiler, median of "
                   f"{TIMED_RUNS}): kernel {r['device'][0]:.4f} ms, library "
                   f"{r['device'][1]:.4f} ms (kernel/library "
                   f"{r['device'][0] / r['device'][1]:.2f}x)"
                   if "device" in r else "")
                + (" | device time by grid: " + ", ".join(
                    f"{re.search(r'ssd_\w+', n).group(0)} {t:.4f} ms"
                    for n, t in r["grids"].items()) if "grids" in r else ""))
            if not ok:
                raise AssertionError(f"{name} {dtype} disagrees with its "
                                     f"plain version: {r}")
            # the JSON line reports the bf16 run at the decode-step shape
            # (rmsnorm rows 8 at width 768, paged W=1) and the prefill
            # shape for flash and the SSD scan (one 512-token prompt)
            if dtype is torch.bfloat16 and name not in summary:
                summary[name] = r
    log("kernels: " + json.dumps({
        "rmsnorm": rmsnorm.LAUNCHES, "flash_attention":
        flash_attention.LAUNCHES, "paged_attention":
        paged_attention.LAUNCHES, "ssd_scan": ssd_scan.LAUNCHES}))
    return summary


# ------------------------------------------------------------------ serving
def ttft_ms(reqs) -> str:
    """TTFT p50 and p99 of finished requests, for the log."""
    t = sorted(r.ttft for r in reqs)
    p99 = t[min(len(t) - 1, round(0.99 * (len(t) - 1)))]
    return f"p50 {t[len(t) // 2] * 1e3:.1f} ms p99 {p99 * 1e3:.1f} ms"


def near_tie_prefix(cfg, params, prompt, tokens, margin=1e-3) -> int:
    """Leading generated positions whose top-2 logit margin (teacher-forced
    over the oracle's own sequence) is at least ``margin``: past the first
    near tie, two correct implementations may diverge."""
    from repro_torch.models import lm
    seq = np.concatenate([np.asarray(prompt), np.asarray(tokens)])
    dev = params["embed"]["tokens"].device
    logits = lm.lm_forward(params, {"tokens": torch.as_tensor(
        seq[None], dtype=torch.int32, device=dev)}, cfg)[0].float()
    steps = logits[len(prompt) - 1:len(prompt) - 1 + len(tokens)]
    top2 = torch.topk(steps, 2, dim=-1).values
    small = ((top2[:, 0] - top2[:, 1]) < margin).nonzero()
    return len(tokens) if len(small) == 0 else int(small[0, 0])


def phase_identity(dev):
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import Request, ServeEngine, greedy_generate
    cfg = get_config("paper_demo", dtype=torch.float32,
                     param_dtype=torch.float32)
    params = lm.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, 64)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (64, 137)] + [
        np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)])
        for n in (71, 136)]
    eng = ServeEngine(cfg, params, device=dev, max_batch=4, page_size=16,
                      max_seq_len=256)
    reqs = [Request(p, 16) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    eng.run(timeout=300)
    m = eng.metrics()
    checked = 0
    for p, r in zip(prompts, reqs):
        want = greedy_generate(cfg, params, p[None], 16, 256,
                               device=dev)[0].tolist()
        n = near_tie_prefix(cfg, params, p, want)
        if r.tokens[:n] != want[:n]:
            raise AssertionError(f"fp32 identity: engine {r.tokens} != "
                                 f"greedy {want} within {n} tokens")
        checked += n
    if m["prefix_hits"] < 1 or m["pages_in_use"] != 0:
        raise AssertionError(f"fp32 identity run: {dict(m)}")
    log(f"phase 4: fp32 identity OK: 4 requests, {checked}/64 tokens "
        f"compared (the rest past a near tie), prefix_hits "
        f"{m['prefix_hits']}")
    eng.shutdown()


def serve_workload(cfg, rng):
    prefix = rng.integers(0, cfg.vocab_size, 256)
    reqs = []
    for i in range(24):
        if i % 3 == 0:     # 8 of 24 share a 256-token prefix
            tail = rng.integers(0, cfg.vocab_size, rng.integers(8, 257))
            prompt = np.concatenate([prefix, tail])
        else:
            prompt = rng.integers(0, cfg.vocab_size, rng.integers(64, 513))
        reqs.append((prompt, int(rng.integers(32, 129))))
    return reqs


def decode_step_device_ms(eng) -> float:
    """Device time of one fused decode step with all 8 slots live at
    mixed positions (sleep-kernel bracketing keeps host gaps out)."""
    S = eng.max_batch
    pos = torch.as_tensor([64 + 100 * i for i in range(S)], dtype=torch.int32,
                          device=eng.device)
    nv = torch.ones(S, dtype=torch.int32, device=eng.device)
    pages = torch.randperm(eng.pool.total_pages)[:S * eng.max_pages]
    tables = pages.view(S, eng.max_pages).to(torch.int32).to(eng.device)
    toks = torch.zeros((S, 1, 1), dtype=torch.int32, device=eng.device)
    return median_ms(lambda: eng._decode_fn(eng.params, eng.pool.arrays,
                                            toks, pos, tables, nv), runs=20)


def sync_detector_works(dev) -> bool:
    """Self-test of the no-wait check: under sync debug mode "error" a
    synchronising call (here ``.item()``) must raise."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.ones(1, device=dev).item()
    except RuntimeError:
        return True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return False


def phase_serve(dev, label):
    from repro_torch.configs import get_config
    from repro_torch.core import TensorOp
    from repro_torch.kernels import flash_attention, paged_attention, rmsnorm
    from repro_torch.models import lm
    from repro_torch.serve import Request, RequestState
    cfg = get_config("paper_demo")
    params = lm.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(2)
    work = serve_workload(cfg, rng)
    eng = serve_engine(cfg, params, dev)
    # warm up cuBLAS / the allocator on two requests, outside the count
    for prompt, n in work[:2]:
        eng.submit(Request(prompt, 4))
    eng.run(until=lambda: len(eng.retired) == 2, timeout=300)
    warm_retired = len(eng.retired)
    steps0, slot_steps0 = eng.stats["steps"], eng.stats["slot_steps"]
    dispatch0 = eng.stats["dispatch_s"]
    hits0 = eng.pool.stats["prefix_hits"]

    rmsnorm.LAUNCHES = flash_attention.LAUNCHES = 0
    paged_attention.LAUNCHES = 0
    TensorOp.PENDING_AT_FIRST_POLL = 0
    reqs = [Request(p, n) for p, n in work]
    if not sync_detector_works(dev):
        raise AssertionError("torch.cuda sync debug mode does not flag a "
                             ".item(): the no-wait check would be blind")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    # any call that makes the host wait for the card (.item(), .cpu(), a
    # blocking copy, a stream sync) raises while the loop runs
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.run(timeout=600)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rmsnorm": rmsnorm.LAUNCHES,
                "flash_attention": flash_attention.LAUNCHES,
                "paged_attention": paged_attention.LAUNCHES}
    pending = TensorOp.PENDING_AT_FIRST_POLL
    m = eng.metrics()
    hits = m["prefix_hits"] - hits0
    n_tokens = sum(len(r.tokens) for r in reqs)
    steps = eng.stats["steps"] - steps0
    slot_steps = eng.stats["slot_steps"] - slot_steps0
    dev_ms = decode_step_device_ms(eng)
    host_ms = (eng.stats["dispatch_s"] - dispatch0) / max(steps, 1) * 1e3
    log(f"phase 5: bf16 serve on {label}: 24 requests, {n_tokens} tokens "
        f"in {wall:.3f} s = {n_tokens / wall:.1f} tokens/s; TTFT "
        f"{ttft_ms(reqs)} (all submitted at t=0); {steps} decode steps, "
        f"{wall / max(steps, 1) * 1e3:.3f} ms/step wall incl. prefills, "
        f"{slot_steps / max(steps, 1):.2f} slots/step; host enqueue of a "
        f"decode step {host_ms:.3f} ms (mean); "
        f"one 8-slot decode step on the device alone {dev_ms:.3f} ms; "
        f"prefix_hits "
        f"{hits}, suffix_steps {eng.stats['suffix_steps']}, "
        f"PENDING_AT_FIRST_POLL {pending}")
    log(f"main path kernels: {json.dumps(launches)}")
    if not all(r.req_state is RequestState.FINISHED for r in reqs):
        raise AssertionError("bf16 serve: not every request finished: "
                             + str([r.req_state.value for r in reqs]))
    if len(eng.retired) - warm_retired != len(reqs):
        raise AssertionError("bf16 serve: retired count mismatch")
    if any(len(r.tokens) != n for r, (_, n) in zip(reqs, work)):
        raise AssertionError("bf16 serve: token budgets not met")
    if m["pages_in_use"] != 0 or hits <= 0:
        raise AssertionError(f"bf16 serve: pages_in_use "
                             f"{m['pages_in_use']} prefix_hits {hits}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"bf16 serve: a kernel never launched on the "
                             f"main path: {launches}")
    vocab_ok = all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens)
    if not vocab_ok:
        raise AssertionError("bf16 serve: token outside the vocabulary")
    eng.shutdown()
    return cfg, params, launches, host_ms


def serve_engine(cfg, params, dev):
    from repro_torch.serve import ServeEngine
    return ServeEngine(cfg, params, device=dev, max_batch=8, page_size=16,
                       max_seq_len=1024, max_inflight=2)


def sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    n = 20_000_000
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(n)
    end.record()
    torch.cuda.synchronize()
    return n / start.elapsed_time(end)


def phase_card_bound(cfg, params, dev, host_ms, label, make_engine=None,
                     phase="5b", sleep_after=False):
    """The loop must run ahead of the card when the card is the slower
    side. A sleep kernel queued with every decode step holds the card for
    several times the host's enqueue of a step; then every step but a
    host hiccup's worth must still be running at its op's first poll.

    The sleep goes ahead of the step's kernels, or with ``sleep_after``
    behind them (before the step's token copy and event): a step that
    launches more kernels than the card's launch queue holds (mamba2's
    ~2,600) would otherwise stall the host's enqueue behind the sleep
    until the card had nearly caught up."""
    from repro_torch.core import TensorOp
    from repro_torch.serve import Request, RequestState
    eng = (make_engine or serve_engine)(cfg, params, dev)
    sleep_ms = max(50.0, 4 * host_ms)
    cycles = int(sleep_ms * sleep_cycles_per_ms())
    decode = eng._decode_fn

    def held_step(*args):
        if not sleep_after:
            torch.cuda._sleep(cycles)
        out = decode(*args)
        if sleep_after:
            torch.cuda._sleep(cycles)
        return out

    eng._decode_fn = held_step
    rng = np.random.default_rng(3)
    reqs = [Request(rng.integers(0, cfg.vocab_size, 64), 12)
            for _ in range(eng.max_batch)]
    TensorOp.PENDING_AT_FIRST_POLL = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.run(timeout=300)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pending = TensorOp.PENDING_AT_FIRST_POLL
    steps = eng.stats["steps"]
    step_host_ms = eng.stats["dispatch_s"] / max(steps, 1) * 1e3
    m = eng.metrics()
    eng.shutdown()
    log(f"phase {phase}: card-bound loop on {label}: {sleep_ms:.1f} ms of "
        f"sleep queued {'behind' if sleep_after else 'ahead of'} each decode "
        f"step's kernels, host enqueue {step_host_ms:.3f} "
        f"ms a step (mean) against {host_ms:.3f} ms with no sleep: the "
        f"host waited {step_host_ms - host_ms:.3f} ms a step on the launch "
        f"queue; {steps} decode steps in {wall * 1e3:.1f} ms "
        f"wall; PENDING_AT_FIRST_POLL {pending} of {steps} steps")
    if not all(r.req_state is RequestState.FINISHED for r in reqs) \
            or m.get("pages_in_use", 0) != 0:
        raise AssertionError(f"card-bound serve did not complete: {dict(m)}")
    if wall * 1e3 < 0.9 * steps * sleep_ms:
        raise AssertionError("card-bound serve: the card was not the slower "
                             "side (the sleep kernels did not hold it)")
    if pending <= 0 or pending < 0.9 * steps:
        raise AssertionError(
            f"card-bound serve: only {pending} of {steps} decode steps were "
            "still running at their first poll: the host waited on the card")


FAMILIES = [("paged_attention", ("paged_attn",)),
            ("flash_attention", ("flash_fwd",)),
            ("ssd_scan", ("ssd_",)),
            ("depthwise conv", ("depthwise", "cudnn", "fprop", "conv1d",
                                "conv2d")),
            ("rmsnorm", ("rmsnorm_kernel",)),
            ("gemm", ("gemm", "nvjet", "cutlass", "sm90_xmma")),
            ("reductions (argmax, sum, mean)", ("reduce_kernel",)),
            ("copies", ("memcpy", "memset", "Memcpy", "Memset"))]


def kernel_family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "elementwise and other"


def phase_profile(cfg, params, dev, label, window_steps: int = 40,
                  make_engine=None, work=None, seated: int = 16,
                  phase="6"):
    """The bf16 workload again, ``torch.profiler`` over ``window_steps``
    decode steps once most requests are seated: the card's busy share of
    the window and its busy time by kernel family."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Request
    eng = (make_engine or serve_engine)(cfg, params, dev)
    if work is None:
        work = serve_workload(cfg, np.random.default_rng(2))
    for prompt, n in work:
        eng.submit(Request(prompt, n))
    eng.close_intake()
    eng.run(until=lambda: eng.stats["prefills"] >= seated, timeout=300)
    steps0 = eng.stats["steps"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(until=lambda: eng.stats["steps"] >= steps0 + window_steps,
                timeout=300)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    steps = eng.stats["steps"] - steps0
    eng.run(timeout=600)
    eng.shutdown()
    by_family: dict = {}
    by_name: dict = {}
    ops = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = evt.time_range.elapsed_us()
            fam = kernel_family(evt.name)
            by_family[fam] = by_family.get(fam, 0.0) + us
            by_name[evt.name] = by_name.get(evt.name, 0.0) + us
            ops += 1
    busy_us = sum(by_family.values())
    if busy_us <= 0:
        raise AssertionError("profile: no device time in the traced window")
    log(f"phase {phase}: profiled window on {label}: {steps} decode steps in "
        f"{window * 1e3:.1f} ms wall ({window / steps * 1e3:.3f} ms/step, "
        f"profiler on); card busy {busy_us / 1e3:.1f} ms = "
        f"{busy_us / 1e6 / window:.1%} of the window; "
        f"{ops / steps:.0f} device ops per step")
    for fam, us in sorted(by_family.items(), key=lambda kv: -kv[1]):
        log(f"  {fam:30s} {us / 1e3:8.3f} ms  {us / busy_us:6.1%} of the "
            "card's busy time")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {us / busy_us:6.1%}  {name[:90]}")


# ------------------------------------------------------------ mamba2 (SSM)
MAMBA_LAYERS = 48


def phase_mamba_identity(dev):
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import Request, ServeEngine, greedy_generate
    cfg = get_config("mamba2_370m", dtype=torch.float32,
                     param_dtype=torch.float32)
    params = lm.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(4)
    # 131 and 509 are prime: the kernel's masked tail chunk runs
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (64, 131, 200,
                                                             509)]
    eng = ServeEngine(cfg, params, device=dev, max_batch=4)
    if eng.paged:
        raise AssertionError("mamba2 must be served in dense mode")
    reqs = [Request(p, 16) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    eng.run(timeout=300)
    eng.shutdown()
    checked = 0
    for p, r in zip(prompts, reqs):
        want = greedy_generate(cfg, params, p[None], 16, 1024,
                               device=dev)[0].tolist()
        n = near_tie_prefix(cfg, params, p, want)
        if r.tokens[:n] != want[:n]:
            raise AssertionError(f"mamba2 fp32 identity: engine {r.tokens} "
                                 f"!= greedy {want} within {n} tokens")
        checked += n
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 512)),
                           dtype=torch.int32, device=dev)
    full = lm.lm_forward(params, {"tokens": toks}, cfg)[:, -1]
    last, _ = lm.lm_prefill(params, {"tokens": toks}, cfg,
                            lm.init_cache(cfg, 1, 512, device=dev))
    err = max_err(full, last[:, -1])
    log(f"phase 7: mamba2 fp32 identity OK: engine in dense mode, 4 "
        f"requests (prompts 64, 131, 200, 509), {checked}/64 tokens equal "
        f"to greedy_generate (the rest past a near tie); lm_forward vs "
        f"lm_prefill last-row logits on 512 tokens: max_abs_err {err:.3g} "
        "(tol 1e-3)")
    if err > 1e-3:
        raise AssertionError("mamba2: lm_forward and lm_prefill disagree")


def mamba_workload(cfg, rng):
    """16 requests, 64–512 prompt tokens (the first two of prime length,
    67 and 509), 32–64 new tokens each."""
    lengths = [67, 509] + [int(n) for n in rng.integers(64, 513, 14)]
    return [(rng.integers(0, cfg.vocab_size, n), int(rng.integers(32, 65)))
            for n in lengths]


def mamba_engine(cfg, params, dev):
    from repro_torch.serve import ServeEngine
    return ServeEngine(cfg, params, device=dev, max_batch=8, max_inflight=2)


def phase_mamba_serve(dev, label):
    from repro_torch.configs import get_config
    from repro_torch.core import TensorOp
    from repro_torch.kernels import (flash_attention, paged_attention,
                                     rmsnorm, ssd_scan)
    from repro_torch.models import lm
    from repro_torch.serve import Request, RequestState
    cfg = get_config("mamba2_370m")
    if cfg.n_layers != MAMBA_LAYERS:
        raise AssertionError("mamba2_370m is not at full depth")
    params = lm.init_params(cfg, seed=0, device=dev)
    work = mamba_workload(cfg, np.random.default_rng(5))
    eng = mamba_engine(cfg, params, dev)
    for prompt, n in work[:2]:        # warm-up, outside the counts
        eng.submit(Request(prompt, 4))
    eng.run(until=lambda: len(eng.retired) == 2, timeout=300)
    steps0, prefills0 = eng.stats["steps"], eng.stats["prefills"]
    slot_steps0, dispatch0 = eng.stats["slot_steps"], eng.stats["dispatch_s"]

    rmsnorm.LAUNCHES = ssd_scan.LAUNCHES = 0
    flash_attention.LAUNCHES = paged_attention.LAUNCHES = 0
    TensorOp.PENDING_AT_FIRST_POLL = 0
    reqs = [Request(p, n) for p, n in work]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.run(timeout=600)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ssd_scan": ssd_scan.LAUNCHES, "rmsnorm": rmsnorm.LAUNCHES,
                "flash_attention": flash_attention.LAUNCHES,
                "paged_attention": paged_attention.LAUNCHES}
    pending = TensorOp.PENDING_AT_FIRST_POLL
    steps = eng.stats["steps"] - steps0
    prefills = eng.stats["prefills"] - prefills0
    slot_steps = eng.stats["slot_steps"] - slot_steps0
    host_ms = (eng.stats["dispatch_s"] - dispatch0) / max(steps, 1) * 1e3
    n_tokens = sum(len(r.tokens) for r in reqs)
    S = eng.max_batch
    toks = torch.zeros((S, 1, 1), dtype=torch.int32, device=dev)
    prompt = torch.as_tensor(np.resize(work[1][0], 512)[None],
                             dtype=torch.int32, device=dev)

    def decode():
        eng._decode_fn(eng.params, eng._cache, toks, None)

    slot0 = {name: t[:, :1] for name, t in eng._cache.items()}

    def prefill():
        lm.lm_prefill(eng.params, {"tokens": prompt}, cfg, slot0)

    # events around a call of ~2,600 (decode) or ~1,500 (prefill)
    # launches time the host past the launch queue's depth; the profiler's
    # kernel times give the card's own share
    step_ev, prefill_ev = median_ms(decode, runs=10), median_ms(prefill,
                                                                runs=10)
    (step_ms, step_split), (prefill_ms, prefill_split) = busy_ms(decode), \
        busy_ms(prefill)
    log(f"phase 8: mamba2 bf16 serve on {label}: dense mode, 16 requests, "
        f"{n_tokens} tokens in {wall:.3f} s = {n_tokens / wall:.1f} "
        f"tokens/s; TTFT {ttft_ms(reqs)} (all submitted at t=0); {steps} "
        f"decode steps, "
        f"{wall / max(steps, 1) * 1e3:.3f} ms/step wall incl. prefills, "
        f"{slot_steps / max(steps, 1):.2f} slots/step, {prefills} prefills; "
        f"host enqueue of a decode step {host_ms:.3f} ms (mean); card busy "
        f"(kernel times, torch.profiler) for one 8-slot decode step "
        f"{step_ms:.3f} ms, one 512-token prefill {prefill_ms:.3f} ms "
        f"(event-timed with a sleep ahead: {step_ev:.3f} ms, "
        f"{prefill_ev:.3f} ms); PENDING_AT_FIRST_POLL {pending}")
    for what, split in (("decode step", step_split),
                        ("512-token prefill", prefill_split)):
        log(f"  card busy of one {what} by kernel family: " + ", ".join(
            f"{fam} {share:.1%}" for fam, share in split.items()))
    log(f"mamba2 path kernels: {json.dumps(launches)}")
    if not all(r.req_state is RequestState.FINISHED for r in reqs):
        raise AssertionError("mamba2 serve: not every request finished")
    if any(len(r.tokens) != n for r, (_, n) in zip(reqs, work)):
        raise AssertionError("mamba2 serve: token budgets not met")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens):
        raise AssertionError("mamba2 serve: token outside the vocabulary")
    if prefills != len(reqs) or \
            launches["ssd_scan"] != MAMBA_LAYERS * prefills:
        raise AssertionError(f"mamba2 serve: {launches['ssd_scan']} SSD "
                             f"launches for {prefills} prefills")
    if launches["rmsnorm"] != (MAMBA_LAYERS + 1) * (prefills + steps):
        raise AssertionError(f"mamba2 serve: {launches['rmsnorm']} rmsnorm "
                             f"launches for {prefills} prefills and {steps} "
                             "decode steps")
    if launches["flash_attention"] or launches["paged_attention"]:
        raise AssertionError("mamba2 serve ran an attention kernel")
    eng.shutdown()
    return cfg, params, launches, host_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    label = card_label()
    log(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; card: {label}")
    from repro_torch.kernels import _build
    _build.lib()
    log(f"phase 2: kernels built in {_build.BUILD_SECONDS:.1f} s "
        f"({_build.BUILD_ROOT / _build.digest()})")
    for line in _build.build_log().splitlines():
        if "Used" in line or "spill stores" in line:
            log("  ptxas: " + line.strip())
    dev = torch.device("cuda", 0)
    summary = phase_kernels(dev, label)
    phase_identity(dev)
    cfg, params, launches, host_ms = phase_serve(dev, label)
    phase_card_bound(cfg, params, dev, host_ms, label)
    phase_profile(cfg, params, dev, label)
    del params
    phase_mamba_identity(dev)
    mcfg, mparams, mlaunches, mhost_ms = phase_mamba_serve(dev, label)
    launches["ssd_scan"] = mlaunches["ssd_scan"]
    phase_card_bound(mcfg, mparams, dev, mhost_ms, label,
                     make_engine=mamba_engine, phase="8b", sleep_after=True)
    phase_profile(mcfg, mparams, dev, label, window_steps=12,
                  make_engine=mamba_engine,
                  work=mamba_workload(mcfg, np.random.default_rng(5)),
                  seated=8, phase="9")
    kernels = []
    for name, r in summary.items():
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    log(label)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
