"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. environment — torch / CUDA runtime, driver and nvcc versions, the
   card's name and power limit; no CUDA means exit 1 with no result;
2. build — compile the kernels of ``src/repro_torch/csrc`` with nvcc;
3. kernels — each kernel against its plain PyTorch version on the card at
   the main path's shapes, in fp32 (TF32 off) and bf16, with its median
   time over CUDA-event-timed runs beside its bound and, where one PyTorch
   call computes the same function, that call's time and the ratio of the
   two; rmsnorm and ``F.rms_norm`` also by their ``torch.profiler``
   device time (median of 50 calls); paged attention at decode (one idle
   slot, and all 8 slots at 900-1023 positions) and at suffix windows of
   16 and 256 rows; the SSD scan at B=1 and T = 512, 509, 64, 2048 and at
   B=4, T=256, with the device time of each of its three grids; then at
   the other dense configs' shapes (phases 15-17): rmsnorm at 8 rows of
   3840, 7168, 16384 and 12288; flash at head_dim 120 with a 4096 window
   at Sq 6144 (SDPA with the window as a boolean mask), and at head_dim
   128 over 8 KV heads with 32, 64, 96 and 128 q-heads (32 at Sq 512 and
   4096, the others at 512 and 768); paged at head_dim 128 with 8 KV
   heads and 8, 16 or 12 q-heads each (decode and a W=16 suffix); and at
   the MoE and hybrid configs' shapes (phases 18-20): rmsnorm at 8 rows
   of 4096, 5120, 2048 and 4096 (zamba2's shared block), flash at head_dim
   128 with 64 q-heads over 4 KV heads and 48 over 8 (Sq 512 and 768) and
   32 over 32 (Sq 512 and 2048), paged with 16 q-heads over 4 and 6 over
   8 (decode and a W=16 suffix), the SSD scan at (head_dim, state) =
   (64, 64) with 64 heads at T = 512, 64 and 2048; and at the enc-dec's
   and the VLM's (phases 21-22): rmsnorm at 8 and 12,000 rows of 1280
   and 8 of 6144, flash non-causal at head_dim 64 over 32/32 heads with
   Sq = Sk = 1500 (whisper's encoder) and with one row a clip against
   1500 keys at B = 8 (its cross-attention at a decode step), flash
   causal at head_dim 128 over 48/8 heads at Sq 1536 (internvl2's
   prefill of 1024 patches and 512 tokens); and the dense decode's route
   (the paged kernel on a dense cache viewed as pages in place) against
   the grouped einsums it replaced and SDPA at zamba2's (8 slots of 4096
   positions, and the zamba2-longctx cell's 32), whisper's, internvl2's
   and the unfused paged path's decode steps;
3g. graph edges — a paged decode call and an SSD scan captured into a
   CUDA graph: how many of its edges kept programmatic dependent launch,
   and its replay bit-equal to the eager calls;
4. fp32 identity — ``paper_demo`` at full width in fp32 served by the
   engine (paged kernel, decode step replayed as a CUDA graph) must emit
   the tokens of the port's ``greedy_generate`` oracle (dense decode,
   eager) up to the first near tie; then the same with
   ``speculate=4`` on repetitive prompts (the verify step's graph; drafts
   must be accepted), and a ``ServeClient`` whose loop thread replays the
   graphs captured on this thread must stream the engine's tokens;
5. bf16 serve — 24 requests at full width in bf16 through
   ``ServeEngine.submit``/``run``, 8 of them sharing a 256-token prefix;
   every request must finish, the pool must drain, the prefix cache must
   hit and each kernel must have launched as often as the steps say
   (graph replays counted). The loop runs under ``torch.cuda`` sync debug
   mode "error" (``.item()``, a blocking copy or a stream sync raises).
   The host's enqueue of a decode step is printed three ways on this
   host: the engine's dispatch (graph replay plus uploads and
   bookkeeping), the replay alone, and the eager step function; the
   card's time for a step by events, eager and replayed, and its busy
   time by kernel family; every serve of phases 8 and 15-17 is driven
   and checked by the same routine;
5b. card-bound loop — the same engine path with a ``torch.cuda._sleep``
   queued ahead of every decode step's replay, holding the card several
   times longer than the host takes to enqueue a step: nearly every step
   must still be running when its ``TensorOp`` is first polled
   (``TensorOp.PENDING_AT_FIRST_POLL``): the host reached the poll before
   the card finished the step, so it had not waited for it;
5s. speculative serve — ``speculate=4`` in bf16 under sync debug mode
   "error" on 16 requests of repetitive and random prompts, beside the
   plain engine on the same requests: tokens/s, the acceptance rate and
   the verify steps;
5c. card-bound verify loop — as 5b, the sleep ahead of each verify
   step's replay;
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
   prefill and a decode step; the card's time for a decode step by
   events around a replay beside the profiler's kernel sum of the eager
   step, and the eager step's and a 512-token prefill's host pace;
8b. its card-bound loop, as 5b (the sleep ahead of each replay);
9. its profile, as 6.

10. zones — the BT-MZ analogue (paper Fig. 2/3) at class B's 64 zones
   (20x width spread, 1024 columns, fp64) on 4 rank threads with a
   stream each: both variants, 30 timesteps, best of 3 under sync debug
   mode "error", bit-identical to the single-rank ``reference_solve`` on
   the card, itself bit-identical to the CPU's at 2 timesteps; the card's
   busy share by ``torch.profiler``, peak device memory; then a pass with
   a sleep kernel ahead of each zone update, where the halo sends must be
   pending at their first poll and still deliver the right halos;
11. Cholesky — the PaRSEC analogue (paper Fig. 6), N = 8192 in 512-tiles
   (816 tasks), continuations and a Testsome window of 4: makespan, mean
   activation latency, fp64 rate against the tensor-core peak; L within
   1e-10 (relative to max |L|) of ``torch.linalg.cholesky``, every POTRF
   ``info`` 0;
12. offload — the ExaHyPE analogue (paper Fig. 8/9), 4 ranks, 8
   iterations of 3 ms tasks, rank 0 with 6x the load: both backends and
   no offloading; every result ``payload * 2 + 1``.

These three run no kernel of ``csrc/``: the JAX package computes them in
numpy, so the port uses plain torch ops and library calls.

13. disaggregated serving — ``DisaggServer`` (a prefill role with a stream
   of its own, KV pages shipped as device tensors over the transport, a
   decode role replaying the engine's captured step):
   13a. fp32 ``paper_demo`` at full width, phase 4's requests at
   chunk_pages 1 and 4 and with ``speculate=4``: tokens equal to phase 4's
   greedy and colocated-engine tokens up to the first near tie, each
   request's first block installed before its prefill finished;
   13b. bf16, phase 5's 24 requests at chunk_pages 1 and 8 beside the
   colocated engine: tokens/s, TTFT, blocks and bytes shipped (bytes on
   the block tags must be blocks × ``page_nbytes``), host µs per block,
   the kernels' launches (paged = layers × (chunks + decode steps));
   then a profiled run: the card's busy share and the share in which the
   two roles' streams ran kernels at once;
   13c. a sleep kernel on the prefill stream ahead of every chunk: ≥ 90%
   of the block sends must be pending at their first poll, and the tokens
   must equal 13a's;
   13k. the paged kernel at the prefill role's windows (S=1, W=16 and
   128 over a 32-page table) against its plain version, with its bound;
14. router — two ``paper_demo`` replicas on the one card: 14a in fp32,
   replica 1 killed mid-decode (zero requests lost, phase 4's tokens, the
   dead replica's pool drained, the failover time); 14b a bf16
   shared-prefix trace beside one engine: tokens/s and the affinity hit
   rate.

Every serving loop of 13 and 14 runs under sync debug mode "error", and
every pool must end with no page in use.

15. h2o-danube3-4b at full width and depth (24 layers, d 3840, 32/8 heads
   of head_dim 120, a 4096 sliding window), served in dense mode on a
   ring of the window per slot (``max_cache_len`` 8192):
   15a. fp32: the engine's tokens equal ``greedy_generate``'s on 4
   prompts × 16 tokens up to the first near tie, and on a 6,000-token
   prompt (6000 % 4096 > 0) the greedy of the no-cache ``lm_forward``;
   15b. bf16: 16 requests of 64–2,048 prompt tokens and the 6,000-token
   one, 32–128 new, ``max_batch=8``: tokens/s, TTFT, the host's and the
   card's ms per decode step, peak memory, launches (each as the steps
   say);
   15c. its card-bound loop, as 5b;
16. deepseek-coder-33b at full width (56 q-heads padded to 64 over 8 KV
   heads, head_dim 128), 16 of its 62 layers, paged and fused: 16a fp32
   identity (prefix hits, suffix prefill at hd 128) and with
   ``speculate=4``; 16b phase 5's bf16 workload;
17. llama3-405b and command-r-plus-104b (parallel blocks, tied 256,000
   vocab) at full width, 2 layers: 17a fp32 identity on 2 prompts × 8
   tokens; 17b a bf16 serve of 8 requests.
18. qwen3-moe-235b-a22b at full width (64/4 heads of head_dim 128, 128
   experts top-8 of d_ff 1536, untied 151,936 vocab), paged and fused:
   18a fp32 identity at 2 layers on 4 cold requests × 16 tokens, guarded
   by the near ties of ``greedy_generate``'s own steps (a no-cache forward
   routes the whole sequence as one group: another function); 18b phase
   5's bf16 workload at 8 layers, with MoE routing and dispatch timed as a
   family of its own; 18c its card-bound loop, as 5b;
19. llama4-scout-17b-16e at full width (40 q-heads padded to 48 over 8,
   16 experts top-1 and a shared expert of d_ff 8192), as 18;
20. zamba2-1.2b whole (38 SSM layers of d 2048, the shared attention
   block at width 4096 before every 6th, 7 sites), dense mode with 4096
   positions a slot: 20a fp32 identity on 4 prompts of 64-1500 tokens and
   ``lm_forward`` against ``lm_prefill`` on 512; 20b a bf16 serve of 16
   requests of 64-2,048 prompt tokens, 32-128 new; 20c its card-bound
   loop.
21. whisper-large-v3 whole (32 encoder and 32 decoder layers, d 1280, 20
   heads padded to 32, tied 51,866 vocabulary), audio embeddings from a
   seed at its 1500 frames, ``max_cache_len`` 448, through the AUDIO step
   factories: 21a fp32, 2 clips x 32 greedy tokens, each step's logits
   within 2e-3 of the teacher-forced forward and the tokens equal up to
   its first near tie; 21b bf16, 8 clips x 64 new tokens: the prefill's
   ms by events (the time to the first token), the decode step captured
   as a ``StepGraph`` and replayed (its tokens equal the eager loop's),
   host and card ms a step against its bytes bound, tokens/s, peak
   memory, the launches exact; 21c 16 replays posted by continuations
   (one ``TensorOp`` a replay, whose continuation takes the tokens and
   posts the next) behind a 50 ms sleep each, under sync debug mode
   "error": >= 90% pending at their first poll, the tokens the eager
   loop's;
22. internvl2-26b (48/8 heads of head_dim 128, d 6144, 1024 patches of
   3200 prepended): 22a fp32 at 4 layers, prompts of 64 and 300 tokens
   with patches x 16 greedy tokens, logits within 1e-3 of ``lm_forward``
   and tokens equal up to its first near tie; 22b bf16 whole (39.8 GB),
   4 requests of 1024 patches and 512 tokens, 32 new: the prefill's ms,
   the dense decode step's card ms as a replay against its bound, peak
   memory, the launches exact; 22c ``ServeEngine`` refuses both configs
   at construction.
23. unfused paged serving — ``paper_demo`` at full width through
   ``ServeEngine(fused=False)`` (each slot's pages gathered into a
   contiguous view for the dense decode, the written pages copied back;
   decode and verify captured as step graphs): 23a fp32, phase 4's
   requests plain and with ``speculate=4``, tokens equal to phase 4's
   fused engine and to greedy up to the first near tie; 23b bf16, phase
   5's workload as the path ``paper_demo_unfused`` (the dense decode's
   paged kernel on the gathered view in place of the fused kernel on the
   pool), beside phase 5's fused numbers of the same call; 23c its
   card-bound loop, as 5b;
24. the bench on the card (``repro_torch.bench``), bf16 ``paper_demo`` at
   full width: a 48-request Poisson trace of phase 5's length ranges
   (4 shared 64-token prefixes); 24a the colocated engine's saturation
   sweep (1-100 requests/s, 3 bisections, a failed probe retried once)
   for lambda*, the highest rate whose TTFT p99 stays under 1 s with
   every request finished; 24b the engine, ``DisaggServer`` at
   ``chunk_pages=8`` and a 2-replica ``Router`` at 0.5 and 0.9 lambda*,
   2 samples each, replayed through ``ServeClient`` (its loop thread
   steps the tier built on this thread): the SLO report (tokens/s,
   goodput, TTFT p50/p99, ITL p99, the cv of each), every request
   finished; 24c one more sample a tier with an ``obs.Recorder``: the
   cause split (queue delay, compute, KV shipping, notify latency) and a
   Perfetto trace under ``build/``;
25. training ``paper_demo`` at full width in fp32 (TF32 off) through
   the kernels forward and backward: 25a one train step on the card
   against the same step on the CPU (plain versions) from one converted
   state and batch (B 2 x 512; loss, grad_norm and the largest per-leaf
   difference of params, m and v over the leaf's max, held to 1e-4);
   25b ``launch.train`` for 30 steps of 8 x 1024 tokens, a checkpoint
   every 10, its loop under sync debug mode "error": card and host ms a
   step, tokens/s, model FLOP/s against fp32's peak, one step's card time
   by kernel family, peak memory, the first and last loss (it must
   fall), and exactly 25 rmsnorm and 12 flash launches each way a step;
   25c the loop behind a sleep ahead of each step: at least 90% of the
   loss readbacks and every checkpoint's copies pending at first poll;
   25d a restart from the step-10 checkpoint, 2 steps in deterministic
   mode, bit-equal to the uninterrupted run;
26. sharding over a ``(data, model)`` mesh of every card the machine
   shows (``repro_torch.sharding``), one process a card on NCCL; it
   prints the mesh (1x1 on one card). 26a the dry run's counts
   (``repro_torch.launch.dryrun``, a CPU subprocess on a fake process
   group of the mesh's size) of the bf16 decode step of phase 5's 8 slots
   at its cache of 1024 and of phase 25's fp32 train step at 8 x 1024,
   each beside its card ms by events (the decode step re-timed here, the
   train step 26b's unsharded steps): the model FLOPs' share of the
   dtype's peak, the counted bound (the larger of the FLOPs and bytes
   terms, named) over the ms, and the counted FLOPs over the model's;
   26b ``paper_demo`` at full width in fp32, 3 train steps of 8 x 1024
   with the state placed by ``train_state_specs`` and the ``train`` rules
   and ``grad_spec_tree`` on, against the unsharded step on card 0: the
   loss and each leaf of m, v and the params (where |g| > 100 eps) within
   1e-5 of the leaf's max, and each rank's flash and rmsnorm launches,
   forward and backward, equal to the unsharded steps' (the kernels ran
   on the shards); 26c ``compressed_psum_mean`` over the data axis
   against the exact mean, within the reference test's bounds; 26d
   ``reshard_state`` of 25d's last committed checkpoint onto the mesh,
   bit-equal to the saved state;
27. training past paper_demo, fp32 with TF32 off, through the three
   backward kernels: ``mamba2_370m`` whole (remat "full"), ``zamba2_1p2b``
   whole, ``whisper_large_v3`` whole (``encdec_loss``, clips of 1500
   frames and 448 decoder tokens) and ``h2o_danube3_4b`` at 6 of 24
   layers, all at published widths (``TRAIN_FAMILIES``): 27a one step of
   each on the card against the same step on the CPU from one converted
   state (mamba2 and danube at 2 layers, zamba2 at 7, whisper at 2 + 2;
   B 2 x 256, whisper B 2 x 1500 frames), held as 25a; 27b ``launch.train``
   for 20 steps of each whole path (8 x 1024 for mamba2 and danube, 2 x
   1024 for zamba2, 2 clips for whisper): the card's ms a step, tokens/s,
   model FLOP/s (6 N a token) against fp32's peak, the loss readbacks
   pending at first poll (>= 90%), the loss falling, peak memory beside
   the dry run's count of the cell on the CPU, one step's card time by
   kernel family; 27c each kernel's launches forward and backward equal
   to the layers x steps (forwards twice under remat "full");
28. ``granite_4_0_h_small`` (moe_hybrid) at published widths, its first 6
   layers (5 Mamba-2, 1 NoPE attention at scale 1/128, each with its
   72-expert dropless MoE block), bf16, dense mode: 28b 16 requests of
   64-3,072 prompt tokens through ``family_serve`` (sync debug mode
   "error", flash and the SSD scan once a prefill at each layer of their
   kind, the paged kernel once a captured decode step at the attention
   layer), and the engine's MoE counters against its steps and prefills;
   28c the card-bound loop.

Phase 3 also holds the three backward kernels (no TPU counterpart) in
fp32 and bf16, each output's error over max(1, its largest magnitude):
rmsnorm's against ``rmsnorm_backward_plain`` (library: ``F.rms_norm``'s
autograd backward) at 8192 rows of every config's width (768 to
16,384) and at phase 27's rows; flash's against
``attention_backward_plain`` in fp32 (library: SDPA forward and backward
by autograd, a window as a boolean mask) at paper_demo's training step
(B 8, 1024 causal rows, 12/4 heads of 64), at phase 27's shapes
(zamba2's 32/32 heads of 128, whisper's encoder over 1500 frames, its
decoder's self- and cross-attention, danube's 32/8 of 120 under its
window, also at 6144 rows) and at 1024 rows of every other config's heads
(deepseek, llama3, command-r, qwen3, llama4, internvl2); the SSD scan's
against ``ssd_scan_backward_plain`` (no library call) at mamba2's and
zamba2's training batches, T 1024, at T 509 and 64, and with the final
state's gradient (B 2, T 1024). Every backward case must also give the
same bits on a second call; its line gives its share of the bound (and
the SSD's scratch bytes and head-slices). Phase 3's last forward cases
are granite-4.0-h-small's at the granite-longctx cell's shapes
(``GRANITE_SHAPES``): rmsnorm at 32 rows of 4096, flash causal at 32/8
heads of 128 over 3,072 rows and the dense decode at 32 slots of 4096
positions (1023-4095), both at the softmax scale 1/128, the SSD scan at
128 heads of (64, 128) over 3,072 rows.

Phases 23 and 24 run right after 14, on phase 4's and 13's weights.
Each phase's weights are freed before the next. Each serve phase sets
the kernels' launch counts to 0 just before it drives its path and reads
them just after; a step graph adds its kernels' launches back on every
replay. The kernels JSON has one entry per kernel and path that ran it
(phase 5 ``paper_demo``, 23b ``paper_demo_unfused``, 8
``mamba2_370m``, 15b-22b, 25b ``train``, 26b ``train_sharded``, 27b's
four ``train_*`` paths, the only paths of the backward kernels, and 28b
``granite_4_0_h_small`` at the cell's shapes; every
serving path must show none of their launches): that path's
launches beside the phase 3 case at its shape (a decode step's rows for
rmsnorm and paged, a 512-token prompt for flash and the SSD scan,
danube's 6144 rows for its windowed flash, whisper's encoder over 1500
frames, internvl2's 1536 prefill rows; the training steps' shapes in
fp32 for ``train`` and 27b's paths, and for ``train_sharded`` at one
card's rows of it, bf16 for the others); each kernel's row is its
first path's entry, with every path's entry under ``paths``. The
next-to-last line is the kernels JSON, the last line the device JSON.
"""
from __future__ import annotations

import dataclasses
import gc
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
SPECULATE = 4          # drafts a verify step scores (phases 4, 5s, 5c)
SOURCES = {
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:41"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:105"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention/kernel.py:141"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:68"),
    # the backward kernels have no TPU counterpart: each is the gradient of
    # the TPU kernel named (the JAX package differentiates its reference)
    "rmsnorm_backward": ("src/repro_torch/csrc/rmsnorm.cu",
                         "src/repro/kernels/rmsnorm/kernel.py:41 (gradient;"
                         " no TPU backward kernel)"),
    "flash_attention_backward": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:105 (gradient; no TPU "
        "backward kernel)"),
    "ssd_scan_backward": ("src/repro_torch/csrc/ssd_scan.cu",
                          "src/repro/kernels/ssd_scan/kernel.py:68 "
                          "(gradient; no TPU backward kernel)"),
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


def enqueue_ms(fn, runs: int = 10) -> float:
    """Median host time to enqueue one call of ``fn``: a host clock around
    the call alone, the card drained between calls (outside the span), so
    the span measures the host's launches, not a wait on the card."""
    fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        spans.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return statistics.median(spans) * 1e3


def device_ms(fn, runs: int = TIMED_RUNS):
    """Median device time of one call of ``fn`` under ``torch.profiler``,
    over ``runs`` calls: each kernel's median duration, by name, summed
    with the number of times one call launches it; and that median by
    name. Unlike events around a call, this leaves out the launch gaps
    between calls and inside one. Medians by name stay right when a
    session drops a kernel event or two, as one now and then does."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a session now and then delivers no device events at all, or misses
    # many (26 of 50 calls' kernels in all three sessions of one run on
    # an H100 80GB HBM3): take the first of five that saw at least 90%,
    # each starting with a sleep kernel the card has finished before the
    # counted calls (a one-off, left out below)
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize()
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        spans: dict = {}
        for e in sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start):
            spans.setdefault(e.name, []).append(e.time_range.elapsed_us())
        # kernels a call launches, by name (a stray one-off is left out)
        per_call = {name: n for name, d in spans.items()
                    if (n := round(len(d) / runs))}
        if per_call and all(len(spans[name]) >= 0.9 * n * runs
                            for name, n in per_call.items()):
            break
    else:
        raise AssertionError(f"device_ms: kernel events by name "
                             f"{ {n: len(d) for n, d in spans.items()} } "
                             f"in {runs} calls")
    by_name = {name: statistics.median(spans[name]) / 1e3
               for name in per_call}
    return sum(per_call[name] * ms for name, ms in by_name.items()), by_name


def bound_ms(n_bytes: float, flops: float, dtype: torch.dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# ----------------------------------------------------------------- kernels
def check_rmsnorm(dtype, rows, D, gen, dev):
    """rmsnorm at one shape against its plain version. A bf16 case's error
    is taken against the plain version run in fp32 on the same inputs, as
    ``check_flash``'s is (ROADMAP C.10): the kernel and the bf16 plain
    version round one fp32 result to bf16 each, and where it sits on a
    rounding boundary they differ by one ulp, 2^-5 past an output of 4,
    more than the bf16 tolerance. ``low`` logs the kernel against the bf16
    plain version, and that version against the fp32 one."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as K
    x = torch.randn((rows, D), generator=gen, device=dev).to(dtype)
    scale = (1 + 0.1 * torch.randn((D,), generator=gen, device=dev))
    out = K.rmsnorm(x, scale)
    ref = K.rmsnorm_plain(x, scale)
    low = None
    if dtype is not torch.float32:
        exact = K.rmsnorm_plain(x.float(), scale)
        low = dict(err_bf16=max_err(out, ref), plain_err=max_err(ref, exact))
        ref = exact
    err = max_err(out, ref)
    item = x.element_size()
    scale_lib = scale.to(dtype)
    kernel = lambda: K.rmsnorm(x, scale)                       # noqa: E731
    library = lambda: F.rms_norm(x, (D,), scale_lib, 1e-5)     # noqa: E731
    return dict(err=err, low=low, ms=median_ms(kernel),
                plain_ms=median_ms(lambda: K.rmsnorm_plain(x, scale)),
                library_ms=median_ms(library),
                device=(device_ms(kernel)[0], device_ms(library)[0]),
                bound=bound_ms(2 * rows * D * item + 4 * D, 4 * rows * D,
                               dtype),
                shape=f"({rows}, {D})")


def check_flash(dtype, gen, dev, B=1, S=512, H=12, KV=4, D=64, window=0,
                causal=True, Sq=None, scale=None):
    """Prefill attention at one shape: causal (or windowed) over a prompt
    of ``S``, or non-causal with ``Sq`` query rows against ``S`` keys (an
    encoder, a cross-attention); SDPA as the library yardstick (with the
    window as a boolean mask). ``scale`` is the softmax's scale of q·k
    (default D^-1/2; granite's is 1/128). Long prompts take fewer timed
    runs.

    A bf16 case's error is taken against the plain version run in fp32 on
    the same (bf16-valued) inputs. The plain version in bf16 rounds the
    normalised probabilities to bf16 before P.V, as the JAX reference
    does, so it is itself off the fp32 result, by more than the bf16
    tolerance where an output nears 4 (one bf16 ulp there is 2^-5): two
    bf16 results can then differ by more than the tolerance while the
    kernel is within it of the fp32 one. ``low`` logs the kernel against
    the bf16 plain version, and that version against the fp32 one."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as K
    Sq = S if Sq is None else Sq
    if causal and Sq != S:
        raise ValueError("check_flash: causal cases have Sq == Sk")
    q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, KV, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, KV, D), generator=gen, device=dev).to(dtype)
    kw = dict(causal=causal, window=window, scale=scale)
    out = K.attention(q, k, v, **kw)
    ref = K.attention_plain(q, k, v, **kw)
    low = None
    if dtype is not torch.float32:
        exact = K.attention_plain(q.float(), k.float(), v.float(), **kw)
        low = dict(err_bf16=max_err(out, ref), plain_err=max_err(ref, exact))
        ref = exact
    err = max_err(out, ref)
    del out, ref
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if window:
        i = torch.arange(S, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True, scale=scale)
    else:
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=True, scale=scale)
    item = q.element_size()
    # (query, key) pairs each row attends: its causal past, cut to the
    # window, or every key
    pairs = sum(min(r + 1, window) if window else r + 1
                for r in range(S)) if causal else Sq * S
    runs = 10 if S >= 4096 else TIMED_RUNS
    return dict(err=err, low=low,
                ms=median_ms(lambda: K.attention(q, k, v, **kw), runs=runs),
                plain_ms=median_ms(lambda: K.attention_plain(q, k, v, **kw),
                                   runs=runs),
                library_ms=median_ms(library, runs=runs),
                bound=bound_ms((2 * B * Sq * H * D + 2 * B * S * KV * D)
                               * item, 4 * B * H * D * pairs, dtype),
                shape=(f"B={B} Sq=Sk={S}" if Sq == S else
                       f"B={B} Sq={Sq} Sk={S}")
                + f" H={H} KV={KV} D={D} "
                + ("causal" if causal else "non-causal")
                + (f" window={window}" if window else "")
                + (f" scale={scale:g}" if scale is not None else ""),
                head_dim=D)


def grad_err(got, want) -> float:
    """The largest error over a backward's outputs, each output's max abs
    error over max(1, its plain version's largest magnitude): a dscale sums
    thousands of rows, a dq or dk is near 1 (so the abs error there)."""
    return max(max_err(g, w) / max(1.0, float(w.float().abs().max()))
               for g, w in zip(got, want))


def check_rmsnorm_bwd(dtype, rows, D, gen, dev):
    """The rmsnorm backward kernel against ``rmsnorm_backward_plain`` (fp32
    arithmetic on the same inputs); the library yardstick is
    ``F.rms_norm``'s autograd backward alone (its forward graph kept)."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as K
    x = torch.randn((rows, D), generator=gen, device=dev).to(dtype)
    scale = 1 + 0.1 * torch.randn((D,), generator=gen, device=dev)
    dy = torch.randn((rows, D), generator=gen, device=dev).to(dtype)
    got = K.rmsnorm_backward(x, scale, dy)
    want = K.rmsnorm_backward_plain(x, scale, dy)
    errs = [max_err(g, w) for g, w in zip(got, want)]
    bit_equal = all(torch.equal(a, b) for a, b in zip(
        got, K.rmsnorm_backward(x, scale, dy)))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    xl = x.clone().requires_grad_()
    wl = scale.to(dtype).requires_grad_()
    y = F.rms_norm(xl, (D,), wl, 1e-5)
    library = lambda: torch.autograd.grad(  # noqa: E731
        y, (xl, wl), dy, retain_graph=True)
    item = x.element_size()
    return dict(err=grad_err(got, want) if finite else float("inf"),
                grads=dict(zip(("dx", "dscale"), errs)), bit_equal=bit_equal,
                ms=median_ms(lambda: K.rmsnorm_backward(x, scale, dy)),
                plain_ms=median_ms(lambda: K.rmsnorm_backward_plain(
                    x, scale, dy)),
                library_ms=median_ms(library),
                bound=bound_ms(3 * rows * D * item + 2 * 4 * D,
                               10 * rows * D, dtype),
                shape=f"({rows}, {D}) backward")


def check_flash_bwd(dtype, gen, dev, B=8, S=1024, H=12, KV=4, D=64,
                    causal=True, window=0, Sq=None):
    """The flash backward kernel against ``attention_backward_plain`` in
    fp32 on the same (dtype-valued) inputs, from the forward kernel's
    output and log-sum-exp, at ``Sq`` query rows (``S`` by default)
    against ``S`` keys; the library yardstick is SDPA's forward and
    backward by autograd, the window as a boolean mask (its backward alone
    is logged beside it). The bound counts the five products a backward
    needs (S again, dP, dV, dK, dQ) over the visible pairs and q, k, v, o,
    dO, lse read, dq, dk, dv written once."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as K
    Sq = S if Sq is None else Sq
    if causal and Sq != S:
        raise ValueError("check_flash_bwd: causal cases have Sq == Sk")
    kw = dict(causal=causal, window=window)
    q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, KV, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, KV, D), generator=gen, device=dev).to(dtype)
    do = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dtype)
    o, lse = K._launch(q, k, v, causal, window, 0, D ** -0.5,
                       _build.DTYPE_CODES[dtype], with_lse=True)
    got = K.attention_backward(q, k, v, o, lse, do, **kw)
    # no atomics: a second call gives the same bits
    bit_equal = all(torch.equal(a, b) for a, b in zip(
        got, K.attention_backward(q, k, v, o, lse, do, **kw)))
    plain_lse = K.attention_lse_plain(q, k, **kw)
    o32 = K.attention_plain(q.float(), k.float(), v.float(), **kw)
    want = K.attention_backward_plain(q.float(), k.float(), v.float(), o32,
                                      plain_lse, do.float(), **kw)
    errs = [max_err(g, w) for g, w in zip(got, want)]
    err = grad_err(got, want)
    lse_err = max_err(lse, plain_lse)
    del o32, want
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa_kw = dict(is_causal=causal)
    if window:
        i = torch.arange(S, device=dev)
        sdpa_kw = dict(attn_mask=(i[None, :] <= i[:, None])
                       & (i[None, :] > i[:, None] - window))
    library = lambda: torch.autograd.grad(  # noqa: E731
        F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                       **sdpa_kw), (qt, kt, vt), dot)
    y = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                       **sdpa_kw)
    sdpa_bwd = median_ms(lambda: torch.autograd.grad(
        y, (qt, kt, vt), dot, retain_graph=True), runs=10)
    del y
    item = q.element_size()
    # (query, key) pairs each row sees: its causal past, cut to the
    # window, or every key
    pairs = B * (sum(min(r + 1, window) if window else r + 1
                     for r in range(S)) if causal else Sq * S)
    return dict(err=max(err, lse_err), grads=dict(zip(("dq", "dk", "dv"),
                                                      errs), lse=lse_err),
                bit_equal=bit_equal,
                splits=K.backward_splits(B, S, H, KV,
                                         K.backward_key_tile(dtype, D)),
                ms=median_ms(lambda: K.attention_backward(q, k, v, o, lse,
                                                          do, **kw)),
                plain_ms=median_ms(lambda: K.attention_backward_plain(
                    q, k, v, o, lse, do, **kw), runs=10),
                library_ms=median_ms(library, runs=10),
                sdpa_bwd_ms=sdpa_bwd,
                bound=bound_ms((4 * B * Sq * H * D + 4 * B * S * KV * D)
                               * item + 4 * B * H * Sq, 10 * H * D * pairs,
                               dtype),
                shape=(f"B={B} Sq=Sk={S}" if Sq == S else
                       f"B={B} Sq={Sq} Sk={S}")
                + f" H={H} KV={KV} D={D} "
                + ("causal" if causal else "non-causal")
                + (f" window={window}" if window else "") + " backward")


def paged_case(kind, dtype, gen, dev, KV=4, G=3, hd=64):
    """Main-path paged shapes: ``decode`` S=8, W=1, mixed positions, one
    idle slot; ``decode_full`` all 8 slots live at 900-1023 positions
    (where splitting positions over blocks pays most); ``suffix`` S=1,
    W=16 over 16 shared prefix pages; ``suffix256`` S=1, W=256 (a long
    page-padded tail, 250 rows valid) over the same 16 prefix pages;
    ``chunk16``/``chunk128`` the disaggregated prefill role's last chunk
    of a 512-token prompt (phase 13). ``KV``, ``G`` and ``hd`` default to
    ``paper_demo``'s heads (deepseek-coder: 8, 8, 128; llama3: 8, 16,
    128)."""
    ps, T = 16, 64
    H = KV * G
    P = 512
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(7))
    if kind.startswith("chunk"):
        # the disaggregated prefill role's last chunk of a 512-token
        # prompt: S=1, a full W-row window at 512 - W, a 32-page table
        S, W, T = 1, int(kind[5:]), 32
        positions, n_valid = [512 - W], [W]
        tables = perm[:T].numpy().astype(np.int32)[None]
    elif kind in ("decode", "decode_full"):
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


def check_paged(kind, dtype, gen, dev, **heads):
    from repro_torch.kernels import paged_attention as K
    args, tables, null, (n_bytes, flops), shape = paged_case(
        kind, dtype, gen, dev, **heads)
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
                shape=shape, head_dim=q.shape[-1])


def check_dense_paged(dtype, gen, dev, B, L, KV, G, hd, positions=None,
                      scale=None):
    """Dense decode at one shape, the way ``attention.decode_attention``
    runs it: the paged kernel over a ``(B, L, KV, hd)`` cache viewed as
    pages in place (``attention.dense_pages``), one new row a slot, every
    slot at its position (default: spread over the cache, the last slot
    idle at 0). Against the grouped einsums of ``attention._grouped`` with
    its ``_write_rows``, the plain version and the path the route replaced:
    the caches bit-equal after one call each, the outputs (a bf16 case's
    against ``_grouped`` in fp32 on the same inputs, as ``check_flash``
    does). SDPA over the cache laid out (B, KV, L, hd) beforehand, with a
    boolean mask of each slot's positions, is the library yardstick. The
    bound: the K/V rows the slots hold and the new rows, q and the output,
    and the splits' fp32 partials written and read, at HBM's rate.
    ``scale`` is the softmax's scale of q·k (default hd^-1/2); given, the
    kernel and ``_grouped`` both take it from a moe_hybrid config (the
    family that carries one, granite's 1/128)."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as K
    from repro_torch.models import attention
    from repro_torch.models.common import ModelConfig
    H = KV * G
    heads = dict(n_heads=H, n_kv_heads=KV, head_dim=hd, head_pad_to=1,
                 dtype=dtype, param_dtype=dtype)
    cfg = ModelConfig(**heads) if scale is None else dataclasses.replace(
        get_config("granite_4_0_h_small"), attention_multiplier=scale,
        **heads)
    if positions is None:
        positions = [int(p) for p in np.linspace(L // 4, L - 1, B - 1)] + [0]
    pos = torch.as_tensor(positions, device=dev)
    pages = attention.dense_pages(cfg, B, L, pos, 1, dev)
    ps = pages.page_size
    q = torch.randn((B, 1, H, hd), generator=gen, device=dev).to(dtype)
    kn = torch.randn((B, 1, KV, hd), generator=gen, device=dev).to(dtype)
    vn = torch.randn((B, 1, KV, hd), generator=gen, device=dev).to(dtype)
    cache = {n: torch.randn((B, L, KV, hd), generator=gen,
                            device=dev).to(dtype) for n in ("k", "v")}
    plain_cache = {n: t.clone() for n, t in cache.items()}
    pools = [cache[n].view(B * L // ps, ps, KV, hd) for n in ("k", "v")]
    idx = pages.tables, pages.positions, pages.n_valid
    kernel = lambda: K.paged_attention(  # noqa: E731
        q, kn, vn, *pools, *idx, page_size=ps, scale=cfg.attn_scale)[0]
    valid = torch.arange(L, device=dev)[None, None, :] <= pos[:, None, None]

    def plain():
        attention._write_rows(plain_cache, kn, vn, pos[:, None] % L)
        return attention._grouped(q, plain_cache["k"], plain_cache["v"],
                                  valid, cfg)
    out, ref = kernel(), plain()
    pools_exact = all(torch.equal(cache[n], plain_cache[n])
                      for n in ("k", "v"))
    low = None
    if dtype is not torch.float32:
        exact = attention._grouped(
            q.float(), plain_cache["k"].float(), plain_cache["v"].float(),
            valid, dataclasses.replace(cfg, dtype=torch.float32))
        low = dict(err_bf16=max_err(out, ref), plain_err=max_err(ref, exact))
        ref = exact
    err = max_err(out, ref)
    del out, ref
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (cache[n].transpose(1, 2).contiguous() for n in ("k", "v"))
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=valid[:, None], enable_gqa=True,
        scale=cfg.attn_scale)
    item = q.element_size()
    held = sum(p + 1 for p in positions)
    n_split = -(-L // K.SPLIT_LEN)
    n_bytes = (2 * held * KV * hd + 2 * q.numel() + 2 * kn.numel()) * item \
        + 2 * n_split * B * H * (hd + 2) * 4
    runs = 10 if B * L >= 1 << 16 else TIMED_RUNS
    shape = (f"dense B={B} L={L} ps={ps} KV={KV} G={G} hd={hd} positions "
             f"{min(positions[:-1])}..{max(positions)}, slot {B - 1} at "
             f"{positions[-1]}"
             + (f" scale={scale:g}" if scale is not None else ""))
    return dict(err=err, low=low, pools_exact=pools_exact,
                ms=median_ms(kernel, runs=runs),
                plain_ms=median_ms(plain, runs=runs),
                library_ms=median_ms(library, runs=runs),
                bound=bound_ms(n_bytes, 4 * H * hd * held, dtype),
                shape=shape, head_dim=hd)


def busy_ms(fn, runs: int = 5, by_name: bool = False):
    """The card's busy time for one call of ``fn``: the sum of the device
    times of the kernels it ran, under ``torch.profiler``, over ``runs``
    calls, and its split by kernel family (shares); with ``by_name`` also
    each kernel name's share and launches a call. For calls that launch
    more kernels than the launch queue holds, where events around the call
    (``median_ms``) measure the host's pace past the queue's depth."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a session now and then delivers no device events: up to three
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        by_family: dict = {}
        names: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                fam = kernel_family(e.name)
                by_family[fam] = by_family.get(fam, 0.0) \
                    + e.time_range.elapsed_us()
                t, n = names.get(e.name, (0.0, 0))
                names[e.name] = (t + e.time_range.elapsed_us(), n + 1)
        us = sum(by_family.values())
        if us > 0:
            break
    else:
        raise AssertionError("busy_ms: the profiler saw no device time")
    out = (us / runs / 1e3, {f: t / us for f, t in sorted(
        by_family.items(), key=lambda kv: -kv[1])})
    if by_name:
        out += ({name: (t / us, n / runs) for name, (t, n) in sorted(
            names.items(), key=lambda kv: -kv[1][0])},)
    return out


def ssd_inputs(gen, dev, B, T, dtype, H=32, P=64, G=1, N=128):
    """mamba2-370m's SSD shapes (zamba2-1.2b's with H=64, N=64) with
    inputs distributed like the model's:
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


def check_ssd(dtype, B, T, gen, dev, H=32, N=128):
    from repro_torch.kernels import ssd_scan as K
    args = ssd_inputs(gen, dev, B, T, dtype, H=H, N=N)
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


def check_ssd_bwd(dtype, B, T, gen, dev, H=32, N=128, dfinal=False):
    """The SSD backward kernel against ``ssd_scan_backward_plain`` in fp32
    on the same (dtype-valued) inputs (no library call computes it), with
    the final state's gradient when ``dfinal``; a second call must give
    the same bits. The bound counts x, dy, B, C, dt (and dfinal) read and
    dx, dB, dC, ddt written once, and per (batch, head, chunk of q real
    rows) the products the gradient needs without recomputing the states:
    dE, dS B, x^T dS and dy E (q P N each), and C B^T, dy x^T, scores^T
    dy, dM^T C and dM B over the q (q + 1) / 2 pairs at or below the
    diagonal. The kernel's fp32 scratch (``backward_scratch_floats``) is
    logged beside it."""
    from repro_torch.kernels import ssd_scan as K
    args = ssd_inputs(gen, dev, B, T, dtype, H=H, N=N)
    x, dt, A, Bm, Cm, D = args
    P, Q, G = x.shape[3], K.CHUNK, Bm.shape[2]
    dy = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
    df = torch.randn((B, H, P, N), generator=gen, device=dev) \
        if dfinal else None
    got = K.ssd_scan_backward(*args, dy, df)
    want = K.ssd_scan_backward_plain(x.float(), dt, A, Bm.float(),
                                     Cm.float(), D, dy.float(), df)
    names = ("dx", "ddt", "dA", "dB", "dC", "dD")
    errs = [max_err(g, w) for g, w in zip(got, want)]
    err = grad_err(got, want)
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    bit_equal = all(torch.equal(a, b) for a, b in zip(
        got, K.ssd_scan_backward(*args, dy, df)))
    del got, want
    item = x.element_size()
    n_bytes = (3 * x.numel() + 4 * Bm.numel()) * item + 8 * dt.numel() \
        + 16 * H + (4 * df.numel() if dfinal else 0)
    rows = [min(Q, T - t0) for t0 in range(0, T, Q)]
    flops = B * H * sum(8 * q * P * N + q * (q + 1) * (3 * N + 2 * P)
                        for q in rows)
    splits = K.backward_head_splits(
        B, T, H, G, torch.cuda.get_device_properties(dev).multi_processor_count)
    return dict(err=err if finite else float("inf"),
                grads=dict(zip(names, errs)), bit_equal=bit_equal,
                splits=splits,
                scratch_bytes=4 * K.backward_scratch_floats(B, T, H, G, P, N,
                                                            splits),
                ms=median_ms(lambda: K.ssd_scan_backward(*args, dy, df)),
                plain_ms=median_ms(lambda: K.ssd_scan_backward_plain(
                    *args, dy, df), runs=10),
                library_ms=None, bound=bound_ms(n_bytes, flops, dtype),
                shape=f"B={B} T={T} H={H} P={P} G={G} N={N} backward"
                      + (" with dfinal" if dfinal else ""))


# each attention config of phases 15-19: (d_model, padded q-heads, KV
# heads, head_dim); zamba2 (20) has cases of its own
FAMILY_SHAPES = {"h2o_danube3_4b": (3840, 32, 8, 120),
                 "deepseek_coder_33b": (7168, 64, 8, 128),
                 "llama3_405b": (16384, 128, 8, 128),
                 "command_r_plus_104b": (12288, 96, 8, 128),
                 "qwen3_moe_235b_a22b": (4096, 64, 4, 128),
                 "llama4_scout_17b_16e": (5120, 48, 8, 128)}
# zamba2-1.2b (20): its 38 SSM layers' width, the shared block's width and
# heads, and the SSD scan's heads, head_dim and state
ZAMBA_SHAPES = dict(d=2048, w=4096, H=32, KV=32, hd=128, ssd=(64, 64, 64))
# whisper-large-v3 (21): d_model, padded q-heads (20 of 32 real), KV heads,
# head_dim, encoder frames (a 30 s window, arXiv:2212.04356) and clips a
# decode batch; internvl2-26b (22): d_model, q-heads, KV heads, head_dim,
# a prefill's rows (1024 patches and 512 tokens) and requests a batch
WHISPER_SHAPES = dict(d=1280, H=32, KV=32, hd=64, frames=1500, clips=8)
VLM_SHAPES = dict(d=6144, H=48, KV=8, hd=128, rows=1536, batch=4)
# granite-4.0-h-small (28) as the granite-longctx cell serves it: d_model,
# q-heads, KV heads, head_dim, the softmax scale (attention_multiplier),
# the SSD scan's heads, head_dim and state, the slots, each slot's cache
# and the longest prompt
GRANITE_SHAPES = dict(d=4096, H=32, KV=8, hd=128, scale=1 / 128,
                      ssd=(128, 64, 128), slots=32, cache=4096, prompt=3072)


# the paths whose decode steps run paper_demo's shapes: paged + fused (5)
# and paged, unfused (23b)
PAPER_PATHS = ("paper_demo", "paper_demo_unfused")
# phase 27b's training paths beyond paper_demo, in fp32: each config at
# its published widths, its depth (whole unless cut), remat policy, global
# batch and sequence (whisper: the encoder's frames, and a decoder of
# min(max_target_len, 448) tokens); the layers of 27a's card-vs-CPU step
TRAIN_FAMILIES = {
    "train_mamba2": dict(arch="mamba2_370m", n_layers=None, remat="full",
                         batch=8, seq=1024, check={"n_layers": 2}),
    "train_zamba2": dict(arch="zamba2_1p2b", n_layers=None, remat="none",
                         batch=2, seq=1024, check={"n_layers": 7}),
    "train_whisper": dict(arch="whisper_large_v3", n_layers=None,
                          remat="none", batch=2, seq=1500,
                          check={"n_enc_layers": 2, "n_dec_layers": 2}),
    "train_danube": dict(arch="h2o_danube3_4b", n_layers=6, remat="none",
                         batch=8, seq=1024, check={"n_layers": 2}),
}
WHISPER_DEC = 448      # whisper's decoder tokens a clip in training
# the training paths (phases 25b, 26b, 27b) run in fp32: the kernels JSON
# reports their fp32 cases, every serving path's bf16 ones
FP32_PATHS = ("train", "train_sharded") + tuple(TRAIN_FAMILIES)
# paper_demo's training step in phase 25b: global batch 8 of 1024 tokens
TRAIN_BATCH, TRAIN_SEQ = 8, 1024


def train_cases(dtype, gen, dev):
    """Phase 3's cases of the training paths: 25b's step at its 8 x 1024
    rows, and 26b's sharded step at one card's share of them (the same
    cases when the machine shows one card)."""
    shard = TRAIN_BATCH // torch.cuda.device_count()
    tags = {TRAIN_BATCH: ("train",)}
    tags[shard] = tags.get(shard, ()) + ("train_sharded",)
    out = []
    for B, tag in tags.items():
        out += [("rmsnorm", tag, check_rmsnorm(dtype, B * TRAIN_SEQ, 768,
                                               gen, dev)),
                ("flash_attention", tag, check_flash(dtype, gen, dev, B=B,
                                                     S=TRAIN_SEQ)),
                ("rmsnorm_backward", tag, check_rmsnorm_bwd(
                    dtype, B * TRAIN_SEQ, 768, gen, dev)),
                ("flash_attention_backward", tag, check_flash_bwd(
                    dtype, gen, dev, B=B, S=TRAIN_SEQ))]
    return out


def train_family_cases(dtype, gen, dev):
    """Phase 3's cases of phase 27's paths, each tagged at the shape its
    27b step runs most (batch included), and the three backward kernels at
    the other shapes the public configs give them with grad (untagged):
    the SSD backward's tails, whisper's decoder self- and cross-attention,
    danube's window at 6144 rows, every other config's heads at 1024 rows,
    and rmsnorm at 8192 rows of every config's width."""
    from repro_torch.configs import ARCHITECTURES, get_config
    m, z, w, d = (TRAIN_FAMILIES[p] for p in (
        "train_mamba2", "train_zamba2", "train_whisper", "train_danube"))
    H, _, N = ZAMBA_SHAPES["ssd"]
    zh = dict(H=ZAMBA_SHAPES["H"], KV=ZAMBA_SHAPES["KV"],
              D=ZAMBA_SHAPES["hd"])
    wh = dict(H=WHISPER_SHAPES["H"], KV=WHISPER_SHAPES["KV"],
              D=WHISPER_SHAPES["hd"])
    _, dH, dKV, dD = FAMILY_SHAPES["h2o_danube3_4b"]
    window = get_config("h2o_danube3_4b").window
    dec_rows = w["batch"] * WHISPER_DEC
    cases = [
        # mamba2: rmsnorm at its width, the SSD scan at (64, 128)
        ("rmsnorm", "train_mamba2", check_rmsnorm(
            dtype, m["batch"] * m["seq"], 1024, gen, dev)),
        ("rmsnorm_backward", "train_mamba2", check_rmsnorm_bwd(
            dtype, m["batch"] * m["seq"], 1024, gen, dev)),
        ("ssd_scan", "train_mamba2", check_ssd(dtype, m["batch"], m["seq"],
                                               gen, dev)),
        ("ssd_scan_backward", "train_mamba2", check_ssd_bwd(
            dtype, m["batch"], m["seq"], gen, dev)),
        ("ssd_scan_backward", None, check_ssd_bwd(dtype, m["batch"], 509,
                                                  gen, dev)),
        # the final state's gradient too (ssd_scan(..., return_state=True)
        # with grad)
        ("ssd_scan_backward", None, check_ssd_bwd(dtype, 2, 1024, gen, dev,
                                                  dfinal=True)),
        # zamba2: its SSM layers' width (38 of 53 norms a step) and the
        # shared block's, flash at 32/32 heads of 128, the SSD at (64, 64)
        ("rmsnorm", "train_zamba2", check_rmsnorm(
            dtype, z["batch"] * z["seq"], ZAMBA_SHAPES["d"], gen, dev)),
        ("rmsnorm_backward", "train_zamba2", check_rmsnorm_bwd(
            dtype, z["batch"] * z["seq"], ZAMBA_SHAPES["d"], gen, dev)),
        ("rmsnorm_backward", None, check_rmsnorm_bwd(
            dtype, z["batch"] * z["seq"], ZAMBA_SHAPES["w"], gen, dev)),
        ("flash_attention", "train_zamba2", check_flash(
            dtype, gen, dev, B=z["batch"], S=z["seq"], **zh)),
        ("flash_attention_backward", "train_zamba2", check_flash_bwd(
            dtype, gen, dev, B=z["batch"], S=z["seq"], **zh)),
        ("ssd_scan", "train_zamba2", check_ssd(dtype, z["batch"], z["seq"],
                                               gen, dev, H=H, N=N)),
        ("ssd_scan_backward", "train_zamba2", check_ssd_bwd(
            dtype, z["batch"], z["seq"], gen, dev, H=H, N=N)),
        ("ssd_scan_backward", None, check_ssd_bwd(dtype, z["batch"], 64,
                                                  gen, dev, H=H, N=N)),
        # whisper: the decoder's rows (97 of 162 norms a step) and the
        # encoder's; flash over the encoder's frames (non-causal), the
        # decoder's causal self-attention and its cross-attention
        ("rmsnorm", "train_whisper", check_rmsnorm(
            dtype, dec_rows, WHISPER_SHAPES["d"], gen, dev)),
        ("rmsnorm_backward", "train_whisper", check_rmsnorm_bwd(
            dtype, dec_rows, WHISPER_SHAPES["d"], gen, dev)),
        ("rmsnorm_backward", None, check_rmsnorm_bwd(
            dtype, w["batch"] * w["seq"], WHISPER_SHAPES["d"], gen, dev)),
        ("flash_attention", "train_whisper", check_flash(
            dtype, gen, dev, B=w["batch"], S=w["seq"], causal=False, **wh)),
        ("flash_attention_backward", "train_whisper", check_flash_bwd(
            dtype, gen, dev, B=w["batch"], S=w["seq"], causal=False, **wh)),
        ("flash_attention_backward", None, check_flash_bwd(
            dtype, gen, dev, B=w["batch"], S=w["seq"], Sq=WHISPER_DEC,
            causal=False, **wh)),
        ("flash_attention_backward", None, check_flash_bwd(
            dtype, gen, dev, B=w["batch"], S=WHISPER_DEC, **wh)),
        # danube: its width, flash at hd 120 under its window (wider than
        # the step's 1024 rows), and at 6144 rows where the window bites
        ("rmsnorm", "train_danube", check_rmsnorm(
            dtype, d["batch"] * d["seq"], 3840, gen, dev)),
        ("rmsnorm_backward", "train_danube", check_rmsnorm_bwd(
            dtype, d["batch"] * d["seq"], 3840, gen, dev)),
        ("flash_attention", "train_danube", check_flash(
            dtype, gen, dev, B=d["batch"], S=d["seq"], H=dH, KV=dKV, D=dD,
            window=window)),
        ("flash_attention_backward", "train_danube", check_flash_bwd(
            dtype, gen, dev, B=d["batch"], S=d["seq"], H=dH, KV=dKV, D=dD,
            window=window)),
        ("flash_attention_backward", None, check_flash_bwd(
            dtype, gen, dev, B=1, S=6144, H=dH, KV=dKV, D=dD,
            window=window))]
    # every other config's (q-heads, KV heads, head_dim) at 1024 rows
    heads = [v[1:] for k, v in FAMILY_SHAPES.items()
             if k != "h2o_danube3_4b"]
    heads.append((VLM_SHAPES["H"], VLM_SHAPES["KV"], VLM_SHAPES["hd"]))
    cases += [("flash_attention_backward", None, check_flash_bwd(
        dtype, gen, dev, B=1, S=1024, H=h, KV=kv, D=hd))
        for h, kv, hd in heads]
    # rmsnorm at 8192 rows of every config's width not held above
    # (paper_demo's 768 is train_cases')
    widths = sorted({get_config(a).d_model for a in ARCHITECTURES}
                    | {ZAMBA_SHAPES["w"]})
    cases += [("rmsnorm_backward", None, check_rmsnorm_bwd(
        dtype, 8192, width, gen, dev)) for width in widths
        if width not in (768, 1024, 3840)]
    return cases


def granite_cases(dtype, gen, dev):
    """Phase 3's cases at granite-4.0-h-small's shapes, tagged for phase
    28's path: rmsnorm at the cell's 32 decode rows of 4096; flash causal
    at 32/8 heads of 128 with the scale 1/128 over the cell's longest
    prompt (3,072); the dense decode at the cell's 32 slots of 4096 KV
    rows (8 heads, G 4) at 1023-4095, scale 1/128; the SSD scan at 128
    heads of (64, 128) over 3,072 rows. Each with its plain version and
    library call as the other configs' cases."""
    g = GRANITE_SHAPES
    H, P, N = g["ssd"]
    tag = "granite_4_0_h_small"
    return [
        ("rmsnorm", tag, check_rmsnorm(dtype, g["slots"], g["d"], gen, dev)),
        ("flash_attention", tag, check_flash(
            dtype, gen, dev, S=g["prompt"], H=g["H"], KV=g["KV"], D=g["hd"],
            scale=g["scale"])),
        ("paged_attention", tag, check_dense_paged(
            dtype, gen, dev, B=g["slots"], L=g["cache"], KV=g["KV"],
            G=g["H"] // g["KV"], hd=g["hd"],
            positions=[int(p) for p in np.linspace(1023, g["cache"] - 1,
                                                   g["slots"] - 1)] + [0],
            scale=g["scale"])),
        ("ssd_scan", tag, check_ssd(dtype, 1, g["prompt"], gen, dev, H=H,
                                    N=N))]


def check_granite_shapes() -> None:
    from repro_torch.configs import get_config
    g, cfg = GRANITE_SHAPES, get_config("granite_4_0_h_small")
    if (cfg.d_model, cfg.padded_heads, cfg.padded_kv_heads,
            cfg.resolved_head_dim, cfg.attn_scale,
            (cfg.ssm_heads, cfg.ssm.head_dim, cfg.ssm.state_dim)) != (
            g["d"], g["H"], g["KV"], g["hd"], g["scale"], g["ssd"]):
        raise AssertionError("GRANITE_SHAPES is not granite-4.0-h-small's")


def phase_kernels(dev, label):
    from repro_torch.kernels import (flash_attention, paged_attention,
                                     rmsnorm, ssd_scan)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("phase 3: kernels vs plain versions; fp32 with TF32 off "
        f"(matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}), "
        f"times on {label}")
    from repro_torch.configs import get_config
    from repro_torch.serve.kv_cache import paged_supported
    for path, shape in FAMILY_SHAPES.items():
        cfg = get_config(path)
        if (cfg.d_model, cfg.padded_heads, cfg.padded_kv_heads,
                cfg.resolved_head_dim) != shape:
            raise AssertionError(f"FAMILY_SHAPES[{path}] is not {cfg.name}'s")
    z, zcfg = ZAMBA_SHAPES, get_config("zamba2_1p2b")
    if (zcfg.d_model, 2 * zcfg.d_model, zcfg.padded_heads,
            zcfg.padded_kv_heads, zcfg.resolved_head_dim,
            (zcfg.ssm_heads, zcfg.ssm.head_dim, zcfg.ssm.state_dim)) != (
            z["d"], z["w"], z["H"], z["KV"], z["hd"], z["ssd"]):
        raise AssertionError("ZAMBA_SHAPES is not zamba2-1.2b's")
    w, wcfg = WHISPER_SHAPES, get_config("whisper_large_v3")
    if (wcfg.d_model, wcfg.padded_heads, wcfg.padded_kv_heads,
            wcfg.resolved_head_dim) != (w["d"], w["H"], w["KV"], w["hd"]):
        raise AssertionError("WHISPER_SHAPES is not whisper-large-v3's")
    vl, vcfg = VLM_SHAPES, get_config("internvl2_26b")
    if (vcfg.d_model, vcfg.padded_heads, vcfg.padded_kv_heads,
            vcfg.resolved_head_dim, vcfg.n_patches + VLM_PROMPT) != (
            vl["d"], vl["H"], vl["KV"], vl["hd"], vl["rows"]):
        raise AssertionError("VLM_SHAPES is not internvl2-26b's")
    check_granite_shapes()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    summary, bad = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        # (kernel, the serving path whose shape the case is, result): the
        # kernels JSON reports each path's case beside its launches
        cases = [
            # rmsnorm at a decode step's 8 rows of each path's width; the
            # unfused paged path (23b) runs paper_demo's rmsnorm and flash
            # shapes, so their cases stand for both paths
            ("rmsnorm", PAPER_PATHS, check_rmsnorm(dtype, 8, 768, gen,
                                                   dev)),
            ("rmsnorm", None, check_rmsnorm(dtype, 512, 768, gen, dev)),
            ("rmsnorm", "mamba2_370m", check_rmsnorm(dtype, 8, 1024, gen,
                                                     dev)),
            ("rmsnorm", None, check_rmsnorm(dtype, 512, 1024, gen, dev)),
            ("flash_attention", PAPER_PATHS, check_flash(dtype, gen, dev)),
            # paper_demo's training step (phase 25b; fp32 there): both
            # kernels forward and backward at its 8 x 1024 rows; 26b's
            # sharded step runs them at each card's rows of the batch
            *train_cases(dtype, gen, dev),
            # phase 27's paths and the backward kernels at every public
            # config's shapes
            *train_family_cases(dtype, gen, dev),
            ("paged_attention", "paper_demo", check_paged("decode", dtype,
                                                          gen, dev)),
            ("paged_attention", None, check_paged("suffix", dtype, gen, dev)),
            ("paged_attention", None, check_paged("decode_full", dtype, gen,
                                                  dev)),
            ("paged_attention", None, check_paged("suffix256", dtype, gen,
                                                  dev)),
            ("ssd_scan", "mamba2_370m", check_ssd(dtype, 1, 512, gen, dev)),
            ("ssd_scan", None, check_ssd(dtype, 1, 509, gen, dev)),
            ("ssd_scan", None, check_ssd(dtype, 4, 256, gen, dev)),
            ("ssd_scan", None, check_ssd(dtype, 1, 64, gen, dev)),
            ("ssd_scan", None, check_ssd(dtype, 1, 2048, gen, dev)),
            # the other dense configs (phases 15-17); flash at head_dim
            # 128 also at 32/8 heads, 512 and 4096 rows
            ("flash_attention", None, check_flash(dtype, gen, dev, S=512,
                                                  H=32, KV=8, D=128)),
            ("flash_attention", None, check_flash(dtype, gen, dev, S=4096,
                                                  H=32, KV=8, D=128)),
            ("flash_attention", "h2o_danube3_4b", check_flash(
                dtype, gen, dev, S=6144, H=32, KV=8, D=120, window=4096))]
        for path, (width, H, KV, hd) in FAMILY_SHAPES.items():
            cases += [("rmsnorm", path, check_rmsnorm(dtype, 8, width, gen,
                                                      dev))]
            if not paged_supported(get_config(path)):
                continue         # danube: dense mode, its flash case above
            # flash at a serve's prompts (512; 768 with a shared prefix),
            # paged at a decode step and a 16-row suffix window
            cases += [("flash_attention", path if S == 512 else None,
                       check_flash(dtype, gen, dev, S=S, H=H, KV=KV, D=hd))
                      for S in (512, 768)]
            cases += [("paged_attention", path if kind == "decode" else None,
                       check_paged(kind, dtype, gen, dev, KV=KV, G=H // KV,
                                   hd=hd))
                      for kind in ("decode", "suffix")]
        # zamba2 (20): rmsnorm at a decode step's 8 rows of the SSM layers'
        # width and of the shared block's; flash at 32/32 heads (G 1) over
        # a prompt of 512 and 2048; the SSD scan at (64, 64), 64 heads
        zp = "zamba2_1p2b"
        H, P, N = z["ssd"]
        cases += [
            ("rmsnorm", zp, check_rmsnorm(dtype, 8, z["d"], gen, dev)),
            ("rmsnorm", None, check_rmsnorm(dtype, 8, z["w"], gen, dev)),
            ("flash_attention", zp, check_flash(dtype, gen, dev, S=512,
                                                H=z["H"], KV=z["KV"],
                                                D=z["hd"])),
            ("flash_attention", None, check_flash(dtype, gen, dev, S=2048,
                                                  H=z["H"], KV=z["KV"],
                                                  D=z["hd"]))]
        cases += [("ssd_scan", zp if T == 512 else None,
                   check_ssd(dtype, 1, T, gen, dev, H=H, N=N))
                  for T in (512, 64, 2048)]
        # whisper-large-v3 (21), at 21b's shapes: rmsnorm at a decode
        # step's 8 rows and at the encoder's 8 clips x 1500 frames; flash
        # non-causal at 32/32 heads of hd 64 with one row a clip against
        # its frames (the cross-attention at the BOS and every step: most
        # of the path's flash launches, so its entry), over the 8 clips'
        # frames (the encoder) and over one clip's. internvl2-26b (22), at
        # 22b's: rmsnorm at a decode step's 4 rows and a prefill's 4 x 1536
        # (and at 8 rows); flash causal at 48/8 heads of hd 128 over the 4
        # prompts of 1536 rows (and over one)
        wp, vp = "whisper_large_v3", "internvl2_26b"
        fw = dict(H=w["H"], KV=w["KV"], D=w["hd"], causal=False)
        fv = dict(S=vl["rows"], H=vl["H"], KV=vl["KV"], D=vl["hd"])
        cases += [
            ("rmsnorm", wp, check_rmsnorm(dtype, w["clips"], w["d"], gen,
                                          dev)),
            ("rmsnorm", None, check_rmsnorm(dtype, w["clips"] * w["frames"],
                                            w["d"], gen, dev)),
            ("flash_attention", wp, check_flash(
                dtype, gen, dev, B=w["clips"], Sq=1, S=w["frames"], **fw)),
            ("flash_attention", None, check_flash(
                dtype, gen, dev, B=w["clips"], S=w["frames"], **fw)),
            ("flash_attention", None, check_flash(dtype, gen, dev,
                                                  S=w["frames"], **fw)),
            ("rmsnorm", vp, check_rmsnorm(dtype, vl["batch"], vl["d"], gen,
                                          dev)),
            ("rmsnorm", None, check_rmsnorm(dtype, vl["batch"] * vl["rows"],
                                            vl["d"], gen, dev)),
            ("rmsnorm", None, check_rmsnorm(dtype, 8, vl["d"], gen, dev)),
            ("flash_attention", vp, check_flash(dtype, gen, dev,
                                                B=vl["batch"], **fv)),
            ("flash_attention", None, check_flash(dtype, gen, dev, **fv))]
        # the dense decode, the paged kernel on a dense cache viewed as
        # pages in place: zamba2's sites (20b's 8 slots of 4096 positions
        # at its prompts' lengths, and the zamba2-longctx cell's 32 slots
        # at 1023-4095), the unfused paged path's gathered view (23b:
        # paper_demo's 8 slots of 1024), whisper's decoder (21b: its
        # self-attention over max_target_len) and internvl2 (22b: past
        # the prompt)
        zh = dict(KV=z["KV"], G=z["H"] // z["KV"], hd=z["hd"])
        cases += [
            ("paged_attention", zp, check_dense_paged(
                dtype, gen, dev, B=8, L=ZAMBA_CACHE,
                positions=[64, 300, 777, 1024, 1500, 2048, 2100, 0], **zh)),
            ("paged_attention", None, check_dense_paged(
                dtype, gen, dev, B=32, L=4096,
                positions=[int(p) for p in np.linspace(1023, 4095, 31)]
                + [0], **zh)),
            ("paged_attention", "paper_demo_unfused", check_dense_paged(
                dtype, gen, dev, B=8, L=1024, KV=4, G=3, hd=64)),
            ("paged_attention", wp, check_dense_paged(
                dtype, gen, dev, B=w["clips"], L=wcfg.max_target_len,
                KV=w["KV"], G=w["H"] // w["KV"], hd=w["hd"],
                positions=list(range(1, 64, 9)) + [0])),
            ("paged_attention", vp, check_dense_paged(
                dtype, gen, dev, B=vl["batch"], L=vl["rows"] + VLM_NEW,
                KV=vl["KV"], G=vl["H"] // vl["KV"], hd=vl["hd"],
                positions=[vl["rows"] + 9, vl["rows"] + 20,
                           vl["rows"] + 31, 0]))]
        cases += granite_cases(dtype, gen, dev)
        report_cases(cases, dtype, summary, bad)
    if bad:
        raise AssertionError("kernels that disagree with their plain "
                             "versions:\n" + "\n".join(bad))
    log("kernels: " + json.dumps({
        "rmsnorm": rmsnorm.LAUNCHES, "flash_attention":
        flash_attention.LAUNCHES, "paged_attention":
        paged_attention.LAUNCHES, "ssd_scan": ssd_scan.LAUNCHES,
        "rmsnorm_backward": rmsnorm.BACKWARD_LAUNCHES,
        "flash_attention_backward": flash_attention.BACKWARD_LAUNCHES,
        "ssd_scan_backward": ssd_scan.BACKWARD_LAUNCHES}))
    return summary


def report_cases(cases, dtype, summary, bad) -> None:
    """Log each of phase 3's ``(kernel, path, result)`` cases in ``dtype``,
    append those out of tolerance to ``bad``, and file each path's case
    under ``summary[kernel, path]``."""
    for name, path, r in cases:
        tol = TOL[dtype]
        ok = r.get("err_y", r["err"]) <= tol \
            and r.get("err_state", 0.0) <= STATE_TOL \
            and r.get("pools_exact", True) and r.get("bit_equal", True)
        lib = r["library_ms"]
        log(f"  {name:16s} {str(dtype):15s} {r['shape']}: max_abs_err "
            + (f"y {r['err_y']:.3g} (tol {tol:g}), final state "
               f"{r['err_state']:.3g} (tol {STATE_TOL:g})"
               if "err_y" in r else f"{r['err']:.3g} (tol {tol:g})")
            + (f" vs the plain version in fp32 (vs it in bf16 "
               f"{r['low']['err_bf16']:.3g}; the bf16 plain version vs "
               f"the fp32 one {r['low']['plain_err']:.3g})"
               if r.get("low") else "")
            + (f" pools_exact={r['pools_exact']}"
               if "pools_exact" in r else "")
            + f" | kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
            + (f", library {lib:.4f} ms (kernel/library "
               f"{r['ms'] / lib:.2f}x)" if lib is not None else "")
            + f", bound {r['bound'][0]:.5f} ms ({r['bound'][1]}"
            + (f", {r['bound'][0] / r['ms']:.1%} of it"
               if name in BACKWARD_NAMES else "") + ")"
            + (f", scratch {r['scratch_bytes'] / 1e6:.1f} MB, "
               f"{r['splits']} head-slice(s) a group, a second call "
               f"bit-equal: {r['bit_equal']}"
               if "scratch_bytes" in r else "")
            + (f", a second call bit-equal: {r['bit_equal']}"
               if name == "rmsnorm_backward" else "")
            + (" | device time (torch.profiler, median of "
               f"{TIMED_RUNS}): kernel {r['device'][0]:.4f} ms, library "
               f"{r['device'][1]:.4f} ms (kernel/library "
               f"{r['device'][0] / r['device'][1]:.2f}x)"
               if "device" in r else "")
            + (" | device time by grid: " + ", ".join(
                f"{re.search(r'ssd_\w+', n).group(0)} {t:.4f} ms"
                for n, t in r["grids"].items()) if "grids" in r else "")
            + (" | each output's max abs error: " + ", ".join(
                f"{n} {e:.3g}" for n, e in r["grads"].items())
               + " (the error above is each over max(1, its largest "
               "|plain|))" if "grads" in r else "")
            + (f" | SDPA backward alone {r['sdpa_bwd_ms']:.4f} ms "
               f"(kernel/SDPA backward {r['ms'] / r['sdpa_bwd_ms']:.2f}x)"
               f", {r['splits']} split(s) of the dK/dV grid, a second "
               f"call bit-equal: {r['bit_equal']}"
               if "sdpa_bwd_ms" in r else ""))
        if not ok:
            bad.append(f"{name} {dtype} {r['shape']}: {r}")
        # the JSON line reports each path's run in its dtype (bf16 for
        # serving, fp32 for training) at its shape: a decode step's for
        # rmsnorm and paged, a prompt's for flash (whisper's: a decode
        # step's cross-attention) and the SSD scan, the training step's
        for one in (path if isinstance(path, tuple) else (path,)):
            if one and (dtype is torch.float32) == (one in FP32_PATHS):
                summary[name, one] = r


def phase_graph_edges(dev):
    """Whether programmatic dependent launch survives stream capture: one
    paged decode call (split, then merge as a dependent launch) and one
    SSD scan (three grids chained so) captured into a CUDA graph that is
    kept, so the driver's ``cuGraphGetEdges_v2`` can list its edges; the
    replay's outputs must equal the eager calls' bit for bit."""
    import ctypes
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ssd_scan as SSD
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    (q, kn, vn, kp, vp, tab, pos, nv), _, _, _, _ = paged_case(
        "decode", torch.bfloat16, gen, dev)
    ssd_args = ssd_inputs(gen, dev, 1, 512, torch.bfloat16)

    def calls():
        # the paged call rewrites the same pool rows with the same values
        out, _, _ = PA.paged_attention(q, kn, vn, kp, vp, tab, pos, nv,
                                       page_size=16)
        return (out,) + SSD.ssd_scan(*ssd_args, return_state=True)

    want = [t.clone() for t in calls()]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        got = calls()
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("graph replay of the paged and SSD kernels "
                             "differs from their eager calls")
    get_edges = ctypes.CDLL("libcuda.so.1").cuGraphGetEdges_v2
    get_edges.restype = ctypes.c_int
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if get_edges(handle, None, None, None, ctypes.byref(n)) != 0:
        raise AssertionError("cuGraphGetEdges_v2 failed")
    src, dst = (ctypes.c_void_p * n.value)(), (ctypes.c_void_p * n.value)()
    # CUgraphEdgeData: from_port, to_port, type, 5 reserved bytes
    data = (ctypes.c_uint8 * (8 * n.value))()
    if get_edges(handle, src, dst, data, ctypes.byref(n)) != 0:
        raise AssertionError("cuGraphGetEdges_v2 failed")
    kinds: dict = {}
    for i in range(n.value):
        key = ("programmatic" if data[8 * i + 2] == 1 else "full",
               data[8 * i])
        kinds[key] = kinds.get(key, 0) + 1
    programmatic = sum(c for (kind, _), c in kinds.items()
                       if kind == "programmatic")
    log(f"phase 3g: programmatic dependent launch under stream capture: "
        f"{programmatic} programmatic of {n.value} edges in a graph of one "
        f"paged decode call and one SSD scan (edge kind, from-port: "
        f"{ {f'{k}/{p}': c for (k, p), c in sorted(kinds.items())} }); "
        "replay bit-equal to the eager calls")
    return programmatic


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
    from repro_torch.serve import (Request, ServeClient, ServeEngine,
                                   greedy_generate)
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
    replays = eng._decode_graph.replays
    eng.shutdown()
    wants = [greedy_generate(cfg, params, p[None], 16, 256,
                             device=dev)[0].tolist() for p in prompts]
    checked = check_identity("fp32 identity", cfg, params, prompts, reqs,
                             wants)
    if m["prefix_hits"] < 1 or m["pages_in_use"] != 0 \
            or replays != m["steps"]:
        raise AssertionError(f"fp32 identity run: {dict(m)}, {replays} "
                             "graph replays")
    log(f"phase 4: fp32 identity OK: 4 requests, {checked}/64 tokens "
        f"compared (the rest past a near tie), prefix_hits "
        f"{m['prefix_hits']}, {replays} decode steps, each one graph "
        "replay")

    # speculative verify: repetitive prompts, so the n-gram drafter's
    # guesses are accepted; the tokens must still be greedy's
    motifs = [rng.integers(0, cfg.vocab_size, n) for n in (4, 7, 16)]
    spec_prompts = [np.tile(mo, -(-96 // len(mo)))[:96] for mo in motifs] \
        + [rng.integers(0, cfg.vocab_size, 80)]
    eng = ServeEngine(cfg, params, device=dev, max_batch=4, page_size=16,
                      max_seq_len=256, speculate=SPECULATE)
    sreqs = [Request(p, 32) for p in spec_prompts]
    for r in sreqs:
        eng.submit(r)
    eng.close_intake()
    eng.run(timeout=300)
    sm = eng.metrics()
    replays = eng._verify_graph.replays
    eng.shutdown()
    swants = [greedy_generate(cfg, params, p[None], 32, 256,
                              device=dev)[0].tolist() for p in spec_prompts]
    checked = check_identity("fp32 speculative identity", cfg, params,
                             spec_prompts, sreqs, swants)
    if sm["draft_accepted"] <= 0 or sm["pages_in_use"] != 0 \
            or replays != sm["verify_steps"]:
        raise AssertionError(f"fp32 speculative run: {dict(sm)}, "
                             f"{replays} graph replays")
    log(f"phase 4: fp32 speculative identity OK (speculate={SPECULATE}): 4 "
        f"requests, {checked}/128 tokens compared, {sm['verify_steps']} verify "
        f"steps (graph replays), drafts accepted {sm['draft_accepted']} "
        f"of {sm['draft_proposed']}")

    # ServeClient: its loop thread replays the graphs this thread captured
    with ServeClient(cfg, params, device=dev, max_batch=4, page_size=16,
                     max_seq_len=256) as client:
        streams = [client.generate(p, max_tokens=16) for p in prompts]
        streamed = [list(st) for st in streams]
    checked = 0
    for p, r, got in zip(prompts, reqs, streamed):
        n = near_tie_prefix(cfg, params, p, r.tokens)
        if got[:n] != r.tokens[:n]:
            raise AssertionError(f"ServeClient streamed {got} != engine "
                                 f"{r.tokens} within {n} tokens")
        checked += n
    log(f"phase 4: ServeClient OK: 4 streams from its loop thread, "
        f"{checked}/64 tokens equal to the engine's")
    # the oracles phases 13a and 14a hold the disaggregated server and the
    # router to
    return dict(cfg=cfg, params=params, prompts=prompts, n=16,
                colocated=[r.tokens for r in reqs], greedy=wants,
                spec_prompts=spec_prompts, spec_n=32,
                spec_colocated=[r.tokens for r in sreqs], spec_greedy=swants)


def check_identity(what, cfg, params, prompts, reqs, wants) -> int:
    """Each request's tokens equal its oracle's up to the oracle's first
    near tie; returns the number of tokens compared."""
    checked = 0
    for p, r, want in zip(prompts, reqs, wants):
        n = near_tie_prefix(cfg, params, p, want)
        if r.tokens[:n] != want[:n]:
            raise AssertionError(f"{what}: engine {r.tokens} != greedy "
                                 f"{want} within {n} tokens")
        checked += n
    return checked


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


def decode_step_times(eng, split: bool = False) -> dict:
    """One paged decode step with all 8 slots live at mixed positions,
    eager (``_decode_fn`` on its own tensors) and replayed (the engine's
    step graph, its static buffers filled with the same inputs): the
    card's time by events (a sleep kernel ahead keeps host gaps out) and
    the host's enqueue time of each; with ``split``, the eager step's
    card busy time by kernel family (``busy_ms``). Run on an idle engine:
    the steps write pages no request holds."""
    S = eng.max_batch
    pos = torch.as_tensor([64 + 100 * i for i in range(S)], dtype=torch.int32,
                          device=eng.device)
    nv = torch.ones(S, dtype=torch.int32, device=eng.device)
    pages = torch.randperm(eng.pool.total_pages)[:S * eng.max_pages]
    tables = pages.view(S, eng.max_pages).to(torch.int32).to(eng.device)
    toks = torch.zeros((S, 1, 1), dtype=torch.int32, device=eng.device)
    eng._meta[:S].copy_(pos)
    eng._meta[S:2 * S].copy_(nv)
    eng._tables_dev[:, :eng.max_pages].copy_(tables)

    def eager():
        if eng.fused:
            eng._decode_fn(eng.params, eng.pool.arrays, toks, pos, tables, nv)
        else:
            eng._decode_fn(eng.params, eng.pool.arrays, toks, pos, tables)
    graph = eng._decode_graph
    return dict(eager_ms=median_ms(eager, runs=20),
                graph_ms=median_ms(graph, runs=20),
                eager_enqueue_ms=enqueue_ms(eager),
                graph_enqueue_ms=enqueue_ms(graph),
                busy=busy_ms(eager, by_name=True) if split else None)


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
    """5: ``paper_demo``'s bf16 serve, paged and fused; the shared prefix
    must hit."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config("paper_demo")
    params = lm.init_params(cfg, seed=0, device=dev)
    work = serve_workload(cfg, np.random.default_rng(2))
    launches, host_ms, d = family_serve("5", cfg, params, dev, work,
                                        serve_engine, label)
    if d["prefix_hits"] <= 0:
        raise AssertionError("bf16 serve: the shared prefix never hit")
    return cfg, params, launches, host_ms, d


def serve_engine(cfg, params, dev, speculate=0, fused=None):
    from repro_torch.serve import ServeEngine
    return ServeEngine(cfg, params, device=dev, max_batch=8, page_size=16,
                       max_seq_len=1024, max_inflight=2, speculate=speculate,
                       fused=fused)


def spec_engine(cfg, params, dev):
    return serve_engine(cfg, params, dev, speculate=SPECULATE)


def spec_workload(cfg, rng):
    """16 requests: 8 prompts that repeat a motif of 4–16 tokens (where
    prompt lookup drafts well) and 8 random ones, 64–256 tokens; 32–128
    new tokens each."""
    reqs = []
    for i in range(16):
        n = int(rng.integers(64, 257))
        if i % 2 == 0:
            motif = rng.integers(0, cfg.vocab_size, rng.integers(4, 17))
            prompt = np.tile(motif, -(-n // len(motif)))[:n]
        else:
            prompt = rng.integers(0, cfg.vocab_size, n)
        reqs.append((prompt, int(rng.integers(32, 129))))
    return reqs


def serve_timed(eng, work):
    """Serve ``work`` under sync debug mode "error" on a warm engine;
    returns (requests, wall seconds)."""
    from repro_torch.serve import Request, RequestState
    warm_up(eng, work)                   # outside the timing
    reqs = [Request(p, n) for p, n in work]
    wall = serve_checked(eng, reqs)
    if not all(r.req_state is RequestState.FINISHED for r in reqs) or any(
            len(r.tokens) != n for r, (_, n) in zip(reqs, work)):
        raise AssertionError("serve: not every request finished its budget")
    if eng.metrics()["pages_in_use"] != 0:
        raise AssertionError("serve: pages left in use")
    return reqs, wall


def phase_spec_serve(cfg, params, dev, label):
    """bf16 speculative serving (5s) beside the plain engine on the same
    requests, same host."""
    from repro_torch.core import TensorOp
    work = spec_workload(cfg, np.random.default_rng(6))
    rows = {}
    spec = f"speculate={SPECULATE}"
    for name, make in (("plain", serve_engine), (spec, spec_engine)):
        eng = make(cfg, params, dev)
        steps0, dispatch0 = eng.stats["steps"], eng.stats["dispatch_s"]
        TensorOp.PENDING_AT_FIRST_POLL = 0
        reqs, wall = serve_timed(eng, work)
        steps = eng.stats["steps"] - steps0
        n_tokens = sum(len(r.tokens) for r in reqs)
        rows[name] = (reqs, n_tokens / wall, steps, eng.stats["dispatch_s"]
                      - dispatch0, dict(eng.metrics()))
        eng.shutdown()
        log(f"phase 5s: bf16 {name} serve on {label}: 16 requests (8 "
            f"repetitive prompts), {n_tokens} tokens in {wall:.3f} s = "
            f"{n_tokens / wall:.1f} tokens/s; TTFT {ttft_ms(reqs)}; {steps} "
            f"steps, host enqueue {rows[name][3] / max(steps, 1) * 1e3:.3f} "
            f"ms a step (mean), {n_tokens / max(steps, 1):.2f} tokens/step; "
            f"PENDING_AT_FIRST_POLL {TensorOp.PENDING_AT_FIRST_POLL}")
    m = rows[spec][4]
    rate = m["draft_accepted"] / max(m["draft_proposed"], 1)
    log(f"phase 5s: {spec}: {m['verify_steps']} verify steps, drafts "
        f"accepted {m['draft_accepted']} of {m['draft_proposed']} "
        f"proposed (acceptance rate {rate:.3f}), {m['spec_tokens']} tokens "
        f"from verify steps; tokens/s {rows[spec][1]:.1f} against "
        f"{rows['plain'][1]:.1f} plain")
    if m["verify_steps"] <= 0 or m["draft_accepted"] <= 0:
        raise AssertionError(f"speculative serve accepted no draft: {m}")


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
                     phase="5b"):
    """The loop must run ahead of the card when the card is the slower
    side. A sleep kernel queued ahead of every decode (or verify) step's
    graph replay, on the same stream, holds the card for several times
    the host's enqueue of a step; then every step but a host hiccup's
    worth must still be running at its op's first poll."""
    from repro_torch.core import TensorOp
    from repro_torch.serve import Request, RequestState
    eng = (make_engine or serve_engine)(cfg, params, dev)
    sleep_ms = max(50.0, 4 * host_ms)
    cycles = int(sleep_ms * sleep_cycles_per_ms())
    attr = "_verify_graph" if eng.speculate else "_decode_graph"
    replay = getattr(eng, attr)

    def held_step():
        torch.cuda._sleep(cycles)
        return replay()

    setattr(eng, attr, held_step)
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
        f"sleep queued ahead of each {attr[1:-6]} step's graph replay, host "
        f"enqueue {step_host_ms:.3f} ms a step (mean) against "
        f"{host_ms:.3f} ms with no sleep; {steps} steps in "
        f"{wall * 1e3:.1f} ms wall; PENDING_AT_FIRST_POLL {pending} of "
        f"{steps} steps")
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


FAMILIES = [("flash_attention backward", ("flash_bwd",)),
            ("rmsnorm backward", ("rmsnorm_bwd",)),
            ("ssd_scan backward", ("ssd_bwd",)),
            ("paged_attention", ("paged_attn",)),
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
    # a session now and then delivers no device events: up to three
    # windows, while the workload lasts
    for _ in range(3):
        steps0 = eng.stats["steps"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.run(until=lambda: eng.idle or
                    eng.stats["steps"] >= steps0 + window_steps,
                    timeout=300)
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        steps = eng.stats["steps"] - steps0
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
        if busy_us > 0 or eng.idle:
            break
    eng.run(timeout=600)
    eng.shutdown()
    if busy_us <= 0 or steps <= 0:
        raise AssertionError(f"profile: {steps} decode steps and "
                             f"{busy_us:.0f} us of device time in the "
                             "traced window")
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
    """8: ``mamba2_370m``'s bf16 serve in dense mode (the SSD kernel once a
    layer a prefill), then the eager decode step and a 512-token prefill
    timed on the idle engine."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config("mamba2_370m")
    if cfg.n_layers != MAMBA_LAYERS:
        raise AssertionError("mamba2_370m is not at full depth")
    params = lm.init_params(cfg, seed=0, device=dev)
    work = mamba_workload(cfg, np.random.default_rng(5))

    def eager_timings(eng, _card_ms):
        prompt = torch.as_tensor(np.resize(work[1][0], 512)[None],
                                 dtype=torch.int32, device=dev)
        slot0 = {name: t[:, :1] for name, t in eng._cache.items()}

        def prefill():
            lm.lm_prefill(eng.params, {"tokens": prompt}, cfg, slot0)

        # events around an eager call of ~2,500 (decode) or ~1,500
        # (prefill) launches time the host past the launch queue's depth;
        # the profiler's kernel sums give the card's busy time
        step_ev = median_ms(eng._dense_step, runs=10)
        eager_enq = enqueue_ms(eng._dense_step)
        prefill_ev = median_ms(prefill, runs=10)
        prefill_ms, prefill_split = busy_ms(prefill)
        log(f"phase 8: eager decode step on the idle engine: host enqueue "
            f"{eager_enq:.3f} ms (median of 10), {step_ev:.3f} ms by events "
            f"(the host's pace); one 512-token prefill (eager): card busy "
            f"{prefill_ms:.3f} ms (kernel sum), {prefill_ev:.3f} ms by "
            "events; its card busy by kernel family: " + ", ".join(
                f"{fam} {share:.1%}" for fam, share in prefill_split.items()))

    launches, host_ms, _ = family_serve("8", cfg, params, dev, work,
                                        mamba_engine, label,
                                        extra=eager_timings)
    return cfg, params, launches, host_ms


# ------------------------------------------------------- the paper's apps
APP_RANKS = 4
FP64_TC_PEAK = 67e12       # H100 SXM data sheet, dense FP64 tensor core
CHOLESKY_TOL = 1e-10


def app_timed(fn):
    """``fn()`` under sync debug mode "error" (a call that makes the host
    wait for the card raises, in any rank thread); the wall time by the
    host's clock, the card drained before the start and at the end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def app_busy(fn):
    """One run of ``fn`` under ``torch.profiler``: the share of its wall
    time in which the card ran at least one kernel or copy (the union of
    their spans: the ranks' streams overlap), and the device op count. A
    session now and then delivers no device events: up to three runs."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if spans:
            break
    else:
        raise AssertionError("app profile: no device events in 3 runs")
    busy, start, end = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > end:
            busy += end - start
            start, end = s, e
        else:
            end = max(end, e)
    busy += end - start
    return busy / wall_us, len(spans)


def mib(n_bytes: float) -> str:
    return f"{n_bytes / 2 ** 20:.1f} MiB"


def peak_start() -> int:
    """Start a phase's peak-memory window; returns what is allocated."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_note(start: int) -> str:
    peak = torch.cuda.max_memory_allocated()
    return (f"peak device memory {mib(peak - start)} above the "
            f"{mib(start)} allocated when the phase began")


def cuda_mallocs() -> int:
    """Segments the caching allocator has taken from ``cudaMalloc`` so
    far. A ``cudaMalloc`` can wait for the card (sync debug mode does not
    see it), so a timed run should add none once warm."""
    return torch.cuda.memory_stats().get("segment.all.allocated", 0)


def phase_zones(dev, label):
    """BT-MZ analogue (paper Fig. 2/3): class B's 64 zones, 20x width
    spread, 4 rank threads, both variants against the single-rank
    reference on the card, bit for bit, and that against the CPU."""
    from repro_torch.core import TensorOp
    from repro_torch.zones import solver
    steps, iters = 30, 2
    t_phase = time.perf_counter()
    start = peak_start()
    zones = solver.make_zones(64, 1024, 256, max_ratio=20.0, seed=3,
                              device=dev)
    widths = [z.shape[0] for z in zones]
    points = sum(z.numel() for z in zones)
    t0 = time.perf_counter()
    cpu = solver.reference_solve([z.cpu() for z in zones], 2, iters)
    cpu_s = time.perf_counter() - t0
    if not all(torch.equal(a.cpu(), b) for a, b in
               zip(solver.reference_solve(zones, 2, iters), cpu)):
        raise AssertionError("zones: the card's reference_solve differs "
                             "from the CPU's at 2 timesteps")
    want = solver.reference_solve(zones, steps, iters)

    def solve(variant, n_steps=steps):
        return solver.distributed_solve(zones, APP_RANKS, n_steps, variant,
                                        iters)

    best, slowest, sends = {}, 0.0, 0
    for variant in ("fork_join", "continuations"):
        walls = []
        for _ in range(3):
            TensorOp.PENDING_AT_FIRST_POLL = 0
            mallocs = cuda_mallocs()
            (out, _), wall = app_timed(lambda: solve(variant))
            mallocs = cuda_mallocs() - mallocs
            if not all(torch.equal(a, b) for a, b in zip(out, want)):
                raise AssertionError(f"zones {variant}: not bit-identical "
                                     "to reference_solve")
            walls.append(wall)
        best[variant] = min(walls)
        slowest = max(slowest, *walls)
        pending = TensorOp.PENDING_AT_FIRST_POLL
        sends = 2 * len(zones) * steps
        log(f"phase 10: zones {variant} on {label}: "
            f"{best[variant] / steps * 1e6:.1f} us per timestep (best of "
            f"3; runs " + ", ".join(f"{w / steps * 1e6:.1f}" for w in walls)
            + f"; {steps} timesteps, smooth_iters {iters}, {APP_RANKS} "
            f"ranks, sync debug mode \"error\"); bit-identical to "
            f"reference_solve; last run: halo sends pending at first poll "
            f"{pending} of {sends}, {mallocs} cudaMalloc segments")
    # the same work on one rank thread, and with no messages at all:
    # what the ranks' sharing of one interpreter costs
    one = {v: app_timed(lambda: solver.distributed_solve(
        zones, 1, steps, v, iters))[1] for v in best}
    t0 = time.perf_counter()
    solver.reference_solve(zones, steps, iters)
    ref_host = time.perf_counter() - t0
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    log(f"phase 10: zones on 1 rank: " + ", ".join(
        f"{v} {w / steps * 1e6:.1f}" for v, w in one.items())
        + f" us per timestep; single-thread reference_solve "
        f"{ref_wall / steps * 1e6:.1f} us per timestep "
        f"({ref_host / steps * 1e6:.1f} us of it to enqueue)")
    busy = {v: app_busy(lambda: solve(v)) for v in best}
    log(f"phase 10: zones: {len(zones)} zones of {min(widths)}-"
        f"{max(widths)} rows x 1024, {points:,} points, "
        f"{mib(points * 8)} of fp64 state; fork_join / continuations = "
        f"{best['fork_join'] / best['continuations']:.3f}; card busy "
        + ", ".join(f"{v} {b:.1%} ({n} device ops)"
                    for v, (b, n) in busy.items())
        + f"; {peak_note(start)}; CPU reference_solve (2 timesteps) "
        f"{cpu_s:.1f} s")

    # the card made the slower side: a sleep kernel ahead of every zone
    # update, on the rank's stream; halo sends must still be running at
    # their first poll (all but timestep 0's, which no update precedes),
    # and still deliver the right halos
    # the host's time for one zone update, all ranks sharing the
    # interpreter, at the slowest of the timed runs (the host's pace
    # varies up to 2x within one process). A rank's host cycle for one of
    # its zones (the update, then its two sends, while three other ranks
    # share the interpreter) takes 3-5x that, and each rank's stream holds
    # a quarter of the zones, so a sleep of 16x makes the card the slower
    # side by 3x or more; at 8x the fastest run's pace a rank's stream could
    # drain before its send loop ended.
    sleep_steps = 4
    host_ms = slowest / (steps * len(zones)) * 1e3
    sleep_ms = max(1.0, 16 * host_ms)
    cycles = int(sleep_ms * sleep_cycles_per_ms())
    per_rank = -(-len(zones) // APP_RANKS)
    plain_smooth = solver._smooth

    def held_smooth(*args):
        torch.cuda._sleep(cycles)
        return plain_smooth(*args)

    want4 = solver.reference_solve(zones, sleep_steps, iters)
    solver._smooth = held_smooth
    try:
        for variant in ("fork_join", "continuations"):
            TensorOp.PENDING_AT_FIRST_POLL = 0
            (out, _), wall = app_timed(lambda: solve(variant, sleep_steps))
            pending = TensorOp.PENDING_AT_FIRST_POLL
            sends = 2 * len(zones) * sleep_steps
            behind = 2 * len(zones) * (sleep_steps - 1)
            log(f"phase 10: zones {variant}, {sleep_ms:.2f} ms sleep "
                f"ahead of each zone update (host {host_ms:.3f} ms an "
                f"update in the slowest timed run): {wall * 1e3:.1f} ms "
                f"for {sleep_steps} "
                f"timesteps; halo sends pending at first poll {pending} "
                f"of {sends} ({behind} posted behind a zone update)")
            if not all(torch.equal(a, b) for a, b in zip(out, want4)):
                raise AssertionError(f"zones {variant} with sleeps: wrong "
                                     "halos delivered")
            if wall * 1e3 < 0.9 * sleep_steps * per_rank * sleep_ms:
                raise AssertionError(f"zones {variant} with sleeps: the "
                                     "card was not the slower side")
            if pending < 0.9 * behind:
                raise AssertionError(
                    f"zones {variant} with sleeps: only {pending} of the "
                    f"{behind} halo sends posted behind a zone update "
                    "were pending at their first poll")
    finally:
        solver._smooth = plain_smooth
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s")


def phase_cholesky(dev, label):
    """PaRSEC-style tiled Cholesky (paper Fig. 6): 16 x 16 tiles of 512
    in fp64, 4 rank threads, both backends, L against
    ``torch.linalg.cholesky`` on the card."""
    from repro_torch.dataflow import (ContinuationBackend, TestsomeBackend,
                                      assemble_result, build_cholesky_graph,
                                      make_spd_matrix, potrf_failures,
                                      run_dataflow)
    nb, tile = 16, 512
    n = nb * tile
    t_phase = time.perf_counter()
    start = peak_start()
    A = make_spd_matrix(n, seed=5, device=dev)
    want = torch.linalg.cholesky(A)
    scale = float(want.abs().max())
    setup = torch.cuda.max_memory_allocated() - start
    run_peak = 0
    backends = {"continuations": lambda eng: ContinuationBackend(eng),
                "testsome_w4": lambda eng: TestsomeBackend(4)}
    best = {}
    for name, factory in backends.items():
        for _ in range(3):
            graph, meta = build_cholesky_graph(A, nb, tile, APP_RANKS)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            (tiles, stats), wall = app_timed(
                lambda: run_dataflow(graph, factory, timeout=300))
            run_peak = max(run_peak, torch.cuda.max_memory_allocated()
                           - base)
            err = float((assemble_result(tiles, meta) - want).abs().max())
            fails = potrf_failures(meta)
            if err / scale > CHOLESKY_TOL or fails \
                    or stats["executed"] != len(graph.tasks):
                raise AssertionError(
                    f"cholesky {name}: max |dL| / max |L| = "
                    f"{err / scale:.3e}, {fails} POTRF failures, "
                    f"{stats['executed']} of {len(graph.tasks)} tasks")
            del tiles
            if name not in best or wall < best[name][0]:
                best[name] = (wall, stats["mean_activation_latency"],
                              err / scale)
        wall, lat, rel = best[name]
        rate = n ** 3 / 3 / wall
        log(f"phase 11: cholesky {name} on {label}: N {n}, {nb}x{nb} tiles "
            f"of {tile}, {len(graph.tasks)} tasks, {APP_RANKS} ranks: "
            f"makespan {wall * 1e3:.1f} ms (best of 3, sync debug mode "
            f"\"error\"), mean activation latency {lat * 1e6:.1f} us, "
            f"{rate / 1e12:.3f} TFLOP/s fp64 = {rate / FP64_TC_PEAK:.2%} "
            f"of the {FP64_TC_PEAK / 1e12:.0f} TFLOP/s fp64 tensor-core "
            f"peak; max |dL| / max |L| {rel:.2e}, every POTRF info 0")
    busy = {}
    for name, factory in backends.items():
        graph, _ = build_cholesky_graph(A, nb, tile, APP_RANKS)
        busy[name] = app_busy(
            lambda: run_dataflow(graph, factory, timeout=300))
    log(f"phase 11: cholesky: testsome_w4 / continuations makespan = "
        f"{best['testsome_w4'][0] / best['continuations'][0]:.3f}; card "
        "busy " + ", ".join(f"{k} {b:.1%} ({m} device ops)"
                            for k, (b, m) in busy.items())
        + f"; peak device memory of a run {mib(run_peak)} above what was "
        f"allocated before it (every tile version); setting up A and its "
        f"reference L peaked at {mib(setup)}; "
        f"{time.perf_counter() - t_phase:.1f} s")


def phase_offload(dev, label):
    """ExaHyPE-style offload (paper Fig. 8/9): 4 ranks, 8 iterations,
    3 ms tasks, rank 0 with 6x the load; both backends and no
    offloading. Every result must be ``payload * 2 + 1``."""
    from repro_torch.runtime.offload import run_offload
    t_phase = time.perf_counter()
    start = peak_start()
    runs = {"no_offloading": dict(offloading=False),
            "continuations": dict(backend="continuations"),
            "testsome": dict(backend="testsome")}
    walls = {}
    for name, kw in runs.items():
        out, wall = app_timed(lambda: run_offload(device=dev, **kw))
        tasks = out["tasks"]
        got = torch.stack([t.result for t in tasks])
        ref = torch.stack([t.payload for t in tasks]) * 2 + 1
        if len(tasks) != 8 * (6 * 8 + 3 * 8) or not torch.equal(got, ref):
            raise AssertionError(f"offload {name}: wrong results")
        walls[name] = wall
        log(f"phase 12: offload {name} on {label}: wall {wall * 1e3:.1f} "
            f"ms, {out['offloaded']} tasks offloaded, critical-path wait "
            f"{out['wait_critical'] * 1e3:.2f} ms, {len(tasks)} results "
            "equal payload * 2 + 1 (sync debug mode \"error\")")
    busy, ops = app_busy(lambda: run_offload(iters=8, device=dev))
    log(f"phase 12: offload: no_offloading / continuations = "
        f"{walls['no_offloading'] / walls['continuations']:.3f}, "
        f"no_offloading / testsome = "
        f"{walls['no_offloading'] / walls['testsome']:.3f}; card busy "
        f"{busy:.2%} of a continuations run ({ops} device ops); "
        f"{peak_note(start)}; {time.perf_counter() - t_phase:.1f} s")


# -------------------------------------------- disaggregated serving, router
DISAGG_CHUNKS = (1, 8)     # chunk_pages of the bf16 runs (13b)
# the sleep ahead of each prefill chunk (13c): 4x the slowest host time
# per chunk seen in 13b (7.5-14.9 ms), so that a host running at half
# its usual pace still posts each block behind its chunk's sleep
CHUNK_SLEEP_MS = 60.0


def serve_checked(tier, reqs, until=None) -> float:
    """Submit ``reqs`` to a serving tier (engine, disaggregated server or
    router), close its intake and run it to the end under sync debug mode
    "error"; returns the wall seconds, the card drained at both ends.
    ``until()`` may end a first stretch of the run early (the caller
    then acts and calls ``tier.run`` itself, still under the mode)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        tier.submit(r)
    tier.close_intake()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tier.run(timeout=600, until=until)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def warm_up(tier, work) -> None:
    """Two requests of ``work`` (4 tokens each) through ``tier``: the
    first launches of each shape and the allocator's first blocks come
    before the counted run."""
    from repro_torch.serve import Request
    n = len(tier.retired)
    for prompt, _ in work[:2]:
        tier.submit(Request(prompt, 4))
    tier.run(until=lambda: len(tier.retired) == n + 2, timeout=300)


def disagg_drained(srv) -> bool:
    return (srv.decode.pool.pages_in_use == 0
            and srv.prefill.pool.pages_in_use == 0)


def install_before_done(srv, reqs) -> bool:
    """Each request's first KV block was installed at the decode role
    before the prefill role finished its prompt."""
    ev = srv.events
    return all(ev.index(("install", r.req_id, 0))
               < ev.index(("prefill_done", r.req_id)) for r in reqs)


def phase_disagg_identity(dev, ident):
    """13a: fp32 ``paper_demo`` at full width through ``DisaggServer`` at
    chunk_pages 1 and 4, and with speculative verify: phase 4's requests,
    held to phase 4's oracles (greedy and the colocated engine)."""
    from repro_torch.serve import DisaggServer, Request
    cfg, params = ident["cfg"], ident["params"]
    plain = (ident["prompts"], ident["n"], ident["colocated"],
             ident["greedy"])
    spec = (ident["spec_prompts"], ident["spec_n"],
            ident["spec_colocated"], ident["spec_greedy"])
    tokens = {}
    for name, kw, (prompts, n, colo, greedy) in (
            ("chunk_pages=1", dict(chunk_pages=1), plain),
            ("chunk_pages=4", dict(chunk_pages=4), plain),
            (f"speculate={SPECULATE}", dict(speculate=SPECULATE), spec)):
        srv = DisaggServer(cfg, params, device=dev, max_batch=4,
                           page_size=16, max_seq_len=256, **kw)
        reqs = [Request(p, n) for p in prompts]
        serve_checked(srv, reqs)
        checked = check_identity(f"13a disagg {name} vs greedy", cfg,
                                 params, prompts, reqs, greedy)
        checked_colo = check_identity(f"13a disagg {name} vs colocated",
                                      cfg, params, prompts, reqs, colo)
        m = srv.metrics()
        dm = srv.decode.metrics()
        if not install_before_done(srv, reqs) or not disagg_drained(srv):
            raise AssertionError(f"13a {name}: a block installed after its "
                                 "prompt's prefill finished, or pages left "
                                 f"in use: {srv.events}")
        if kw.get("speculate") and dm["draft_accepted"] <= 0:
            raise AssertionError(f"13a {name}: no draft accepted")
        log(f"phase 13a: fp32 disagg {name} OK: {len(reqs)} requests, "
            f"{checked}/{n * len(reqs)} tokens equal to greedy and "
            f"{checked_colo} to the colocated engine (up to the first near "
            f"tie); {m['blocks_shipped']} blocks shipped, "
            f"{srv.prefill.stats['chunks']} chunks, first install before "
            "prefill_done for every request, both pools drained"
            + (f"; drafts accepted {dm['draft_accepted']} of "
               f"{dm['draft_proposed']}" if kw.get("speculate") else ""))
        tokens[name] = [r.tokens for r in reqs]
        srv.shutdown()
    return tokens


def stream_overlap(prepare, markers: int = 3):
    """The share of a profiled run's wall time in which the card ran
    anything, in which a given stream ran kernels, in which other streams
    did, and in which both did at once. ``prepare()`` builds what is run
    (outside the profiler) and returns ``(run, stream)``. ``stream`` is
    found in the trace by ``markers`` sleep kernels queued on it before
    and after the run; every other stream counts as the other side. A
    session now and then misses device events (all of them, or the first
    ones): up to five runs, until a marker is seen."""
    from torch.profiler import ProfilerActivity, profile

    def union(spans):
        out = []
        for s, e in sorted(spans):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def total(iv):
        return sum(e - s for s, e in iv)

    def mark(stream):
        with torch.cuda.stream(stream):
            for _ in range(markers):
                torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    for _ in range(5):
        run, stream = prepare()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            mark(stream)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            mark(stream)
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        ids = {e.device_resource_id for e in events if "spin" in e.name}
        work = [e for e in events if "spin" not in e.name]
        if len(ids) == 1 and work:
            break
    else:
        raise AssertionError("stream overlap: no run of 5 showed the marker "
                             f"kernels on one stream: {ids}")
    (sid,) = ids
    spans = [(e.time_range.start, e.time_range.end) for e in work]
    a = union([(e.time_range.start, e.time_range.end) for e in work
               if e.device_resource_id == sid])
    b = union([(e.time_range.start, e.time_range.end) for e in work
               if e.device_resource_id != sid])
    both, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        both += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return (total(union(spans)) / wall_us, both / wall_us,
            total(a) / wall_us, total(b) / wall_us, len(spans))


def phase_disagg_serve(dev, label):
    """13b: phase 5's 24-request bf16 workload through ``DisaggServer`` at
    chunk_pages 1 and 8, beside the colocated engine on the same host;
    then a profiled run for the card's busy share and the overlap of the
    two roles' streams."""
    from repro_torch.configs import get_config
    from repro_torch.core import TensorOp
    from repro_torch.kernels import flash_attention, paged_attention, rmsnorm
    from repro_torch.models import lm
    from repro_torch.serve import Request, RequestState
    from repro_torch.serve.disagg import block_tag
    cfg = get_config("paper_demo")
    params = lm.init_params(cfg, seed=0, device=dev)
    work = serve_workload(cfg, np.random.default_rng(2))
    eng = serve_engine(cfg, params, dev)
    reqs, wall = serve_timed(eng, work)
    n_tokens = sum(len(r.tokens) for r in reqs)
    colo_rate = n_tokens / wall
    log(f"phase 13b: bf16 colocated engine on {label} (same workload, same "
        f"host): 24 requests, {n_tokens} tokens in {wall:.3f} s = "
        f"{colo_rate:.1f} tokens/s; TTFT {ttft_ms(reqs)}")
    eng.shutdown()
    L = cfg.n_layers
    for cp in DISAGG_CHUNKS:
        srv = disagg_server(cfg, params, dev, chunk_pages=cp)
        warm_up(srv, work)
        pre0, dec0 = dict(srv.prefill.stats), dict(srv.decode.stats)
        tr0 = srv.transport.stats()
        replays0 = srv.decode._decode_graph.replays
        rmsnorm.LAUNCHES = flash_attention.LAUNCHES = 0
        paged_attention.LAUNCHES = 0
        TensorOp.PENDING_AT_FIRST_POLL = 0
        reqs = [Request(p, n) for p, n in work]
        wall = serve_checked(srv, reqs)
        launches = {"rmsnorm": rmsnorm.LAUNCHES,
                    "flash_attention": flash_attention.LAUNCHES,
                    "paged_attention": paged_attention.LAUNCHES}
        pre, dec = srv.prefill.stats, srv.decode.stats
        tr = srv.transport.stats()
        chunks = pre["chunks"] - pre0["chunks"]
        steps = dec["steps"] - dec0["steps"]
        blocks = pre["blocks_shipped"] - pre0["blocks_shipped"]
        chunk_host = (pre["dispatch_s"] - pre0["dispatch_s"]) / max(chunks, 1)
        page_nbytes = srv.prefill.pool.page_nbytes
        tags = [tr["per_tag"][block_tag(r.req_id)] for r in reqs]
        sent = sum(t["sent_bytes"] for t in tags)
        recvd = sum(t["recvd_bytes"] for t in tags)
        held = tr["device_sends_pending"] - tr0["device_sends_pending"]
        dev_sends = tr["device_sends"] - tr0["device_sends"]
        n_tokens = sum(len(r.tokens) for r in reqs)
        log(f"phase 13b: bf16 disagg chunk_pages={cp} on {label}: 24 "
            f"requests, {n_tokens} tokens in {wall:.3f} s = "
            f"{n_tokens / wall:.1f} tokens/s "
            f"({n_tokens / wall / colo_rate:.3f}x colocated); TTFT "
            f"{ttft_ms(reqs)}; {chunks} prefill chunks (W={16 * cp}), "
            f"{steps} decode steps; {blocks} blocks shipped, "
            f"{sent} bytes on their tags ({blocks} x page_nbytes "
            f"{page_nbytes} = {blocks * page_nbytes}), {recvd} received; "
            f"device sends pending at post {held} of {dev_sends}; host "
            f"{chunk_host * 1e3:.3f} ms per chunk (upload, chunk, exports, "
            f"sends, continuations run inline); PENDING_AT_FIRST_POLL "
            f"{TensorOp.PENDING_AT_FIRST_POLL}")
        log(f"disagg chunk_pages={cp} kernels: {json.dumps(launches)}")
        if not all(r.req_state is RequestState.FINISHED for r in reqs) or \
                any(len(r.tokens) != n for r, (_, n) in zip(reqs, work)):
            raise AssertionError(f"13b chunk_pages={cp}: not every request "
                                 "finished its budget")
        if not disagg_drained(srv):
            raise AssertionError(f"13b chunk_pages={cp}: pages left in use")
        if sent != blocks * page_nbytes or recvd != sent or blocks <= 0:
            raise AssertionError(f"13b chunk_pages={cp}: {blocks} blocks "
                                 f"but {sent} bytes sent, {recvd} received")
        if launches["paged_attention"] != L * (chunks + steps) or \
                launches["rmsnorm"] != (2 * L + 1) * (chunks + steps) or \
                launches["flash_attention"] != 0 or \
                srv.decode._decode_graph.replays - replays0 != steps:
            raise AssertionError(f"13b chunk_pages={cp}: launches "
                                 f"{launches} for {chunks} chunks and "
                                 f"{steps} decode steps")
        if cp == DISAGG_CHUNKS[0]:
            post, deliver, install, mallocs = block_host_us(srv)
            log(f"phase 13b: host cost of one shipped block on this host "
                f"(192 blocks in batches of 8 through the idle server's "
                f"transport): export and send {post:.1f} us, delivery "
                f"(poll, match) {deliver:.1f} us, take and install "
                f"{install:.1f} us; {post + deliver + install:.1f} us in "
                f"all; {mallocs} cudaMalloc segments")
        srv.shutdown()

    # the card's busy share and the two roles' overlap, profiled
    servers = []

    def prepare():
        srv = disagg_server(cfg, params, dev, chunk_pages=1)
        warm_up(srv, work)
        servers.append(srv)
        return (lambda: serve_checked(srv, [Request(p, n)
                                            for p, n in work[:4]]),
                srv.prefill.stream)

    busy, both, pre_share, dec_share, ops = stream_overlap(prepare)
    if not all(disagg_drained(srv) for srv in servers) or busy <= 0:
        raise AssertionError("13b profiled run: pages left in use or no "
                             "device time")
    for srv in servers:
        srv.shutdown()
    log(f"phase 13b: profiled disagg run (chunk_pages=1, 4 requests, "
        f"profiler on): card busy {busy:.1%} of the wall time; prefill "
        f"stream busy {pre_share:.1%}, decode stream {dec_share:.1%}, both "
        f"at once {both:.1%}; {ops} device ops; {len(servers)} session(s)")
    return cfg, params


def block_host_us(srv, batches: int = 25, per_batch: int = 8):
    """The host's cost of shipping one KV block, on an idle server, in
    batches of ``per_batch`` (as many as a serve run has in flight):
    exports of a prefill-pool page each sent to a posted receive (under
    the prefill stream); once the card has run the copies, the polls that
    deliver them; then ``take`` and the install into a decode page (under
    the decode stream). The first batch warms the allocator and is not
    counted. Mean microseconds of each part, and the ``cudaMalloc``
    segments the counted batches took."""
    from repro_torch.core.transport import take
    from repro_torch.serve.disagg import KVBlockMsg
    tr, tag = srv.transport, 1 << 30
    spent = [0.0, 0.0, 0.0]
    mallocs = 0
    for b in range(batches):
        if b == 1:
            mallocs = cuda_mallocs()
        recvs = [tr.irecv(1, source=0, tag=tag) for _ in range(per_batch)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.cuda.stream(srv.prefill.stream):
            for i in range(per_batch):
                kv = srv.prefill.pool.export_page(0)
                tr.isend(0, 1, tag, KVBlockMsg(-1, i, kv["k"], kv["v"]))
        t1 = time.perf_counter()
        del kv
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        while not all(r.done() for r in recvs):
            pass
        t3 = time.perf_counter()
        with torch.cuda.stream(srv.decode.stream):
            for r in recvs:
                msg = take(r.status.payload, srv.decode.stream)
                srv.decode.pool.import_page(0, {"k": msg.k, "v": msg.v})
        t4 = time.perf_counter()
        del msg, recvs
        torch.cuda.synchronize()
        if b:
            for k, dt in enumerate((t1 - t0, t3 - t2, t4 - t3)):
                spent[k] += dt
    n = (batches - 1) * per_batch
    return tuple(t / n * 1e6 for t in spent) + (cuda_mallocs() - mallocs,)


def disagg_server(cfg, params, dev, **kw):
    from repro_torch.serve import DisaggServer
    return DisaggServer(cfg, params, device=dev, max_batch=8, page_size=16,
                        max_seq_len=1024, max_inflight=2, **kw)


def phase_disagg_card_bound(dev, ident, tokens, label):
    """13c: a sleep kernel on the prefill stream ahead of every chunk:
    nearly every block send must be posted while its page is still being
    written (held at its first poll), and the tokens must not change."""
    from repro_torch.serve import DisaggServer, Request
    cfg, params = ident["cfg"], ident["params"]
    prompts, n = ident["prompts"], ident["n"]
    srv = DisaggServer(cfg, params, device=dev, max_batch=4, page_size=16,
                       max_seq_len=256, chunk_pages=1)
    cycles = int(CHUNK_SLEEP_MS * sleep_cycles_per_ms())
    plain = srv.prefill._suffix_fn

    def held_chunk(*args):
        torch.cuda._sleep(cycles)       # on the prefill role's stream
        return plain(*args)

    srv.prefill._suffix_fn = held_chunk
    reqs = [Request(p, n) for p in prompts]
    wall = serve_checked(srv, reqs)
    st = srv.transport.stats()
    chunks = srv.prefill.stats["chunks"]
    blocks = srv.prefill.stats["blocks_shipped"]
    held, sends = st["device_sends_pending"], st["device_sends"]
    got = [r.tokens for r in reqs]
    log(f"phase 13c: card-bound prefill on {label}: {CHUNK_SLEEP_MS:.0f} ms "
        f"of sleep ahead of each of {chunks} chunks, {wall * 1e3:.1f} ms "
        f"wall; block sends pending at their first poll {held} of {sends} "
        f"({blocks} blocks); tokens equal to 13a's chunk_pages=1 run: "
        f"{got == tokens['chunk_pages=1']}")
    if sends != blocks or held < 0.9 * sends:
        raise AssertionError(f"13c: only {held} of {sends} block sends were "
                             "pending at their first poll")
    if got != tokens["chunk_pages=1"] or not disagg_drained(srv):
        raise AssertionError("13c: the tokens changed under the sleeps, or "
                             "pages were left in use")
    if wall * 1e3 < 0.9 * CHUNK_SLEEP_MS * chunks / 2:
        raise AssertionError("13c: the card was not the slower side")
    srv.shutdown()


def phase_chunk_kernels(dev, label):
    """The paged kernel at the prefill role's windows (13k): the last
    chunk of a 512-token prompt at W = 16 and 128 (chunk_pages 1 and 8),
    against its plain version, beside its bound, and its launches per
    512-token prompt."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        for W in (16, 128):
            r = check_paged(f"chunk{W}", dtype, gen, dev)
            ok = r["err"] <= TOL[dtype] and r["pools_exact"]
            log(f"phase 13k: paged_attention {str(dtype):15s} {r['shape']} "
                f": max_abs_err {r['err']:.3g} (tol {TOL[dtype]:g}) "
                f"pools_exact={r['pools_exact']} | kernel {r['ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} "
                f"ms ({r['bound'][1]}) on {label}; {12 * 512 // W} launches "
                "per 512-token prompt (12 layers)")
            if not ok:
                raise AssertionError(f"paged_attention at W={W} {dtype} "
                                     f"disagrees with its plain version: {r}")


def router_workload(cfg, rng):
    """24 requests over 4 shared 256-token prefixes (a system prompt or a
    document each), 8–64-token tails, 32–64 new tokens."""
    prefixes = [rng.integers(0, cfg.vocab_size, 256) for _ in range(4)]
    return [(np.concatenate([prefixes[i % 4], rng.integers(
        0, cfg.vocab_size, rng.integers(8, 65))]), int(rng.integers(32, 65)))
        for i in range(24)]


def phase_router(dev, ident, bf16, label):
    """14a: 2 fp32 replicas on the one card, replica 1 killed mid-decode:
    zero requests lost, phase 4's tokens, the dead replica's pool drained.
    14b: a bf16 shared-prefix trace through 2 replicas beside one
    engine."""
    from repro_torch.kernels import paged_attention
    from repro_torch.serve import Request, RequestState, Router
    cfg, params = ident["cfg"], ident["params"]
    prompts, n = ident["prompts"], ident["n"]
    r = Router(cfg, params, n_replicas=2, device=dev, max_batch=4,
               page_size=16, max_seq_len=256)
    paged_attention.LAUNCHES = 0
    reqs = [Request(p, n) for p in prompts]

    def victim_mid_decode():
        return any(t.rank == 1 and 2 <= t.original.delivered < n
                   for t in r._tracked.values())

    wall = serve_checked(r, reqs, until=lambda: victim_mid_decode() or (
        r.batcher.closed and r.idle))
    if not victim_mid_decode():
        raise AssertionError("14a: replica 1 never had a request mid-decode")
    r.kill_replica(1)
    torch.cuda.set_sync_debug_mode("error")
    try:
        r.run(timeout=300)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    m = r.metrics()
    dead = r.workers[0]
    lost = sum(q.req_state is not RequestState.FINISHED for q in reqs)
    checked = check_identity("14a router vs greedy", cfg, params, prompts,
                             reqs, ident["greedy"])
    check_identity("14a router vs single engine", cfg, params, prompts,
                   reqs, ident["colocated"])
    log(f"phase 14a: fp32 router on {label}: 2 replicas, replica 1 killed "
        f"mid-decode after {wall * 1e3:.1f} ms; {lost} requests lost, "
        f"{m['requeued']} requeued, failover (kill to requeue, heartbeat "
        f"timeout {r.monitor.timeout_s} s) "
        f"{r.failover_s[0] * 1e3:.1f} ms; {checked}/{n * len(reqs)} tokens "
        f"equal to greedy and the single engine; dead replica's pages in "
        f"use {dead.pool.pages_in_use}; paged launches "
        f"{paged_attention.LAUNCHES}")
    if lost or m["failovers"] != 1 or m["requeued"] < 1 or \
            m["pages_in_use"] != 0 or paged_attention.LAUNCHES <= 0:
        raise AssertionError(f"14a: {lost} lost, metrics {dict(m)}")
    r.shutdown()

    cfg, params = bf16
    work = router_workload(cfg, np.random.default_rng(8))
    eng = serve_engine(cfg, params, dev)
    reqs, wall = serve_timed(eng, work)
    n_tokens = sum(len(q.tokens) for q in reqs)
    one = n_tokens / wall
    log(f"phase 14b: bf16 one engine on {label}: shared-prefix trace, 24 "
        f"requests, {n_tokens} tokens in {wall:.3f} s = {one:.1f} tokens/s; "
        f"TTFT {ttft_ms(reqs)}; prefix_hits {eng.pool.stats['prefix_hits']}")
    eng.shutdown()
    r = Router(cfg, params, n_replicas=2, device=dev, max_batch=8,
               page_size=16, max_seq_len=1024, max_inflight=2)
    # warmed on other prompts: the trace's prefixes reach the affinity map
    # only by its own requests
    warm_up(r, router_workload(cfg, np.random.default_rng(9)))
    routed0, hits0 = r.stats["routed"], r.stats["affinity_hits"]
    paged_attention.LAUNCHES = 0
    reqs = [Request(p, k) for p, k in work]
    wall = serve_checked(r, reqs)
    m = r.metrics()
    rate = (r.stats["affinity_hits"] - hits0) / (r.stats["routed"] - routed0)
    n_tokens = sum(len(q.tokens) for q in reqs)
    log(f"phase 14b: bf16 router on {label}: 2 replicas, 24 requests, "
        f"{n_tokens} tokens in {wall:.3f} s = {n_tokens / wall:.1f} tokens/s "
        f"({n_tokens / wall / one:.3f}x one engine); TTFT {ttft_ms(reqs)}; "
        f"affinity hit rate {rate:.3f}; prefix_hits by replica "
        + ", ".join(f"{w.rank}: {w.pool.stats['prefix_hits']}"
                    for w in r.workers)
        + f"; paged launches {paged_attention.LAUNCHES}")
    if not all(q.req_state is RequestState.FINISHED for q in reqs) or \
            m["pages_in_use"] != 0 or paged_attention.LAUNCHES <= 0:
        raise AssertionError(f"14b: unfinished requests or pages in use: "
                             f"{dict(m)}")
    r.shutdown()

# ------------------------------------------------- unfused paged serving (23)
def unfused_engine(cfg, params, dev, speculate=0):
    return serve_engine(cfg, params, dev, speculate=speculate, fused=False)


def phase_unfused(dev, ident, bf16, fused_d, label):
    """23: ``paper_demo`` at full width through ``ServeEngine(fused=False)``:
    each slot's pages gathered for the dense decode and the written pages
    copied back, captured as step graphs like the fused steps. 23a fp32:
    phase 4's requests, plain and with ``speculate=4``, must emit phase 4's
    fused tokens and greedy's up to the first near tie; 23b bf16: phase
    5's workload as the path ``paper_demo_unfused`` (the paged kernel on
    the gathered view, as the dense decode runs it), beside phase 5's
    fused numbers of this call; 23c its card-bound loop. Returns 23b's
    launches."""
    from repro_torch.serve import Request
    t_phase = time.perf_counter()
    cfg, params = ident["cfg"], ident["params"]
    for what, prompts, n, spec, fused_toks, greedy in (
            ("plain", ident["prompts"], ident["n"], 0, ident["colocated"],
             ident["greedy"]),
            (f"speculate={SPECULATE}", ident["spec_prompts"],
             ident["spec_n"], SPECULATE, ident["spec_colocated"],
             ident["spec_greedy"])):
        eng = unfused_engine(cfg, params, dev, speculate=spec)
        graph = eng._verify_graph if spec else eng._decode_graph
        if eng.fused or graph.graph is None:
            raise AssertionError("23a: the unfused engine took the fused "
                                 "path or captured no step graph")
        reqs = [Request(p, n) for p in prompts]
        serve_checked(eng, reqs)
        m = eng.metrics()
        eng.shutdown()
        checked = check_identity(f"23a unfused {what} vs greedy", cfg,
                                 params, prompts, reqs, greedy)
        check_identity(f"23a unfused {what} vs the fused engine", cfg,
                       params, prompts, reqs, fused_toks)
        if graph.replays != m["steps"] or m["pages_in_use"] != 0 \
                or m["draft_accepted" if spec else "prefix_hits"] <= 0:
            raise AssertionError(f"23a unfused {what}: {dict(m)}, "
                                 f"{graph.replays} graph replays")
        log(f"phase 23a: fp32 unfused {what} identity OK: {len(reqs)} "
            f"requests, {checked}/{n * len(reqs)} tokens equal to greedy and "
            f"to phase 4's fused engine, {graph.replays} steps (graph "
            f"replays), prefix_hits {m['prefix_hits']}, drafts accepted "
            f"{m['draft_accepted']}")
    bcfg, bparams = bf16
    work = serve_workload(bcfg, np.random.default_rng(2))
    launches, host_ms, d = family_serve("23b", bcfg, bparams, dev, work,
                                       unfused_engine, label)
    if d["prefix_hits"] <= 0:
        raise AssertionError(f"23b: {launches}, prefix_hits "
                             f"{d['prefix_hits']}")
    log(f"phase 23b: unfused / fused paper_demo on {label}, this call: "
        f"tokens/s {d['tokens_per_s']:.1f} / {fused_d['tokens_per_s']:.1f} "
        f"({d['tokens_per_s'] / fused_d['tokens_per_s']:.3f}x); TTFT p50 "
        f"{d['ttft_p50_s'] * 1e3:.1f} / {fused_d['ttft_p50_s'] * 1e3:.1f} ms, "
        f"p99 {d['ttft_p99_s'] * 1e3:.1f} / "
        f"{fused_d['ttft_p99_s'] * 1e3:.1f} ms; card ms a step "
        f"{d['card_ms']:.3f} / {fused_d['card_ms']:.3f}; host ms a step "
        f"{host_ms:.3f} / "
        f"{fused_d['dispatch_s'] / max(fused_d['steps'], 1) * 1e3:.3f}")
    phase_card_bound(bcfg, bparams, dev, host_ms, label,
                     make_engine=unfused_engine, phase="23c")
    log(f"phase 23: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------- the bench on the card (24)
# phase 24's trace and sweep, cut from 64 requests and 4 bisections to
# keep phases 23-24 near 90 s: the 1 request/s probe alone spans the
# trace's arrivals at that rate (47 s)
BENCH_REQUESTS = 48
BENCH_ITERS = 3
BENCH_SLO_TTFT_S = 1.0


def bench_trace():
    """Phase 5's length ranges (prompts 64-512 over 4 shared 64-token
    prefixes, 32-128 new), arriving as a Poisson process."""
    from repro_torch.bench import synthetic_trace
    return synthetic_trace(BENCH_REQUESTS, seed=0, vocab_size=16384,
                           arrival="poisson", prompt_len=(64, 512),
                           output_len=(32, 128), n_prefix_groups=4,
                           shared_len=64)


def bench_tiers(cfg, params, dev):
    """The three serving tiers of phase 24, each built on this thread (the
    one that owns the card's work; their step graphs are captured here)
    when its turn comes."""
    from repro_torch.serve import Router
    return (("engine", lambda: serve_engine(cfg, params, dev)),
            ("disagg", lambda: disagg_server(cfg, params, dev,
                                             chunk_pages=8)),
            ("router", lambda: Router(cfg, params, n_replicas=2, device=dev,
                                      max_batch=8, page_size=16,
                                      max_seq_len=1024, max_inflight=2)))


def all_finished(results) -> bool:
    return all(r.count("finished") == len(r.records) for r in results)


def phase_bench(dev, bf16, label):
    """24: TTFT under open-loop arrivals on the three serving tiers through
    ``repro_torch.bench``, bf16 ``paper_demo`` at full width. 24a: the
    colocated engine's saturation sweep over 1-100 requests/s (the highest
    Poisson rate whose TTFT p99 stays under 1 s with every request
    finished: lambda*; 100 if the SLO holds at every probe); 24b:
    each tier at 0.5 and 0.9 lambda*, 2 untraced samples each, its SLO
    report; 24c: one more sample a tier with a ``Recorder`` attached: the
    cause split and a Perfetto trace under ``build/``. A tier that misses
    the SLO is a finding; a request lost or unfinished fails the phase."""
    from repro_torch.bench import (SLO, Replayer, rescale_qps, slo_report,
                                   sweep_tier, to_markdown)
    from repro_torch.obs import Recorder
    t_phase = time.perf_counter()
    cfg, params = bf16
    trace = bench_trace()
    slo = SLO(ttft_p99_s=BENCH_SLO_TTFT_S, min_finished_frac=1.0)
    tiers = bench_tiers(cfg, params, dev)
    rp = Replayer(tiers[0][1](), name="engine")
    t0 = time.perf_counter()
    sweep = sweep_tier(rp, trace, slo, lo_qps=1.0, hi_qps=100.0,
                       iters=BENCH_ITERS, retries=1)
    lam = sweep.max_qps
    log(f"phase 24a: saturation sweep of the colocated engine on {label}: "
        f"{len(trace)} requests (Poisson, prompts 64-512 over 4 shared "
        f"64-token prefixes, 32-128 new), SLO TTFT p99 <= "
        f"{BENCH_SLO_TTFT_S} s with every request finished: lambda* = "
        f"{lam} requests/s"
        + (" (the SLO held at every probe: the boundary lies past the "
           "probed range)" if sweep.saturated_range else "")
        + "; probes " + json.dumps(sweep.to_dict()["points"])
        + f"; {time.perf_counter() - t0:.1f} s")
    if lam is None:
        rp.close()
        raise AssertionError("24a: the engine misses the SLO even at 1 "
                             "request/s")
    rates = (0.5 * lam, 0.9 * lam)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(out_dir, exist_ok=True)
    table = {}
    for i, (name, make) in enumerate(tiers):
        t0 = time.perf_counter()
        if i:
            rp = Replayer(make(), name=name)
        for rate in rates:
            results = rp.run(rescale_qps(trace, rate), samples=2,
                             timeout=600.0)
            report = slo_report(results, slo)
            if not all_finished(results):
                rp.close()
                raise AssertionError(
                    f"24b: {name} at {rate:.3f} requests/s lost or left "
                    "requests unfinished: " + json.dumps(report["metrics"]))
            mt = report["metrics"]
            table[name, rate] = mt
            log(f"phase 24b: {name} at {rate:.3f} requests/s "
                f"({rate / lam:.1f} lambda*) on {label}: tokens/s "
                f"{mt['tokens_per_s']['mean']:.1f} (cv "
                f"{mt['tokens_per_s']['cv']:.3f}), goodput "
                f"{mt['goodput_tokens_per_s']['mean']:.1f} tokens/s, TTFT "
                f"p50 {mt['ttft_p50_s']['mean'] * 1e3:.1f} ms (cv "
                f"{mt['ttft_p50_s']['cv']:.3f}), p99 "
                f"{mt['ttft_p99_s']['mean'] * 1e3:.1f} ms (cv "
                f"{mt['ttft_p99_s']['cv']:.3f}), ITL p99 "
                f"{mt['itl_p99_s']['mean'] * 1e3:.2f} ms (cv "
                f"{mt['itl_p99_s']['cv']:.3f}); SLO "
                f"{'holds' if report['slo']['ok'] else 'missed'}; samples "
                + json.dumps({k: mt[k]['values'] for k in (
                    'tokens_per_s', 'ttft_p50_s', 'ttft_p99_s')}))
            for line in to_markdown(report).splitlines():
                log("  " + line)
        rec = Recorder()
        rp.recorder = rec
        traced = rp.run(rescale_qps(trace, rates[1]), samples=1,
                        timeout=600.0)
        rp.recorder = None
        rp.close()
        if not all_finished(traced):
            raise AssertionError(f"24c: {name}: a traced request did not "
                                 "finish")
        path = rec.write(os.path.join(out_dir, f"phase24_{name}.json"))
        causes = rec.cause_summary()
        log(f"phase 24c: {name}, one traced sample at {rates[1]:.3f} "
            f"requests/s on {label}: cause split (mean a request) "
            + json.dumps(causes) + f"; Perfetto trace {path} "
            f"({os.path.getsize(path) / 2 ** 20:.1f} MiB); tier "
            f"{time.perf_counter() - t0:.1f} s")
        if causes["requests"] < len(trace) or causes["compute_ms_mean"] <= 0:
            raise AssertionError(f"24c: {name}: trace saw {causes}")
        free_card()
    log(f"phase 24: TTFT under open-loop arrivals on {label}, lambda* "
        f"{lam} requests/s: " + json.dumps({
            f"{name}@{rate / lam:.1f}": {
                k: round(table[name, rate][k]["mean"], 6)
                for k in ("tokens_per_s", "ttft_p50_s", "ttft_p99_s")}
            for name, _ in tiers for rate in rates})
        + f"; {time.perf_counter() - t_phase:.1f} s")


# ------------------------------- the dense family at head_dim 120 and 128
DANUBE_LONG = 6000     # a prompt past danube's 4096 window, 6000 % 4096 > 0
DANUBE_CACHE = 8192    # max_cache_len of phase 15: a ring of the 4096 window
DEEPSEEK_LAYERS = 16   # deepseek-coder-33b cut from 62 layers (phase 16)
WIDE_LAYERS = 2        # llama3-405b (126) and command-r-plus (64), phase 17


def family_config(name, dtype, n_layers=None):
    """A ported config at its published widths in ``dtype`` (weights too),
    its depth cut to ``n_layers`` where given (a moe_hybrid stack to its
    first ``n_layers`` mixers)."""
    from repro_torch.configs import get_config
    cfg = get_config(name, dtype=dtype, param_dtype=dtype)
    if not n_layers:
        return cfg
    cut = dict(n_layers=n_layers)
    if cfg.layer_types:
        cut["layer_types"] = cfg.layer_types[:n_layers]
    return dataclasses.replace(cfg, **cut)


def free_card() -> None:
    """Return the memory of dropped weights and engines to the card."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


KERNEL_NAMES = ("rmsnorm", "flash_attention", "paged_attention", "ssd_scan")


def kernel_modules():
    from repro_torch.kernels import (flash_attention, paged_attention,
                                     rmsnorm, ssd_scan)
    return dict(zip(KERNEL_NAMES, (rmsnorm, flash_attention,
                                   paged_attention, ssd_scan)))


#: the backward kernels, counted by their forward's module
BACKWARD_NAMES = ("rmsnorm_backward", "flash_attention_backward",
                  "ssd_scan_backward")


def backward_modules():
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan
    return dict(zip(BACKWARD_NAMES, (rmsnorm, flash_attention, ssd_scan)))


def zero_counts() -> None:
    for m in kernel_modules().values():
        m.LAUNCHES = 0
    for m in backward_modules().values():
        m.BACKWARD_LAUNCHES = 0



def read_counts() -> dict:
    """Every kernel's launches since ``zero_counts``, the backward kernels'
    too (a serving path must show 0 of those)."""
    return {**{name: m.LAUNCHES for name, m in kernel_modules().items()},
            **{name: m.BACKWARD_LAUNCHES
               for name, m in backward_modules().items()}}


def danube_engine(cfg, params, dev, max_batch=8):
    """Dense mode (a sliding window has no paged cache): a ring of the
    whole 4096 window per slot."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params, device=dev, max_batch=max_batch,
                      max_cache_len=DANUBE_CACHE, max_inflight=2)
    if eng.paged or eng._cache["k"].shape[2] != cfg.window:
        raise AssertionError("danube must be served in dense mode on a ring "
                             "of its window")
    return eng


def identity_prompts(cfg, rng, lengths, prefix_len=64, shared=()):
    """Random prompts of ``lengths``; those whose index is in ``shared``
    start with one common ``prefix_len``-token prefix."""
    prefix = rng.integers(0, cfg.vocab_size, prefix_len)
    return [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)])
            if i in shared else rng.integers(0, cfg.vocab_size, n)
            for i, n in enumerate(lengths)]


def greedy_margins(cfg, params, prompt, n, max_len, dev):
    """The port's greedy decoding as ``greedy_generate`` runs it (prefill,
    then one dense decode step a token), with each step's top-2 logit
    margin: returns (tokens, the count before the first near tie). An MoE
    needs its guard from these steps: a no-cache forward routes the whole
    sequence as one group, another function (ROADMAP C.8)."""
    from repro_torch.serve import make_decode_step, make_prefill_step
    logits, cache = make_prefill_step(cfg, max_len)(params, {
        "tokens": torch.as_tensor(np.asarray(prompt)[None], dtype=torch.int32,
                                  device=dev)})
    decode = make_decode_step(cfg)
    toks, near = [], n
    for i in range(n):
        top2 = torch.topk(logits[0, -1].float(), 2)
        if near == n and float(top2.values[0] - top2.values[1]) < 1e-3:
            near = i
        toks.append(int(top2.indices[0]))
        if i + 1 < n:
            logits, cache = decode(params, cache, torch.tensor(
                [[toks[-1]]], dtype=torch.int32, device=dev), len(prompt) + i)
    return toks, near


def family_identity(tag, cfg, params, dev, prompts, n, make_engine,
                    oracle_len, step_guard=False):
    """fp32: the engine's tokens against the port's ``greedy_generate``
    (dense decode, eager) up to the first near tie (by ``greedy_margins``
    with ``step_guard``, else by the no-cache forward); every decode (or
    verify) step one graph replay, every page back in the pool."""
    from repro_torch.serve import Request, greedy_generate
    eng = make_engine(cfg, params, dev)
    reqs = [Request(p, n) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    eng.run(timeout=600)
    m = eng.metrics()
    graph = eng._verify_graph if eng.speculate else eng._decode_graph
    replays = graph.replays
    eng.shutdown()
    wants = [greedy_generate(cfg, params, p[None], n, oracle_len,
                             device=dev)[0].tolist() for p in prompts]
    if step_guard:
        checked = 0
        for p, r, want in zip(prompts, reqs, wants):
            toks, near = greedy_margins(cfg, params, p, n, oracle_len, dev)
            if toks[:near] != want[:near] or r.tokens[:near] != want[:near]:
                raise AssertionError(f"{tag}: engine {r.tokens} != greedy "
                                     f"{want} (its steps: {toks}) within "
                                     f"{near} tokens")
            checked += near
    else:
        checked = check_identity(tag, cfg, params, prompts, reqs, wants)
    if replays != m["steps"] or m.get("pages_in_use", 0) != 0:
        raise AssertionError(f"{tag}: {dict(m)}, {replays} graph replays")
    return checked, m


def tensors_of(tree):
    """The tensors of a nested dict."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tensors_of(v)
    else:
        yield tree


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tensors_of(tree))


def tree_numel(tree) -> int:
    return sum(t.numel() for t in tensors_of(tree))


def step_bytes(eng) -> int:
    """The least bytes a decode step moves: every weight read once (of an
    untied embedding table only the slots' rows, left out), and in dense
    mode the whole per-slot cache, which the step whose card time
    ``family_serve`` takes reads: its slots sit near the cache's end."""
    emb = eng.params["embed"]["tokens"]
    n = tree_bytes(eng.params)
    if not eng.cfg.tied_embeddings:
        n -= emb.numel() * emb.element_size()
    if not eng.paged:
        n += tree_bytes(eng._cache)
    return n


def family_serve(tag, cfg, params, dev, work, make_engine, label,
                 extra=None):
    """bf16: ``work`` through a warm engine under sync debug mode "error",
    the kernels' counts set to 0 just before and read just after: tokens/s,
    TTFT, the host's and the card's ms per decode step, peak memory.
    Every request must finish its budget, the pool drain, and each kernel
    launch as often as the steps say it must. ``extra(eng, card_ms)``
    runs on the idle engine before it shuts down (a phase's own timings;
    ``card_ms`` is the card's time of one decode step's replay). Returns
    (launches, host ms per step, the run's counts: steps, prefills,
    suffix_steps, prefix_hits, and its tokens/s, TTFT p50/p99 s and card
    ms a step)."""
    from repro_torch.core import TensorOp
    from repro_torch.kernels import paged_attention
    from repro_torch.models.common import HYBRID, MOE_HYBRID, SSM
    from repro_torch.serve import Request, RequestState
    if not sync_detector_works(dev):
        raise AssertionError("torch.cuda sync debug mode does not flag a "
                             ".item(): the no-wait check would be blind")
    start = peak_start()
    eng = make_engine(cfg, params, dev)
    warm_up(eng, work)
    retired0 = len(eng.retired)
    st0 = dict(eng.stats)
    hits0 = eng.pool.stats["prefix_hits"] if eng.paged else 0
    replays0 = eng._decode_graph.replays
    zero_counts()
    TensorOp.PENDING_AT_FIRST_POLL = 0
    reqs = [Request(p, k) for p, k in work]
    wall = serve_checked(eng, reqs)
    launches = read_counts()
    pending = TensorOp.PENDING_AT_FIRST_POLL
    d = {k: eng.stats[k] - st0[k] for k in ("steps", "prefills",
                                            "suffix_steps", "slot_steps",
                                            "dispatch_s")}
    d["prefix_hits"] = eng.pool.stats["prefix_hits"] - hits0 \
        if eng.paged else 0
    steps, prefills = d["steps"], d["prefills"]
    replays = eng._decode_graph.replays - replays0
    retired = len(eng.retired) - retired0
    host_ms = d["dispatch_s"] / max(steps, 1) * 1e3
    n_tokens = sum(len(r.tokens) for r in reqs)
    m = dict(eng.metrics())
    # the card's time for one step: events around a replay of the decode
    # graph on the idle engine (it rewrites rows no request holds); the
    # host's enqueue of that replay alone
    if eng.paged:
        t = decode_step_times(eng, split=True)
        card_ms, replay_enq = t["graph_ms"], t["graph_enqueue_ms"]
        busy, split, names = t["busy"]
        eager = (f"; eager step function: host {t['eager_enqueue_ms']:.3f} "
                 f"ms, card {t['eager_ms']:.3f} ms by events")
    else:
        S = eng.max_batch
        if eng._dense_kv:
            # the card's time where a step reads a slot's whole cache:
            # every slot past danube's window (its whole ring valid), or
            # zamba2's near the end of its cache
            L = eng._cache["k"].shape[2]
            i = torch.arange(S, device=dev) * 100
            eng._meta[:S].copy_(i + 4096 if cfg.window else L - 1 - i)
        card_ms = median_ms(eng._decode_graph, runs=20)
        replay_enq = enqueue_ms(eng._decode_graph)
        busy, split, names = busy_ms(eng._dense_step, by_name=True)
        eager = ""
    L = cfg.n_layers
    ssm = cfg.family in (SSM, HYBRID)      # an SSD scan a layer a prefill
    # norms a step or prefill, and the flash layers of a prefill: a hybrid
    # runs its shared block (two norms, one attention) at each site
    sites = cfg.hybrid_sites if cfg.family == HYBRID else 0
    norms = (1 if cfg.parallel_block or ssm else 2) * L + 2 * sites + 1
    attn_layers = sites if ssm else L
    ssd_layers = L if ssm else 0
    if cfg.family == MOE_HYBRID:
        # one mixer a layer, of either kind; two norms a layer (mixer, MoE)
        attn_layers = cfg.n_mixers("attention")
        ssd_layers = cfg.n_mixers("mamba")
    mode = ("paged + fused" if eng.fused else "paged, unfused") \
        if eng.paged else "dense mode"
    heads = "" if cfg.family == SSM else (
        f", {cfg.padded_heads}/{cfg.padded_kv_heads} heads of hd "
        f"{cfg.resolved_head_dim}" + (f" at {sites} sites" if sites else ""))
    log(f"phase {tag}: bf16 serve of {cfg.name} ({L} layers, d "
        f"{cfg.d_model}{heads}) on {label}: "
        f"{mode}, {len(reqs)} "
        f"requests, {n_tokens} tokens in {wall:.3f} s = "
        f"{n_tokens / wall:.1f} tokens/s; TTFT {ttft_ms(reqs)} (all "
        f"submitted at t=0); {steps} decode steps, "
        f"{wall / max(steps, 1) * 1e3:.3f} ms/step wall incl. prefills, "
        f"{d['slot_steps'] / max(steps, 1):.2f} slots/step, {prefills} "
        f"prefills ({d['suffix_steps']} suffix), prefix_hits "
        f"{d['prefix_hits']}; PENDING_AT_FIRST_POLL {pending}")
    n_bytes = step_bytes(eng)
    log(f"  decode step: host {host_ms:.3f} ms (engine dispatch: uploads, "
        f"graph replay, bookkeeping; mean over the run; graph replay alone "
        f"{replay_enq:.3f} ms), card {card_ms:.3f} ms (events around one "
        f"graph replay, median of 20, {eng.max_batch} slots){eager}; bytes "
        f"bound {n_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms (weights"
        + ("" if eng.paged else " and the dense cache")
        + f" read once: {n_bytes / 1e9:.2f} GB); {peak_note(start)}")
    log_busy(busy, split, names)
    log(f"  {cfg.name} path kernels: {json.dumps(launches)}")
    if extra:
        extra(eng, card_ms)
    eng.shutdown()
    if not all(r.req_state is RequestState.FINISHED for r in reqs) or any(
            len(r.tokens) != k for r, (_, k) in zip(reqs, work)) \
            or retired != len(reqs):
        raise AssertionError(f"{tag}: not every request finished its budget "
                             f"({retired} of {len(reqs)} retired)")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens):
        raise AssertionError(f"{tag}: token outside the vocabulary")
    if m.get("pages_in_use", 0) != 0 or replays != steps:
        raise AssertionError(f"{tag}: {m}; {replays} replays for "
                             f"{steps} steps")
    cold = prefills - d["suffix_steps"]
    # the paged kernel at every attention layer of a step: fused, or the
    # dense decode (dense mode, the unfused steps' gathered view) where
    # the head_dim has an instantiation and no window makes a ring
    paged = eng.fused or (attn_layers and not cfg.window and
                          cfg.resolved_head_dim in paged_attention.HEAD_DIMS)
    want = {"rmsnorm": norms * (prefills + steps),
            "flash_attention": attn_layers * cold,
            "paged_attention": attn_layers * (steps + d["suffix_steps"])
            if paged else 0,
            "ssd_scan": ssd_layers * prefills,
            **dict.fromkeys(BACKWARD_NAMES, 0)}   # serving: no gradient
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, the steps say "
                             f"{want}")
    ttft = sorted(r.ttft for r in reqs)
    d.update(tokens_per_s=n_tokens / wall, card_ms=card_ms,
             ttft_p50_s=ttft[len(ttft) // 2],
             ttft_p99_s=ttft[min(len(ttft) - 1,
                                 round(0.99 * (len(ttft) - 1)))])
    return launches, host_ms, d


def log_busy(busy, split, names) -> None:
    """``busy_ms(..., by_name=True)`` of one eager decode step, printed:
    the kernel sum, its split by family, the 8 costliest kernels."""
    log(f"  card busy of one eager decode step {busy:.3f} ms (kernel sum, "
        "torch.profiler), by kernel family: " + ", ".join(
            f"{fam} {share:.1%}" for fam, share in split.items()))
    for name, (share, n) in list(names.items())[:8]:
        log(f"    {share:6.1%} in {n:g} launches a step: {name[:100]}")


def long_prompt_check(cfg, params, dev, prompt, n):
    """The engine's tokens for one prompt past the window against greedy
    by the port's no-cache ``lm_forward`` over the growing sequence, up to
    the forward's first near tie; returns (tokens compared, forward's
    greedy)."""
    from repro_torch.models import lm
    from repro_torch.serve import Request
    eng = danube_engine(cfg, params, dev, max_batch=1)
    req = Request(prompt, n)
    eng.submit(req)
    eng.close_intake()
    eng.run(timeout=600)
    eng.shutdown()
    seq, near = list(prompt), n
    for i in range(n):
        toks = torch.as_tensor(np.asarray(seq, np.int32)[None], device=dev)
        last = lm.lm_forward(params, {"tokens": toks}, cfg)[0, -1].float()
        top2 = torch.topk(last, 2).values
        if near == n and float(top2[0] - top2[1]) < 1e-3:
            near = i
        seq.append(int(torch.argmax(last)))
        del last
    want = seq[len(prompt):]
    if req.tokens[:near] != want[:near]:
        raise AssertionError(f"15a: {len(prompt)}-token prompt: engine "
                             f"{req.tokens} != no-cache greedy {want} within "
                             f"{near} tokens")
    return near, want


def phase_danube(dev, label):
    """15: h2o-danube3-4b at full width and depth, dense mode on a ring of
    its 4096 window."""
    from repro_torch.models import lm
    t_phase = time.perf_counter()
    start = peak_start()
    cfg = family_config("h2o_danube3_4b", torch.float32)
    params = lm.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(15)
    prompts = identity_prompts(cfg, rng, (64, 200, 777, 1500))
    checked, _ = family_identity("15a fp32 identity", cfg, params, dev,
                                 prompts, 16, danube_engine, DANUBE_CACHE)
    long = rng.integers(0, cfg.vocab_size, DANUBE_LONG)
    near, _ = long_prompt_check(cfg, params, dev, long, 8)
    log(f"phase 15a: fp32 danube identity OK: engine in dense mode (ring of "
        f"{cfg.window}), 4 requests (prompts 64-1500), {checked}/64 tokens "
        f"equal to greedy_generate (the rest past a near tie); the "
        f"{DANUBE_LONG}-token prompt ({DANUBE_LONG} % {cfg.window} = "
        f"{DANUBE_LONG % cfg.window}): {near}/8 tokens equal to greedy by "
        f"the no-cache lm_forward; {peak_note(start)}")
    del params
    free_card()
    cfg = family_config("h2o_danube3_4b", torch.bfloat16)
    params = lm.init_params(cfg, seed=0, device=dev)
    work = [(rng.integers(0, cfg.vocab_size, int(n)),
             int(rng.integers(32, 129)))
            for n in rng.integers(64, 2049, 16)]
    work.append((rng.integers(0, cfg.vocab_size, DANUBE_LONG), 64))
    launches, host_ms, _ = family_serve("15b", cfg, params, dev, work,
                                        danube_engine, label)
    phase_card_bound(cfg, params, dev, host_ms, label,
                     make_engine=danube_engine, phase="15c")
    del params
    free_card()
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return launches


def ident_engine(cfg, params, dev, speculate=0):
    from repro_torch.serve import ServeEngine
    return ServeEngine(cfg, params, device=dev, max_batch=4, page_size=16,
                       max_seq_len=256, speculate=speculate)


def phase_deepseek(dev, label):
    """16: deepseek-coder-33b at full width (56 q-heads padded to 64 over 8
    KV heads, hd 128), 16 of its 62 layers, paged and fused."""
    from repro_torch.models import lm
    t_phase = time.perf_counter()
    start = peak_start()
    cfg = family_config("deepseek_coder_33b", torch.float32, DEEPSEEK_LAYERS)
    params = lm.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(16)
    prompts = identity_prompts(cfg, rng, (64, 137, 71, 136), shared=(2, 3))
    checked, m = family_identity("16a fp32 identity", cfg, params, dev,
                                 prompts, 16, ident_engine, 256)
    motifs = [rng.integers(0, cfg.vocab_size, k) for k in (4, 7, 16)]
    spec_prompts = [np.tile(mo, -(-96 // len(mo)))[:96] for mo in motifs] \
        + [rng.integers(0, cfg.vocab_size, 80)]
    spec_checked, sm = family_identity(
        "16a fp32 speculative identity", cfg, params, dev, spec_prompts, 16,
        lambda c, p, d: ident_engine(c, p, d, speculate=SPECULATE),
        256)
    log(f"phase 16a: fp32 deepseek identity OK: paged + fused, 4 requests, "
        f"{checked}/64 tokens equal to greedy_generate, prefix_hits "
        f"{m['prefix_hits']} (suffix prefill at hd 128); speculate="
        f"{SPECULATE}: {spec_checked}/64 tokens equal, {sm['verify_steps']} "
        f"verify steps, drafts accepted {sm['draft_accepted']} of "
        f"{sm['draft_proposed']}; {peak_note(start)}")
    if m["prefix_hits"] < 1 or sm["verify_steps"] < 1:
        raise AssertionError("16a: no prefix hit or no verify step")
    del params
    free_card()
    cfg = family_config("deepseek_coder_33b", torch.bfloat16,
                        DEEPSEEK_LAYERS)
    params = lm.init_params(cfg, seed=0, device=dev)
    launches, _, d = family_serve("16b", cfg, params, dev,
                                  serve_workload(cfg, rng), serve_engine,
                                  label)
    if d["prefix_hits"] < 1:
        raise AssertionError("16b: the shared prefix never hit")
    del params
    free_card()
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return launches


def wide_workload(cfg, rng):
    """8 requests of 64-512 prompt tokens, 16-32 new."""
    return [(rng.integers(0, cfg.vocab_size, int(n)),
             int(rng.integers(16, 33))) for n in rng.integers(64, 513, 8)]


def phase_wide(dev, label):
    """17: llama3-405b and command-r-plus-104b at full width, 2 layers:
    fp32 identity, then a short bf16 serve."""
    from repro_torch.models import lm
    out = {}
    for name in ("llama3_405b", "command_r_plus_104b"):
        t_phase = time.perf_counter()
        start = peak_start()
        cfg = family_config(name, torch.float32, WIDE_LAYERS)
        params = lm.init_params(cfg, seed=0, device=dev)
        rng = np.random.default_rng(17)
        prompts = identity_prompts(cfg, rng, (64, 151))
        checked, _ = family_identity(f"17a {name} fp32 identity", cfg,
                                     params, dev, prompts, 8,
                                     ident_engine, 256)
        log(f"phase 17a: fp32 {name} identity OK ({WIDE_LAYERS} layers, d "
            f"{cfg.d_model}, {cfg.padded_heads}/{cfg.padded_kv_heads} heads, "
            f"parallel_block={cfg.parallel_block}): {checked}/16 tokens equal "
            f"to greedy_generate; {peak_note(start)}")
        del params
        free_card()
        cfg = family_config(name, torch.bfloat16, WIDE_LAYERS)
        params = lm.init_params(cfg, seed=0, device=dev)
        out[name], _, _ = family_serve("17b", cfg, params, dev,
                                       wide_workload(cfg, rng), serve_engine,
                                       label)
        del params
        free_card()
        log(f"phase 17 {name}: {time.perf_counter() - t_phase:.1f} s")
    return out


# ------------------------------------- the MoE and hybrid families (18-20)
MOE_LAYERS = 8         # qwen3-moe (94 layers) and llama4-scout (48), bf16
MOE_IDENT_LAYERS = 2   # the same in fp32 (twice the bytes a layer)
ZAMBA_CACHE = 4096     # max_cache_len of phase 20: prompts to 2,048 + 128


def moe_dispatch_share(cfg, dev):
    """``extra`` of 18b/19b: MoE routing, dispatch and combine in one
    decode step, as a family of their own: each stage of layer 0's block
    at the step's shape (8 slots, one token each, capacity 1) timed by
    events (median of 20, a sleep ahead), times the layers, against the
    step's card time."""
    from repro_torch.models import moe
    from repro_torch.models.layers import mlp

    def extra(eng, card_ms):
        m, L, S = cfg.moe, cfg.n_layers, eng.max_batch
        lp = eng._layers[0]["moe"]
        x = torch.randn((S, 1, cfg.d_model), device=dev).to(cfg.dtype)
        expert_in, how = moe._dispatch(lp, x, cfg)
        out = moe._experts_apply(lp, expert_in, cfg)
        t = {"routing and dispatch": median_ms(
                 lambda: moe._dispatch(lp, x, cfg), runs=20),
             "expert products": median_ms(
                 lambda: moe._experts_apply(lp, expert_in, cfg), runs=20),
             "combine": median_ms(lambda: moe._combine(out, how, cfg),
                                  runs=20),
             "shared expert": median_ms(lambda: mlp(lp["shared"], x),
                                        runs=20) if m.shared_d_ff else 0.0}
        block = median_ms(lambda: moe.moe_block(lp, x, cfg), runs=20)
        own = t["routing and dispatch"] + t["combine"]
        log(f"  MoE block of one layer at the step's shape, by events: "
            f"{block:.3f} ms; x {L} layers against the step's card "
            f"{card_ms:.3f} ms: " + ", ".join(
                f"{name} {ms * L:.3f} ms ({ms * L / card_ms:.1%})"
                for name, ms in t.items())
            + f"; MoE routing, dispatch and combine as one family "
            f"{own * L:.3f} ms = {own * L / card_ms:.1%} of the step")
    return extra


def phase_moe(tag, name, dev, label):
    """18 (qwen3-moe-235b-a22b: 64/4 heads, 128 experts top-8) and 19
    (llama4-scout-17b-16e: 40 q-heads padded to 48 over 8, 16 experts
    top-1 and a shared expert) at full width, paged and fused: fp32
    identity on 4 cold requests at 2 layers, phase 5's bf16 workload at 8,
    and the card-bound loop."""
    from repro_torch.models import lm
    t_phase = time.perf_counter()
    start = peak_start()
    cfg = family_config(name, torch.float32, MOE_IDENT_LAYERS)
    params = lm.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(int(tag))
    prompts = identity_prompts(cfg, rng, (64, 137, 71, 136))
    checked, m = family_identity(f"{tag}a fp32 identity", cfg, params, dev,
                                 prompts, 16, ident_engine, 256,
                                 step_guard=True)
    mo = cfg.moe
    log(f"phase {tag}a: fp32 {name} identity OK ({MOE_IDENT_LAYERS} layers, "
        f"d {cfg.d_model}, {cfg.padded_heads}/{cfg.padded_kv_heads} heads, "
        f"{mo.n_experts} experts top-{mo.top_k}"
        + (f" + a shared expert" if mo.shared_d_ff else "")
        + f"): paged + fused, 4 cold requests, {checked}/64 tokens equal to "
        f"greedy_generate (guarded by its own steps' margins); "
        f"{peak_note(start)}")
    if m["prefix_hits"]:
        raise AssertionError(f"{tag}a: a cold request hit the prefix cache")
    del params
    free_card()
    cfg = family_config(name, torch.bfloat16, MOE_LAYERS)
    params = lm.init_params(cfg, seed=0, device=dev)
    launches, host_ms, d = family_serve(
        f"{tag}b", cfg, params, dev, serve_workload(cfg, rng), serve_engine,
        label, extra=moe_dispatch_share(cfg, dev))
    if d["prefix_hits"] < 1:
        raise AssertionError(f"{tag}b: the shared prefix never hit")
    phase_card_bound(cfg, params, dev, host_ms, label, phase=f"{tag}c")
    del params
    free_card()
    log(f"phase {tag}: {time.perf_counter() - t_phase:.1f} s")
    return launches


def zamba_engine(cfg, params, dev, max_batch=8):
    """Dense mode (a hybrid has no paged cache): the SSM state and 7 sites'
    KV of ``ZAMBA_CACHE`` positions a slot."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params, device=dev, max_batch=max_batch,
                      max_cache_len=ZAMBA_CACHE, max_inflight=2)
    if eng.paged or tuple(eng._cache["k"].shape[:3]) != (
            cfg.hybrid_sites, max_batch, ZAMBA_CACHE):
        raise AssertionError("zamba2 must be served in dense mode with a "
                             "KV cache a site")
    return eng


def phase_zamba(dev, label):
    """20: zamba2-1.2b whole (38 SSM layers, the shared block at 7 sites),
    dense mode: fp32 identity and forward/prefill agreement, a bf16 serve
    of 16 requests of 64-2,048 prompt tokens, the card-bound loop."""
    from repro_torch.models import lm
    t_phase = time.perf_counter()
    start = peak_start()
    cfg = family_config("zamba2_1p2b", torch.float32)
    params = lm.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(20)
    prompts = identity_prompts(cfg, rng, (64, 200, 777, 1500))
    checked, _ = family_identity("20a fp32 identity", cfg, params, dev,
                                 prompts, 16, zamba_engine, ZAMBA_CACHE)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 512)),
                           dtype=torch.int32, device=dev)
    full = lm.lm_forward(params, {"tokens": toks}, cfg)[:, -1]
    last, _ = lm.lm_prefill(params, {"tokens": toks}, cfg,
                            lm.init_cache(cfg, 1, 512, device=dev))
    err = max_err(full, last[:, -1])
    log(f"phase 20a: fp32 zamba2 identity OK: whole ({cfg.n_layers} SSM "
        f"layers, the shared block at {cfg.hybrid_sites} sites, "
        f"{cfg.param_count() / 1e9:.3f} B parameters), engine in dense "
        f"mode, 4 requests (prompts 64-1500), {checked}/64 tokens equal to "
        f"greedy_generate (the rest past a near tie); lm_forward vs "
        f"lm_prefill last-row logits on 512 tokens: max_abs_err {err:.3g} "
        f"(tol 1e-3); {peak_note(start)}")
    if err > 1e-3:
        raise AssertionError("zamba2: lm_forward and lm_prefill disagree")
    del params, full, last
    free_card()
    cfg = family_config("zamba2_1p2b", torch.bfloat16)
    params = lm.init_params(cfg, seed=0, device=dev)
    work = [(rng.integers(0, cfg.vocab_size, int(n)),
             int(rng.integers(32, 129)))
            for n in rng.integers(64, 2049, 16)]
    launches, host_ms, _ = family_serve("20b", cfg, params, dev, work,
                                        zamba_engine, label)
    phase_card_bound(cfg, params, dev, host_ms, label,
                     make_engine=zamba_engine, phase="20c")
    del params
    free_card()
    log(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    return launches


GRANITE_LAYERS = 6     # 28's depth: layers 0-4 Mamba-2, layer 5 attends


def granite_engine(cfg, params, dev, max_batch=8):
    """Dense mode (a moe_hybrid has no paged cache): the SSM state of its
    Mamba-2 layers and its attention layers' KV of the cell's 4096
    positions a slot, and the MoE counters on the device."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params, device=dev, max_batch=max_batch,
                      max_cache_len=GRANITE_SHAPES["cache"], max_inflight=2)
    if eng.paged or tuple(eng._cache["k"].shape[:3]) != (
            cfg.n_mixers("attention"), max_batch, GRANITE_SHAPES["cache"]) \
            or eng._moe_counts is None:
        raise AssertionError("granite must be served in dense mode with a "
                             "KV cache an attention layer and MoE counters")
    return eng


def granite_counters(cfg):
    """28b's ``extra``: the MoE counters the engine put in ``stats`` (from
    the device, behind each step) against its steps and prefills: every
    layer's block once a captured decode step and once a prefill, each
    step's rows every slot's top-k, the experts hit between one and all a
    call."""
    from repro_torch.obs import events

    def check(eng, _card_ms):
        st, L, m = eng.stats, cfg.n_layers, cfg.moe
        (dc, dr, dh), (pc, pr, ph) = (
            [st[n] for n in names] for names in events.MOE_COUNTERS)
        log(f"  MoE counters (engine stats): decode {dc} calls, {dr} rows, "
            f"{dh} experts hit ({dr / max(dh, 1):.2f} rows an expert); "
            f"prefill {pc} calls, {pr} rows, {ph} experts hit; "
            f"{st['steps']} steps, {st['prefills']} prefills, {L} layers")
        if (dc, pc, dr) != (L * st["steps"], L * st["prefills"],
                            dc * eng.max_batch * m.top_k) \
                or not dc <= dh <= dc * m.n_experts \
                or not pc <= ph <= pc * m.n_experts or pr % m.top_k:
            raise AssertionError("28b: the MoE counters disagree with the "
                                 "engine's steps and prefills")
    return check


def phase_granite(dev, label):
    """28: granite-4.0-h-small at its published widths cut to its first
    ``GRANITE_LAYERS`` layers (5 Mamba-2, 1 NoPE attention at 1/128, each
    with its 72-expert dropless MoE block), bf16 (the card's grouped
    products take nothing else), dense mode: 16 requests of 64-3,072
    prompt tokens under sync debug mode "error" (no readback in a step),
    each kernel's launches as the steps say (flash a prefill and the paged
    kernel a captured step at the attention layer, the SSD scan a prefill
    at each Mamba-2 layer), the MoE counters against the steps; then the
    card-bound loop."""
    from repro_torch.models import lm
    t_phase = time.perf_counter()
    cfg = family_config("granite_4_0_h_small", torch.bfloat16,
                        GRANITE_LAYERS)
    if cfg.mixers[-1] != ("attention", 0) or cfg.n_mixers("attention") != 1:
        raise AssertionError("28: the cut stack must end at its first "
                             "attention layer")
    params = lm.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(28)
    work = [(rng.integers(0, cfg.vocab_size, int(n)),
             int(rng.integers(32, 129)))
            for n in rng.integers(64, GRANITE_SHAPES["prompt"] + 1, 16)]
    launches, host_ms, _ = family_serve("28b", cfg, params, dev, work,
                                        granite_engine, label,
                                        extra=granite_counters(cfg))
    phase_card_bound(cfg, params, dev, host_ms, label,
                     make_engine=granite_engine, phase="28c")
    del params
    free_card()
    log(f"phase 28: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------- the enc-dec and the VLM (21-22)
WHISPER_TOKENS = 64    # 21b's new tokens a clip (the BOS's and 63 steps')
WHISPER_IDENT = 32     # 21a's greedy tokens a clip
CARD_BOUND_STEPS = 16  # 21c's continuation-driven replays
STEP_SLEEP_MS = 50.0   # the sleep ahead of each of 21c's replays
VLM_PROMPT = 512       # 22b's tokens a request after its 1024 patches
VLM_NEW = 32           # 22b's new tokens a request
VLM_IDENT_LAYERS = 4   # internvl2-26b cut from 48 layers for 22a's fp32


def events_ms(fn):
    """``fn()``'s result and its ms by events around one call (the host's
    enqueue and the card's work, whichever ends later)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def near_tie_free(logits, margin=1e-3) -> int:
    """Positions of ``logits (S, V)`` before the first whose top-2 margin
    is below ``margin``: greedy tokens past it may flip."""
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    near = torch.nonzero(top2[:, 0] - top2[:, 1] < margin)
    return int(near[0, 0]) if len(near) else logits.shape[0]


def decode_graph(step, first, pos, dev):
    """``step(tokens, positions)`` → logits, captured as a ``StepGraph``
    over static token (B, 1) and position (B,) buffers with the greedy
    argmax in the graph; returns (graph, token buffer, position buffer).
    The capture runs the step once eagerly first, at ``first``/``pos``."""
    from repro_torch.serve.graphs import StepGraph
    tok_buf = first.clone()
    pos_buf = torch.full((first.shape[0],), pos, dtype=torch.int64,
                         device=dev)

    def fn():
        logits = step(tok_buf, pos_buf)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    return StepGraph(fn, dev), tok_buf, pos_buf


def greedy_replays(graph, tok_buf, pos_buf, first, pos, n):
    """``n`` greedy steps from token ``first`` at position ``pos``, one
    replay each; the next step's token and positions are set on the card
    (no host read). Returns the (B, n) tokens the steps emitted."""
    tok_buf.copy_(first)
    pos_buf.fill_(pos)
    out = []
    for _ in range(n):
        nxt = graph()
        out.append(nxt.clone())
        tok_buf.copy_(nxt)
        pos_buf.add_(1)
    return torch.cat(out, dim=1)


def greedy_eager(step, first, pos, n):
    """The same ``n`` greedy steps through the eager step function."""
    tok, out = first, []
    for i in range(n):
        logits = step(tok, pos + i)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)


def clone_state(state):
    """An enc-dec decode state whose self-KV is a copy (the cross-KV is
    only read, so it is shared)."""
    return {"cross": state["cross"],
            "self": {n: t.clone() for n, t in state["self"].items()}}


def continuation_loop(graph, tok_buf, pos_buf, first, pos, n, dev):
    """21c: ``n`` replays driven by the port's continuation engine. Each
    replay is queued behind a ``STEP_SLEEP_MS`` sleep kernel, its tokens
    start down to a pinned host tensor, and its completion is one
    ``TensorOp``; the op's continuation takes the tokens and posts the
    next step. The host only polls (``Engine.tick``), under sync debug
    mode "error". Returns (tokens (B, n) on the host, steps pending at
    their first poll, wall s)."""
    from repro_torch.core import ContinueFlags, Engine, TensorOp
    engine = Engine()
    cr = engine.continue_init()
    flags = ContinueFlags(enqueue_complete=True)
    cycles = int(STEP_SLEEP_MS * sleep_cycles_per_ms())
    got = []

    def post(i):
        torch.cuda._sleep(cycles)
        nxt = graph()
        host = torch.empty(nxt.shape, dtype=nxt.dtype, pin_memory=True)
        host.copy_(nxt, non_blocking=True)
        tok_buf.copy_(nxt)
        pos_buf.add_(1)
        engine.continue_when(TensorOp(nxt, payload=host), on_done,
                             (i, host), cr=cr, flags=flags)

    def on_done(statuses, meta):
        i, host = meta
        got.append(host.numpy().copy())
        if i + 1 < n:
            post(i + 1)

    tok_buf.copy_(first)
    pos_buf.fill_(pos)
    torch.cuda.synchronize()
    TensorOp.PENDING_AT_FIRST_POLL = 0
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    deadline = t0 + 60 + n * STEP_SLEEP_MS / 1e3
    try:
        post(0)
        while len(got) < n:
            if time.perf_counter() > deadline:
                raise TimeoutError(f"21c: {len(got)} of {n} steps delivered")
            engine.tick()
            time.sleep(0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    wall = time.perf_counter() - t0
    engine.shutdown()
    return (np.concatenate(got, axis=1), TensorOp.PENDING_AT_FIRST_POLL,
            wall)


def whisper_identity(dev, label):
    """21a: fp32, whole, 2 clips x 32 greedy tokens through the two step
    factories, each step's logits held to the teacher-forced forward."""
    from repro_torch.models import encdec
    from repro_torch.serve import make_decode_step, make_prefill_step
    start = peak_start()
    cfg = family_config("whisper_large_v3", torch.float32)
    params = encdec.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(21)
    audio = torch.as_tensor(rng.standard_normal(
        (2, WHISPER_SHAPES["frames"], cfg.frontend_dim), dtype=np.float32),
        device=dev)
    logits, state = make_prefill_step(cfg, cfg.max_target_len)(
        params, {"audio_embed": audio})
    decode = make_decode_step(cfg)
    steps, toks = [logits[:, -1]], []
    for i in range(1, WHISPER_IDENT):
        toks.append(torch.argmax(steps[-1], -1).to(torch.int32)[:, None])
        logits, state = decode(params, state, toks[-1], i)
        steps.append(logits[:, -1])
    toks.append(torch.argmax(steps[-1], -1).to(torch.int32)[:, None])
    step_logits = torch.stack(steps, dim=1)                 # (2, 32, V)
    tokens = torch.cat(toks, dim=1)
    # the teacher-forced forward over BOS and the first 31 tokens
    seq = torch.cat([torch.zeros_like(tokens[:, :1]), tokens[:, :-1]], 1)
    full = encdec.encdec_logits(params, audio, seq, cfg)
    err = max_err(step_logits, full)
    checked = 0
    for b in range(2):
        near = near_tie_free(full[b])
        if not torch.equal(torch.argmax(full[b, :near], -1).to(torch.int32),
                           tokens[b, :near]):
            raise AssertionError(f"21a: clip {b}: the steps' greedy tokens "
                                 "differ from the forward's before a near "
                                 "tie")
        checked += near
    log(f"phase 21a: fp32 whisper-large-v3 whole ({cfg.n_enc_layers} + "
        f"{cfg.n_dec_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads padded to {cfg.padded_heads}, "
        f"{cfg.param_count() / 1e9:.3f} B parameters) on {label}: 2 clips of "
        f"{WHISPER_SHAPES['frames']} frames x {WHISPER_IDENT} greedy tokens "
        f"(prefill step, then decode steps): logits vs the teacher-forced "
        f"forward max_abs_err {err:.3g} (tol 2e-3); {checked}/"
        f"{2 * WHISPER_IDENT} tokens equal to the forward's greedy (the rest "
        f"past a near tie); {peak_note(start)}")
    if err > 2e-3 or not torch.isfinite(step_logits[..., :cfg.vocab_size]
                                        ).all():
        raise AssertionError("21a: cached decoding disagrees with the "
                             "teacher-forced forward")


def whisper_serve(dev, label):
    """21b and 21c: bf16, whole, 8 clips x 64 new tokens; the decode step
    captured once and replayed, against the eager loop; then the replays
    driven by continuations with a sleep ahead of each."""
    from repro_torch.models import encdec
    from repro_torch.models.layers import layer_views
    from repro_torch.serve import make_prefill_step
    start = peak_start()
    cfg = family_config("whisper_large_v3", torch.bfloat16)
    params = encdec.init_params(cfg, seed=0, device=dev)
    B, T = WHISPER_SHAPES["clips"], WHISPER_SHAPES["frames"]
    rng = np.random.default_rng(22)
    audio = torch.as_tensor(rng.standard_normal(
        (B, T, cfg.frontend_dim), dtype=np.float32), device=dev)
    prefill = make_prefill_step(cfg, cfg.max_target_len)
    views = layer_views(params, "decoder")

    def decode(params, state, token, pos):
        # the model's step on layer views made once, so that the eager
        # loop's host time does not remake them every step
        return encdec.encdec_decode_step(params, token, cfg, state, pos,
                                         layers=views)
    prefill(params, {"audio_embed": audio})          # warm: cuBLAS, kernels
    zero_counts()
    (logits, state), prefill_ms = events_ms(
        lambda: prefill(params, {"audio_embed": audio}))
    first = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    eager_state = clone_state(state)
    n = WHISPER_TOKENS - 1
    graph, tok_buf, pos_buf = decode_graph(
        lambda t, p: decode(params, state, t, p)[0], first, 1, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    replayed = greedy_replays(graph, tok_buf, pos_buf, first, 1, n)
    pace_ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = read_counts()
    want = {"rmsnorm": 2 * cfg.n_enc_layers + 1 + (3 * cfg.n_dec_layers + 1)
            * (2 + n), "flash_attention": cfg.n_enc_layers
            + cfg.n_dec_layers * (2 + n),
            "paged_attention": cfg.n_dec_layers * (2 + n),
            "ssd_scan": 0, **dict.fromkeys(BACKWARD_NAMES, 0)}
    eager = greedy_eager(lambda t, p: decode(params, eager_state, t, p)[0],
                         first, 1, n)
    if not torch.equal(eager, replayed):
        raise AssertionError("21b: the replayed steps' tokens differ from "
                             "the eager loop's")
    if launches != want:
        raise AssertionError(f"21b: launches {launches}, one prefill, the "
                             f"capture's eager step and {n} replays say "
                             f"{want}")
    card_ms = median_ms(graph, runs=20)
    host_ms = enqueue_ms(graph)
    eager_step = lambda: decode(params, eager_state, first, 1)  # noqa: E731
    eager_host = enqueue_ms(eager_step)
    busy = busy_ms(eager_step, by_name=True)
    # the least bytes a step moves: the decoder's weights, the tied
    # embedding (the logits read all of it) and the final norm once, the
    # cross-KV and the self-KV rows the timed replay holds (positions 0 ..
    # WHISPER_TOKENS: the dense decode reads a row's held positions only);
    # the prefill's operations: the frontend, the encoder's and the
    # cross-KV projections' products, the encoder's attention over every
    # (frame, frame) pair
    self_kv = tree_bytes(state["self"]) * (WHISPER_TOKENS + 1) \
        // cfg.max_target_len
    step_bytes_ = tree_bytes(params["decoder"]) + tree_bytes(params["embed"]) \
        + tree_bytes(params["dec_norm"]) + tree_bytes(state["cross"]) \
        + self_kv
    d, hd = cfg.d_model, cfg.resolved_head_dim
    enc_w = tree_numel(params["encoder"])
    cross_w = 2 * d * cfg.padded_kv_heads * hd * cfg.n_dec_layers
    rows = B * T
    prefill_flops = 2 * rows * (cfg.frontend_dim * d + enc_w + cross_w) \
        + 4 * B * cfg.padded_heads * hd * T * T * cfg.n_enc_layers
    prefill_bound = bound_ms(tree_bytes(params) + tree_bytes(state),
                             prefill_flops, cfg.dtype)
    step_bound = step_bytes_ / HBM_BYTES_PER_S * 1e3
    tokens_s = B * WHISPER_TOKENS / (prefill_ms / 1e3 + decode_s)
    log(f"phase 21b: bf16 whisper-large-v3 whole on {label}: {B} clips of "
        f"{T} frames x {WHISPER_TOKENS} new tokens: prefill (encoder, "
        f"cross-KV, BOS) {prefill_ms:.3f} ms by events = TTFT (bound "
        f"{prefill_bound[0]:.3f} ms, {prefill_bound[1]}); decode step: host "
        f"{host_ms:.3f} ms (one replay's enqueue on the idle card, median of "
        f"10; the loop of {n} replays paced {pace_ms:.3f} ms a step; eager "
        f"step function {eager_host:.3f} ms), card {card_ms:.3f} ms (events "
        f"around one "
        f"replay, median of 20) against a bytes bound of {step_bound:.3f} ms "
        f"({step_bytes_ / 1e9:.2f} GB: decoder weights, embedding, cross-KV "
        f"{tree_bytes(state['cross']) / 1e9:.2f} GB, self-KV "
        f"{self_kv / 1e9:.2f} GB of the {WHISPER_TOKENS + 1} positions held "
        f"of {cfg.max_target_len}); {B * WHISPER_TOKENS} tokens in "
        f"{prefill_ms / 1e3 + decode_s:.3f} s = {tokens_s:.1f} tokens/s; "
        f"replayed tokens equal to the eager loop's ({B}x{n}); "
        f"{peak_note(start)}")
    log_busy(*busy)
    log(f"  whisper_large_v3 path kernels: {json.dumps(launches)} (one "
        f"prefill, the capture's eager step, {n} replays)")
    # 21c: from where 21b stopped; its tokens held to the eager loop's
    last, pos = replayed[:, -1:], WHISPER_TOKENS
    eager = greedy_eager(lambda t, p: decode(params, eager_state, t, p)[0],
                         eager[:, -1:], pos, CARD_BOUND_STEPS)
    got, pending, wall = continuation_loop(graph, tok_buf, pos_buf, last,
                                           pos, CARD_BOUND_STEPS, dev)
    log(f"phase 21c: card-bound loop on {label}: {CARD_BOUND_STEPS} replays "
        f"posted by continuations, {STEP_SLEEP_MS:.0f} ms of sleep queued "
        f"ahead of each; {wall * 1e3:.1f} ms wall; PENDING_AT_FIRST_POLL "
        f"{pending} of {CARD_BOUND_STEPS} steps; tokens equal to the eager "
        f"loop's: {bool(np.array_equal(got, eager.cpu().numpy()))}")
    if not np.array_equal(got, eager.cpu().numpy()):
        raise AssertionError("21c: the continuation-driven replays' tokens "
                             "differ from the eager loop's")
    if wall * 1e3 < 0.9 * CARD_BOUND_STEPS * STEP_SLEEP_MS:
        raise AssertionError("21c: the sleep kernels did not hold the card")
    if pending < 0.9 * CARD_BOUND_STEPS:
        raise AssertionError(f"21c: only {pending} of {CARD_BOUND_STEPS} "
                             "steps were running at their first poll")
    if not all(0 <= t < cfg.vocab_size for t in got.ravel()):
        raise AssertionError("21c: token outside the vocabulary")
    return launches


def phase_whisper(dev, label):
    """21: whisper-large-v3 whole: fp32 identity, the bf16 8-clip decode
    as graph replays, and the continuation-driven card-bound loop."""
    t_phase = time.perf_counter()
    whisper_identity(dev, label)
    free_card()
    launches = whisper_serve(dev, label)
    free_card()
    log(f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    return launches


def vlm_inputs(cfg, rng, B, S, dev):
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             dtype=torch.int32, device=dev)
    patches = torch.as_tensor(rng.standard_normal(
        (B, cfg.n_patches, cfg.frontend_dim), dtype=np.float32), device=dev)
    return tokens, patches


def vlm_identity(dev, label):
    """22a: fp32 at 4 layers, 2 prompts of 64 and 300 tokens with 1024
    patches, 16 greedy tokens each (prefill with patches, then decode at
    n_patches + S + i), held to ``lm_forward`` over patches, prompt and
    generated tokens."""
    from repro_torch.models import lm
    from repro_torch.serve import make_decode_step, make_prefill_step
    start = peak_start()
    cfg = family_config("internvl2_26b", torch.float32, VLM_IDENT_LAYERS)
    params = lm.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(23)
    n, errs, checked = 16, [], 0
    decode = make_decode_step(cfg)
    for S in (64, 300):
        tokens, patches = vlm_inputs(cfg, rng, 1, S, dev)
        base = cfg.n_patches + S
        logits, cache = make_prefill_step(cfg, base + n)(
            params, {"tokens": tokens, "patches": patches})
        steps, toks = [logits[:, -1]], []
        for i in range(n):
            toks.append(torch.argmax(steps[-1], -1).to(torch.int32)[:, None])
            if i + 1 < n:
                logits, cache = decode(params, cache, toks[-1], base + i)
                steps.append(logits[:, -1])
        gen = torch.cat(toks, dim=1)
        full = lm.lm_forward(params, {"tokens": torch.cat(
            [tokens, gen[:, :-1]], 1), "patches": patches}, cfg)[0, base - 1:]
        errs.append(max_err(torch.stack(steps, 1)[0], full))
        near = near_tie_free(full)
        if not torch.equal(torch.argmax(full[:near], -1).to(torch.int32),
                           gen[0, :near]):
            raise AssertionError(f"22a: prompt {S}: greedy tokens differ from "
                                 "the forward's before a near tie")
        checked += near
        del full, cache
    log(f"phase 22a: fp32 internvl2-26b ({VLM_IDENT_LAYERS} of 48 layers, d "
        f"{cfg.d_model}, {cfg.padded_heads}/{cfg.padded_kv_heads} heads of hd "
        f"{cfg.resolved_head_dim}, {cfg.n_patches} patches of "
        f"{cfg.frontend_dim}) on {label}: prompts of 64 and 300 tokens x {n}: "
        f"prefill with patches, decode at n_patches + S + i: logits vs "
        f"lm_forward max_abs_err {max(errs):.3g} (tol 1e-3); {checked}/"
        f"{2 * n} tokens equal to the forward's greedy; {peak_note(start)}")
    if max(errs) > 1e-3:
        raise AssertionError("22a: decoding after patches disagrees with "
                             "lm_forward")


def vlm_serve(dev, label):
    """22b, 22c: bf16, whole (48 layers): 4 requests of 1024 patches and
    512 tokens, 32 new; the dense decode step captured and replayed; then
    the engine's refusals."""
    from repro_torch.models import lm
    from repro_torch.models.layers import layer_views
    from repro_torch.serve import ServeEngine, make_prefill_step
    start = peak_start()
    cfg = family_config("internvl2_26b", torch.bfloat16)
    params = lm.init_params(cfg, seed=0, device=dev)
    held = torch.cuda.memory_allocated()
    rng = np.random.default_rng(24)
    B, S = VLM_SHAPES["batch"], VLM_PROMPT
    tokens, patches = vlm_inputs(cfg, rng, B, S, dev)
    base = cfg.n_patches + S
    prefill = make_prefill_step(cfg, base + VLM_NEW)
    views = layer_views(params)

    def decode(params, cache, token, pos):
        # as in 21b: the model's step on layer views made once
        return lm.lm_decode_step(params, token, cfg, cache, pos,
                                 layers=views)
    batch = {"tokens": tokens, "patches": patches}
    prefill(params, batch)                            # warm
    zero_counts()
    (logits, cache), prefill_ms = events_ms(lambda: prefill(params, batch))
    first = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    n = VLM_NEW - 1
    graph, tok_buf, pos_buf = decode_graph(
        lambda t, p: decode(params, cache, t, p)[0], first, base, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = greedy_replays(graph, tok_buf, pos_buf, first, base, n)
    pace_ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    launches = read_counts()
    L = cfg.n_layers
    want = {"rmsnorm": (2 * L + 1) * (2 + n), "flash_attention": L,
            "paged_attention": L * (1 + n), "ssd_scan": 0,
            **dict.fromkeys(BACKWARD_NAMES, 0)}
    if launches != want:
        raise AssertionError(f"22b: launches {launches}, one prefill, the "
                             f"capture's eager step and {n} replays say "
                             f"{want}")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()) \
            or not bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        raise AssertionError("22b: non-finite logits or a token outside "
                             "the vocabulary")
    card_ms = median_ms(graph, runs=20)
    host_ms = enqueue_ms(graph)
    busy = busy_ms(lambda: decode(params, cache, first, base), by_name=True)
    # a step's least bytes: every weight but the token table (4 rows of
    # it) and the patch projector, and the whole dense KV cache; the
    # prefill's operations: every layer's products over its rows, causal
    # attention, and the patch projection
    emb = params["embed"]["tokens"]
    step_b = tree_bytes(params) - emb.numel() * emb.element_size() \
        - tree_bytes(params["frontend"]) + tree_bytes(cache)
    rows = B * VLM_SHAPES["rows"]
    layer_w = tree_numel(params["layers"])
    pairs = VLM_SHAPES["rows"] * (VLM_SHAPES["rows"] + 1) // 2
    prefill_flops = 2 * rows * (layer_w + cfg.frontend_dim * cfg.d_model) \
        + 4 * B * cfg.padded_heads * cfg.resolved_head_dim * pairs * L \
        + 2 * B * cfg.d_model * cfg.padded_vocab
    prefill_bound = bound_ms(tree_bytes(params) + tree_bytes(cache),
                             prefill_flops, cfg.dtype)
    log(f"phase 22b: bf16 internvl2-26b whole ({L} layers, "
        f"{tree_bytes(params) / 1e9:.2f} GB of weights) on {label}: {B} "
        f"requests of {cfg.n_patches} patches + {S} tokens, {VLM_NEW} new: "
        f"prefill {prefill_ms:.3f} ms by events (bound "
        f"{prefill_bound[0]:.3f} ms, {prefill_bound[1]}); dense decode "
        f"step: host {host_ms:.3f} ms (one replay's enqueue on the idle "
        f"card; the loop paced {pace_ms:.3f} ms a step), card "
        f"{card_ms:.3f} ms "
        f"(events around one replay, median of 20) against a bytes bound of "
        f"{step_b / HBM_BYTES_PER_S * 1e3:.3f} ms ({step_b / 1e9:.2f} GB: "
        f"weights and the {tree_bytes(cache) / 1e9:.2f} GB KV cache of "
        f"{base + VLM_NEW} positions); weights held "
        f"{mib(held - start)}; {peak_note(start)}")
    log_busy(*busy)
    log(f"  internvl2_26b path kernels: {json.dumps(launches)} (one prefill, "
        f"the capture's eager step, {n} replays)")
    refused = []
    for c, p in ((cfg, params), (family_config("whisper_large_v3",
                                               torch.bfloat16), {})):
        try:
            ServeEngine(c, p, device=dev)
        except NotImplementedError as e:
            refused.append(f"{c.name}: {e}")
        else:
            raise AssertionError(f"22c: ServeEngine built for {c.name}")
    log("phase 22c: ServeEngine refuses at construction: "
        + "; ".join(refused))
    return launches


def phase_vlm(dev, label):
    """22: internvl2-26b: fp32 identity at 4 layers, the bf16 whole model's
    prefill and captured decode step, the engine's refusals."""
    t_phase = time.perf_counter()
    vlm_identity(dev, label)
    free_card()
    launches = vlm_serve(dev, label)
    free_card()
    log(f"phase 22: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------ phase 25
TRAIN_STEPS = 30       # 25b: launch.train's steps, a checkpoint every 10
TRAIN_CKPT_EVERY = 10
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 512   # 25a's step (the CPU's too)
NOWAIT_STEPS = 6       # 25c: steps behind a sleep, a checkpoint every 3
RESTART_AT, RESTART_STEPS = 10, 12            # 25d


def tree_rel_diff(a, b, where=None) -> float:
    """The largest per-leaf difference of two like trees, each over its
    leaf's largest magnitude (``b`` the reference); with ``where`` (a like
    tree of masks) only at the masked elements."""
    from repro_torch.optim.tree import tree_leaves
    masks = tree_leaves(where) if where is not None else None
    worst = 0.0
    for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
        x, y = x.detach().cpu().float(), y.detach().cpu().float()
        d = (x - y).abs()
        if masks is not None:
            d = d[masks[i]]
        if d.numel():
            worst = max(worst, float(d.max())
                        / max(float(y.abs().max()), 1e-30))
    return worst


#: AdamW's first update of an element is lr * g / (|g| + eps): where |g| is
#: near eps (1e-8) it turns on the gradient's last bits, so two correct
#: steps that sum in other orders differ there by up to 2 lr (so does the
#: CPU against itself at another thread count). 25a holds
#: the params where |g| is above 100 eps, and everywhere the gradient
#: itself (through m = 0.1 g and v = 0.05 g^2)
WELL_CONDITIONED_GRAD = 1e-6


def train_step_check(dev, cfg=None, batch=(TRAIN_CHECK_BATCH,
                                          TRAIN_CHECK_SEQ), tag="25a",
                     what="at full width"):
    """25a / 27a: one fp32 step of ``cfg`` (paper_demo by default) on the
    card (the kernels, forward and backward) against the same step on the
    CPU (the plain versions), from one converted state and one synthetic
    batch of ``batch`` = (B, S) (whisper: S the encoder's frames)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokenSource
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.optim import OptConfig
    from repro_torch.optim.tree import tree_map
    from repro_torch.train.train_step import init_train_state, make_train_step
    if cfg is None:
        cfg = get_config("paper_demo", dtype=torch.float32,
                         param_dtype=torch.float32)
    opt = OptConfig()
    tree = tree_map(lambda t: t.numpy(), init_train_state(
        cfg, opt, seed=0, device="cpu"))
    card = train_state_from_numpy(tree, cfg, dev)
    host = train_state_from_numpy(tree, cfg, "cpu")
    del tree
    B, S = batch
    data = {k: torch.from_numpy(v) for k, v in SyntheticTokenSource(
        cfg, B, S, seed=0).make_batch(0).items()}
    step = make_train_step(cfg, opt)
    t0 = time.perf_counter()
    card, mg = step(card, {k: v.to(dev) for k, v in data.items()})
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host, mc = step(host, data)
    host_s = time.perf_counter() - t0
    part = {"params": lambda st: st["params"],
            "m": lambda st: st["opt"]["m"], "v": lambda st: st["opt"]["v"]}
    diffs = {k: tree_rel_diff(f(card), f(host)) for k, f in part.items()}
    # m = (1 - b1) g after one step
    sure = tree_map(lambda m: m.abs() > (1 - opt.b1) * WELL_CONDITIONED_GRAD,
                    host["opt"]["m"])
    held = {"params where |g| > 1e-6": tree_rel_diff(
        card["params"], host["params"], sure),
        "m": diffs["m"], "v": diffs["v"]}
    worst = max(held.values())
    log(f"phase {tag}: one fp32 train step of {cfg.name} {what} "
        f"(B {B} x {S}), card (kernels) vs "
        f"CPU (plain versions) from one converted state: loss "
        f"{float(mg['loss']):.6f} vs {float(mc['loss']):.6f}, grad_norm "
        f"{float(mg['grad_norm']):.6f} vs {float(mc['grad_norm']):.6f}; "
        "largest per-leaf difference over the leaf's max: " + ", ".join(
            f"{k} {v:.3g}" for k, v in held.items())
        + f" (tol 1e-4); params everywhere {diffs['params']:.3g} (not held: "
        f"AdamW's first update where |g| is near eps); card {card_s:.2f} s "
        f"(first call), CPU {host_s:.2f} s")
    if worst > 1e-4 or abs(float(mg["loss"]) - float(mc["loss"])) > 1e-4 \
            or abs(float(mg["grad_norm"]) / float(mc["grad_norm"]) - 1) \
            > 1e-4:
        raise AssertionError(f"{tag}: the card's step is off the CPU's: "
                             f"{held}")


def train_profile(dev, cfg=None, batch=(TRAIN_BATCH, TRAIN_SEQ)):
    """The card time of one train step of ``cfg`` (25b's paper_demo by
    default) at ``batch`` = (B, S) by kernel family (torch.profiler)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokenSource
    from repro_torch.launch.train import upload
    from repro_torch.optim import OptConfig, warmup_cosine
    from repro_torch.train.train_step import init_train_state, make_train_step
    if cfg is None:
        cfg = get_config("paper_demo", dtype=torch.float32,
                         param_dtype=torch.float32)
    opt = OptConfig()
    state = [init_train_state(cfg, opt, seed=0, device=dev)]
    step = make_train_step(cfg, opt, lr_schedule=warmup_cosine(3e-4, 1, 30))
    data = upload(SyntheticTokenSource(cfg, *batch).make_batch(0), dev)

    def one():
        state[0] = step(state[0], data)[0]
    return busy_ms(one, runs=2, by_name=True)


def phase_train(dev, label):
    """Phase 25: training paper_demo at full width in fp32 on the card.
    Returns 25b's launches."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train_step_check(dev)
    free_card()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "phase25")
    shutil.rmtree(root, ignore_errors=True)
    cfg = get_config("paper_demo")
    n_params = cfg.param_count()
    L, H, D = cfg.n_layers, cfg.padded_heads, cfg.resolved_head_dim
    tokens = TRAIN_BATCH * TRAIN_SEQ
    pairs = TRAIN_BATCH * TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    # the model's FLOPs a step: 6 N per token for the weights' products
    # (forward and backward), and attention's 4 H D per (query, key) pair
    # forward and 8 backward (the minimal products), each layer
    flops = 6 * n_params * tokens + 12 * L * H * D * pairs

    # 25b: the launcher, 30 steps, a checkpoint every 10, its loop under
    # sync debug mode "error"
    start = peak_start()
    zero_counts()
    t0 = time.perf_counter()
    out = train("paper_demo", steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                seq_len=TRAIN_SEQ, ckpt_dir=os.path.join(root, "b"),
                ckpt_every=TRAIN_CKPT_EVERY, log_every=10, device=dev,
                sync_debug_mode="error")
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = peak_note(start)
    want = {"rmsnorm": (2 * L + 1) * TRAIN_STEPS,
            "flash_attention": L * TRAIN_STEPS,
            "paged_attention": 0, "ssd_scan": 0,
            "rmsnorm_backward": (2 * L + 1) * TRAIN_STEPS,
            "flash_attention_backward": L * TRAIN_STEPS,
            "ssd_scan_backward": 0}
    if launches != want:
        raise AssertionError(f"25b: launches {launches}, {TRAIN_STEPS} steps "
                             f"say {want}")
    rows = out["rows"]
    if [r["step"] for r in rows] != list(range(TRAIN_STEPS)):
        raise AssertionError(f"25b: loss readbacks for steps "
                             f"{[r['step'] for r in rows]}")
    losses = [r["loss"] for r in rows]
    if not all(np.isfinite(losses)) or not \
            np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"25b: the loss did not fall: {losses}")
    steps = sorted(os.listdir(os.path.join(root, "b")))
    if steps != ["step-00000010", "step-00000020", "step-00000030"]:
        raise AssertionError(f"25b: committed checkpoints {steps}")
    card_ms = out["card_ms_median"]
    # steps after the first (its first launches and allocations)
    card_ms_warm = statistics.median(out["card_ms_per_step"][1:])
    host_each = out["host_ms_each"]
    saves = [i for i in range(TRAIN_STEPS) if (i + 1) % TRAIN_CKPT_EVERY == 0]
    host_plain = statistics.median(h for i, h in enumerate(host_each)
                                   if i and i not in saves)
    busy, split, names = train_profile(dev)
    log(f"phase 25b: launch.train paper_demo at full width in fp32 on "
        f"{label}: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens, a checkpoint every {TRAIN_CKPT_EVERY}, loop under sync "
        f"debug mode \"error\": card {card_ms_warm:.1f} ms a step by events "
        f"(median over steps 1-{TRAIN_STEPS - 1}; {card_ms:.1f} over all), "
        f"host {out['host_ms_per_step']:.1f} ms a step over the loop "
        f"(median {host_plain:.1f} over steps without a save or first "
        f"launches; the saves' iterations "
        + ", ".join(f"{host_each[i]:.1f}" for i in saves) + " ms); "
        f"{tokens / card_ms_warm * 1e3:,.0f} tokens/s by the card's step, "
        f"{tokens * TRAIN_STEPS / wall:,.0f} over the whole call "
        f"({wall:.1f} s with init, checkpoints and the last readback); "
        f"model FLOP/s {flops / card_ms_warm / 1e9:.2f} TFLOP/s "
        f"({flops / 1e12:.2f} TFLOP a step) against fp32's "
        f"{PEAK_FLOPS[torch.float32] / 1e12:.0f} "
        f"({flops / card_ms_warm * 1e3 / PEAK_FLOPS[torch.float32]:.1%}); "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (means of the first and "
        f"last 5: {np.mean(losses[:5]):.4f}, {np.mean(losses[-5:]):.4f}); "
        f"{peak}; launches "
        f"{json.dumps(launches)}")
    log(f"  one step's card time by kernel family (torch.profiler, "
        f"{busy:.1f} ms busy): " + ", ".join(
            f"{f} {v:.1%}" for f, v in split.items()))
    for name, (share, n) in list(names.items())[:8]:
        log(f"    {share:6.1%} in {n:g} launches a step: {name[:100]}")
    shutil.rmtree(os.path.join(root, "b"), ignore_errors=True)

    # 25c: the same loop behind a sleep ahead of every step: the loss
    # readbacks and each checkpoint's copies must still be running when
    # first polled
    sleep_ms = max(50.0, 4 * out["host_ms_per_step"])
    cycles = int(sleep_ms * sleep_cycles_per_ms())
    out = train("paper_demo", steps=NOWAIT_STEPS, global_batch=TRAIN_BATCH,
                seq_len=TRAIN_SEQ, ckpt_dir=os.path.join(root, "c"),
                ckpt_every=3, log_every=100, device=dev,
                sync_debug_mode="error",
                before_step=lambda i: torch.cuda._sleep(cycles))
    pend, n = out["loss_pending_at_first_poll"], out["loss_ops"]
    copies = out["ckpt_copy_pending_at_return"]
    log(f"phase 25c: card-bound loop on {label}: "
        f"{sleep_ms:.0f} ms of sleep ahead of each of "
        f"{NOWAIT_STEPS} steps, sync debug mode \"error\": {pend} of {n} "
        f"loss readbacks pending at first poll; checkpoint copies pending "
        f"at save_async's return: {copies}")
    if pend < 0.9 * n or len(copies) != NOWAIT_STEPS // 3 \
            or not all(copies):
        raise AssertionError(f"25c: the loop waited on the card: {pend}/{n} "
                             f"pending, copies {copies}")
    shutil.rmtree(os.path.join(root, "c"), ignore_errors=True)

    # 25d: restart from the step-10 checkpoint, 2 steps, against the
    # uninterrupted run, in deterministic mode
    torch.use_deterministic_algorithms(True)
    try:
        kw = dict(steps=RESTART_STEPS, global_batch=TRAIN_BATCH,
                  seq_len=TRAIN_SEQ, ckpt_every=RESTART_AT, log_every=100,
                  device=dev)
        a, b = os.path.join(root, "d_full"), os.path.join(root, "d_restart")
        train("paper_demo", ckpt_dir=a, **kw)
        at = f"step-{RESTART_AT:08d}"
        shutil.copytree(os.path.join(a, at), os.path.join(b, at))
        out = train("paper_demo", ckpt_dir=b, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    if [r["step"] for r in out["rows"]] != list(range(RESTART_AT,
                                                      RESTART_STEPS)):
        raise AssertionError(f"25d: the restart ran {out['rows']}")
    end = f"step-{RESTART_STEPS:08d}"
    files = sorted(f for f in os.listdir(os.path.join(a, end))
                   if f.endswith(".npy"))
    equal, worst = 0, 0.0
    for f in files:
        x = np.load(os.path.join(a, end, f))
        y = np.load(os.path.join(b, end, f))
        equal += x.tobytes() == y.tobytes()
        worst = max(worst, float(np.abs(x.astype(np.float64)
                                        - y.astype(np.float64)).max()))
    log(f"phase 25d: restart from step {RESTART_AT}'s checkpoint, "
        f"{RESTART_STEPS - RESTART_AT} steps, deterministic mode: "
        f"{equal} of {len(files)} leaves of the step-{RESTART_STEPS} state "
        f"bit-equal to the uninterrupted run's (largest difference "
        f"{worst:.3g})")
    if equal != len(files):
        raise AssertionError("25d: the restarted run is not bit-equal to "
                             "the uninterrupted one")
    # 26d restores this committed checkpoint onto its mesh
    shutil.rmtree(KEPT_CKPT, ignore_errors=True)
    shutil.copytree(os.path.join(a, end), os.path.join(KEPT_CKPT, end))
    shutil.rmtree(root, ignore_errors=True)
    log(f"phase 25: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------ phase 26
SHARD_STEPS = 3        # 26b: sharded train steps against unsharded ones
DECODE_SLOTS, DECODE_CACHE = 8, 1024   # 26a: phase 5's decode step
PHASE26_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "phase26")
#: 25d's last committed checkpoint, kept for 26d's restore
KEPT_CKPT = os.path.join(PHASE26_ROOT, "ckpt")


def dryrun_counts(shape, mesh, *flags, arch="paper_demo"):
    """``repro_torch.launch.dryrun`` of ``arch`` at ``shape`` on a fake
    process group of ``mesh``'s size (the debug mesh with ``mesh`` None),
    started in a subprocess (CPU only)."""
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.path.join(here, "src")
    where = ["--debug-mesh"] if mesh is None else [
        "--mesh", "x".join(str(n) for n in mesh)]
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, *where, *flags]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def read_counts_json(proc, what, tag="26a"):
    out, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{tag}: the dry run of {what} failed:\n"
                             f"{err[-3000:]}")
    r = json.loads(out[out.index("{"):])
    if r["status"] != "ok":
        raise AssertionError(f"{tag}: the dry run of {what}: {r['status']}")
    return r


def shard_shares(what, r, ms, dtype, label):
    """Print 26a's line for one program: its counts beside its card ms."""
    cost, terms = r["cost"], r["roofline"]
    flops, mf = cost["flops_per_device"], terms["model_flops"]
    chips = r["chips"]
    bound_s = max(terms["compute_s"], terms["memory_s"])
    by = "operations" if terms["compute_s"] >= terms["memory_s"] \
        else "bytes"
    colls = {k: v for k, v in r["collectives"].items() if v["count"]}
    log(f"phase 26a: {what} on a {r['mesh']} mesh, one card's share "
        f"counted from shapes ({r['compile_s']} s): "
        f"{flops / 1e12:.4f} TFLOP ("
        + ", ".join(f"{k} {v / 1e12:.4f}" for k, v in
                    cost["flops_per_device_by_dtype"].items())
        + f"), {cost['bytes_per_device'] / 1e9:.3f} GB accessed, "
        f"collectives {json.dumps(colls)}, live peak "
        f"{r['memory']['temp_bytes_per_device'] / 2**20:.1f} MiB; "
        f"card {ms:.4f} ms by events on {label}; model FLOPs "
        f"{mf / chips / 1e12:.4f} TFLOP a card, "
        f"{mf / chips / (ms * 1e-3) / PEAK_FLOPS[dtype]:.2%} of "
        f"{str(dtype)[6:]}'s {PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s; "
        f"the counted bound {bound_s * 1e3:.4f} ms (by {by}: compute "
        f"{terms['compute_s'] * 1e3:.4f} ms, memory "
        f"{terms['memory_s'] * 1e3:.4f} ms), "
        f"{bound_s * 1e3 / ms:.2%} of the card's ms; counted FLOPs over "
        f"model FLOPs {flops * chips / mf:.3f}")


def phase26_rank(rank, world, port):
    """One card's process of 26b-26d (``torch.multiprocessing.spawn``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint.async_ckpt import AsyncCheckpointer
    from repro_torch.configs import get_config
    from repro_torch.core import Engine
    from repro_torch.data.pipeline import SyntheticTokenSource
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.optim import (OptConfig, compressed_psum_mean,
                                   init_compression_state)
    from repro_torch.optim.tree import tree_leaves, tree_map
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.sharding import place, specs_to_shardings, use_sharding
    from repro_torch.train.sharding import batch_logical_axes, rules_for
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step,
                                              train_state_specs)
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world, device_id=dev)
    try:
        mesh = init_device_mesh("cuda", (world, 1),
                                mesh_dim_names=("data", "model"))
        out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
        cfg = get_config("paper_demo", dtype=torch.float32,
                         param_dtype=torch.float32)
        opt = OptConfig()
        rules = rules_for("train")
        specs = train_state_specs(cfg)
        tree = tree_map(lambda t: t.numpy(), init_train_state(
            cfg, opt, seed=0, device="cpu"))
        src = SyntheticTokenSource(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
        batches = [torch.from_numpy(src.make_batch(i)["tokens"])
                   for i in range(SHARD_STEPS)]

        # 26b: the unsharded step on card 0, then the sharded one on each
        # card, each with its launches counted
        want = None
        if rank == 0:
            state = train_state_from_numpy(tree, cfg, dev)
            step = make_train_step(cfg, opt)
            zero_counts()
            losses, ms = [], []
            for tokens in batches:
                (state, m), t = events_ms(
                    lambda: step(state, {"tokens": tokens.to(dev)}))
                losses.append(float(m["loss"]))
                ms.append(t)
            want = {"counts": read_counts(), "losses": losses, "ms": ms}
            ref = {k: tree_map(lambda x: x.detach().cpu(), v) for k, v in
                   (("params", state["params"]),
                    ("m", state["opt"]["m"]), ("v", state["opt"]["v"]))}
            del state
            free_card()
        box = [want]
        dist.broadcast_object_list(box, src=0)
        want = box[0]
        state = place(train_state_from_numpy(tree, cfg, dev),
                      specs_to_shardings(specs, mesh, rules))
        step = make_train_step(cfg, opt, grad_spec_tree=specs["params"])
        zero_counts()
        losses, ms = [], []
        for tokens in batches:
            batch = place({"tokens": tokens.to(dev)}, specs_to_shardings(
                batch_logical_axes({"tokens": tokens}), mesh, rules))
            with use_sharding(mesh, rules):
                (state, m), t = events_ms(lambda: step(state, batch))
            losses.append(float(m["loss"].full_tensor()))
            ms.append(t)
        counts = read_counts()
        local = tuple(state["params"]["layers"]["attn"]["wq"]
                      .to_local().shape)
        whole = {k: tree_map(lambda x: x.full_tensor().cpu(), v) for k, v in
                 (("params", state["params"]),
                  ("m", state["opt"]["m"]), ("v", state["opt"]["v"]))}
        del state
        free_card()
        if counts != want["counts"]:
            raise AssertionError(f"26b: rank {rank}'s sharded launches "
                                 f"{counts}, the unsharded step's "
                                 f"{want['counts']}")
        if rank == 0:
            sure = tree_map(
                lambda m: m.abs() > (1 - opt.b1) * WELL_CONDITIONED_GRAD,
                ref["m"])
            diffs = {"params where |g| > 1e-6": tree_rel_diff(
                whole["params"], ref["params"], sure),
                "m": tree_rel_diff(whole["m"], ref["m"]),
                "v": tree_rel_diff(whole["v"], ref["v"])}
            loss_diff = max(abs(a - b) / abs(b)
                            for a, b in zip(losses, want["losses"]))
            out["26b"] = {"diffs": diffs, "loss_rel": loss_diff,
                          "losses": losses, "want_losses": want["losses"],
                          "ms": ms, "want_ms": want["ms"],
                          "counts": counts, "wq_local": local}

        # 26c: int8 error-feedback mean over the data axis, each rank's
        # gradients (of paper_demo's shapes) its own draw
        gen = torch.Generator(device=dev)
        gen.manual_seed(100 + rank)
        grads = tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                               device=dev), whole["params"])
        del whole
        mean, err = compressed_psum_mean(grads, init_compression_state(
            grads), mesh["data"])
        group = mesh["data"].get_group()
        n = dist.get_world_size(group)
        worst, worst_bound, worst_recon = 0.0, 0.0, 0.0
        for g, mu, e in zip(tree_leaves(grads), tree_leaves(mean),
                            tree_leaves(err)):
            exact = g.clone()
            dist.all_reduce(exact, group=group)
            exact /= n
            esum = e.clone()
            dist.all_reduce(esum, group=group)
            # each rank's scale, gathered: the reference's bound (2.1
            # quantization steps of the largest scale) plus the ranks'
            # scale mismatch, which the error state carries
            scale = (g.abs().max() / 127.0 + 1e-12).reshape(1)
            scales = [torch.empty_like(scale) for _ in range(n)]
            dist.all_gather(scales, scale, group=group)
            scales = torch.cat(scales)
            bound = 2.1 * float(scales.max()) + float(
                (scales - scales.mean()).abs().sum()) * 127 / n
            worst = max(worst, float((mu - exact).abs().max()) / bound)
            worst_bound = max(worst_bound, bound)
            worst_recon = max(worst_recon, float(
                (mu + esum / n - exact).abs().max()))
        out["26c"] = {"ranks": n, "err_over_bound": worst,
                      "bound": worst_bound, "recon": worst_recon,
                      "elements": sum(g.numel() for g in tree_leaves(grads))}
        if worst > 1.0 or worst_recon > 1e-5:
            raise AssertionError(f"26c: rank {rank}: {out['26c']}")
        del grads, mean, err

        # 26d: phase 25's committed checkpoint restored onto the mesh
        ck = AsyncCheckpointer(KEPT_CKPT, Engine())
        step_no = ck.latest_step()
        like = init_train_state(cfg, opt, seed=0, device="cpu")
        t0 = time.perf_counter()
        host = ck.restore(step_no, like)
        placed = reshard_state(host, specs, mesh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        equal = total = 0
        for a, b in zip(tree_leaves(placed), tree_leaves(host)):
            a = a.full_tensor().cpu() if hasattr(a, "full_tensor") else a
            total += 1
            equal += a.numpy().tobytes() == b.numpy().tobytes()
        ck.close()
        out["26d"] = {"step": step_no, "equal": equal, "leaves": total,
                      "s": restore_s}
        if equal != total:
            raise AssertionError(f"26d: rank {rank}: {equal} of {total} "
                                 "leaves bit-equal after the re-shard")
        # 26e: a mamba2 train step under DTensor on the mesh (full width at
        # 2 layers) against the unsharded step on card 0: the SSM family's
        # sharded path (its causal conv runs on each rank's shard)
        mcfg = get_config("mamba2_370m", dtype=torch.float32,
                          param_dtype=torch.float32, n_layers=2)
        mtree = tree_map(lambda t: t.numpy(), init_train_state(
            mcfg, opt, seed=1, device="cpu"))
        mtok = torch.from_numpy(SyntheticTokenSource(
            mcfg, 2 * world, 256, seed=1).make_batch(0)["tokens"])
        if rank == 0:
            st, m = make_train_step(mcfg, opt)(
                train_state_from_numpy(mtree, mcfg, dev),
                {"tokens": mtok.to(dev)})
            mwant = (float(m["loss"]), tree_map(
                lambda x: x.detach().cpu(), st["opt"]["m"]))
            del st
            free_card()
        mspecs = train_state_specs(mcfg)
        st = place(train_state_from_numpy(mtree, mcfg, dev),
                   specs_to_shardings(mspecs, mesh, rules))
        mb = place({"tokens": mtok.to(dev)}, specs_to_shardings(
            batch_logical_axes({"tokens": mtok}), mesh, rules))
        with use_sharding(mesh, rules):
            st, m = make_train_step(mcfg, opt)(st, mb)
        mloss = float(m["loss"].full_tensor())
        mm = tree_map(lambda x: x.full_tensor().cpu(), st["opt"]["m"])
        del st
        free_card()
        if rank == 0:
            out["26e"] = {"loss": mloss, "want_loss": mwant[0],
                          "m": tree_rel_diff(mm, mwant[1]),
                          "B": 2 * world}
            if out["26e"]["m"] > 1e-5 or \
                    abs(mloss - mwant[0]) > 1e-5 * abs(mwant[0]):
                raise AssertionError(f"26e: {out['26e']}")
            with open(os.path.join(PHASE26_ROOT, "out.json"), "w") as f:
                json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def phase_shards(dev, label):
    """Phase 26: sharding over a (data, model) mesh of every card the
    machine shows, one process a card on NCCL. Returns 26b's launches
    (rank 0's sharded steps)."""
    import socket
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.steps import make_decode_step
    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    mesh = (n, 1)
    log(f"phase 26: a (data, model) = {mesh[0]}x{mesh[1]} mesh of the "
        f"{n} card(s) this machine shows, one process a card (NCCL)")
    # 26a: the dry run's counts (CPU subprocesses, while the card works)
    decode_p = dryrun_counts("decode_32k", mesh, "--batch",
                             str(DECODE_SLOTS), "--seq-len",
                             str(DECODE_CACHE))
    train_p = dryrun_counts("train_4k", mesh, "--exact", "--microbatches",
                            "1", "--batch", str(TRAIN_BATCH), "--seq-len",
                            str(TRAIN_SEQ), "--dtype", "float32")
    # whisper's prefill on the 2x2 debug mesh, its rows and heads both
    # split (the grouped einsum of its BOS step runs on each rank's shard)
    whisper_p = dryrun_counts("prefill_32k", None, arch="whisper_large_v3")
    # ... and the decode step re-timed on this card, whole (the train
    # step's card ms are 26b's unsharded steps after the first)
    cfg = get_config("paper_demo")
    params = lm.init_params(cfg, seed=0, device=dev)
    cache = lm.init_cache(cfg, DECODE_SLOTS, DECODE_CACHE, device=dev)
    token = torch.zeros((DECODE_SLOTS, 1), dtype=torch.int32, device=dev)
    decode = make_decode_step(cfg)
    decode_ms = median_ms(lambda: decode(params, cache, token,
                                         DECODE_CACHE - 1), runs=20)
    del params, cache
    free_card()

    # 26b-26d: one process a card
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out_path = os.path.join(PHASE26_ROOT, "out.json")
    if os.path.exists(out_path):
        os.remove(out_path)
    torch.multiprocessing.start_processes(
        phase26_rank, args=(n, port), nprocs=n, start_method="spawn")
    with open(out_path) as f:
        out = json.load(f)
    b, c, d = out["26b"], out["26c"], out["26d"]
    shard_shares(f"bf16 decode step, {DECODE_SLOTS} slots at cache "
                 f"{DECODE_CACHE} (lm_decode_step)",
                 read_counts_json(decode_p, "the decode step"), decode_ms,
                 torch.bfloat16, label)
    shard_shares(f"fp32 train step, {TRAIN_BATCH} x {TRAIN_SEQ} (card ms: "
                 "26b's unsharded steps after the first)",
                 read_counts_json(train_p, "the train step"),
                 statistics.median(b["want_ms"][1:]), torch.float32, label)
    w = read_counts_json(whisper_p, "whisper's prefill_32k debug cell")
    log(f"phase 26a: whisper_large_v3 prefill_32k on the 2x2 debug mesh "
        f"(batch and heads split) runs on this machine's torch "
        f"({torch.__version__}): {w['cost']['flops_per_device'] / 1e12:.4f}"
        f" TFLOP a device, live peak "
        f"{w['memory']['temp_bytes_per_device'] / 2**30:.2f} GiB, "
        f"collectives {json.dumps({k: v['count'] for k, v in w['collectives'].items() if v['count']})}")
    log(f"phase 26b: paper_demo at full width in fp32, {SHARD_STEPS} train "
        f"steps of {TRAIN_BATCH} x {TRAIN_SEQ} on the {out['mesh']} mesh "
        f"(state by train_state_specs, rules_for(\"train\"), grad_spec_tree "
        f"on; wq's shard {tuple(b['wq_local'])}) against the unsharded "
        f"step on card 0: losses {', '.join(f'{x:.6f}' for x in b['losses'])}"
        f" vs {', '.join(f'{x:.6f}' for x in b['want_losses'])} (largest "
        f"relative difference {b['loss_rel']:.3g}); largest per-leaf "
        "difference over the leaf's max: " + ", ".join(
            f"{k} {v:.3g}" for k, v in b["diffs"].items())
        + " (tol 1e-5); card ms a step by events, sharded "
        + ", ".join(f"{x:.1f}" for x in b["ms"]) + ", unsharded "
        + ", ".join(f"{x:.1f}" for x in b["want_ms"])
        + f"; launches each rank {json.dumps(b['counts'])}, equal to the "
        "unsharded step's")
    if max(b["diffs"].values()) > 1e-5 or b["loss_rel"] > 1e-5:
        raise AssertionError(f"26b: the sharded steps are off the "
                             f"unsharded ones: {b}")
    log(f"phase 26c: compressed_psum_mean over the data axis ({c['ranks']} "
        f"rank(s), {c['elements']:,} elements of paper_demo's shapes a "
        f"rank): the largest error over the reference's bound "
        f"{c['err_over_bound']:.3f} (must be <= 1; bound up to "
        f"{c['bound']:.4g}), mean + sum(err)/n against the exact mean "
        f"{c['recon']:.3g} (tol 1e-5)")
    log(f"phase 26d: reshard_state of phase 25's step-{d['step']} "
        f"checkpoint onto the mesh: {d['equal']} of {d['leaves']} leaves "
        f"bit-equal to the saved state ({d['s']:.2f} s restore and "
        "re-shard)")
    e = out["26e"]
    log(f"phase 26e: a mamba2_370m train step (2 layers at full width, "
        f"B {e['B']} x 256) under DTensor on the {out['mesh']} mesh against "
        f"the unsharded step on card 0: loss {e['loss']:.6f} vs "
        f"{e['want_loss']:.6f}, AdamW's first moment (the gradient) off by "
        f"{e['m']:.3g} of each leaf's max (tol 1e-5)")
    log(f"phase 26: {time.perf_counter() - t_phase:.1f} s")
    return b["counts"]


# ------------------------------------------------------------ phase 27
FAMILY_STEPS = 20      # 27b: launch.train's steps a path
FAMILY_CHECK_SEQ = 256                # 27a's B 2 x 256 (whisper: 1500 frames)


def train_family_config(f, depth=None):
    """A TRAIN_FAMILIES entry's config in fp32 at its published widths:
    at 27b's depth, or ``depth`` (27a's layer counts)."""
    from repro_torch.configs import get_config
    over = depth or ({"n_layers": f["n_layers"]} if f["n_layers"] else {})
    return get_config(f["arch"], dtype=torch.float32,
                      param_dtype=torch.float32, remat=f["remat"], **over)


def family_step_launches(cfg) -> dict:
    """Each kernel's launches in one train step of ``cfg``: a forward a
    layer (twice under remat ``"full"``, which re-runs each layer's
    forward in the backward; a hybrid's stack and the enc-dec are never
    rematerialised) and a backward a layer."""
    from repro_torch.models.common import AUDIO, HYBRID, SSM
    L = cfg.n_layers
    rerun = 2 if cfg.remat == "full" and cfg.family not in (AUDIO,
                                                             HYBRID) else 1
    fwd = dict.fromkeys(KERNEL_NAMES, 0)
    if cfg.family == AUDIO:
        fwd.update(rmsnorm=2 * cfg.n_enc_layers + 3 * cfg.n_dec_layers + 2,
                   flash_attention=cfg.n_enc_layers + 2 * cfg.n_dec_layers)
        bwd = dict(fwd)
    elif cfg.family == SSM:
        fwd.update(rmsnorm=rerun * L + 1, ssd_scan=rerun * L)
        bwd = dict(fwd, rmsnorm=L + 1, ssd_scan=L)
    elif cfg.family == HYBRID:
        sites = cfg.hybrid_sites
        fwd.update(rmsnorm=L + 2 * sites + 1, flash_attention=sites,
                   ssd_scan=L)
        bwd = dict(fwd)
    else:
        fwd.update(rmsnorm=rerun * 2 * L + 1, flash_attention=rerun * L)
        bwd = dict(fwd, rmsnorm=2 * L + 1, flash_attention=L)
    return {**fwd, **{f"{k}_backward": bwd[k] for k in
                      ("rmsnorm", "flash_attention", "ssd_scan")}}


def family_model_flops(cfg, B: int, S: int) -> float:
    """6 N a token, N the weights a token passes through: zamba2's shared
    block once a site, whisper's encoder (and frontend) over its S frames
    and its decoder and embedding over the decoder's tokens."""
    from repro_torch.models import encdec, lm
    from repro_torch.models.common import AUDIO, HYBRID
    if cfg.family == AUDIO:
        p = encdec.init_params(cfg, device="meta")
        enc = tree_numel({k: p[k] for k in ("frontend", "encoder",
                                            "enc_norm")})
        dec = tree_numel(p) - enc
        return 6.0 * B * (enc * S + dec * min(cfg.max_target_len,
                                               WHISPER_DEC))
    p = lm.init_params(cfg, device="meta")
    n = tree_numel(p)
    if cfg.family == HYBRID:
        sh = p["shared"]
        n += (cfg.hybrid_sites - 1) * (tree_numel(sh) - sh["proj"].numel())
    return 6.0 * n * B * S


def family_dryrun(f):
    """``repro_torch.launch.dryrun`` of a TRAIN_FAMILIES cell at its 27b
    shape on a 1x1 mesh (a CPU subprocess on meta DTensors, started while
    27a runs): each path's argument, output and live-peak bytes."""
    depth = ["--n-layers", str(f["n_layers"])] if f["n_layers"] else []
    return dryrun_counts("train_4k", (1, 1), "--dtype", "float32",
                         "--microbatches", "1", "--batch", str(f["batch"]),
                         "--seq-len", str(f["seq"]), "--remat", f["remat"],
                         *depth, arch=f["arch"])


def family_train(path, f, dev, label, dry):
    """27b and 27c for one path: ``launch.train`` at 27b's cell; the
    card's ms a step, tokens/s, model FLOP/s, the loss readbacks pending
    at first poll, peak memory beside the dry run's count (``dry``, the
    subprocess of ``family_dryrun``), one step's card time by kernel
    family, and the launches against the steps."""
    from repro_torch.launch.train import train
    from repro_torch.models.common import AUDIO
    cfg = train_family_config(f)
    B, S = f["batch"], f["seq"]
    audio = cfg.family == AUDIO
    tokens = B * (S + min(cfg.max_target_len, WHISPER_DEC)) if audio \
        else B * S
    flops = family_model_flops(cfg, B, S)
    start = peak_start()
    zero_counts()
    t0 = time.perf_counter()
    out = train(f["arch"], steps=FAMILY_STEPS, global_batch=B, seq_len=S,
                n_layers=f["n_layers"], remat=f["remat"], log_every=100,
                device=dev)
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() - start
    want = {k: v * FAMILY_STEPS for k, v in
            family_step_launches(cfg).items()}
    rows = out["rows"]
    losses = [r["loss"] for r in rows]
    pend, n = out["loss_pending_at_first_poll"], out["loss_ops"]
    card_ms = statistics.median(out["card_ms_per_step"][1:])
    mem = read_counts_json(dry, f"the {path} cell", tag="27b")["memory"]
    dry_args, dry_out, dry_temp = (mem[k + "_bytes_per_device"] for k in
                                   ("argument", "output", "temp"))
    free_card()
    busy, split, names = train_profile(dev, cfg, (B, S))
    free_card()
    depth = (f"{cfg.n_enc_layers} + {cfg.n_dec_layers} layers" if audio
             else f"{cfg.n_layers} layers")
    log(f"phase 27b: {path}: launch.train {cfg.name} at full width "
        f"({depth}, d {cfg.d_model}) in fp32, remat {f['remat']!r}, on "
        f"{label}: {FAMILY_STEPS} steps of B {B} x "
        + (f"{S} frames + {min(cfg.max_target_len, WHISPER_DEC)} decoder "
           "tokens" if audio else f"{S} tokens")
        + f": card {card_ms:.1f} ms a step by events (median over steps "
        f"1-{FAMILY_STEPS - 1}), host {out['host_ms_per_step']:.1f} ms a "
        f"step over the loop; {tokens / card_ms * 1e3:,.0f} tokens/s by "
        f"the card's step ({tokens * FAMILY_STEPS / wall:,.0f} over the "
        f"whole call, {wall:.1f} s with init and the last readback); model "
        f"FLOP/s {flops / card_ms / 1e9:.2f} TFLOP/s ({flops / 1e12:.2f} "
        f"TFLOP a step, 6 N a token) against fp32's "
        f"{PEAK_FLOPS[torch.float32] / 1e12:.0f} "
        f"({flops / card_ms * 1e3 / PEAK_FLOPS[torch.float32]:.1%}); loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (means of the first and last "
        f"5: {np.mean(losses[:5]):.4f}, {np.mean(losses[-5:]):.4f}); {pend} "
        f"of {n} loss readbacks pending at first poll; peak device memory "
        f"{mib(peak)} above the {mib(start)} allocated when it began, the "
        f"dry run's count on this machine (torch {torch.__version__}) "
        f"{mib(dry_args + dry_out + dry_temp)} "
        f"(arguments {mib(dry_args)}, outputs {mib(dry_out)}, live peak "
        f"{mib(dry_temp)}: it runs the kernels' plain versions, and their "
        f"intermediates, on meta tensors)")
    log(f"  one step's card time by kernel family (torch.profiler, "
        f"{busy:.1f} ms busy): " + ", ".join(
            f"{fam} {v:.1%}" for fam, v in split.items()))
    for name, (share, k) in list(names.items())[:6]:
        log(f"    {share:6.1%} in {k:g} launches a step: {name[:100]}")
    log(f"phase 27c: {path}: launches {json.dumps(launches)}; "
        f"{FAMILY_STEPS} steps say {json.dumps(want)}")
    if launches != want:
        raise AssertionError(f"27c: {path}: launches {launches}, "
                             f"{FAMILY_STEPS} steps say {want}")
    if [r["step"] for r in rows] != list(range(FAMILY_STEPS)):
        raise AssertionError(f"27b: {path}: loss readbacks for steps "
                             f"{[r['step'] for r in rows]}")
    if not all(np.isfinite(losses)) or not \
            np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"27b: {path}: the loss did not fall: "
                             f"{losses}")
    if pend < 0.9 * n:
        raise AssertionError(f"27b: {path}: {pend} of {n} loss readbacks "
                             "pending at first poll")
    return launches


def phase_train_families(dev, label):
    """Phase 27: training mamba2, zamba2, whisper and danube at full width
    in fp32 on the card, through the three backward kernels. Returns each
    path's 27b launches."""
    from repro_torch.models.common import AUDIO
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # each 27b cell's dry run, on the host's cores while 27a runs
    dry = {path: family_dryrun(f) for path, f in TRAIN_FAMILIES.items()}
    # 27a: each path's step at a cut depth, card against CPU
    for path, f in TRAIN_FAMILIES.items():
        cfg = train_family_config(f, f["check"])
        audio = cfg.family == AUDIO
        seq = f["seq"] if audio else FAMILY_CHECK_SEQ
        depth = (f"{cfg.n_enc_layers} + {cfg.n_dec_layers} layers" if audio
                 else f"{cfg.n_layers} layers")
        train_step_check(dev, cfg, (TRAIN_CHECK_BATCH, seq), tag="27a",
                         what=f"({path}) at full width, {depth}")
        free_card()
    log(f"phase 27a: {time.perf_counter() - t_phase:.1f} s")
    # 27b/27c: each path whole (danube at 6 layers)
    paths = {path: family_train(path, f, dev, label, dry[path])
             for path, f in TRAIN_FAMILIES.items()}
    log(f"phase 27: {time.perf_counter() - t_phase:.1f} s")
    return paths


#: each phase's seconds in this run (``timed``)
PHASE_SECONDS = {}
T_START = time.perf_counter()


def timed(name, fn, *args, **kw):
    """``fn(*args, **kw)``, its seconds logged and kept as phase
    ``name``'s."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    log(f"phase {name} took {PHASE_SECONDS[name]:.1f} s")
    return out


def ptxas_summary() -> None:
    """Registers and spills of every kernel as ``-Xptxas -v`` printed them
    at the build, the flash backward's by name; fails on any spill."""
    from repro_torch.kernels import _build
    name, regs, spills = None, {}, {}
    for line in _build.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills[name] = int(m.group(1)) + int(m.group(2))

    def short(mangled):
        m = re.search(r"(flash_bwd_(?:dkdv|dq)_(?:wgmma|f32))ILi(\d+)",
                      mangled)
        return f"{m.group(1)}<{m.group(2)}>" if m else None
    named = sorted((short(k), v) for k, v in regs.items() if short(k))
    log("  ptxas -v, the flash backward kernels' registers: "
        + ", ".join(f"{k} {v}" for k, v in named)
        + f"; spill bytes over all {len(regs)} kernels: "
        f"{sum(spills.values())}")
    if any(spills.values()):
        raise AssertionError("phase 2: spills in " + ", ".join(
            k for k, v in spills.items() if v))


def backward_sass() -> None:
    """The flash backward's SASS in the built library (``cuobjdump
    -sass``): each kernel's tensor-core (HGMMA, HMMA), TMA-load
    (UTMALDG), cp.async (LDGSTS) and FFMA instruction counts, and an
    excerpt of the bf16 kernels; fails unless both bf16 flash kernels have
    HGMMA fed by UTMALDG and both bf16 SSD backward grids (the state
    passes, the chunk gradients) have HMMA (``mma.sync``)."""
    from repro_torch.kernels import _build
    lib = _build.BUILD_ROOT / _build.digest() / _build.LIB_NAME
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    ops = ("HGMMA", "HMMA", "UTMALDG", "LDGSTS", "FFMA")
    counts, excerpt, name = {}, {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(flash_bwd_(?:dkdv|dq)_(?:wgmma|f32))ILi(\d+)",
                          line)
            name = f"{m.group(1)}<{m.group(2)}>" if m else None
            m = re.search(r"(ssd_bwd_chunk_mma|ssd_bwd_pass)I(?:13__nv_"
                          r"bfloat16)?Li(\d+)ELi(\d+)", line)
            if m:
                name = f"{m.group(1)}<{m.group(2)}, {m.group(3)}>"
            if name:
                counts[name] = dict.fromkeys(ops, 0)
                excerpt[name] = {}
            continue
        if name is None:
            continue
        for op in ops:
            if re.search(rf"\b{op}\b", line):
                counts[name][op] += 1
                if op in ("HGMMA", "UTMALDG", "HMMA"):
                    excerpt[name].setdefault(
                        op, re.sub(r"\s+", " ", line.strip())[:110])
    for k in sorted(counts):
        log(f"  SASS {k}: {json.dumps(counts[k])}")
        for line in excerpt[k].values():
            log(f"    {line}")
    bad = [k for k in counts if "wgmma" in k and not (
        counts[k]["HGMMA"] and counts[k]["UTMALDG"])]
    bad += [k for k in counts if k.startswith("ssd_bwd")
            and not counts[k]["HMMA"]]
    if bad or not any("dkdv_wgmma" in k for k in counts) or \
            not any("dq_wgmma" in k for k in counts) or \
            sum(k.startswith("ssd_bwd") for k in counts) != 4:
        raise AssertionError(f"phase 2: bf16 backward kernels without "
                             f"their tensor-core instructions: "
                             f"{bad or counts}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    # cuBLAS reads this at its first handle: phase 25d's deterministic mode
    # needs a fixed workspace
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    label = card_label()
    from repro_torch.kernels import _build
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    log(f"phase 1: torch {torch.__version__} (CUDA runtime "
        f"{torch.version.cuda}), driver {driver.strip()}, nvcc "
        f"{re.search(r'release [0-9.]+', nvcc).group(0)}, python "
        f"{sys.version.split()[0]}; card: {label}")
    _build.lib()
    log(f"phase 2: kernels built in {_build.BUILD_SECONDS:.1f} s "
        f"({_build.BUILD_ROOT / _build.digest()})")
    ptxas_summary()
    backward_sass()
    dev = torch.device("cuda", 0)
    summary = timed("3", phase_kernels, dev, label)
    timed("3g", phase_graph_edges, dev)
    ident = timed("4", phase_identity, dev)
    cfg, params, launches, host_ms, fused_d = timed("5", phase_serve, dev,
                                                    label)
    timed("5b", phase_card_bound, cfg, params, dev, host_ms, label)
    timed("5s", phase_spec_serve, cfg, params, dev, label)
    timed("5c", phase_card_bound, cfg, params, dev, host_ms, label,
          make_engine=spec_engine, phase="5c")
    timed("6", phase_profile, cfg, params, dev, label)
    del params
    timed("7", phase_mamba_identity, dev)
    mcfg, mparams, mlaunches, mhost_ms = timed("8", phase_mamba_serve, dev,
                                               label)
    timed("8b", phase_card_bound, mcfg, mparams, dev, mhost_ms, label,
          make_engine=mamba_engine, phase="8b")
    timed("9", phase_profile, mcfg, mparams, dev, label, window_steps=12,
          make_engine=mamba_engine,
          work=mamba_workload(mcfg, np.random.default_rng(5)),
          seated=8, phase="9")
    del mparams
    timed("10", phase_zones, dev, label)
    timed("11", phase_cholesky, dev, label)
    timed("12", phase_offload, dev, label)
    t_phase = time.perf_counter()
    tokens = phase_disagg_identity(dev, ident)
    bf16 = phase_disagg_serve(dev, label)
    phase_disagg_card_bound(dev, ident, tokens, label)
    phase_chunk_kernels(dev, label)
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    PHASE_SECONDS["13"] = time.perf_counter() - t_phase
    timed("14", phase_router, dev, ident, bf16, label)
    # the paper_demo paths added later run here, on phase 4's and 13's
    # weights: unfused paged serving (23), the bench's tiers (24)
    unfused = timed("23", phase_unfused, dev, ident, bf16, fused_d, label)
    timed("24", phase_bench, dev, bf16, label)
    del ident, bf16
    free_card()
    # each serving path's launches, its counts set to 0 just before it ran
    paths = {"paper_demo": launches, "paper_demo_unfused": unfused,
             "mamba2_370m": mlaunches,
             "h2o_danube3_4b": timed("15", phase_danube, dev, label),
             "deepseek_coder_33b": timed("16", phase_deepseek, dev, label),
             **timed("17", phase_wide, dev, label),
             "qwen3_moe_235b_a22b": timed("18", phase_moe, "18",
                                          "qwen3_moe_235b_a22b", dev, label),
             "llama4_scout_17b_16e": timed("19", phase_moe, "19",
                                           "llama4_scout_17b_16e", dev,
                                           label),
             "zamba2_1p2b": timed("20", phase_zamba, dev, label),
             "whisper_large_v3": timed("21", phase_whisper, dev, label),
             "internvl2_26b": timed("22", phase_vlm, dev, label),
             "train": timed("25", phase_train, dev, label),
             "train_sharded": timed("26", phase_shards, dev, label),
             **timed("27", phase_train_families, dev, label),
             "granite_4_0_h_small": timed("28", phase_granite, dev, label)}
    log("each phase's seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items())
        + f"; the script so far {time.perf_counter() - T_START:.1f} s")
    # one entry per (kernel, path that ran it): that path's launches beside
    # phase 3's case at its shape; a kernel's row is its first path's
    # entry, every path's entry under "paths"
    kernels = []
    for name in KERNEL_NAMES + BACKWARD_NAMES:
        src, replaces = SOURCES[name]
        rows = []
        for path, counts in paths.items():
            r = summary.get((name, path))
            n = counts[name]
            if (r is None) != (n == 0):
                raise AssertionError(
                    f"{name} on the {path} path: {n} launches, "
                    f"phase 3 case at its shape: {r is not None}")
            if r is not None:
                rows.append({
                    "path": path, "shape": r["shape"],
                    "launches": n, "max_abs_err": r["err"],
                    "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                    "library_ms": r["library_ms"]})
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, **rows[0], "paths": rows})
    log(label)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
