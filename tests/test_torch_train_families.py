"""Training past paper_demo on the CPU: the plain version of the SSD scan's
backward kernel against ``jax.vjp`` of the JAX package's SSD references
and against autograd of the port's plain forward, the rmsnorm plain
backward at llama3's 16,384 columns, and the port's ``launch.train`` on
reduced mamba2 and whisper against the JAX package's launcher.

Inputs are made from seeds with numpy and handed to both packages in
float32. The plain backward is held to within 1e-5 of each gradient's
largest magnitude (both packages in fp32, summing in other orders); the
launcher's first loss to the JAX launcher's within 1e-4, from the JAX
launcher's own initial state (its step-0 checkpoint, which the port's
launcher restores).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import ref as jrms_ref
from repro.kernels.ssd_scan import ref as jssd_ref
from repro.launch import train as jlaunch
from repro_torch.kernels import rmsnorm as rms
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch.train import train

REL_TOL = 1e-5
#: the wrapper's CPU path at its default chunk of 64: autograd and the
#: plain backward sum dA's cancelling terms in other orders over longer
#: chunks, ~1.4e-5 of its max apart at these inputs
WRAPPER_TOL = 1e-4
LOSS_TOL = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ssd_inputs(B, T, H, P, G, N, seed):
    """mamba2-like inputs: dt ~ softplus(N(-3, 0.5)), A = -linspace(1, 16),
    D near 1 and per head, and an output gradient dy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = (0.5 * rng.standard_normal((B, T, H, P))).astype(f32)
    dt = np.log1p(np.exp(0.5 * rng.standard_normal((B, T, H)) - 3)).astype(
        f32)
    A = (-np.linspace(1.0, 16.0, H)).astype(f32)
    Bm = (rng.standard_normal((B, T, G, N)) * N ** -0.25).astype(f32)
    Cm = (rng.standard_normal((B, T, G, N)) * N ** -0.25).astype(f32)
    D = (1 + 0.1 * rng.standard_normal(H)).astype(f32)
    dy = rng.standard_normal((B, T, H, P)).astype(f32)
    return (x, dt, A, Bm, Cm, D), dy


def _assert_close_to_max(got, want, what, tol=REL_TOL):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, f"{what} {name}"
        err = np.abs(g - w).max()
        assert err <= tol * np.abs(w).max(), \
            f"{what} {name}: {err:.3g} over max {np.abs(w).max():.3g}"


# (B, T, H, P, G, N, chunk): T a multiple of the chunk, one and two groups;
# the kernel's chunk of 64 in the last
SSD_CASES = {
    "g1": (2, 64, 4, 8, 1, 16, 16),
    "g2": (2, 48, 4, 8, 2, 16, 16),
    "chunk64": (1, 128, 2, 16, 1, 8, 64),
}


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_backward_plain_matches_jax_vjp_of_ssd_chunked(case):
    B, T, H, P, G, N, chunk = SSD_CASES[case]
    args, dy = _ssd_inputs(B, T, H, P, G, N, seed=len(case))
    _, vjp = jax.vjp(lambda *a: jssd_ref.ssd_chunked(*a, chunk=chunk)[0],
                     *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(dy))
    got = ssd.ssd_scan_backward_plain(
        *(torch.from_numpy(a) for a in args), torch.from_numpy(dy),
        chunk=chunk)
    _assert_close_to_max([g.numpy() for g in got], want, case)


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_backward_plain_with_dfinal_matches_jax_vjp_of_ssd_chunked(case):
    """Cotangents on both of ``ssd_chunked``'s outputs, y and the final
    state: the plain backward's ``dfinal`` starts its reverse state pass."""
    B, T, H, P, G, N, chunk = SSD_CASES[case]
    args, dy = _ssd_inputs(B, T, H, P, G, N, seed=len(case) + 20)
    dfinal = np.random.default_rng(len(case)).standard_normal(
        (B, H, P, N)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jssd_ref.ssd_chunked(*a, chunk=chunk),
                     *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(dy), jnp.asarray(dfinal)))
    got = ssd.ssd_scan_backward_plain(
        *(torch.from_numpy(a) for a in args), torch.from_numpy(dy),
        torch.from_numpy(dfinal), chunk=chunk)
    _assert_close_to_max([g.numpy() for g in got], want, case)


# (B, T, H, G, N) at the kernel's head_dim 64 and chunk: one group and a
# tail, two groups, mamba2's state at 8 heads
ROUNDING_CASES = {"g1_tail": (1, 200, 4, 1, 128),
                  "g2_tail": (2, 130, 4, 2, 64),
                  "h8": (1, 256, 8, 1, 128)}


@pytest.mark.parametrize("case", sorted(ROUNDING_CASES))
def test_ssd_backward_bf16_rounding_stays_within_bf16_tolerance(case):
    """The bf16 backward kernel rounds each operand it computes in fp32
    once before its tensor-core products (``BACKWARD_ROUNDING``): on
    bf16-valued inputs, with dx, dB and dC cast to bf16 as the kernel
    writes them, every gradient stays within bf16's 2e-2 of max(1, its
    largest magnitude) of the fp32 plain backward, with a dfinal too."""
    B, T, H, G, N = ROUNDING_CASES[case]
    assert set(ssd.BACKWARD_ROUNDING) == {"xw", "dye", "entering",
                                          "dstates", "scores", "dM"}
    args, dy = _ssd_inputs(B, T, H, 64, G, N, seed=T)
    bf = [torch.from_numpy(a) for a in args]
    for i in (0, 3, 4):                      # x, B and C as bf16 values
        bf[i] = bf[i].to(torch.bfloat16).float()
    gy = torch.from_numpy(dy).to(torch.bfloat16).float()
    dfinal = torch.from_numpy(np.random.default_rng(T).standard_normal(
        (B, H, 64, N)).astype(np.float32))
    for df in (None, dfinal):
        want = ssd.ssd_scan_backward_plain(*bf, gy, df)
        got = ssd.ssd_scan_backward_plain(*bf, gy, df,
                                          rounding=ssd.BACKWARD_ROUNDING)
        for name, g, w in zip(NAMES, got, want):
            if name in ("dx", "dB", "dC"):
                g = g.to(torch.bfloat16).float()
            err = float((g - w).abs().max())
            assert err <= 2e-2 * max(1.0, float(w.abs().max())), \
                f"{case} {name} dfinal={df is not None}: {err:.3g}"


def test_ssd_backward_plain_of_a_tail_matches_jax_vjp_of_the_recurrence():
    """T = 50 over chunks of 16: the last chunk padded with dt = 0 rows
    (``ssd_chunked`` takes no tail, so the exact per-step recurrence is
    the reference here)."""
    args, dy = _ssd_inputs(2, 50, 4, 8, 2, 16, seed=7)
    _, vjp = jax.vjp(lambda *a: jssd_ref.ssd_sequential(*a)[0],
                     *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(dy))
    got = ssd.ssd_scan_backward_plain(
        *(torch.from_numpy(a) for a in args), torch.from_numpy(dy),
        chunk=16)
    _assert_close_to_max([g.numpy() for g in got], want, "tail")
    assert all(torch.isfinite(g).all() for g in got)


@pytest.mark.parametrize("T,G", [(64, 1), (50, 2), (7, 1)])
def test_ssd_backward_plain_matches_autograd_of_the_plain_forward(T, G):
    args, dy = _ssd_inputs(2, T, 4, 8, G, 16, seed=T)
    watched = [torch.from_numpy(a).requires_grad_() for a in args]
    y = ssd.ssd_scan_plain(*watched, chunk=16)
    want = torch.autograd.grad(y, watched, torch.from_numpy(dy))
    got = ssd.ssd_scan_backward_plain(
        *(torch.from_numpy(a) for a in args), torch.from_numpy(dy),
        chunk=16)
    _assert_close_to_max([g.numpy() for g in got],
                         [w.numpy() for w in want], f"T={T} G={G}")


def test_ssd_scan_on_the_cpu_is_differentiated_by_autograd():
    """The wrapper's CPU path is the plain forward: autograd's gradients
    there equal the plain backward's."""
    args, dy = _ssd_inputs(1, 70, 2, 8, 1, 8, seed=3)
    watched = [torch.from_numpy(a).requires_grad_() for a in args]
    got = torch.autograd.grad(ssd.ssd_scan(*watched), watched,
                              torch.from_numpy(dy))
    want = ssd.ssd_scan_backward_plain(
        *(torch.from_numpy(a) for a in args), torch.from_numpy(dy))
    _assert_close_to_max([g.numpy() for g in got],
                         [w.numpy() for w in want], "cpu wrapper",
                         tol=WRAPPER_TOL)


def test_ssd_backward_scratch_is_sized_from_the_shapes():
    """The backward kernel's scratch: the entering states and the state
    gradients, the chunk's dA and dD terms, and each head-slice's dB and
    dC rows only when a group is split; nothing a head."""
    B, T, H, P, N = 3, 130, 4, 64, 128
    nC = 3
    assert ssd.backward_scratch_floats(B, T, H, 1, P, N, 1) == \
        B * nC * H * (2 * P * N + 2)
    assert ssd.backward_scratch_floats(B, T, H, 2, P, N, 2) == \
        B * nC * H * (2 * P * N + 2) + 2 * B * T * 2 * 2 * N


@pytest.mark.parametrize("shape,k", [
    ((8, 1024, 32, 1), 4),     # mamba2's training step: 128 chunks
    ((2, 1024, 64, 1), 16),    # zamba2's: 32 chunks
    ((8, 4096, 32, 1), 1),     # 512 chunks fill two waves unsplit
    ((4, 4160, 4, 1), 2),      # 260 chunks: one short of two waves
    ((4, 4224, 4, 1), 1),      # 264: exactly two waves
    ((1, 7, 4, 1), 4),         # never two waves: every head its own
    ((2, 100, 8, 2), 4),       # per group
])
def test_ssd_backward_head_split_rule(shape, k):
    """The head-slices of the backward's chunk grid: the smallest divisor
    of a group's heads that gives two waves of an H100's 132 SMs."""
    B, T, H, G = shape
    assert ssd.backward_head_splits(B, T, H, G) == k
    blocks = G * B * -(-T // ssd.CHUNK)
    assert (H // G) % k == 0
    assert k * blocks >= 2 * 132 or k == H // G
    assert all((H // G) % s or s * blocks < 2 * 132 for s in range(1, k))


@pytest.mark.parametrize("d,itemsize,tpr,threads", [
    (768, 4, 32, 256), (1024, 4, 32, 256), (1280, 4, 64, 256),
    (3840, 4, 128, 256), (5120, 4, 160, 160), (12288, 4, 384, 384),
    (16384, 4, 512, 512), (768, 2, 32, 256), (1280, 2, 64, 256),
    (16384, 2, 512, 512),
])
def test_rmsnorm_backward_plan_holds_a_row_in_registers(d, itemsize, tpr,
                                                        threads):
    """The rmsnorm backward's threads a row from D: the fewest warps that
    hold the row at 32 columns a thread; teams fill 256 threads a block;
    the grid is one wave of contiguous row ranges, none empty."""
    assert rms.backward_plan(8192, d, itemsize)[:2] == (tpr, threads)
    assert tpr * rms.BACKWARD_COLS >= d and tpr <= rms.MAX_BACKWARD_D // 32
    for rows in (1, 7, 8192, 8193):
        _, _, blocks = rms.backward_plan(rows, d, itemsize)
        per = -(-rows // blocks)
        assert (blocks - 1) * per < rows <= blocks * per
        assert blocks <= 132 * max(1, 512 // threads)


def test_rmsnorm_backward_plain_at_16384_columns_matches_jax_vjp():
    """llama3-405b's rows: the width the widened backward kernel takes."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 16384)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(16384)).astype(np.float32)
    dy = rng.standard_normal((3, 16384)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, s: jrms_ref.rmsnorm(a, s, 1e-5),
                     jnp.asarray(x), jnp.asarray(scale))
    wdx, wds = vjp(jnp.asarray(dy))
    dx, ds = rms.rmsnorm_backward_plain(torch.from_numpy(x),
                                        torch.from_numpy(scale),
                                        torch.from_numpy(dy))
    for g, w in ((dx, wdx), (ds, wds)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= REL_TOL * np.abs(w).max()


# the launcher's cell of each reduced config: global batch, sequence (the
# encoder frames of whisper), steps
LAUNCH_CELLS = {"mamba2_370m": (2, 32, 4), "whisper_large_v3": (2, 32, 4)}


@pytest.fixture
def _reference_prefetch_closes(monkeypatch):
    """The reference's ``PrefetchPipeline`` re-posts a fill from each
    fill's continuation, and ``close`` cancels a queued fill while holding
    the pool's shutdown lock: the cancelled fill's continuation runs there
    and re-posts, waiting on that same lock for ever. A closed pipeline
    posts nothing here, so the launcher's teardown cannot hang; what it
    trains is unchanged."""
    from repro.data import pipeline as jpipeline
    cls = jpipeline.PrefetchPipeline
    post, close = cls._post_fill, cls.close

    def post_unless_closed(self):
        if not getattr(self, "_closed", False):
            post(self)

    def close_first(self):
        self._closed = True
        close(self)
    monkeypatch.setattr(cls, "_post_fill", post_unless_closed)
    monkeypatch.setattr(cls, "close", close_first)


@pytest.mark.usefixtures("_reference_prefetch_closes")
@pytest.mark.parametrize("arch", sorted(LAUNCH_CELLS))
def test_cpu_launcher_starts_at_the_jax_launchers_loss_and_falls(tmp_path,
                                                                 arch):
    """The JAX launcher run for 0 steps commits its initial state as the
    step-0 checkpoint; the port's launcher restores it and trains on the
    same synthetic batches: its first loss is the JAX launcher's, and the
    loss falls."""
    B, S, steps = LAUNCH_CELLS[arch]
    kw = dict(global_batch=B, seq_len=S, lr=3e-3, reduced=True,
              log_every=100)
    init = str(tmp_path / "init")
    jlaunch.train(arch, steps=0, ckpt_dir=init, **kw)
    want = jlaunch.train(arch, steps=steps, **kw)
    got = train(arch, steps=steps, ckpt_dir=init, ckpt_every=100,
                device="cpu", **kw)
    assert [r["step"] for r in got["rows"]] == list(range(steps))
    assert abs(got["first_loss"] - want["first_loss"]) <= LOSS_TOL
    assert np.isfinite([r["loss"] for r in got["rows"]]).all()
    assert got["final_loss"] < got["first_loss"]
