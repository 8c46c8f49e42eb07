"""The port's sharded programs on a mesh of processes (CPU, gloo), against
the JAX package.

Each mesh is one spawned group: this file, run as a script, spawns one
process a rank (``torch.distributed`` over gloo, a file store in the
test's temporary directory), each running every scenario of its mesh, and
rank 0's results (whole tensors, ``full_tensor()``) come back in a file.
Each group runs under a subprocess timeout of its own, so a hang fails the
test and does not eat the suite's clock. The JAX side runs in the test
process on the same numpy inputs.

* 2×2 ``(data, model)`` mesh, reduced ``paper_demo`` in fp32: 2 sharded
  train steps with ``grad_spec_tree`` on and off; a sharded prefill
  (``prefill`` rules) and a dense decode step (``decode`` rules, and again
  under the ``prefill`` rules: a cache split by rows alone); reduced
  qwen3-moe (experts over the model axis) and reduced mamba2 (the
  ``long`` rules) one step each; one sharded train step each of reduced
  mamba2, zamba2 and whisper (the SSM, hybrid and enc-dec families);
  ``compressed_psum_mean`` over the data axis; the kernels' refusals of
  placements they cannot take.
* 2×2×2 ``(pod, data, model)`` mesh on 8 processes: the reference's
  elastic case (``tests/launch/test_launch.py``), rank 1 fails, the mesh
  shrinks to (1, 2, 2) with values equal, then regrows.

Tolerances: a sharded step sums in another order than the reference's.
AdamW's moments (the gradient) are held to 1e-5 of each leaf's largest
magnitude everywhere, and so are the logits. The params are held to the
reference's own bound for a reduction-order change (atol 5e-5, rtol 1e-4:
its microbatching test, ``tests/train/test_train_step.py``), where the
reference's first moment is above 1e-7: AdamW's first update of a gradient
near its eps (1e-8) turns on the gradient's last bits (``chip_smoke.py``
25a). The elastic case is value-equal.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.abspath(__file__)
SRC = os.path.join(os.path.dirname(HERE), "..", "src")
REL = 1e-5
STEP_RTOL, STEP_ATOL = 1e-4, 5e-5
GROUP_TIMEOUT = 300
#: the families beyond the dense decoder whose sharded train step is held
#: to the reference's (one step each, ``train`` rules)
FAMILY_TRAIN = ("mamba2_370m", "zamba2_1p2b", "whisper_large_v3")


# ============================================================ the workers
def _rank_main(rank, world, scenario, d):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    try:
        inputs = torch.load(os.path.join(d, "in.pt"), weights_only=False)
        out = SCENARIOS[scenario](inputs)
        if rank == 0:
            torch.save(out, os.path.join(d, "out.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _whole(tree):
    """numpy copies of a tree's leaves (a DTensor's whole tensor)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    return tree.detach().numpy().copy()


def _mesh2x2_main(inputs):
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {"train": {}}
    for gst in (False, True):
        out["train"][gst] = _sharded_train(mesh, "paper_demo",
                                           inputs["train"], gst)
    out["moe"] = _sharded_train(mesh, "qwen3_moe_235b_a22b", inputs["moe"],
                                False)
    for name in FAMILY_TRAIN:
        out[name] = _sharded_train(mesh, name, inputs[name], False)
    out["serve"] = _sharded_serve(mesh, "paper_demo", inputs["serve"],
                                  "prefill", "decode")
    # the cache's rows split by batch, its positions whole: each rank
    # writes its own rows
    out["serve_rows"] = _sharded_serve(mesh, "paper_demo", inputs["serve"],
                                       "prefill", "prefill")
    out["ssm"] = _sharded_serve(mesh, "mamba2_370m", inputs["ssm"], "long",
                                "long")
    out["compress"] = _compress(mesh, inputs["compress"])
    out["refusals"] = _refusals(mesh)
    return out


def _tcfg(name):
    from repro_torch.configs import get_config
    return get_config(name, reduced=True, dtype=torch.float32,
                      param_dtype=torch.float32)


def _sharded_train(mesh, name, inp, gst):
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.optim import OptConfig, warmup_cosine
    from repro_torch.sharding import place, specs_to_shardings, use_sharding
    from repro_torch.train.sharding import batch_logical_axes, rules_for
    from repro_torch.train.train_step import (make_train_step,
                                              train_state_specs)
    cfg = _tcfg(name)
    rules = rules_for("train")
    specs = train_state_specs(cfg)
    state = place(train_state_from_numpy(inp["state"], cfg, "cpu"),
                  specs_to_shardings(specs, mesh, rules))
    step = make_train_step(cfg, OptConfig(lr=1e-3),
                           lr_schedule=warmup_cosine(1e-3, 1, 10),
                           grad_spec_tree=specs["params"] if gst else None)
    losses = []
    for b in inp["batches"]:
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        batch = place(batch, specs_to_shardings(
            batch_logical_axes(batch), mesh, rules))
        with use_sharding(mesh, rules):
            state, metrics = step(state, batch)
        losses.append(float(metrics["loss"].full_tensor()))
    return {"state": _whole(state), "losses": losses}


def _sharded_serve(mesh, name, inp, prefill_kind, decode_kind):
    from repro_torch.models import lm
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.serve.steps import make_decode_step, make_prefill_step
    from repro_torch.sharding import (place, place_by_specs,
                                      specs_to_shardings, use_sharding)
    from repro_torch.train.sharding import rules_for
    cfg = _tcfg(name)
    rules = rules_for(prefill_kind)
    params = place(params_from_numpy(inp["params"], cfg, "cpu"),
                   specs_to_shardings(lm.param_specs(cfg), mesh, rules))
    tokens = torch.from_numpy(inp["tokens"])
    with use_sharding(mesh, rules):
        batch = place_by_specs({"tokens": tokens}, {"tokens": ("batch", None)})
        logits, cache = make_prefill_step(cfg, inp["max_len"])(params, batch)
    nxt = torch.from_numpy(inp["next"])
    with use_sharding(mesh, rules_for(decode_kind)):
        cache = place_by_specs(cache, lm.cache_specs(cfg))
        tok = place_by_specs({"t": nxt}, {"t": ("batch", None)})["t"]
        logits2, _ = make_decode_step(cfg)(params, cache, tok,
                                           tokens.shape[1])
    return {"prefill": _whole(logits), "decode": _whole(logits2)}


def _compress(mesh, inp):
    """Each rank's gradients by its (data, model) coordinate; the mean over
    the data axis, and every data rank's new error state."""
    import torch.distributed as dist
    from repro_torch.optim import compressed_psum_mean, init_compression_state
    di, mi = mesh.get_coordinate()
    grads = {k: torch.from_numpy(v) for k, v in inp[(di, mi)].items()}
    mean, err = compressed_psum_mean(grads, init_compression_state(grads),
                                     mesh["data"])
    group = mesh["data"].get_group()
    gathered = [{k: torch.empty_like(v) for k, v in err.items()}
                for _ in range(2)]
    for k in sorted(err):
        parts = [g[k] for g in gathered]
        dist.all_gather(parts, err[k], group=group)
    errs = [{k: v.numpy() for k, v in g.items()} for g in gathered]
    return {"mean": {k: v.numpy() for k, v in mean.items()}, "errs": errs,
            "coord": (di, mi)}


def _refusals(mesh):
    """The kernels raise on placements they cannot take."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor import distribute_tensor as put
    from repro_torch.kernels import flash_attention, rmsnorm
    q = torch.randn(4, 8, 4, 16)
    out = {}
    try:   # the sequence sharded
        flash_attention.attention(*(put(t, mesh, [Replicate(), Shard(1)])
                                    for t in (q, q, q)))
        out["flash_seq"] = "ran"
    except ValueError as e:
        out["flash_seq"] = str(e)
    x = put(torch.randn(4, 16), mesh, [Shard(0), Replicate()])
    x = x.redistribute(mesh, [Shard(0), Replicate()])
    partial = torch.distributed.tensor.DTensor.from_local(
        x.to_local(), mesh, [Shard(0), Partial()], run_check=False)
    try:
        rmsnorm.rmsnorm(partial, torch.ones(16))
        out["rms_partial"] = "ran"
    except ValueError as e:
        out["rms_partial"] = str(e)
    try:   # the width sharded
        rmsnorm.rmsnorm(put(torch.randn(4, 16), mesh,
                            [Replicate(), Shard(1)]), torch.ones(16))
        out["rms_width"] = "ran"
    except ValueError as e:
        out["rms_width"] = str(e)
    # and rows sharded over both axes run, equal to the plain version
    y = rmsnorm.rmsnorm(put(x.full_tensor(), mesh, [Shard(0), Shard(0)]),
                        torch.ones(16))
    out["rms_rows"] = float((y.full_tensor() - rmsnorm.rmsnorm_plain(
        x.full_tensor(), torch.ones(16))).abs().max())
    return out


def _elastic_main(inputs):
    from repro_torch.runtime.elastic import (build_mesh, reshard_state,
                                             shrink_after_failure)
    from repro_torch.sharding import place, specs_to_shardings
    ranks = list(range(8))
    axes = ("pod", "data", "model")
    mesh = build_mesh(ranks, (2, 2, 2), axes)
    specs = {"w": ("fsdp", "tp"), "b": (None,)}
    state = place({"w": torch.arange(64.0).reshape(8, 8),
                   "b": torch.ones(4)}, specs_to_shardings(specs, mesh))
    new_mesh, new_shape = shrink_after_failure(ranks, (2, 2, 2), axes, [1])
    restored = reshard_state(state, specs, new_mesh)
    member = new_mesh.get_coordinate() is not None
    small = _whole(restored) if member else None
    # expansion: the shrunk state back onto the full mesh
    big = _whole(reshard_state(restored, specs, mesh))
    # rank 0 is outside the new mesh: gather rank 4's view to it
    import torch.distributed as dist
    box = [small]
    dist.broadcast_object_list(box, src=4)
    return {"shape": new_shape, "mesh_ranks": new_mesh.mesh.tolist(),
            "member_0": member, "small": box[0], "big": big}


SCENARIOS = {"mesh2x2": _mesh2x2_main, "elastic": _elastic_main}


def _run_group(scenario, world, inputs, tmp_path):
    d = str(tmp_path)
    torch.save(inputs, os.path.join(d, "in.pt"))
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, HERE, scenario, d, str(world)], capture_output=True,
        text=True, timeout=GROUP_TIMEOUT, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return torch.load(os.path.join(d, "out.pt"), weights_only=False)


# ============================================================ the JAX side
def _jax_config(name):
    import jax.numpy as jnp
    from repro.configs import get_config
    return get_config(name, reduced=True, dtype=jnp.float32,
                      param_dtype=jnp.float32)


def _jax_train(name, batches, seed=0):
    import jax
    import jax.numpy as jnp
    from repro.optim import OptConfig, warmup_cosine
    from repro.train import train_step as jtrain
    cfg = _jax_config(name)
    opt = OptConfig(lr=1e-3)
    state = jtrain.init_train_state(jax.random.PRNGKey(seed), cfg, opt)
    start = jax.tree_util.tree_map(np.asarray, state)
    step = jax.jit(jtrain.make_train_step(
        cfg, opt, lr_schedule=warmup_cosine(1e-3, 1, 10)))
    losses = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return start, jax.tree_util.tree_map(np.asarray, state), losses


def _jax_serve(name, B, S, max_len, seed):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import lm as jlm
    from repro.serve.steps import make_decode_step, make_prefill_step
    cfg = get_config(name, reduced=True, dtype=jnp.float32,
                     param_dtype=jnp.float32)
    params = jlm.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    logits, cache = make_prefill_step(cfg, max_len)(
        params, {"tokens": jnp.asarray(tokens)})
    logits2, _ = make_decode_step(cfg)(params, cache, jnp.asarray(nxt),
                                       jnp.int32(S))
    inp = {"params": jax.tree_util.tree_map(np.asarray, params),
           "tokens": tokens, "next": nxt, "max_len": max_len}
    return inp, {"prefill": np.asarray(logits), "decode": np.asarray(logits2)}


def _batches(vocab, seed, n=2, B=4, S=32, frontend=0):
    """``n`` batches of tokens, or of an enc-dec's frames (16 a row, at
    ``frontend`` features) and decoder tokens."""
    rng = np.random.default_rng(seed)
    if frontend:
        return [{"audio_embed": rng.standard_normal(
                    (B, 16, frontend)).astype(np.float32),
                 "dec_tokens": rng.integers(0, vocab, (B, S))
                 .astype(np.int32)} for _ in range(n)]
    return [{"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32)}
            for _ in range(n)]


def _compress_inputs():
    rng = np.random.default_rng(7)
    return {(di, mi): {"w": rng.standard_normal((64, 32)).astype(np.float32),
                       "b": (rng.standard_normal(9) * 1e-2)
                       .astype(np.float32)}
            for di in range(2) for mi in range(2)}


@pytest.fixture(scope="module")
def mesh2x2(tmp_path_factory):
    """The 2×2 group's results beside the JAX package's."""
    want = {}
    inputs = {}
    for key, name, seed in (("train", "paper_demo", 0),
                            ("moe", "qwen3_moe_235b_a22b", 1)):
        batches = _batches(512, 10 + seed, n=2 if key == "train" else 1)
        start, end, losses = _jax_train(name, batches, seed)
        inputs[key] = {"state": start, "batches": batches}
        want[key] = {"state": end, "losses": losses}
    inputs["serve"], want["serve"] = _jax_serve("paper_demo", 4, 16, 32, 3)
    want["serve_rows"] = want["serve"]
    inputs["ssm"], want["ssm"] = _jax_serve("mamba2_370m", 1, 16, 32, 4)
    # two rows (one a data rank), drawn from seed 20, and the reference's
    # weights from key 0: on many other inputs (zamba2's batches from
    # seeds 21-23, or 4 rows of seed 20; mamba2's weights from key 5) the
    # reference's own gradient of its SSD scan is NaN (ROADMAP C.12), and
    # there is nothing to hold the port to
    for name in FAMILY_TRAIN:
        jcfg = _jax_config(name)
        batches = _batches(jcfg.vocab_size, 20, n=1, B=2,
                           frontend=jcfg.frontend_dim
                           if jcfg.n_enc_layers else 0)
        start, end, losses = _jax_train(name, batches, 0)
        inputs[name] = {"state": start, "batches": batches}
        want[name] = {"state": end, "losses": losses}
    inputs["compress"] = _compress_inputs()
    got = _run_group("mesh2x2", 4, inputs,
                     tmp_path_factory.mktemp("mesh2x2"))
    return got, want, inputs


# ================================================================== tests
def _rel(got, want, where=None):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    if where is not None:
        d = d[where]
    if not d.size:
        return 0.0
    return float(d.max()) / max(float(np.abs(want).max()), 1e-30)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _check_state(got, want):
    """m and v everywhere within REL of each leaf's max; the params where
    the reference's m is above 1e-7 at the reference's step bound (see the
    module's docstring)."""
    for part in ("m", "v"):
        for (path, g), (_, w) in zip(_leaves(got["opt"][part]),
                                     _leaves(want["opt"][part])):
            assert g.shape == w.shape, path
            assert _rel(g, w) <= REL, (part, path, _rel(g, w))
    for (path, g), (_, w), (_, m) in zip(_leaves(got["params"]),
                                         _leaves(want["params"]),
                                         _leaves(want["opt"]["m"])):
        sure = np.abs(m) > 1e-7
        np.testing.assert_allclose(g[sure], w[sure], rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=path)
    assert int(got["step"]) == int(want["step"])


@pytest.mark.parametrize("gst", [False, True],
                         ids=["all-reduce", "grad_spec_tree"])
def test_sharded_train_steps_match_jax(mesh2x2, gst):
    got, want, _ = mesh2x2
    g, w = got["train"][gst], want["train"]
    np.testing.assert_allclose(g["losses"], w["losses"], rtol=REL)
    _check_state(g["state"], w["state"])


@pytest.mark.parametrize("name", FAMILY_TRAIN)
def test_sharded_family_train_step_matches_jax(mesh2x2, name):
    got, want, _ = mesh2x2
    np.testing.assert_allclose(got[name]["losses"], want[name]["losses"],
                               rtol=REL)
    _check_state(got[name]["state"], want[name]["state"])


def test_sharded_moe_train_step_matches_jax(mesh2x2):
    got, want, _ = mesh2x2
    np.testing.assert_allclose(got["moe"]["losses"], want["moe"]["losses"],
                               rtol=REL)
    _check_state(got["moe"]["state"], want["moe"]["state"])


@pytest.mark.parametrize("key", ["serve", "serve_rows", "ssm"],
                         ids=["paper_demo prefill/decode rules",
                              "paper_demo prefill rules",
                              "mamba2 long rules"])
def test_sharded_prefill_and_decode_match_jax(mesh2x2, key):
    got, want, _ = mesh2x2
    for step in ("prefill", "decode"):
        g, w = got[key][step], want[key][step]
        assert g.shape == w.shape
        assert _rel(g, w) <= REL, (step, _rel(g, w))


def _emulate(gs):
    """The reference's algorithm in numpy (fp32): each rank's int8 values
    at its own scale, summed, times the ranks' mean scale."""
    scales = [np.float32(np.abs(g).max()) / np.float32(127.0)
              + np.float32(1e-12) for g in gs]
    qs = [np.clip(np.round(g / s), -127, 127) for g, s in zip(gs, scales)]
    avg = np.float32(sum(scales) / np.float32(len(gs)))
    mean = np.float32(sum(qs)) * avg / np.float32(len(gs))
    return mean, scales, avg


def test_compressed_psum_mean_over_the_data_axis(mesh2x2):
    """Over two data ranks: the reference's algorithm (numpy), the
    reference test's quantization bound (2.1 steps of the largest scale)
    plus the bias of the ranks' scale mismatch, which the error feedback
    carries: mean + Σ err / n reconstructs the exact mean within 1e-5 (for
    one rank this is the reference's mean + err / n)."""
    got, _, inputs = mesh2x2
    c = got["compress"]
    di, mi = c["coord"]
    g = [inputs["compress"][(r, mi)] for r in range(2)]
    for k in ("w", "b"):
        true = (g[0][k] + g[1][k]) / 2
        emu, scales, avg = _emulate([x[k] for x in g])
        np.testing.assert_allclose(c["mean"][k], emu, rtol=1e-6, atol=1e-7)
        step = max(scales)
        bias = sum(abs(avg - s) for s in scales) * 127 / 2
        assert np.abs(c["mean"][k] - true).max() <= 2.1 * step + bias
        recon = c["mean"][k] + sum(e[k] for e in c["errs"]) / 2
        assert np.abs(recon - true).max() <= 1e-5


def test_kernels_refuse_placements_they_cannot_take(mesh2x2):
    got, _, _ = mesh2x2
    r = got["refusals"]
    assert "flash_attention" in r["flash_seq"] and "dims [0, 2]" in \
        r["flash_seq"]
    assert "rmsnorm" in r["rms_partial"] and "P(sum)" in r["rms_partial"]
    assert "rmsnorm" in r["rms_width"]
    assert r["rms_rows"] <= 1e-6


def test_elastic_shrink_and_regrow_on_eight_ranks(tmp_path):
    """The reference's elastic case: params sharded on a 2×2×2 mesh survive
    a pod failure (rank 1 in pod 0): reshard onto 1×2×2 with identical
    values, then regrow onto the full mesh."""
    r = _run_group("elastic", 8, {}, tmp_path)
    assert r["shape"] == (1, 2, 2)
    assert r["mesh_ranks"] == [[[4, 5], [6, 7]]]
    assert not r["member_0"]
    want_w = np.arange(64.0).reshape(8, 8)
    np.testing.assert_array_equal(r["small"]["w"], want_w)
    np.testing.assert_array_equal(r["small"]["b"], np.ones(4))
    np.testing.assert_array_equal(r["big"]["w"], want_w)
    np.testing.assert_array_equal(r["big"]["b"], np.ones(4))


if __name__ == "__main__":
    scenario, d, world = sys.argv[1], sys.argv[2], int(sys.argv[3])
    torch.multiprocessing.start_processes(
        _rank_main, args=(world, scenario, d), nprocs=world,
        start_method="spawn")
