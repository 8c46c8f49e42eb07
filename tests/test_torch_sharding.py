"""The port's sharding layer against the JAX package, in one process on the
CPU: the logical rules (``logical_to_spec`` under every ``rules_for``
kind), the spec trees of every config, the launch shape tables, the
roofline constants, the counting of a sharded program on a fake 16×16
process group, and ``compressed_psum_mean`` on one rank.

Spec trees are compared leaf by leaf. Two places differ from the
reference's trees as the port's layout does, and the test maps them:

* a hybrid's cache is one flat dict in the port, its SSM leaves stacked
  over the layers and ``k``/``v`` over the shared-block sites, where the
  reference keeps lists of per-layer (``"ssm"``) and per-site (``"kv"``)
  dicts (``repro/models/lm.py:342-346``): each port leaf is the
  reference's per-layer (per-site) spec behind a leading ``None``;
* the hybrid's ``shared.proj`` stacks one projector per site in the port
  (7 for zamba2) where the reference has 6 (ROADMAP C.7); the spec, one
  leaf for the stack, is the same.
"""
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sharding as jsharding
from repro.configs import get_config as jax_get_config
from repro.launch import shapes as jshapes
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.roofline import hlo as jhlo
from repro.train import sharding as jtrain_sharding
from repro.train import train_step as jtrain
from repro_torch import sharding
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.launch import shapes
from repro_torch.models import encdec, lm
from repro_torch.models.common import AUDIO, HYBRID
from repro_torch.optim import compressed_psum_mean, init_compression_state
from repro_torch.roofline import counts
from repro_torch.train import sharding as train_sharding
from repro_torch.train.train_step import train_state_specs

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"single-pod": ("data", "model"),
          "multi-pod": ("pod", "data", "model")}
#: logical axes of every kind the models name, duplicates and tuples too
AXES = [
    ("batch", None, "act_heads", None),
    ("batch", "kv_seq", None, "tp"),
    (None, "batch", "kv_seq", None, "tp"),
    ("fsdp", "tp"), ("tp", "fsdp"), ("fsdp", "vocab"),
    ("expert", "fsdp", None), ("heads", None, "fsdp"),
    ("fsdp", "heads", None), (None, "fsdp", "tp"),
    ("expert", "batch", None, None), ("batch", None, "expert", None),
    ("batch", "tp", None, None), ("batch", None, "tp"),
    ("tp", "tp"), ("batch", "fsdp"), ("vocab", "heads"),
    (("batch", "tp"), None), (("pod", "data"), "model"),
    ("seq", "state", "chunk"), ("nonexistent",), (), (None,),
]


# ------------------------------------------------------------------ rules
@pytest.mark.parametrize("kind", train_sharding.SHAPE_KINDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_logical_to_spec_matches_jax(kind, mesh):
    names = MESHES[mesh]
    assert train_sharding.rules_for(kind) == \
        jtrain_sharding.rules_for(kind)
    jmesh = types.SimpleNamespace(axis_names=names)
    tmesh = types.SimpleNamespace(mesh_dim_names=names)
    with jsharding.use_sharding(jmesh, jtrain_sharding.rules_for(kind)):
        want = [tuple(jsharding.logical_to_spec(a)) for a in AXES]
    with sharding.use_sharding(tmesh, train_sharding.rules_for(kind)):
        got = [sharding.logical_to_spec(a) for a in AXES]
    assert got == want


def test_decode_cache_puts_kv_seq_and_head_dim_on_one_axis_once():
    """Decode rules map both ``kv_seq`` and the ``tp`` head_dim to the
    model axis; the ``used`` set keeps it for the sequence only."""
    cfg = get_config("llama3_405b")
    tmesh = types.SimpleNamespace(mesh_dim_names=MESHES["single-pod"])
    with sharding.use_sharding(tmesh, train_sharding.rules_for("decode")):
        spec = sharding.logical_to_spec(lm.cache_specs(cfg)["k"])
    assert spec == (None, "data", "model", None, None)


def _fake_mesh(names, sizes):
    return types.SimpleNamespace(mesh_dim_names=names,
                                 size=lambda i: sizes[i])


def test_placements_for_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _fake_mesh(MESHES["multi-pod"], (2, 16, 8))
    assert sharding.placements_for((("pod", "data"), None, "model"),
                                   mesh) == (Shard(0), Shard(0), Shard(2))
    assert sharding.placements_for((None, "model"), mesh) == \
        (Replicate(), Replicate(), Shard(1))
    assert sharding.placements_for((), mesh) == (Replicate(),) * 3
    # an axis of one rank replicates (a card's 1×1 mesh)
    one = _fake_mesh(MESHES["single-pod"], (1, 1))
    assert sharding.placements_for(("data", "model"), one) == \
        (Replicate(), Replicate())


def test_helpers_are_no_ops_without_a_mesh():
    x = torch.ones(2, 3)
    assert sharding.constrain(x, "batch", "tp") is x
    assert sharding.named_sharding(("batch",)) is None
    assert sharding.logical_to_spec(("batch",)) == ()
    assert sharding.axis_size("act_heads") == 1
    assert sharding.place_by_specs({"x": x}, {"x": ("batch", None)}) == \
        {"x": x}


# ------------------------------------------------------------- spec trees
def _configs(name, reduced):
    return (jax_get_config(name, reduced=reduced),
            get_config(name, reduced=reduced))


def _flat(tree, prefix=()):
    """{path: leaf} of a nested dict/list spec tree (tuples are leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (i,)))
        return out
    return {prefix: tree}


def _jax_cache_as_port(cfg, jspecs):
    """The reference's cache specs on the port's layout (see the module's
    docstring)."""
    if cfg.family != HYBRID:
        return jspecs
    out = {}
    for group in ("ssm", "kv"):
        first = jspecs[group][0]
        assert all(s == first for s in jspecs[group])
        out.update({k: (None,) + tuple(v) for k, v in first.items()})
    return out


CASES = [(n, r) for n in ARCHITECTURES for r in (False, True)]


@pytest.mark.parametrize("name,reduced", CASES)
def test_param_specs_match_jax(name, reduced):
    jcfg, tcfg = _configs(name, reduced)
    jfn = jencdec.param_specs if jcfg.family == AUDIO else jlm.param_specs
    tfn = encdec.param_specs if tcfg.family == AUDIO else lm.param_specs
    want, got = _flat(jfn(jcfg)), _flat(tfn(tcfg))
    assert got == want
    # and each leaf names every dim of the port's parameter
    init = encdec.init_params if tcfg.family == AUDIO else lm.init_params
    params = _flat(init(tcfg, device="meta"))
    assert sorted(params) == sorted(got)
    for path, spec in got.items():
        assert len(spec) == params[path].dim(), path


@pytest.mark.parametrize("name,reduced",
                         [c for c in CASES if not c[0].startswith("whisper")])
def test_cache_specs_match_jax(name, reduced):
    jcfg, tcfg = _configs(name, reduced)
    want = _flat(_jax_cache_as_port(jcfg, jlm.cache_specs(jcfg)))
    got = _flat(lm.cache_specs(tcfg))
    assert got == want
    cache = _flat(lm.init_cache(tcfg, 2, 8, device="meta"))
    assert sorted(cache) == sorted(got)
    for path, spec in got.items():
        assert len(spec) == cache[path].dim(), path


@pytest.mark.parametrize("name,reduced", CASES)
def test_train_state_specs_match_jax(name, reduced):
    jcfg, tcfg = _configs(name, reduced)
    assert _flat(train_state_specs(tcfg)) == \
        _flat(jtrain.train_state_specs(jcfg))


# ----------------------------------------------------------------- shapes
def test_shape_tables_match_jax():
    assert {k: tuple(vars(v).values()) for k, v in shapes.SHAPES.items()} \
        == {k: tuple(vars(v).values()) for k, v in jshapes.SHAPES.items()}
    assert shapes.MICROBATCHES == jshapes.MICROBATCHES
    assert shapes.WHISPER_CROSS_LEN == jshapes.WHISPER_CROSS_LEN


_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("name", [a for a in ARCHITECTURES
                                  if a != "paper_demo"])
def test_shape_cells_match_jax(name):
    """The 40 arch × shape cells: applicability, microbatches, cache length
    and the inputs' shapes and dtypes."""
    jcfg, tcfg = _configs(name, False)
    for sname, spec in shapes.SHAPES.items():
        jspec = jshapes.SHAPES[sname]
        assert shapes.is_applicable(tcfg, spec) == \
            jshapes.is_applicable(jcfg, jspec)
        assert shapes.microbatches_for(tcfg) == jshapes.microbatches_for(jcfg)
        assert shapes.cache_shape_len(tcfg, spec) == \
            jshapes.cache_shape_len(jcfg, jspec)
        want = jshapes.input_specs(jcfg, jspec)
        got = shapes.input_specs(tcfg, spec)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == tuple(w.shape), (sname, k)
            assert got[k].dtype == _DTYPES[str(w.dtype)], (sname, k)
            assert got[k].device.type == "meta"


# --------------------------------------------------------------- roofline
@pytest.mark.parametrize("name", ARCHITECTURES)
def test_model_flops_match_jax(name):
    """Equal, but for the hybrid's extra projector (C.7): the port counts
    the function it computes, one ``(2d, d)`` projector a site."""
    jcfg, tcfg = _configs(name, False)
    extra = 0
    if tcfg.family == HYBRID:
        extra = (tcfg.hybrid_sites - tcfg.n_layers // tcfg.hybrid_attn_every
                 ) * 2 * tcfg.d_model * tcfg.d_model
        assert extra > 0
    for kind, per_token in (("train", 6), ("prefill", 2), ("decode", 2)):
        assert counts.model_flops(tcfg, kind, 4096) == \
            jhlo.model_flops(jcfg, kind, 4096) + per_token * extra * 4096


def test_roofline_terms_units_at_h100_peaks():
    terms = counts.roofline_terms(989e12, 3.35e12, 50e9, chips=256)
    assert terms["compute_s"] == pytest.approx(1.0)
    assert terms["memory_s"] == pytest.approx(1.0)
    assert terms["collective_s"] == pytest.approx(1.0)
    assert terms["flops_global"] == pytest.approx(989e12 * 256)
    assert counts.PEAK_FLOPS[torch.float32] == 67e12
    assert counts.AXIS_BW == {"model": 450e9, "data": 50e9, "pod": 50e9}
    # compute and collective seconds by dtype and by axis
    t = counts.roofline_terms(0, 0, 0, 1, compute_s=2.0, collective_s=0.5)
    assert t["dominant"] == "compute_s" and t["roofline_fraction"] == 1.0


_TOY = """
import json, torch, torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_mesh
from repro_torch.roofline.counts import CountMode
fake_world(256)
mesh = make_mesh((16, 16), ("data", "model"), "cuda")
x = DTensor.from_local(torch.empty(16, 4096, device="meta"), mesh,
                       [Shard(0), Replicate()], run_check=False,
                       shape=(256, 4096), stride=(4096, 1))
w = DTensor.from_local(torch.empty(4096, 1024, device="meta"), mesh,
                       [Replicate(), Shard(1)], run_check=False,
                       shape=(4096, 16384), stride=(16384, 1))
mode = CountMode(mesh)
with mode:
    y = x @ w
    z = y.redistribute(mesh, [Shard(0), Replicate()])
print(json.dumps({"flops": mode.flops, "colls": mode.collectives,
                  "axes": mode.by_axis, "local": list(z.to_local().shape),
                  "peak": mode.peak}))
"""


def test_counts_of_a_sharded_mm_on_a_fake_16x16_group():
    """One rank's share: the local mm's FLOPs (not the global product's
    3.44e10) and the all-gather's local operand."""
    import json
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _TOY], capture_output=True,
                         text=True, timeout=240, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["flops"] == {"float32": 2 * 16 * 4096 * 1024}
    assert r["colls"]["all-gather"] == {"count": 1,
                                        "bytes": 16 * 1024 * 4}
    assert r["axes"] == {"model": 16 * 1024 * 4}
    assert r["local"] == [16, 16384]
    assert r["peak"] >= 16 * 16384 * 4


# --------------------------------------------------------------- compress
def test_compressed_psum_mean_on_one_rank_is_bit_equal_to_jax():
    """The reference's test (``tests/train/test_train_step.py``) on one
    device: the same numpy gradients and error state, twice (the second
    call carries the first's error feedback)."""
    from functools import partial
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map
    from repro.optim import compressed_psum_mean as jmean
    rng = np.random.default_rng(0)
    g = {"w": rng.standard_normal((64, 32)).astype(np.float32),
         "b": (rng.standard_normal((7,)) * 1e-3).astype(np.float32)}
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))

    @partial(shard_map, mesh=mesh, in_specs=(P(), P()),
             out_specs=(P(), P()), check_vma=False)
    def sync(gs, e):
        return jmean(gs, e, "data")

    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    je = jax.tree_util.tree_map(jnp.zeros_like, jg)
    te = init_compression_state(tg)
    for _ in range(2):
        jm, je = sync(jg, je)
        tm, te = compressed_psum_mean(tg, te)
        for k in g:
            assert np.array_equal(np.asarray(jm[k]), tm[k].numpy()), k
            assert np.array_equal(np.asarray(je[k]), te[k].numpy()), k
    assert tm["w"].dtype == torch.float32
