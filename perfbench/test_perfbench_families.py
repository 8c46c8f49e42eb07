"""The architecture of a configuration lives in its family's module
(``families/<family>.py``) and nowhere else in the harness: a family the
harness has never seen joins as one new file, found by name; a family
without a module, or a size its family does not report, is refused
before any weight is made; and no other module branches on a family's
name or reads the SSM sizes, but the SSD kernel's own count and readers."""
import ast
import copy
import json

import pytest

from perfbench import families, harness, spec, testing

#: the port's dense family (``paper_demo``: GQA, RoPE, SwiGLU, tied
#: embeddings), written as a later configuration would bring it: one
#: module that composes the shared reference pieces
DENSE = '''
import torch

from perfbench.counts.decode import SIZE
from perfbench.reference.model import Model as Base
from perfbench.weights import generator, normal, ones


def sizes(cfg):
    return {"family": cfg.family, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab_size": cfg.vocab_size,
            "padded_vocab": cfg.padded_vocab, "norm_eps": cfg.norm_eps,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
            "rope_theta": cfg.rope_theta}


def make_params(cfg, seed, device):
    dev = torch.device(device)
    gen = generator(seed, dev)
    pd = cfg.param_dtype
    L, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    nh, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def dense(shape, fan_in):
        return normal(gen, (L,) + shape, fan_in ** -0.5, pd, dev)
    return {
        "embed": {"tokens": normal(gen, (cfg.padded_vocab, d), 0.02, pd,
                                   dev)},
        "final_norm": {"scale": ones((d,), dev)},
        "layers": {
            "norm1": {"scale": ones((L, d), dev)},
            "attn": {"wq": dense((d, nh, hd), d), "wk": dense((d, kv, hd), d),
                     "wv": dense((d, kv, hd), d),
                     "wo": dense((nh, hd, d), nh * hd)},
            "norm2": {"scale": ones((L, d), dev)},
            "mlp": {"wi": dense((d, ff), d), "wg": dense((d, ff), d),
                    "wo": dense((ff, d), ff)}}}


class Model(Base):
    def hidden(self, params, tokens, layer_fn=None):
        run = layer_fn or (lambda fn, *a: fn(*a))
        x = self.embed(params, tokens)
        for i in range(self.m["n_layers"]):
            x = run(self.layer, self.layer_at(params["layers"], i), x)
        return self.rmsnorm(x, params["final_norm"]["scale"])

    def layer(self, lp, x):
        x = x + self.attention(lp["attn"], self.rmsnorm(
            x, lp["norm1"]["scale"]))
        return x + self.mlp(lp["mlp"], self.rmsnorm(x, lp["norm2"]["scale"]))


def leaves(m):
    d, hd, ff = m["d_model"], m["head_dim"], m["d_ff"]
    per = 2 * d + d * hd * (2 * m["n_heads"] + 2 * m["n_kv_heads"]) \\
        + 3 * d * ff
    return {"embed": m["padded_vocab"] * d, "layers": m["n_layers"] * per,
            "final_norm": d}


def flops_params(m):
    return sum(leaves(m).values())


def weight_bytes(m, dtype):
    lv, d = leaves(m), m["d_model"]
    fp32 = (2 * m["n_layers"] + 1) * d
    n = m["vocab_size"] * d + lv["layers"] + lv["final_norm"] - fp32
    return n * SIZE[dtype] + fp32 * 4


def state_bytes(m, dtype):
    return 0


def kv_row_bytes(m, dtype):
    return m["n_layers"] * 2 * m["n_kv_heads"] * m["head_dim"] * SIZE[dtype]
'''

#: ``paper_demo`` as the program reduces it for the CPU
PAPER_DEMO = {
    "name": "paper_demo",
    "program": {"name": "paper_demo", "reduced": True},
    "model": {"family": "dense", "n_layers": 2, "d_model": 128,
              "vocab_size": 512, "padded_vocab": 512, "norm_eps": 1e-05,
              "n_heads": 4, "n_kv_heads": 2, "head_dim": 32, "d_ff": 256,
              "rope_theta": 10000.0},
    "serve": {"dtype": "bfloat16"},
}


@pytest.fixture
def dense_family(tmp_path, monkeypatch):
    """The family lookup pointed at a directory that holds only the dense
    family's module; a serve cell of ``paper_demo`` and a benchmark that
    lists it."""
    (tmp_path / "dense.py").write_text(DENSE)
    assert [p.name for p in tmp_path.iterdir()] == ["dense.py"]
    monkeypatch.setattr(families, "HERE", tmp_path)
    bench = copy.deepcopy(spec.benchmark())
    cell = testing.shrink(copy.deepcopy(spec.cell("mamba2-gen")))
    cell.update(name="paper-demo-gen", config="paper_demo")
    for m in bench["end_to_end"]:
        if "mamba2-gen" in m.get("workloads", []):
            m["workloads"].append(cell["name"])
    return bench, cell, copy.deepcopy(PAPER_DEMO)


def test_a_new_family_is_one_new_file(dense_family):
    res = testing.run(*dense_family)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["metrics"]["decode_tokens_per_s"]["value"] > 0
    assert families.module("dense").__file__.startswith(
        str(families.HERE))


def test_a_new_family_with_a_token_altered_fails(dense_family, monkeypatch):
    from repro_torch.serve.request import Request
    deliver = Request.deliver

    def altered(self, toks):
        return deliver(self, [(int(t) + 1) % 512 for t in toks])
    monkeypatch.setattr(Request, "deliver", altered)
    assert not testing.run(*dense_family)["correct"]


def _no_weights(monkeypatch):
    from perfbench import serve_cell, train_cell

    def never(*args):
        raise AssertionError("weights were made")
    for mod in (serve_cell, train_cell):
        monkeypatch.setattr(mod, "make_params", never)


@pytest.mark.parametrize("cell", ["mamba2-gen", "zamba2-train"])
def test_a_family_without_a_module_is_refused_before_any_weight(
        cell, capsys, monkeypatch):
    from perfbench import run
    config = spec.config

    def unknown(name, bench, root=spec.ROOT):
        conf = copy.deepcopy(config(name, bench, root))
        conf["model"]["family"] = "no_such_family"
        return conf
    monkeypatch.setattr(spec, "config", unknown)
    _no_weights(monkeypatch)
    with pytest.raises(SystemExit) as exc:
        run.main(["--workload", cell, "--seed", "3000000000", "--seconds",
                  "1", "--trace", "0"], check_device=False)
    assert "no_such_family.py" in str(exc.value.code)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cell, key, value", [
    ("mamba2-gen", "moe", {"n_experts": 72, "top_k": 10}),
    ("mamba2-train", "n_heads", 0),
    ("zamba2-longctx", "layer_pattern", ["ssm", "attention"]),
])
def test_a_size_the_family_does_not_report_is_refused(cell, key, value,
                                                      capsys, monkeypatch):
    from perfbench import run
    c = spec.cell(cell)
    conf = copy.deepcopy(spec.config(c["config"], spec.benchmark()))
    conf["model"][key] = value
    with pytest.raises(SystemExit) as exc:
        harness.program_config(conf, c["path"])
    assert repr(key) in str(exc.value.code)
    config = spec.config
    monkeypatch.setattr(spec, "config", lambda *a, **k: json.loads(
        json.dumps(conf)) if a[0] == c["config"] else config(*a, **k))
    _no_weights(monkeypatch)
    with pytest.raises(SystemExit):
        run.main(["--workload", cell, "--seed", "3000000001", "--seconds",
                  "1", "--trace", "0"], check_device=False)
    assert capsys.readouterr().out == ""


# ------------------------------------------------ where architecture lives
#: outside ``families/``, the SSM sizes are the SSD kernel's count's and
#: its readers' alone: they are listed only for cells that run the kernel
SSM_READERS = {"counts/ssd.py", "kernel_roofline.py"}


def _harness_files():
    for f in sorted(spec.HERE.rglob("*.py")):
        rel = f.relative_to(spec.HERE).as_posix()
        if not rel.startswith("families/"):
            yield rel, ast.parse(f.read_text())


def _names_family(node):
    if isinstance(node, ast.Attribute):
        return node.attr == "family"
    if isinstance(node, ast.Name):
        return node.id == "family"
    if isinstance(node, ast.Subscript):
        return isinstance(node.slice, ast.Constant) \
            and node.slice.value == "family"
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        return node.func.attr == "get" and node.args \
            and isinstance(node.args[0], ast.Constant) \
            and node.args[0].value == "family"
    return False


def _literal(node):
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str)
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return any(_literal(e) for e in node.elts)
    return False


def test_no_module_outside_families_branches_on_a_family_name():
    found = []
    for rel, tree in _harness_files():
        for node in ast.walk(tree):
            if isinstance(node, ast.Compare):
                sides = [node.left] + node.comparators
                if any(map(_names_family, sides)) and any(map(_literal,
                                                              sides)):
                    found.append((rel, node.lineno))
            elif isinstance(node, ast.Match) and _names_family(node.subject):
                found.append((rel, node.lineno))
    assert not found


def test_only_the_ssd_count_and_readers_read_the_ssm_sizes_outside_families():
    found = []
    for rel, tree in _harness_files():
        if rel in SSM_READERS or rel.startswith("metrics/ssd_"):
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.slice, ast.Constant) \
                    and node.slice.value == "ssm":
                found.append((rel, node.lineno))
            elif isinstance(node, ast.Attribute) and node.attr == "ssm":
                found.append((rel, node.lineno))
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "get" and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and node.args[0].value == "ssm":
                found.append((rel, node.lineno))
    assert not found


def test_every_configuration_has_its_family_module():
    for c in spec.benchmark()["configs"]:
        model = spec.config(c["name"], spec.benchmark())["model"]
        mod = families.of(model)
        for name in ("sizes", "make_params", "Model", "leaves",
                     "flops_params", "weight_bytes", "state_bytes",
                     "kv_row_bytes"):
            assert hasattr(mod, name), (c["name"], name)
