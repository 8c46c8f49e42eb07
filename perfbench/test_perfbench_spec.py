"""The benchmark's files: each found by name, names and units in the
allowed characters, every per-layer metric reported where it says, and a
new cell found from a new file alone."""
import json
import re
import shutil

import pytest

from perfbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_config_cell_and_metric_is_found_by_name():
    for c in BENCH["configs"]:
        conf = spec.config(c["name"], BENCH)
        assert conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        assert cell["config"] == w["config"] and w["traffic"] == w["name"]
        assert cell["why"] == w["why"]
    for m in BENCH["per_layer"]:
        mod = spec.reader(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
            m["layer"], m["unit"], m["source"], m["moves"])


def test_names_and_units_use_only_the_allowed_characters():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in metrics + BENCH["configs"]
             + BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for e in BENCH["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in (
            "host_clock", "device_trace")


def test_each_metric_moves_a_metric_of_every_cell_it_lists():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        for c in m["workloads"]:
            assert c in cells
            e2e = {e["name"] for e in spec.end_to_end(BENCH, c)}
            assert m["moves"] in e2e, (m["name"], c)
    for c in cells:
        assert "setup_s" in {e["name"] for e in spec.end_to_end(BENCH, c)}
        assert spec.per_layer(BENCH, c)


def test_a_new_cell_is_a_new_file(tmp_path):
    here = tmp_path / "perfbench"
    shutil.copytree(spec.HERE / "workloads", here / "workloads")
    shutil.copytree(spec.HERE / "metrics", here / "metrics")
    before = {p.name: p.read_bytes() for p in (here / "workloads").iterdir()}
    cell = spec.cell("mamba2-gen", here)
    cell["name"] = "mamba2-dummy"
    (here / "workloads" / "mamba2-dummy.json").write_text(json.dumps(cell))
    assert spec.cell("mamba2-dummy", here)["config"] == "mamba2_370m"
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "mamba2-dummy",
                               "config": "mamba2_370m",
                               "traffic": "mamba2-dummy", "chips": 1,
                               "why": "a dummy"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "mamba2-gen" in m.get("workloads", []):
            m["workloads"].append("mamba2-dummy")
    got = {m["name"] for m in spec.per_layer(bench, "mamba2-dummy")}
    assert got == {m["name"] for m in spec.per_layer(bench, "mamba2-gen")}
    for name, data in before.items():
        assert (here / "workloads" / name).read_bytes() == data


def test_a_missing_file_is_refused():
    with pytest.raises(SystemExit):
        spec.cell("no-such-cell")
    with pytest.raises(SystemExit):
        spec.reader("no_such_metric")
