"""The controls of the output check, on the card at each cell's own size
(``control.py``'s readings; marked ``gpu``, they skip elsewhere): on
three seeds the program's numbers stay within the cell's limits, and the
control (and, in a train cell, the planted fault) breaks at least one."""
import json

import pytest

from perfbench import control, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(cell, card):
    check = spec.cell(cell)["check"]
    seconds = 20.0 if spec.cell(cell)["path"] == "serve" else 2.0
    for row in control.readings(cell, [101, 102, 103], seconds, card):
        print(json.dumps(row), flush=True)
        if "control" in row:
            assert row["program"] <= check["limit"] < row["control"]
            continue
        limits = check["limits"]
        assert all(row["program"][k] <= limits[k] for k in limits)
        for bad in ("control_tf32", "fault_half_batch"):
            assert any(row[bad][k] > limits[k] for k in limits), bad
