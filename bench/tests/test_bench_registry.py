"""Every part of every cell is found by its name, and BENCHMARK.json keeps the contract's shape."""
import json
import re

import pytest

from bench.harness import cell as cellmod
from bench.harness.env import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_parts_are_found_by_name(name):
    cell = cellmod.load(name)
    ref = cell.reference()
    specs = ref.param_specs(cell.arch)
    assert specs and len({n for n, _, _ in specs}) == len(specs)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer and all(m["moves"] in e2e for m in cell.per_layer)
    for m in cell.per_layer:
        assert callable(cellmod.reader(m["name"]))
    assert cell.limits and all(v > 0 for v in cell.limits.values())


def test_names_units_and_keys_keep_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and SPEC["paths"] == ["bench"]
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in SPEC["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics) and len(set(CELLS)) == len(CELLS)
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert set(m["workloads"]) <= set(CELLS)
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in SPEC["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"] == []
        assert c["file"].startswith("bench/")


@pytest.mark.parametrize("name", sorted({m["name"] for m in SPEC["per_layer"]}))
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    from bench.harness.run_state import Run
    from bench.harness.spans import Spans

    metric = next(m for m in SPEC["per_layer"] if m["name"] == name)
    cell = cellmod.load(metric["workloads"][0] if "workloads" in metric else CELLS[0])
    assert cellmod.reader(name)(Run(spans=Spans(sync=False, device_type="cpu")), cell) is None
