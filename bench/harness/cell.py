"""Finding a cell's parts by name: its entry in ``BENCHMARK.json``, its configuration
(``bench/configs/<config>.json``), its traffic mix (``bench/traffic/<mix>.json``),
its limits (``bench/limits/<cell>.json``), the plain reference that its
configuration names (``bench/reference/<module>.py``) and a reader for each of
its per-layer metrics (``bench/metrics/<metric>.py``)."""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

from . import traffic
from .env import BENCH, ROOT


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file: source, assumed, reduced, arch
    mix: dict             # the traffic mix's parameters
    limits: dict          # {number compared: limit}
    end_to_end: list      # this cell's entries of end_to_end
    per_layer: list       # this cell's entries of per_layer

    @property
    def arch(self) -> dict:
        return self.config["arch"]

    def reference(self):
        return importlib.import_module(f"bench.reference.{self.config['reference']}")


def _for(cell: str, metrics: list) -> list:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def load(name: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = traffic.load(root / "bench" / "traffic" / f"{w['traffic']}.json")
    limits = json.loads((root / "bench" / "limits" / f"{name}.json").read_text())
    return Cell(name, w["chips"], config, mix, limits["limits"],
                _for(name, spec["end_to_end"]), _for(name, spec["per_layer"]))


def reader(metric: str):
    """The ``read(run, cell)`` function of ``bench/metrics/<metric>.py``: the metric from one
    run of the cell, or None where the run holds nothing to read it from."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
