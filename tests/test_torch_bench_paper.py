"""The benches of the full suite that ``--smoke`` leaves out, through both
packages in the same test: the port's rows equal the reference's field for
field, apart from the wall-clock ones (the ``us_per_call`` column, keys ending
in ``_s``, ``speedup``, ``pace`` and ``us``), as ``scripts/check_bench.py``
skips them."""
from __future__ import annotations

import importlib
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMING_KEYS = {"speedup", "pace", "us"}
# the runner's name -> its module (benchmarks/run.py's BENCHES)
BENCHES = {
    "model_fig2": "bench_model",
    "fig1_small_kv_gc": "bench_fig1",
    "fig6_loadrun": "bench_loadrun",
    "fig7_medium_ablation": "bench_ablation",
    "thresholds_beyond_paper": "bench_thresholds",
    "fig8_merge_level": "bench_merge",
}


def _untimed(row: str) -> tuple[str, list[str]]:
    name, _, derived = row.split(",", 2)
    fields = [p for p in derived.split(";") if p.split("=", 1)[0] not in TIMING_KEYS
              and not p.split("=", 1)[0].endswith("_s")]
    return name, fields


@pytest.mark.parametrize("bench", sorted(BENCHES))
def test_full_suite_bench_equals_the_reference(bench):
    sys.path.insert(0, str(ROOT))  # the reference's benchmarks/ lives at the root
    try:
        ref = importlib.import_module(f"benchmarks.{BENCHES[bench]}")
    finally:
        sys.path.remove(str(ROOT))
    port = importlib.import_module(f"repro_torch.benchmarks.{BENCHES[bench]}")
    ref_rows, port_rows = [], []
    ref.main(ref_rows.append)
    if bench == "model_fig2":
        port.main(port_rows.append, device="cpu")
    else:
        port.main(port_rows.append)
    assert len(port_rows) == len(ref_rows) > 0
    assert [_untimed(r) for r in port_rows] == [_untimed(r) for r in ref_rows]
