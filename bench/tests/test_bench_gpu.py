"""On the card (marked ``gpu``; each test decides inside itself whether a card is there).

    python -m pytest -m gpu bench/tests/test_bench_gpu.py

A short run of the first cell must come out correct with its result line as the contract
fixes it, and the control (the reference in float8, at the cell's own size) must fail its limit.
"""
import json
import subprocess
import sys

import pytest

from bench.harness import cell as cellmod
from bench.harness.env import ROOT


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_a_short_run_of_the_first_cell_is_correct():
    _need_card()
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "mamba2-780m.longprompt", "--seed",
                          "4000000001", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0 and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {m["name"] for m in cellmod.load("mamba2-780m.longprompt").end_to_end}
    assert list(line)[-1] == "checks"


@pytest.mark.gpu
def test_the_control_fails_at_the_cells_size():
    _need_card()
    out = subprocess.run([sys.executable, "bench/calibrate.py", "--workload", "mamba2-780m.longprompt",
                          "--control-seeds", "4000000002"], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    limit = json.loads((ROOT / "bench" / "limits" / "mamba2-780m.longprompt.json").read_text())["limits"]["logit_gap"]
    assert row["program"]["logit_gap"] <= limit < row["control"]["logit_gap"]
