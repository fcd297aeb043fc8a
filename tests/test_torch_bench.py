"""The port's bench runner (``python -m repro_torch.benchmarks.run``) against
the reference's: the bench modules are the reference's with imports renamed,
the ``--smoke`` suite reproduces all 89 rows of ``BENCH_BASELINE.json``
(field for field, apart from wall-clock ones), the runner refuses what the
reference's refuses, and ``bench_kernels`` says which implementation ran."""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.benchmarks import bench_kernels, common, run

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch" / "benchmarks"
ENV = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
# copied from benchmarks/ with only the package renamed
RENAMED = ["bench_ablation", "bench_analysis", "bench_checkpoint", "bench_elastic", "bench_fig1",
           "bench_lifetime", "bench_loadrun", "bench_merge", "bench_range", "bench_shard", "bench_thresholds",
           "bench_ycsb"]
# and these with the named lines changed: (reference line, port line)
CHANGED = {
    "bench_model": [
        ("def main(emit) -> None:", 'def main(emit, device: str = "cuda") -> None:'),
        ("M.separation_benefit(4, 8, p))", "M.separation_benefit(4, 8, p, device=device))"),
    ],
    "bench_roofline": [
        ("run `python -m repro_torch.launch.dryrun --all --mesh single --out results/dryrun_single.json` first",
         "run `python -m repro_torch.launch.dryrun --all --mesh single --out src/repro_torch/results/dryrun_single.json` first"),
    ],
}


def renamed(text: str) -> str:
    return re.sub(r"\brepro(?=[./])", "repro_torch", text)


def _runner(*args: str, timeout: int = 300) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.run", *args], capture_output=True,
                          text=True, env=ENV, cwd=ROOT, timeout=timeout)


@pytest.mark.parametrize("name", RENAMED + sorted(CHANGED))
def test_bench_module_equals_the_reference_after_the_rename(name):
    expect = renamed((ROOT / "benchmarks" / f"{name}.py").read_text())
    for old, new in CHANGED.get(name, []):
        assert expect.count(old) == 1, old
        expect = expect.replace(old, new)
    assert (PORT / f"{name}.py").read_text() == expect


def test_common_is_the_reference_and_the_baseline_check():
    head = (PORT / "common.py").read_text().split("\n\n\n# " + "-" * 75 + "\n", 1)[0]
    assert head == renamed((ROOT / "benchmarks" / "common.py").read_text())


def test_runner_registers_the_reference_benches():
    ref = (ROOT / "benchmarks" / "run.py").read_text()
    listed = re.findall(r'^\s+\("(\w+)", ', ref, re.MULTILINE)
    assert [n for n, _ in run.BENCHES] + [n for n, _ in run.SMOKE_BENCHES] == listed
    assert len(run.BENCHES) == 15 and len(run.SMOKE_BENCHES) == 7


def test_smoke_suite_equals_the_baseline(tmp_path):
    out = tmp_path / "smoke.json"
    res = _runner("--smoke", "--device", "cpu", "--json", str(out))
    assert res.returncode == 0, res.stderr[-4000:]
    payload = json.loads(out.read_text())
    assert payload["smoke"] is True and payload["failures"] == []
    rows = [f"{r['name']},{r['us_per_call']},{r['derived']}" for r in payload["rows"]]
    assert len(rows) == 89
    assert res.stdout.splitlines()[1:] == rows
    assert common.baseline_mismatches(rows, ROOT / "BENCH_BASELINE.json") == []
    gate = subprocess.run([sys.executable, str(ROOT / "scripts" / "check_bench.py"), str(out),
                           str(ROOT / "BENCH_BASELINE.json"), "--tol", "0"], capture_output=True, text=True,
                          timeout=60)
    assert gate.returncode == 0, gate.stdout
    assert "bench gate: OK (89 baseline rows, tol 0.0" in gate.stdout


@pytest.mark.parametrize("args,message", [
    (("no_such_bench",), "matched no benchmarks"),
    (("--smoke", "fig1"), "matched no benchmarks"),  # fig1 is not in the smoke set
    (("--bogus",), "unknown flag"),
    (("--json",), "--json needs an output path"),
    (("--device",), "--device needs cuda or cpu"),
    (("--device", "tpu"), "--device must be cuda or cpu"),
])
def test_runner_refusals_exit_2(args, message):
    res = _runner(*args, "--device", "cpu") if "--device" not in args else _runner(*args)
    assert res.returncode == 2, res.stdout + res.stderr
    assert message in res.stderr and res.stdout == ""


def test_runner_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run.main(["--smoke", "fig5"])
    rows = []
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench_kernels.main(rows.append)
    assert rows == []


def test_baseline_check_skips_timing_fields_only(tmp_path):
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"rows": [
        {"name": "r", "us_per_call": "1", "derived": "amp=4.42;speedup=3.1;replay_s=0.01;us=5"},
        {"name": "r", "us_per_call": "1", "derived": "amp=1.00"},
        {"name": "bench:x/total", "us_per_call": "9", "derived": "ok"},
        {"name": "p@hash2:gate", "us_per_call": "0", "derived": "speedup_gate=applied"},
    ]}))
    ok = ["r,7,amp=4.42;speedup=9.9;replay_s=3.00;us=1", "r,8,amp=1.00", "bench:x/total,1,ok",
          "p@hash2:gate,0,speedup_gate=skipped_cpu_bound"]
    assert common.baseline_mismatches(ok, base) == []
    for bad in (["r,7,amp=4.43;speedup=3.1;replay_s=0.01;us=5"],  # amp differs
                ["r,7,amp=4.42", "r,7,amp=4.42"],  # the second occurrence differs
                ["r,7,amp=4.420"],  # string-equal is the bar, not numerically close
                ["r,7,amp=4.42;probes=1"],  # a field the baseline lacks
                ["bench:x/total,1,CLAIM-FAILED:boom"],
                ["new,1,amp=1.00"]):
        assert common.baseline_mismatches(bad, base) != [], bad


def test_kernel_rows_on_the_cpu_say_plain():
    rows = []
    bench_kernels.main(rows.append, device="cpu")
    names = [r.split(",", 1)[0] for r in rows]
    assert names == ["kernel:flash_attn_b1s1024h8d64", "kernel:ssd_scan_b2s2048h8p64n64", "kernel:merge_runs_g64t512"]
    for row, oracle in zip(rows, ("gflops_oracle", "tokens_per_s_oracle", "keys_per_s_oracle")):
        fields = dict(p.split("=", 1) for p in row.split(",", 2)[2].split(";"))
        assert list(fields) == [oracle, "impl"] and fields["impl"] == "plain", row
