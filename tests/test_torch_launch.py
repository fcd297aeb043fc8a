"""The port's training launcher (``python -m repro_torch.launch.train``) and its
examples (``python -m repro_torch.examples.<name>``), run as a user runs them,
on the CPU (``--device cpu``).

The launcher's resume is the flow of ``tests/test_system.py``'s restart
test: a run killed after a checkpoint and resumed with ``--resume`` ends with
the uninterrupted run's params and AdamW state, bitwise.  Each process runs
one thread: the CPU's threaded reductions are not bitwise reproducible from
one process to the next.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS
from repro_torch.models import get_model
from repro_torch.optim import adamw
from repro_torch.sharding import rules

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
RESUME = ["--arch", "mamba2-780m", "--steps", "40", "--seq", "16", "--batch", "2", "--ckpt-every", "4",
          "--device", "cpu"]


def _python(*args: str, timeout: float = 300) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, env=ENV, cwd=ROOT, timeout=timeout)


def _launch(*args: str) -> list[str]:
    out = _python("-m", "repro_torch.launch.train", *args)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


def test_launcher_reduced_run_on_cpu(tmp_path):
    """The reference's flags and lines: the config line with the mesh, a line every
    10 steps and at the last, then ``done``; ``--metrics-json`` a finite row a step."""
    log = tmp_path / "steps.jsonl"
    lines = _launch("--arch", "qwen2.5-3b", "--steps", "12", "--seq", "16", "--batch", "4", "--device", "cpu",
                    "--metrics-json", str(log))
    assert lines[0] == "arch=qwen2.5-3b-reduced params=0.1M mesh={'data': 1, 'model': 1} layout=baseline"
    assert [ln.split()[1] for ln in lines[1:-1]] == ["0", "10", "11"] and lines[-1] == "done"
    rows = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert [r["step"] for r in rows] == list(range(12))
    assert all(math.isfinite(r[k]) for r in rows for k in ("loss", "grad_norm", "lr", "ms"))
    assert all(r["ssd_scan"] == [0, 0] and r["flash_attention"] == [0, 0] for r in rows)  # no kernel on the CPU


def _last_checkpoint(directory: Path) -> tuple[dict, int]:
    """The launcher's last checkpoint of reduced mamba2-780m, restored on the CPU."""
    cfg = rules.pad_config_for_mesh(ARCHS["mamba2-780m"].reduced(),
                                    SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1)))
    model = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return CheckpointManager(str(directory)).restore({"params": dict(model.named_parameters()),
                                                      "opt": adamw.init(model)})


def test_launcher_resume_ends_bitwise_equal_to_an_uninterrupted_run(tmp_path):
    """A run killed at its first checkpoint, then ``--resume``d, ends where the
    uninterrupted run ends: the last checkpoints are bitwise equal."""
    _launch(*RESUME, "--ckpt-dir", str(tmp_path / "whole"))
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *RESUME, "--ckpt-dir",
                             str(tmp_path / "cut")], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
                            env=ENV, cwd=ROOT)
    try:
        for line in proc.stdout:
            if line.startswith("checkpointed @"):
                proc.kill()  # the crash
                break
    finally:
        proc.kill()
        proc.wait()
    resumed = _launch(*RESUME, "--ckpt-dir", str(tmp_path / "cut"), "--resume")
    at = int(resumed[0].removeprefix("resumed at step "))
    assert 0 < at < 40 and resumed[-2].startswith("checkpointed @40")
    (whole, s1), (cut, s2) = _last_checkpoint(tmp_path / "whole"), _last_checkpoint(tmp_path / "cut")
    assert s1 == s2 == 40 and int(cut["opt"]["step"]) == 40
    for name, t in whole["params"].items():
        assert torch.equal(t, cut["params"][name]), name
    for m in ("mu", "nu"):
        for name, t in whole["opt"][m].items():
            assert torch.equal(t, cut["opt"][m][name]), (m, name)


@pytest.mark.parametrize("mesh,ranks", [("production", 256), ("multipod", 512)])
def test_launcher_refuses_a_production_mesh_without_its_ranks(mesh, ranks):
    out = _python("-m", "repro_torch.launch.train", "--arch", "mamba2-780m", "--mesh", mesh, "--device", "cpu")
    assert out.returncode != 0
    assert f"--mesh {mesh}" in out.stderr and f"needs a process group of {ranks} ranks; this one has 1" in out.stderr


@pytest.mark.parametrize("name", ["kvstore_demo", "range_shard_demo"])
def test_store_demos_print_what_the_reference_examples_print(name):
    """The store demos are the reference's with their imports renamed; the store is
    byte-identical, so is what they print (they run on the host, as the reference's)."""
    port = _python("-m", f"repro_torch.examples.{name}", "--device", "cpu")
    ref = _python(str(ROOT / "examples" / f"{name}.py"))
    assert port.returncode == 0 == ref.returncode, port.stderr[-2000:] + ref.stderr[-2000:]
    assert port.stdout == ref.stdout and port.stdout


def test_quickstart_runs_on_cpu():
    out = _python("-m", "repro_torch.examples.quickstart", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert sum("I/O amplification" in ln for ln in lines) == 3 and lines[-1] == "done."
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines if "loss=" in ln]
    assert len(losses) == 5 and losses[-1] < losses[0]


def test_train_lm_runs_checkpoints_and_resumes_on_cpu(tmp_path):
    args = ["-m", "repro_torch.examples.train_lm", "--steps", "20", "--ckpt-every", "10", "--ckpt-dir",
            str(tmp_path), "--device", "cpu"]
    out = _python(*args)
    assert out.returncode == 0, out.stderr[-3000:]
    assert sum(ln.startswith("  checkpointed @") for ln in out.stdout.splitlines()) == 2
    again = _python(*args, "--resume")
    assert again.returncode == 0, again.stderr[-3000:]
    assert "resumed from checkpoint at step 20" in again.stdout and again.stdout.splitlines()[-1].startswith("done")


def test_serve_lm_runs_on_cpu():
    out = _python("-m", "repro_torch.examples.serve_lm", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert sum(ln.startswith("seq ") for ln in lines) == 4 and "'active': 0" in lines[-1]
