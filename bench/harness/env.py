"""Where a run reads and writes, what it refuses to load, and what it reports of the card.

Imports nothing heavy: ``bench/run.py`` calls ``prepare`` before torch is imported,
so that every cache the run fills lies at a fixed path inside the checkout.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]          # the checkout
BENCH = ROOT / "bench"
SRC = ROOT / "src"                                  # the program: ``repro_torch``
CACHE = ROOT / "build"                              # the program builds its kernels into build/kernels

# top-level modules a run may not load: JAX, the JAX package, the JAX-era benchmarks
BANNED = ("jax", "jaxlib", "flax", "repro", "benchmarks")

# the H100 SXM data sheet, dense: bf16 tensor-core FLOP/s, HBM bytes/s
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def process_start() -> float:
    """The wall-clock time this process started, from the kernel's record of it."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - int(fields[19]) / ticks)
    except (OSError, ValueError, IndexError):
        return time.time()


def prepare() -> None:
    """Caches at fixed paths in the checkout; the program on ``sys.path``."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(CACHE / sub)
    for p in (str(SRC), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def banned_loaded(modules=None) -> list[str]:
    """Banned top-level names in ``sys.modules``, compared whole (``repro_torch`` is not ``repro``)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(BANNED))


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why there is none."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"
