"""Build a kernel's CUDA source with ``nvcc`` for ``sm_90a`` and load it with ``ctypes``.

Each source has a plain C entry point that returns a ``cudaError_t``.  The
build happens at the first ``load`` of a source, into ``build/kernels/`` at
the repository root, named by a hash of the flags and of every file in the
source's directory (the ``.cu`` and the headers it includes), so that an edit
to any of them is rebuilt.  Importing this module needs no compiler and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

BUILD_LOGS: dict[str, str] = {}  # ptxas' report (registers, shared memory, spills) by source name
_entries: dict[Path, ctypes._CFuncPtr] = {}


def _nvcc(name: str) -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(f"{name}: nvcc not found; the CUDA kernel cannot be built")
    return path


def library_path(source: Path) -> Path:
    """Where ``source``'s library is built: named by a hash of the flags and of
    every file under its directory, by sorted relative name and content."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in source.parent.rglob("*") if p.is_file()):
        digest.update(str(path.relative_to(source.parent)).encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"


def load(source: Path, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """Compile ``source`` (if not yet built), load it and return its entry
    point ``symbol`` with ``argtypes`` and an int result; raises on failure."""
    if source in _entries:
        return _entries[source]
    name = source.stem
    out = library_path(source)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(name), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed ({proc.returncode}):\n{proc.stderr}")
        BUILD_LOGS[name] = proc.stderr
        os.replace(tmp, out)
    entry = getattr(ctypes.CDLL(str(out)), symbol)
    entry.argtypes = argtypes
    entry.restype = ctypes.c_int
    _entries[source] = entry
    return entry
