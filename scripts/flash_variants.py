"""Measure where the port's bf16 flash-attention kernel's time goes, on a card.

    PYTHONPATH=src python scripts/flash_variants.py

Builds edited copies of ``repro_torch/kernels/flash_attention/csrc/`` into
``build/kernels/variants/`` (one ``nvcc`` per copy, started together) and
times each against the kernel as it is, in turns, at qwen2.5-3b's forward
shape, by CUDA events:

- ``one_rounding``: P rounded to bf16 once (no P_lo product): the cost of the
  split.  Its results miss the kernel's bar; only its time is read.
- ``stages_2``, ``stages_4``: other depths of the K/V ring.
- ``phases``: clock64 probes in each consumer warpgroup, summed over the grid:
  SM cycles per (warpgroup, K/V tile) waiting for the tile, in S = Q K^T, in
  the softmax and split, and in O += P V, and per warpgroup waiting for Q.

Prints one JSON object.  Nothing here is on the port's path; the edits are
made to copies, and each one fails loudly if the source no longer holds the
text it edits.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.kernels import _nvcc
from repro_torch.kernels.flash_attention import kernel

SHAPE = dict(b=4, s=1024, h=16, kh=2, d=128)  # qwen2.5-3b forward, 4 x 1024 tokens
OUT = _nvcc.BUILD_DIR / "variants"

# (anchor, replacement) edits of csrc/flash_attention.cu per variant
PROBES = [
    ('#include "hopper.cuh"\n',
     '#include "hopper.cuh"\n__device__ unsigned long long g_phase[8];\n'),
    ("    hopper::mbar_wait(q_full, 0);\n    int stage = 0;",
     "    const long long t_start = clock64();\n    hopper::mbar_wait(q_full, 0);\n"
     "    long long t_q = clock64() - t_start, t_full = 0, t_qk = 0, t_sm = 0, t_pv = 0, tt = 0, n = 0;\n"
     "    int stage = 0;"),
    ("      hopper::mbar_wait(full0 + 8 * stage, phase);\n      if (kt >= n_lo",
     "      tt = clock64();\n      hopper::mbar_wait(full0 + 8 * stage, phase);\n"
     "      t_full += clock64() - tt;\n      if (kt >= n_lo"),
    ("        hopper::fence_regs(s);\n        hopper::wgmma_fence();\n        issue_qk",
     "        tt = clock64();\n        hopper::fence_regs(s);\n        hopper::wgmma_fence();\n        issue_qk"),
    ("        hopper::wgmma_wait<0>();\n        hopper::fence_regs(s);\n",
     "        hopper::wgmma_wait<0>();\n        hopper::fence_regs(s);\n        t_qk += clock64() - tt;\n"
     "        tt = clock64();\n"),
    ("        hopper::fence_regs(acc);\n        hopper::wgmma_fence();\n        issue_pv",
     "        t_sm += clock64() - tt;\n        tt = clock64();\n"
     "        hopper::fence_regs(acc);\n        hopper::wgmma_fence();\n        issue_pv"),
    ("        hopper::wgmma_wait<0>();\n        hopper::fence_regs(acc);\n      }\n",
     "        hopper::wgmma_wait<0>();\n        hopper::fence_regs(acc);\n        t_pv += clock64() - tt;\n"
     "        ++n;\n      }\n"),
    ("    if (active) {\n#pragma unroll\n      for (int r = 0; r < 2; ++r) {\n",
     "    if (t == 0) {\n"
     "      const long long v[7] = {t_full, t_qk, t_sm, t_pv, n, t_q, 1};\n"
     "      for (int i = 0; i < 7; ++i) atomicAdd(&g_phase[i], (unsigned long long)v[i]);\n"
     "    }\n"
     "    if (active) {\n#pragma unroll\n      for (int r = 0; r < 2; ++r) {\n"),
]
PHASES_ENTRY = '''
extern "C" int flash_attention_phases(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  const unsigned long long zero[8] = {0};
  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
'''
VARIANTS = {
    "kernel": [],
    "one_rounding": [("    hopper::wgmma_m64n128k16_rs(acc, p_lo[j], db, 1);\n", "")],
    "stages_2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "stages_4": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "phases": PROBES,
}


def variant_source(name: str) -> str:
    """The text of csrc/flash_attention.cu with the edits of variant ``name``."""
    text = kernel.SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: the source no longer holds {old!r} once")
        text = text.replace(old, new)
    return text + PHASES_ENTRY if name == "phases" else text


def build(name: str):
    """Copy csrc/ to OUT/name with the variant's source and build it; returns
    the loaded library and ptxas' spill lines."""
    dst = OUT / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(kernel.SOURCE.parent, dst)
    source = dst / kernel.SOURCE.name
    source.write_text(variant_source(name))
    lib = dst / "lib.so"
    proc = subprocess.run([_nvcc._nvcc(name), *_nvcc.NVCC_FLAGS, "-o", str(lib), str(source)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"variant {name}: nvcc failed:\n{proc.stderr}")
    spills = [ln.strip() for ln in proc.stderr.splitlines() if "spill" in ln]
    return ctypes.CDLL(str(lib)), spills


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("variants: needs a CUDA card")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    b, s, h, kh, d = SHAPE.values()
    r = np.random.default_rng(0)
    q, k, v = (torch.tensor(r.standard_normal(shape), dtype=torch.float32, device="cuda").to(torch.bfloat16)
               for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(lib):
        fn = lib.flash_attention_launch
        fn.argtypes, fn.restype = kernel.ARGTYPES, ctypes.c_int

        def run():
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, kh, d, 0, d**-0.5, 1, stream)
            if rc:
                raise RuntimeError(f"launch failed with cudaError {rc}")
        return run

    def ms(fn, iters=50):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    runs = {name: launcher(lib) for name, (lib, _) in built.items()}
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    runs["sdpa"] = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                           enable_gqa=True)
    times = {name: [] for name in runs}
    for order in (list(runs), list(reversed(runs))):  # in turns: forward, then backward
        for name in order:
            times[name].append(ms(runs[name]))

    lib = built["phases"][0]
    counters = (ctypes.c_ulonglong * 8)()
    lib.flash_attention_phases(counters)  # clears what the timing runs summed
    runs["phases"]()
    torch.cuda.synchronize()
    lib.flash_attention_phases(counters)
    full, qk, soft, pv, tiles, q_wait, groups = list(counters)[:7]
    print(json.dumps({
        "shape": SHAPE,
        "device": torch.cuda.get_device_name(0),
        "ms": times,
        "spills": {name: spills for name, (_, spills) in built.items()},
        "phases_cycles_per_tile": {"wait_kv": full / tiles, "qk": qk / tiles, "softmax_split": soft / tiles,
                                   "pv": pv / tiles},
        "phases_cycles_per_warpgroup": {"wait_q": q_wait / groups},
        "tiles": tiles,
        "warpgroups": groups,
    }))


if __name__ == "__main__":
    main()
