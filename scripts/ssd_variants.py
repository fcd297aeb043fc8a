"""Time the port's ``ssd_scan`` kernel at mamba2-780m's serving shape, on a card.

    PYTHONPATH=src python scripts/ssd_variants.py [--src DIR] [--iters 50]

Builds the kernel, holds ``ops.ssd_scan`` against the plain version at the
card's bars (bf16 y 2e-2, state 1e-3; f32 2e-4) at the serving shape and at
a many-chunk shape, then times at the serving shape (B=4, S=1024, H=48, P=64,
G=1, N=128, L=256):

- ``ms``: one ``ops.ssd_scan`` call, the mean over ``--iters`` back-to-back
  calls by CUDA events, bf16 and f32;
- ``stages_ms``: the device time of each kernel the call launches, by name,
  from ``torch.profiler`` over ``--iters`` calls (null where the trace holds
  no kernel);
- ``plain_ms``: the plain PyTorch version.

``--variants`` also builds edited copies of ``csrc/ssd_scan.cu`` into
``build/kernels/variants/`` (one ``nvcc`` per copy, started together) and
times each in bf16 against the kernel as it is, in turns, with its stages.
Their results are not checked: they measure where the time goes
(``VARIANTS`` below says what each leaves out).  Each edit fails loudly if
the source no longer holds the text it edits.

``--prefill`` also times mamba2-780m's ``prefill`` of 4 x 1024 tokens at
full width (random weights from seed 0), host clock around each call,
synchronised, after one warm-up, and reads the peak device memory.

``--src`` imports ``repro_torch`` from another tree (an unpacked parent
commit), so that two versions are timed in one call, in turns.  Prints one
JSON object with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SERVE = dict(b=4, s=1024, h=48, p=64, g=1, n=128, L=256)  # mamba2-780m prefill
MANY_CHUNKS = dict(b=2, s=4096, h=8, p=64, g=1, n=128, L=256)
TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (2e-2, 1e-3)}

# (anchor, replacement) edits of csrc/ssd_scan.cu per variant
VARIANTS = {
    # chunk_out without the lo products of the split (W and S_in rounded once)
    "out_no_lo": [("        mma_16x8x16(acc[2 * jp], alo, r[0], r[1]);\n", ""),
                  ("        mma_16x8x16(acc[2 * jp + 1], alo, r[2], r[3]);\n", ""),
                  ("          mma_16x8x16(acc[2 * jp], a, rl[0], rl[1]);\n", ""),
                  ("          mma_16x8x16(acc[2 * jp + 1], a, rl[2], rl[3]);\n", "")],
    # chunk_out without the inter-chunk term
    "out_no_inter": [("  if (c > 0) {\n    for (int k0 = 0; k0 < N; k0 += kT) {", "  if (false) {\n    for (int k0 = 0; k0 < N; k0 += kT) {")],
    # chunk_out without reading CB (W from a constant)
    "out_no_cb_reads": [("        const float2 fa = va ? *reinterpret_cast<const float2*>(cba + s) : make_float2(0.f, 0.f);\n"
                         "        const float2 fb = vb ? *reinterpret_cast<const float2*>(cbb + s) : make_float2(0.f, 0.f);\n",
                         "        const float2 fa = make_float2(0.5f, 0.5f), fb = fa;\n")],
    # chunk_state without the lo product of the split
    "state_no_lo": [("    warp_mma<true, true>(acc, xl, kLd, bs, kLdWide, m0, nw0, ks);\n", "")],
}


def inputs(b, s, h, p, g, n, seed, dtype):
    r = np.random.default_rng(seed)

    def t(shape, scale=1.0):
        return torch.tensor(r.standard_normal(shape) * scale, dtype=torch.float32, device="cuda")

    x = t((b, s, h, p)).to(dtype)
    dt = torch.nn.functional.softplus(t((b, s, h))) * 0.5
    a = -torch.exp(t((h,), 0.3))
    return x, dt, a, t((b, s, g, n), 0.5).to(dtype), t((b, s, g, n), 0.5).to(dtype)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def stages_ms(fn, iters: int) -> dict | None:
    """Device ms per call of each kernel that fn launches, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"([A-Za-z_]\w*(?:<[^()]*>)?)\(", e.name)  # the kernel's own name
            name = m.group(1) if m else e.name
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    return by_name or None


def check(ops, ref, shape, dtype, seed) -> dict:
    b, s, h, p, g, n, L = shape.values()
    args = inputs(b, s, h, p, g, n, seed, dtype)
    y, st = ops.ssd_scan(*args, chunk=L)
    y_ref, st_ref = ref(*args, chunk=L)
    torch.cuda.synchronize()
    ytol, stol = TOL[dtype]
    worst = {
        "y": ((y.float() - y_ref).abs() / (ytol + ytol * y_ref.abs())).max().item(),
        "state": ((st - st_ref).abs() / (stol + stol * st_ref.abs())).max().item(),
    }
    return {"shape": shape, "dtype": str(dtype), "worst_share_of_bar": worst,
            "ok": max(worst.values()) <= 1.0, "max_abs_err_y": (y.float() - y_ref).abs().max().item()}


def build_variant(kernel, nvcc, name: str):
    """Copy csrc/ to build/kernels/variants/name with the variant's edits and
    build it; returns the entry point and ptxas' register and spill lines."""
    text = kernel.SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: the source no longer holds {old!r} once")
        text = text.replace(old, new)
    dst = nvcc.BUILD_DIR / "variants" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(kernel.SOURCE.parent, dst)
    (dst / kernel.SOURCE.name).write_text(text)
    lib = dst / "lib.so"
    proc = subprocess.run([nvcc._nvcc(name), *nvcc.NVCC_FLAGS, "-o", str(lib), str(dst / kernel.SOURCE.name)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"variant {name}: nvcc failed:\n{proc.stderr}")
    entry = ctypes.CDLL(str(lib)).ssd_scan_launch
    entry.argtypes, entry.restype = kernel.ARGTYPES, ctypes.c_int
    return entry, [ln.strip() for ln in proc.stderr.splitlines() if "registers" in ln or "spill" in ln]


def time_variants(kernel, ops, nvcc, iters: int) -> dict:
    """bf16 at the serving shape: each variant and the kernel as it is, in turns."""
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda n: build_variant(kernel, nvcc, n), VARIANTS)))
    entries = {"kernel": kernel.build(), **{name: entry for name, (entry, _) in built.items()}}
    a = inputs(*list(SERVE.values())[:-1], 0, torch.bfloat16)
    real_build = kernel.build
    out = {name: {"ms": []} for name in entries}
    try:
        for order in (list(entries), list(reversed(entries))):
            for name in order:
                kernel.build = lambda e=entries[name]: e  # the wrapper launches this entry
                out[name]["ms"].append(cuda_ms(lambda: ops.ssd_scan(*a, chunk=SERVE["L"]), iters))
        for name in entries:
            kernel.build = lambda e=entries[name]: e
            out[name]["stages_ms"] = stages_ms(lambda: ops.ssd_scan(*a, chunk=SERVE["L"]), iters)
    finally:
        kernel.build = real_build
    for name, (_, ptxas) in built.items():
        out[name]["ptxas"] = ptxas
    return out


def time_prefill(repeats: int = 5) -> dict:
    """Host ms of each of ``repeats`` synchronised mamba2-780m prefills of 4 x 1024
    tokens, and the peak device memory over them."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import get_model

    cfg = ARCHS["mamba2-780m"]
    model = get_model(cfg)
    params = model.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 1024)), device="cuda")
    out = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(repeats + 1):  # the first call warms the allocator and cuBLAS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(cfg, params, {"tokens": tokens}, 2048)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return {"ms": out[1:], "max_memory_allocated": torch.cuda.max_memory_allocated()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--prefill", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ssd_variants: needs a CUDA card")
    sys.path.insert(0, args.src)
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels.ssd_scan import kernel, ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    kernel.build()
    checks = [check(ops, ssd_scan_ref, sh, dt, seed=i)
              for i, sh in enumerate((SERVE, MANY_CHUNKS)) for dt in (torch.bfloat16, torch.float32)]
    timing = {}
    for dtype in (torch.bfloat16, torch.float32):
        a = inputs(*list(SERVE.values())[:-1], 0, dtype)

        def call():
            return ops.ssd_scan(*a, chunk=SERVE["L"])

        timing[str(dtype)] = {
            "ms": [cuda_ms(call, args.iters) for _ in range(3)],
            "stages_ms": stages_ms(call, args.iters),
            "plain_ms": cuda_ms(lambda: ssd_scan_ref(*a, chunk=SERVE["L"]), 10),
        }
    if args.variants:
        timing["variants"] = time_variants(kernel, ops, _nvcc, args.iters)
    if args.prefill:
        timing["mamba2_prefill"] = time_prefill()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"src": args.src, "nvidia_smi": smi, "shape": SERVE, "timing": timing,
                      "checks": checks, "ok": all(c["ok"] for c in checks)}), flush=True)
    if not all(c["ok"] for c in checks):
        sys.exit("ssd_variants: the kernel misses a bar")


if __name__ == "__main__":
    main()
