"""Time the port's ``merge_runs`` kernel at its four shapes, on a card.

    PYTHONPATH=src python scripts/merge_variants.py [--src DIR] [--iters 50]

Builds the kernel and holds ``kernel.merge_runs_cuda`` against the plain
version (``ref.merge_runs_ref``) at every shape below and a few edge shapes,
int32, uint32 and float32 keys: keys and payloads equal in place.  Then it
times, int32 keys and payloads, at

- G=16384, T=512: the compaction shape of ``chip_smoke.py``;
- G=262144, T=32 and G=1024, T=8192: the same 268 MB as short tiles and at
  ``MAX_T``;
- G=64, T=512: ``benchmarks/bench_kernels.py``'s tiles, where the host sets
  the rate;

- ``ms``: one ``merge_runs_cuda`` call, the mean over ``--iters`` back-to-back
  calls by CUDA events;
- ``host_ms``: the host's time per call, back to back, not synchronised;
- ``kernel_device_ms``: the kernel's own device time per call, from
  ``torch.profiler`` over ``--iters`` calls;
- ``plain_ms``, ``library_ms`` (``torch.sort(stable=True)`` of the keys
  alone, a yardstick) and ``copy_ms`` (a copy of the four input tiles, which
  moves the same bytes), once.

``host_parts`` times the launch path's parts at the bench shape, host clock
per call, for each tree.  ``--variants`` also builds edited copies of
``csrc/merge_runs.cu`` into ``build/kernels/variants/`` (one ``nvcc`` per
copy, started together) and times each against the kernel as it is, in
turns, at the 268 MB shapes (``VARIANTS`` says what each changes; their
results are not checked).

``--src DIR`` also imports ``repro_torch`` from another tree (an unpacked
parent commit: ``git archive <commit> src | tar -x -C build/parent``, then
``--src build/parent/src``), checks its kernel at the reference's bar (keys
equal, equal (key, payload) multisets per row) and times both in turns:
parent, change, change, parent.  Prints one JSON object with the card's name
and power limit; exits non-zero if a kernel misses its bar.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SHAPES = {
    "compaction": dict(g=16384, t=512),
    "short_tiles": dict(g=262144, t=32),
    "max_t": dict(g=1024, t=8192),
    "bench": dict(g=64, t=512),
}
# (anchor, replacement) edits of csrc/merge_runs.cu per variant; their results are not checked
VARIANTS = {
    # 8 blocks an SM: registers capped at 32
    "min_blocks_8": [("__global__ void __launch_bounds__(kThreads)\n", "__global__ void __launch_bounds__(kThreads, 8)\n")],
    # other block sizes: 1,024 and 4,096 outputs a block
    "threads_128": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "threads_512": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    # 16 outputs a thread: 4,096 a block, half the searches
    "e_16": [("constexpr int kE = 8; ", "constexpr int kE = 16;")],
    # outputs stored evict-first
    "streaming_stores": [("      dk[c] = make_uint4(kw[4 * c], kw[4 * c + 1], kw[4 * c + 2], kw[4 * c + 3]);\n"
                          "      dv[c] = make_uint4(vw[4 * c], vw[4 * c + 1], vw[4 * c + 2], vw[4 * c + 3]);\n",
                          "      __stcs(dk + c, make_uint4(kw[4 * c], kw[4 * c + 1], kw[4 * c + 2], kw[4 * c + 3]));\n"
                          "      __stcs(dv + c, make_uint4(vw[4 * c], vw[4 * c + 1], vw[4 * c + 2], vw[4 * c + 3]));\n")],
    # without each thread's second search (its end taken as s0 + e): the cost of the search
    "one_search": [("    s1 = split<K>(ka, na, kb, nb, d + e);\n", "    s1 = min(s0 + e, na);\n")],
}
EDGES = [dict(g=1000, t=1), dict(g=1001, t=2), dict(g=13, t=64), dict(g=7, t=4096), dict(g=20, t=8192)]
HBM_BYTES_S = 3.35e12  # H100 SXM data sheet


def load_tree(src: str):
    """Import ``repro_torch``'s merge kernel from the tree at ``src``, apart
    from any copy imported before (each keeps its own modules)."""
    for name in [m for m in sys.modules if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, src)
    try:
        kernel = importlib.import_module("repro_torch.kernels.merge_runs.kernel")
        ref = importlib.import_module("repro_torch.kernels.merge_runs.ref")
        ops = importlib.import_module("repro_torch.kernels.merge_runs.ops")
    finally:
        sys.path.remove(src)
    kernel.build()
    return kernel, ref, ops


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
    entry = ctypes.CDLL(str(lib)).merge_runs_launch
    entry.argtypes, entry.restype = kernel.ARGTYPES, ctypes.c_int
    return entry, [ln.strip() for ln in proc.stderr.splitlines() if "registers" in ln or "spill" in ln]


def time_variants(kernel, args: dict, iters: int) -> dict:
    """The 268 MB shapes: each variant and the kernel as it is, in turns."""
    nvcc = sys.modules["repro_torch.kernels._nvcc"]
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda n: build_variant(kernel, nvcc, n), VARIANTS)))
    entries = {"kernel": kernel.build(), **{name: entry for name, (entry, _) in built.items()}}
    real_build = kernel.build
    out = {name: {shape: [] for shape in SHAPES if shape != "bench"} for name in entries}
    try:
        for order in (list(entries), list(reversed(entries))):
            for name in order:
                kernel.build = lambda e=entries[name]: e  # the wrapper launches this entry
                for shape in out[name]:
                    out[name][shape].append(cuda_ms(lambda a=args[shape]: kernel.merge_runs_cuda(*a), iters))
    finally:
        kernel.build = real_build
    for name, (_, ptxas) in built.items():
        out[name]["ptxas"] = ptxas
    return out


def host_parts(kernel, ops, a: list, iters: int) -> dict:
    """Host ms per call of the launch path's parts at one shape, back to back."""
    g, t = a[0].shape
    entry = kernel.build()
    out = torch.empty((2, g, 2 * t), dtype=torch.int32, device="cuda")
    ptrs = [x.data_ptr() for x in a] + [out.data_ptr(), out.data_ptr() + 8 * g * t]
    stream = torch.cuda.current_stream().cuda_stream
    parts = {
        "merge_tiles": lambda: ops.merge_tiles(*a),
        "merge_runs_cuda": lambda: kernel.merge_runs_cuda(*a),
        "launch_only": lambda: entry(*ptrs, g, t, 0, stream),
        "torch_empty": lambda: torch.empty((2, g, 2 * t), dtype=torch.int32, device="cuda"),
        "unbind_and_views": lambda: [x.view(torch.int32) for x in out.unbind(0)],
        "unbind": lambda: out.unbind(0),
        "new_empty": lambda: a[0].new_empty((2, g, 2 * t)),
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "data_ptr_x4": lambda: [x.data_ptr() for x in a],
        "is_contiguous_x4": lambda: [x.is_contiguous() for x in a],
        "device_x4": lambda: [x.device for x in a],
    }
    return {name: host_ms(fn, iters * 20) for name, fn in parts.items()}


def ptxas_lines() -> list[str]:
    """ptxas' register and spill lines for the merge kernel last built here."""
    log = sys.modules["repro_torch.kernels._nvcc"].BUILD_LOGS.get("merge_runs", "")
    return [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]


def inputs(g, t, key_dtype, seed, distinct=0, offset=0):
    """Two (g, t) ascending key tiles and int32 payloads on the card; with
    ``offset``, cut from larger tensors that many elements in (misaligned)."""
    r = np.random.default_rng(seed)

    def keys():
        if key_dtype == torch.float32:
            return torch.from_numpy(np.sort(r.standard_normal((g, t)).astype(np.float32), axis=1))
        hi = distinct or (1 << 32 if key_dtype == torch.uint32 else 1 << 31)
        lo = 0 if distinct or key_dtype == torch.uint32 else -(1 << 31)
        k = np.sort(r.integers(lo, hi, (g, t), dtype=np.int64), axis=1)
        return torch.from_numpy(k.astype(np.uint32 if key_dtype == torch.uint32 else np.int32))

    vals = [torch.from_numpy(r.integers(-(1 << 31), 1 << 31, (g, t)).astype(np.int32)) for _ in range(2)]
    out = []
    for x in (keys(), keys(), *vals):
        y = torch.empty(x.numel() + offset, dtype=x.dtype, device="cuda")[offset:].view(x.shape)
        out.append(y.copy_(x))
    return out


def words(x):
    return x.view(torch.int32)


def check(kernel, ref, in_place: bool) -> list[str]:
    """Where the kernel misses its bar: keys equal and payloads equal in place
    (``in_place``), else equal (key, payload) multisets per row."""
    misses = []
    cases = [(sh, kd, 0, 0) for sh in (*SHAPES.values(), *EDGES) for kd in (torch.int32, torch.uint32, torch.float32)]
    cases += [(dict(g=64, t=512), torch.int32, 4, 0), (dict(g=5, t=4096), torch.uint32, 3, 0),
              (dict(g=9, t=64), torch.int32, 0, 1), (dict(g=3, t=2048), torch.float32, 3, 1)]
    for i, (sh, key_dtype, distinct, offset) in enumerate(cases):
        args = inputs(sh["g"], sh["t"], key_dtype, seed=100 + i, distinct=distinct, offset=offset)
        ok, ov = kernel.merge_runs_cuda(*args)
        rk, rv = ref.merge_runs_ref(*args)

        def pairs(k, v):
            return torch.sort((words(k).to(torch.int64) << 32) | (words(v).to(torch.int64) & 0xFFFFFFFF), dim=1)[0]

        good = torch.equal(words(ok), words(rk)) and torch.equal(pairs(ok, ov), pairs(rk, rv))
        if in_place:
            good = good and torch.equal(words(ov), words(rv))
        if not good:
            misses.append(f"g={sh['g']} t={sh['t']} {key_dtype} distinct={distinct} offset={offset}")
    return misses


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
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


def host_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def device_ms(fn, iters: int) -> float | None:
    """Device time per call of the kernels fn launches, by ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and "merge" in e.name)
    return us / 1e3 / iters if us else None


def time_tree(kernel, args: dict, iters: int) -> dict:
    out = {}
    for name, a in args.items():
        def call(a=a):
            return kernel.merge_runs_cuda(*a)
        out[name] = {"ms": cuda_ms(call, iters), "host_ms": host_ms(call, iters)}
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=None, help="another tree's src/ to time against, in turns")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--variants", action="store_true", help="also time the edited copies in VARIANTS")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("merge_variants: needs a CUDA card")
    here = str(Path(__file__).resolve().parents[1] / "src")
    trees = {}
    if opts.src:
        trees["parent"] = load_tree(str(Path(opts.src).resolve()))
    trees["change"] = load_tree(here)
    ptxas = ptxas_lines()
    misses = {"change": check(*trees["change"][:2], in_place=True)}
    if opts.src:
        misses["parent"] = check(*trees["parent"][:2], in_place=False)

    args = {name: inputs(sh["g"], sh["t"], torch.int32, seed=0) for name, sh in SHAPES.items()}
    kernel, ref, ops = trees["change"]
    order = ["parent", "change", "change", "parent"] if opts.src else ["change", "change"]
    turns = {tree: [] for tree in trees}
    for tree in order:
        turns[tree].append(time_tree(trees[tree][0], args, opts.iters))
    extra = {"host_parts": {tree: host_parts(k, o, args["bench"], opts.iters) for tree, (k, _, o) in trees.items()}}
    if opts.variants:
        extra["variants"] = time_variants(kernel, args, opts.iters)
    shapes = {}
    for name, sh in SHAPES.items():
        a = args[name]
        cat, tiles = torch.cat(a[:2], dim=1), torch.cat(a, dim=1)
        nbytes = 4 * 4 * sh["g"] * sh["t"] + 2 * 4 * sh["g"] * 2 * sh["t"]
        shapes[name] = {
            "shape": sh, "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_S * 1e3,
            **{tree: {key: [turn[name][key] for turn in turns[tree]] for key in ("ms", "host_ms")} for tree in trees},
            "plain_ms": cuda_ms(lambda: ref.merge_runs_ref(*a), 10),
            "library_ms": cuda_ms(lambda: torch.sort(cat, dim=1, stable=True), opts.iters),
            # a device-to-device copy that moves the same bytes: the rate the card reaches in practice
            "copy_ms": cuda_ms(lambda: torch.empty_like(tiles).copy_(tiles), opts.iters),
            "kernel_device_ms": {tree: device_ms(lambda k=k: k.merge_runs_cuda(*a), opts.iters)
                                 for tree, (k, *_) in trees.items()},
        }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    ok = not any(misses.values())
    print(json.dumps({"src": opts.src, "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
                      "order": order, "ptxas": ptxas, "shapes": shapes, **extra, "misses": misses, "ok": ok}), flush=True)
    if not ok:
        sys.exit("merge_variants: a kernel misses its bar")


if __name__ == "__main__":
    main()
