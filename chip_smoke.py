#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources beside this file (one
``nvcc`` per source, started together) and holds each against its plain
PyTorch version on the card.  Then it drives the port's paths at full width,
with random weights from seed 0, and checks that each went through its kernel:

- mamba2-780m serves two batches through ``ServeEngine`` (48 ``ssd_scan``
  launches per prefill);
- qwen2.5-3b runs ``forward`` and ``loss_fn`` with ``attention_impl="flash"``
  (36 ``flash_attention`` launches per call), and an f32 twin holds the
  kernel path against the plain attention;
- qwen2.5-3b serves two batches through ``ServeEngine`` (no kernel launch:
  prefill and decode use the plain attention, as in the reference);
- ``merge_tiles`` merges sorted tiles through ``merge_runs`` at the bench and
  compaction shapes, and ``merge_sorted_runs`` an L1 run into an L2 run;
- the store engine (``repro_torch.api``, on the host as in the reference)
  reproduces the fig5 smoke rows of ``BENCH_BASELINE.json``, reads back every
  acknowledged write after GC, crash and recover, and classifies 2^24 sizes
  on the card exactly as on the CPU.

Prints one JSON line per phase; the last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Exits non-zero, with no
result, when there is no card or when this file stands outside the repository.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

SERVE_SHAPE = dict(b=4, s=1024, h=48, p=64, g=1, n=128, L=256)  # mamba2-780m prefill
TEST_SHAPES = [  # tests/test_kernels.py's ssd sweep: G=2 and a single chunk among them
    dict(b=2, s=64, h=4, p=16, g=1, n=16, L=16),
    dict(b=1, s=128, h=4, p=32, g=2, n=32, L=32),
    dict(b=2, s=256, h=8, p=64, g=1, n=64, L=64),
    dict(b=1, s=64, h=2, p=8, g=1, n=8, L=64),
    # the bf16 kernel's stages: 16 chunks through the state pass, two groups at L = 256
    dict(b=2, s=4096, h=8, p=64, g=1, n=128, L=256),
    dict(b=1, s=1024, h=4, p=64, g=2, n=128, L=256),
]
SSD_STAGES = ("ssd_cb_kernel", "ssd_chunk_state_kernel", "ssd_state_pass_kernel", "ssd_chunk_out_kernel")
# y at the reference tests' bars (f32: 2e-4, bf16: 2e-2); the state is f32 in
# both versions, so in bf16 only the order of its sums differs
TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (2e-2, 1e-3)}

FA_FORWARD_SHAPE = dict(b=4, s=1024, h=16, kh=2, d=128)  # qwen2.5-3b forward, 4 x 1024 tokens
# tests/test_kernels.py's flash sweep and its window case, then a ragged S, then
# windows at D = 64 that leave some rows no key in their warpgroup's first tile
FA_TEST_SHAPES = [
    dict(b=1, s=128, h=4, kh=2, d=32),
    dict(b=2, s=256, h=8, kh=2, d=64),
    dict(b=1, s=256, h=4, kh=4, d=32),
    dict(b=1, s=512, h=2, kh=1, d=64),
    dict(b=2, s=128, h=4, kh=2, d=32, window=32),
    dict(b=2, s=1000, h=16, kh=2, d=128),
    dict(b=2, s=128, h=4, kh=2, d=64, window=32),
    dict(b=2, s=300, h=4, kh=1, d=64, window=70),
]
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # the reference tests' bars, abs and rel
# bf16 kernel against the float32 plain version of its own inputs: the kernel
# keeps the softmax in float32 and carries P into the product with v as two
# bfloat16 terms (about 16 bits), then rounds its output, so each element lies
# within twice bfloat16's unit roundoff (2**-8) of that version, plus float32 noise
FA_BF16_VS_F32 = dict(atol=1e-5, rtol=2**-7)


MERGE_BENCH_SHAPE = dict(g=64, t=512)  # benchmarks/bench_kernels.py's merge tiles
# ~8.4M keys a side: about the L2 of a store with the paper's 128 MB L0, growth 4
# and SD's 251-B mean KV (benchmarks/common.py)
MERGE_COMPACTION_SHAPE = dict(g=16384, t=512)
# the same 268 MB as short tiles (8 rows a block) and at MAX_T (a row over 8 blocks)
MERGE_268MB_SHAPES = (dict(g=262144, t=32), dict(g=1024, t=8192))
MERGE_TEST_SHAPES = [(8, 64), (16, 128), (8, 256), (32, 32), (1, 512)]  # tests/test_kernels.py's sweep
MERGE_RUNS = (2_097_152, 8_388_608)  # merge_sorted_runs: an L1 run into an L2 run
KEY_DTYPES = (torch.int32, torch.uint32, torch.float32)
CLASSIFY_PAIRS = 1 << 24


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn over `iters` back-to-back calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean host time of one call of fn, back to back without synchronising:
    what the host spends to enqueue it (the device's queue does not fill)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def ssd_inputs(b, s, h, p, g, n, seed, dtype):
    r = np.random.default_rng(seed)

    def t(shape, scale=1.0):
        return torch.tensor(r.standard_normal(shape) * scale, dtype=torch.float32, device="cuda")

    x = t((b, s, h, p)).to(dtype)
    dt = torch.nn.functional.softplus(t((b, s, h))) * 0.5
    a = -torch.exp(t((h,), 0.3))
    return x, dt, a, t((b, s, g, n), 0.5).to(dtype), t((b, s, g, n), 0.5).to(dtype)


def ssd_bound(b, s, h, p, g, n, L, dtype):
    """(bound_ms, bound_by, bytes, flops) of one scan: each input read and each
    output written once; the operations of the causal half of the L x L form."""
    e = torch.finfo(dtype).bits // 8
    nbytes = e * (2 * b * s * h * p + 2 * b * s * g * n) + 4 * (b * s * h + h + b * h * p * n)
    tri = L * (L + 1) // 2
    flops = b * h * (s // L) * 2 * (tri * n + tri * p + 2 * L * p * n)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def check_ssd(shape, dtype, seed) -> float:
    """Kernel (through ops.ssd_scan) against the plain version; returns max |dy|."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    b, s, h, p, g, n, L = (shape[k] for k in "b s h p g n L".split())
    args = ssd_inputs(b, s, h, p, g, n, seed, dtype)
    y, st = ops.ssd_scan(*args, chunk=L)
    y_ref, st_ref = ssd_scan_ref(*args, chunk=L)
    torch.cuda.synchronize()
    ytol, stol = TOL[dtype]
    where = f"ssd_scan {shape} {dtype}"
    if y.dtype != dtype or y.shape != (b, s, h, p) or st.shape != (b, h, p, n):
        fail(f"{where}: got y {y.dtype}{tuple(y.shape)}, state {tuple(st.shape)}")
    for name, got, ref, tol in (("y", y.float(), y_ref, ytol), ("state", st, st_ref, stol)):
        if not torch.allclose(got, ref, atol=tol, rtol=tol):
            fail(f"{where}: {name} differs from the plain version by {(got - ref).abs().max().item()}")
    return (y.float() - y_ref).abs().max().item()


def phase_ssd_kernel() -> dict:
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs[dtype] = check_ssd(SERVE_SHAPE, dtype, seed=0)
        for i, shape in enumerate(TEST_SHAPES):
            check_ssd(shape, dtype, seed=1 + i)
        check_ssd({**SERVE_SHAPE, "s": 1000}, dtype, seed=9)  # S % L != 0

    sh = SERVE_SHAPE
    timing = {}
    for dtype in (torch.bfloat16, torch.float32):
        args = ssd_inputs(sh["b"], sh["s"], sh["h"], sh["p"], sh["g"], sh["n"], 0, dtype)
        kernel_ms = cuda_ms(lambda: ops.ssd_scan(*args, chunk=sh["L"]), iters=50)
        ref_ms = cuda_ms(lambda: ssd_scan_ref(*args, chunk=sh["L"]), iters=10)
        bound_ms, bound_by, nbytes, flops = ssd_bound(*sh.values(), dtype)
        timing[dtype] = dict(ms=kernel_ms, plain_ms=ref_ms, bound_ms=bound_ms, bound_by=bound_by,
                             bytes=nbytes, flops=flops)
        if dtype == torch.bfloat16:  # each stage's device ms per call, over 20 calls
            calls = 20
            prof = profile(lambda: [ops.ssd_scan(*args, chunk=sh["L"]) for _ in range(calls)], top=8)
            timing[dtype]["stages_ms"] = {
                stage: sum(k["ms"] for k in prof["top"] if stage in k["name"]) / calls for stage in SSD_STAGES
            }
    bf, f32 = timing[torch.bfloat16], timing[torch.float32]
    return {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:75",
        "launches": None,  # filled from the serving phase
        "max_abs_err": errs[torch.bfloat16],
        "ms": bf["ms"],
        "plain_ms": bf["plain_ms"],
        "bound_ms": bf["bound_ms"],
        "bound_by": bf["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the SSD scan
        "design": "bf16: cb, chunk_state, state_pass, chunk_out on mma.sync, split operands; f32: CUDA cores",
        "stages_ms": bf["stages_ms"],
        "kernel_ms": bf["ms"],
        "ref_ms": bf["plain_ms"],
        "shape": sh,
        "dtype": "bfloat16",
        "bytes": bf["bytes"],
        "flops": bf["flops"],
        "f32": {"max_abs_err": errs[torch.float32], "ms": f32["ms"], "plain_ms": f32["plain_ms"],
                "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"]},
    }


def profile(fn, top: int = 6, named: str | None = None) -> dict:
    """One call of fn under torch.profiler: host wall ms, the device's busy ms
    (the union of kernel intervals), its idle share, the kernels that took
    the most device time and, with ``named``, the device ms of the kernels
    whose name holds it.  The profiler slows the host, so the idle share is
    an upper bound.  Device numbers are null where the trace holds no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"wall_ms": wall_ms, "device_busy_ms": None, "idle_share": None, "kernels": 0, "top": [],
                **({f"{named}_ms": None} if named is not None else {})}
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + e.time_range.elapsed_us() / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out = {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3, "idle_share": 1 - busy / 1e3 / wall_ms,
           "kernels": len(kernels), "top": [{"name": n, "ms": t} for n, t in ranked]}
    if named is not None:
        out[f"{named}_ms"] = sum(t for n, t in by_name.items() if named in n)
    return out


def fa_inputs(b, s, h, kh, d, seed, dtype):
    r = np.random.default_rng(seed)
    return [
        torch.tensor(r.standard_normal(shape), dtype=torch.float32, device="cuda").to(dtype)
        for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d))
    ]


def fa_bound(b, s, h, kh, d, dtype):
    """(bound_ms, bound_by, bytes, flops) of one causal call: q, k, v read and o
    written once; two products of 2*D operations per (q, k) pair the mask keeps."""
    e = torch.finfo(dtype).bits // 8
    nbytes = e * (2 * b * s * h * d + 2 * b * s * kh * d)
    flops = b * h * (s * (s + 1) // 2) * 4 * d
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def check_fa(shape, dtype, seed) -> tuple[float, float | None]:
    """Kernel (through ops.flash_attention) against the plain version; returns
    max |do| and, in bf16, ||o - ref32|| / ||ref32|| against the float32 plain
    version of the same inputs."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    window = shape.get("window", 0)
    q, k, v = fa_inputs(*(shape[x] for x in "b s h kh d".split()), seed, dtype)
    out = ops.flash_attention(q, k, v, window=window)
    ref = flash_attention_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    where = f"flash_attention {shape} {dtype}"
    if out.dtype != dtype or out.shape != q.shape:
        fail(f"{where}: got {out.dtype}{tuple(out.shape)}")
    tol = FA_TOL[dtype]
    if not torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol):
        fail(f"{where}: differs from the plain version by {(out.float() - ref.float()).abs().max().item()}")
    rel = None
    if dtype == torch.bfloat16:
        ref32 = flash_attention_ref(q.float(), k.float(), v.float(), window=window)
        rel = ((out.float() - ref32).norm() / ref32.norm()).item()
        if not torch.allclose(out.float(), ref32, **FA_BF16_VS_F32):
            fail(f"{where}: differs from the float32 plain version by {(out.float() - ref32).abs().max().item()}")
    return (out.float() - ref.float()).abs().max().item(), rel


def phase_fa_kernel() -> dict:
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    errs, rels = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        errs[dtype], rels[dtype] = check_fa(FA_FORWARD_SHAPE, dtype, seed=0)
        for i, shape in enumerate(FA_TEST_SHAPES):
            check_fa(shape, dtype, seed=1 + i)
    # causality (tests/test_kernels.py): a changed tail leaves earlier rows as they were
    q, k, v = fa_inputs(1, 128, 2, 2, 32, 1, torch.float32)
    out1 = ops.flash_attention(q, k, v)
    k[:, 100:], v[:, 100:] = 99.0, -99.0
    out2 = ops.flash_attention(q, k, v)
    if not torch.allclose(out1[:, :100], out2[:, :100], atol=1e-6, rtol=0):
        fail("flash_attention: rows before a changed tail moved")

    sh = FA_FORWARD_SHAPE
    timing = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = fa_inputs(*sh.values(), 0, dtype)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # (B, heads, S, D) views for SDPA
        kernel_ms = cuda_ms(lambda: ops.flash_attention(q, k, v), iters=50)
        call_ms = host_ms(lambda: ops.flash_attention(q, k, v), iters=50)
        ref_ms = cuda_ms(lambda: flash_attention_ref(q, k, v), iters=10)
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters=50)
        bound_ms, bound_by, nbytes, flops = fa_bound(*sh.values(), dtype)
        timing[dtype] = dict(ms=kernel_ms, host_ms=call_ms, plain_ms=ref_ms, library_ms=lib_ms, bound_ms=bound_ms,
                             bound_by=bound_by, bytes=nbytes, flops=flops)
    bf, f32 = timing[torch.bfloat16], timing[torch.float32]
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:76",
        "launches": None,  # filled from the forward phase
        "max_abs_err": errs[torch.bfloat16],
        "rel_err_vs_f32": rels[torch.bfloat16],
        "ms": bf["ms"],
        "plain_ms": bf["plain_ms"],
        "bound_ms": bf["bound_ms"],
        "bound_by": bf["bound_by"],
        "library_ms": bf["library_ms"],  # F.scaled_dot_product_attention, a yardstick only
        "design": "wgmma+tma, split P",
        "host_ms": bf["host_ms"],  # the host's time per call of ops.flash_attention, wrapper included
        "forward_device_share": None,  # filled from the profiled forward
        "shape": sh,
        "dtype": "bfloat16",
        "bytes": bf["bytes"],
        "flops": bf["flops"],
        "f32": {"max_abs_err": errs[torch.float32], "ms": f32["ms"], "plain_ms": f32["plain_ms"],
                "library_ms": f32["library_ms"], "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"]},
    }


def merge_inputs(g, t, key_dtype, seed, val_dtype=torch.int32, distinct=0):
    """Two (g, t) ascending key tiles and their payloads, on the card.  With
    ``distinct``, keys are drawn from that many values, so runs share keys."""
    r = np.random.default_rng(seed)

    def keys():
        if key_dtype == torch.float32:
            k = r.standard_normal((g, t)).astype(np.float32)
        elif distinct:
            k = r.integers(0, distinct, (g, t)).astype(np.int64)
        elif key_dtype == torch.uint32:  # about half with the top bit set
            k = r.integers(0, 1 << 32, (g, t), dtype=np.uint64).astype(np.int64)
        else:
            k = r.integers(-(1 << 31), 1 << 31, (g, t)).astype(np.int64)
        k = np.sort(k, axis=1)
        if key_dtype == torch.float32:
            return torch.from_numpy(k)
        npt = np.uint32 if key_dtype == torch.uint32 else np.int32
        return torch.from_numpy(k.astype(npt))

    def vals():
        v = r.standard_normal((g, t)).astype(np.float32) if val_dtype == torch.float32 else \
            r.integers(-(1 << 31), 1 << 31, (g, t)).astype(np.int32)
        return torch.from_numpy(v)

    return [x.to("cuda") for x in (keys(), keys(), vals(), vals())]


def pair_multisets(keys, vals):
    """Per row, the sorted (key bits, payload bits) pairs as int64: equal for two
    results exactly when their rows hold the same (key, payload) multisets."""
    from repro_torch.kernels.merge_runs.ref import words

    return torch.sort((words(keys).to(torch.int64) << 32) | (words(vals).to(torch.int64) & 0xFFFFFFFF), dim=1)[0]


def check_merge(g, t, key_dtype, seed, val_dtype=torch.int32, distinct=0, offset=0) -> float:
    """Kernel against the plain version: keys and payloads equal in place (the
    kernel is a stable merge; the reference's bar, equal (key, payload)
    multisets per row, is checked too).  ``offset`` > 0 cuts the inputs from
    larger tensors at that many elements, off the 16-byte boundary.  Returns
    the largest |key - plain key|."""
    from repro_torch.kernels.merge_runs import kernel
    from repro_torch.kernels.merge_runs.ref import merge_runs_ref, sort_key, words

    args = merge_inputs(g, t, key_dtype, seed, val_dtype, distinct)
    if offset:
        cut = [torch.empty(x.numel() + offset, dtype=x.dtype, device="cuda")[offset:].view(x.shape) for x in args]
        for c, x in zip(cut, args):
            c.copy_(x)
        args = cut
    ok, ov = kernel.merge_runs_cuda(*args)
    rk, rv = merge_runs_ref(*args)
    torch.cuda.synchronize()
    where = f"merge_runs g={g} t={t} keys {key_dtype} payloads {val_dtype} distinct={distinct} offset={offset}"
    if ok.dtype != key_dtype or ov.dtype != val_dtype or ok.shape != (g, 2 * t) or ov.shape != (g, 2 * t):
        fail(f"{where}: got {ok.dtype}{tuple(ok.shape)}, {ov.dtype}{tuple(ov.shape)}")
    if not torch.equal(words(ok), words(rk)):
        bad = (words(ok) != words(rk)).sum().item()
        fail(f"{where}: {bad} keys differ from the plain version")
    if not torch.equal(words(ov), words(rv)):
        bad = (words(ov) != words(rv)).sum().item()
        fail(f"{where}: {bad} payloads differ from the plain version's in place")
    if not torch.equal(pair_multisets(ok, ov), pair_multisets(rk, rv)):
        fail(f"{where}: (key, payload) pairs differ from the plain version's")
    return (sort_key(ok).double() - sort_key(rk).double()).abs().max().item()


def merge_bound(g, t) -> tuple[float, int]:
    """(bound_ms, bytes) of one merge: four (g, t) 32-bit inputs read and two
    (g, 2t) outputs written once, at the HBM rate.  A merge of 2t keys needs
    about 2t comparisons, far below what would set the bound, whatever
    implements it, so the bound is the bytes'."""
    nbytes = 4 * 4 * g * t + 2 * 4 * g * 2 * t
    return nbytes / HBM_BYTES_S * 1e3, nbytes


def time_merge(g, t) -> dict:
    """Kernel, plain version and torch.sort(stable) of the concatenated keys
    (the library yardstick, keys only), int32 keys and payloads; ``host_ms``
    is what the host spends per call back to back (the wrapper's checks, the
    allocation, ctypes)."""
    from repro_torch.kernels.merge_runs import kernel
    from repro_torch.kernels.merge_runs.ref import merge_runs_ref

    args = merge_inputs(g, t, torch.int32, 0)
    cat = torch.cat(args[:2], dim=1)
    kernel_ms = cuda_ms(lambda: kernel.merge_runs_cuda(*args), iters=50)
    call_ms = host_ms(lambda: kernel.merge_runs_cuda(*args), iters=50)
    plain_ms = cuda_ms(lambda: merge_runs_ref(*args), iters=10)
    lib_ms = cuda_ms(lambda: torch.sort(cat, dim=1, stable=True), iters=50)
    # 20 launches under the profiler: the kernel's own device time per launch,
    # without the host's share of back-to-back calls (checks, ctypes, allocation)
    merge_ms = profile(lambda: [kernel.merge_runs_cuda(*args) for _ in range(20)], named="merge")["merge_ms"]
    device_ms = merge_ms / 20 if merge_ms else None
    bound_ms, nbytes = merge_bound(g, t)
    return dict(shape=dict(g=g, t=t), ms=kernel_ms, host_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                kernel_device_ms=device_ms, bound_ms=bound_ms, bound_by="bytes", bytes=nbytes)


def phase_merge_kernel() -> dict:
    from repro_torch.kernels.merge_runs import kernel

    errs = []
    for i, (g, t) in enumerate(MERGE_TEST_SHAPES):
        for key_dtype in KEY_DTYPES:
            errs.append(check_merge(g, t, key_dtype, seed=1 + i))
    for key_dtype in KEY_DTYPES:
        for val_dtype in (torch.int32, torch.float32):
            errs.append(check_merge(8, 128, key_dtype, seed=20, val_dtype=val_dtype))
        errs.append(check_merge(1000, 1, key_dtype, seed=21))  # T = 1
        errs.append(check_merge(20, kernel.MAX_T, key_dtype, seed=22))  # T = 8192: a row over 8 blocks
        errs.append(check_merge(13, 64, key_dtype, seed=23))  # G not a multiple of 8
        errs.append(check_merge(1001, 2, key_dtype, seed=24))  # a last block with 233 of its 256 rows
        errs.append(check_merge(7, 4096, key_dtype, seed=27))  # a row over two blocks
        errs.append(check_merge(9, 64, key_dtype, seed=28, offset=1))  # misaligned: the 4-byte path
        errs.append(check_merge(3, 2048, key_dtype, seed=29, offset=1))
    for g, t, distinct in ((64, 512, 4), (3, 8192, 2), (700, 4, 3), (5, 4096, 3)):  # runs that share keys
        errs.append(check_merge(g, t, torch.int32, seed=25, distinct=distinct))
        errs.append(check_merge(g, t, torch.uint32, seed=26, distinct=distinct))
    # the duplicates case of tests/test_kernels.py
    dk = [torch.tensor([row], dtype=torch.int32, device="cuda") for row in
          ([1, 1, 2, 2, 3, 3, 4, 4], [1, 2, 2, 3, 3, 3, 5, 9])]
    dv = [torch.arange(8, dtype=torch.int32, device="cuda")[None] + off for off in (0, 100)]
    out, _ = kernel.merge_runs_cuda(*dk, *dv)
    if out[0].tolist() != sorted(dk[0][0].tolist() + dk[1][0].tolist()):
        fail(f"merge_runs duplicates case: {out[0].tolist()}")
    for shape in (MERGE_BENCH_SHAPE, MERGE_COMPACTION_SHAPE, *MERGE_268MB_SHAPES):
        for key_dtype in KEY_DTYPES:
            errs.append(check_merge(shape["g"], shape["t"], key_dtype, seed=30))
    try:
        kernel.merge_runs_cuda(*merge_inputs(2, 2 * kernel.MAX_T, torch.int32, 0))
        fail("merge_runs accepted T = 16384, beyond its shared-memory limit")
    except ValueError:
        pass

    compaction = time_merge(**MERGE_COMPACTION_SHAPE)
    bench = time_merge(**MERGE_BENCH_SHAPE)
    others = [time_merge(**shape) for shape in MERGE_268MB_SHAPES]
    return {
        "name": "merge_runs",
        "route": "cuda",
        "source": "src/repro_torch/kernels/merge_runs/csrc/merge_runs.cu",
        "replaces": "src/repro/kernels/merge_runs/kernel.py:64",
        "launches": None,  # filled from the merge path
        "max_abs_err": max(errs),  # over every key checked; payloads equal in place too
        "ms": compaction["ms"],
        "plain_ms": compaction["plain_ms"],
        "bound_ms": compaction["bound_ms"],
        "bound_by": compaction["bound_by"],
        "library_ms": compaction["library_ms"],  # torch.sort(stable=True) of the keys alone, a yardstick only
        "kernel_device_ms": compaction["kernel_device_ms"],
        "shape": compaction["shape"],
        "dtype": "int32 keys, int32 payloads",
        "bytes": compaction["bytes"],
        "host_ms": compaction["host_ms"],
        "bench_shape": bench,
        "shapes_268mb": others,
    }


def phase_merge_path() -> tuple[dict, int]:
    """merge_tiles through the kernel at the bench and compaction shapes, then
    merge_sorted_runs (plain PyTorch, as in the reference) of an L1 run into an L2 run."""
    from repro_torch.kernels.merge_runs import ops
    from repro_torch.kernels.merge_runs.ref import merge_runs_ref, words

    shapes = (MERGE_BENCH_SHAPE, MERGE_COMPACTION_SHAPE)
    inputs = [merge_inputs(sh["g"], sh["t"], torch.int32, 40 + i) for i, sh in enumerate(shapes)]
    torch.cuda.synchronize()
    ops.LAUNCHES = 0
    outs = [ops.merge_tiles(*args) for args in inputs]
    torch.cuda.synchronize()
    launches = ops.LAUNCHES
    if launches != len(shapes):
        fail(f"merge_tiles launched merge_runs {launches} times in {len(shapes)} calls")
    for args, (ok, ov) in zip(inputs, outs):
        rk, rv = merge_runs_ref(*args)
        if not torch.equal(ok, rk) or not torch.equal(ov, rv):
            fail(f"merge_tiles at {tuple(args[0].shape)} differs from the plain version")

    na, nb = MERGE_RUNS
    r = np.random.default_rng(41)
    a = torch.from_numpy(np.sort(r.integers(0, 1 << 32, na, dtype=np.uint64).astype(np.uint32))).to("cuda")
    b = torch.from_numpy(np.sort(r.integers(0, 1 << 32, nb, dtype=np.uint64).astype(np.uint32))).to("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mk, flags = ops.merge_sorted_runs(a, b)
    torch.cuda.synchronize()
    runs_ms = (time.perf_counter() - t0) * 1e3
    want = torch.sort(words(torch.cat([a, b])).to(torch.int64) & 0xFFFFFFFF)[0]
    if not torch.equal(words(mk).to(torch.int64) & 0xFFFFFFFF, want):
        fail("merge_sorted_runs: keys differ from torch.sort of the concatenation")
    if int((flags == 0).sum()) != na or int((flags == 1).sum()) != nb:
        fail(f"merge_sorted_runs: {int((flags == 0).sum())} flags of A, expected {na}")
    return {
        "phase": "merge_path",
        "merge_tiles_shapes": list(shapes),
        "merge_runs_launches": launches,
        "merge_sorted_runs": {"a": na, "b": nb, "dtype": "uint32", "host_ms_synchronised": runs_ms},
        "nvidia_smi": smi(),
    }, launches


def durability_walk(mode: str, num_keys: int, seed: int) -> dict:
    """MD load, large-value updates, forced GC, more updates, crash, recover:
    every write with an LSN at or below the crash's durable cutoff reads back
    with its last such value, and no later write does (a dict model)."""
    import repro_torch.api as api
    from repro_torch.benchmarks.common import AVG_KV, scaled_config
    from repro_torch.core.ycsb import Workload, make_key, payload

    eng = api.open(api.EngineConfig(store=scaled_config(mode, dataset_keys=num_keys, avg_kv_bytes=AVG_KV["MD"])))
    st = eng.store
    history = []
    for op in Workload("load_a", "MD", num_keys=num_keys, num_ops=0, seed=seed).load_ops():
        v = payload(op.value_size)
        st.put(op.key, v)
        history.append((st.lsn, op.key, v))
    r = np.random.default_rng(seed)

    def updates(n, tag):
        for i, k in enumerate(r.integers(0, num_keys, n)):
            key, v = make_key(int(k)), payload(996) + f"{tag}{i:07d}".encode()
            st.update(key, v)
            history.append((st.lsn, key, v))

    updates(num_keys, "u")
    gc_relocated = st.gc_tick(force=True)
    updates(num_keys // 10, "v")
    cutoff = st.crash()
    st.recover()
    expect = {}
    for lsn, k, v in history:
        if lsn <= cutoff:
            expect[k] = v
    probe = [make_key(i) for i in range(num_keys)]
    got = [st.get(k) for k in probe]
    missing = sum(g != expect.get(k) for k, g in zip(probe, got))
    if missing:
        fail(f"durability walk ({mode}): {missing} of {num_keys} keys do not read back their last durable write")
    if st.scan(b"", num_keys + 10) != sorted(expect.items()):
        fail(f"durability walk ({mode}): the full scan differs from the durable writes")
    eng.close()
    return {"mode": mode, "writes": len(history), "durable_lsn": cutoff, "durable_keys": len(expect),
            "gc_relocated": gc_relocated, "gc_relocations": st.stats.gc_relocations}


def phase_store() -> dict:
    """The store engine on the host, as in the reference, and its classifier on the card."""
    from repro_torch.benchmarks import bench_ycsb, common
    from repro_torch.core import model, ycsb

    rows = []
    t0 = time.perf_counter()
    bench_ycsb.main(rows.append, smoke=True)
    wall = time.perf_counter() - t0
    bad = common.baseline_mismatches(rows, ROOT / "BENCH_BASELINE.json")
    if len(rows) != 18 or bad:
        fail(f"fig5 smoke: {len(rows)} rows, mismatches against BENCH_BASELINE.json: {bad}")
    ops = 3 * (1200 + 4 * 300 + 80)  # per system: the load, four run phases, Run E

    t0 = time.perf_counter()
    walks = [durability_walk(mode, 4_000, seed=7 + i) for i, mode in enumerate(("parallax", "rocksdb", "blobdb"))]
    walk_s = time.perf_counter() - t0

    r = np.random.default_rng(5)
    ks = torch.from_numpy(r.integers(1, 64, CLASSIFY_PAIRS))
    vs = torch.from_numpy(ycsb._sizes_for("SD", r, CLASSIFY_PAIRS))
    pol = model.SizePolicy()
    cpu = pol.classify(ks, vs)
    card = pol.classify(ks.to("cuda"), vs.to("cuda"))
    if card.device.type != "cuda" or not torch.equal(card.cpu(), cpu):
        fail(f"SizePolicy.classify on the card: {(card.cpu() != cpu).sum().item()} of {CLASSIFY_PAIRS} differ from the CPU")
    p = torch.from_numpy(r.random(1 << 20).astype(np.float32))
    ben_cpu = model.separation_benefit(4, 8, p)
    ben_card = model.separation_benefit(4, 8, p.to("cuda"))
    if not torch.equal(ben_card.cpu().view(torch.int32), ben_cpu.view(torch.int32)):
        fail("separation_benefit on the card differs in its bits from the CPU")
    return {
        "phase": "store",
        "fig5_rows": len(rows),
        "fig5_rows_equal_baseline": True,
        "host_wall_s": wall,
        "host_ops_per_s": ops / wall,
        "durability": walks,
        "durability_host_wall_s": walk_s,
        "classify_pairs_on_card": CLASSIFY_PAIRS,
        "classify_categories": torch.bincount(cpu.to(torch.int64), minlength=3).tolist(),
    }


def check_model_f32(cfg, params) -> dict:
    """Full-width model in float32 on a small input: the kernel path against the
    same model with the plain scan, and prefill(S) against prefill(S-1) + decode."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models import get_model

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    m = get_model(cfg32)
    p32 = m.init_params(cfg32, torch.Generator(device="cuda").manual_seed(0), "cuda")
    p32.load_state_dict(params.state_dict())  # the same weights, computing in float32
    tokens = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 300)), dtype=torch.int64, device="cuda"
    )
    logits, _ = m.prefill(cfg32, p32, {"tokens": tokens}, 512)
    kernel_scan = ops.ssd_scan
    ops.ssd_scan = lambda *a, chunk: ssd_scan_ref(*a, chunk=chunk)
    try:
        ref_logits, _ = m.prefill(cfg32, p32, {"tokens": tokens}, 512)
    finally:
        ops.ssd_scan = kernel_scan
    _, cache = m.prefill(cfg32, p32, {"tokens": tokens[:, :-1]}, 512)
    dec_logits, _ = m.decode_step(cfg32, p32, cache, tokens[:, -1:])
    del p32
    torch.cuda.synchronize()
    if logits.shape != (2, 1, cfg.vocab_padded) or not torch.isfinite(logits).all():
        fail(f"f32 prefill logits: shape {tuple(logits.shape)} or not finite")
    scale = ref_logits.abs().max().item()
    err_ref = (logits - ref_logits).abs().max().item()
    err_dec = (logits - dec_logits).abs().max().item()
    if err_ref > 1e-3 * scale or err_dec > 1e-3 * scale:
        fail(f"f32 model check: |kernel - plain| {err_ref}, |prefill - decode| {err_dec}, scale {scale}")
    return {"logit_scale": scale, "err_vs_plain_scan": err_ref, "err_prefill_vs_decode": err_dec}


def serve_batches(cfg, params) -> dict:
    """Two batches of 4 requests (prompts of 1024, then 1000 tokens; 32 new
    tokens each) through ServeEngine; times prefill and each decode step."""
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(cfg, params, max_len=2048, batch_size=4, device="cuda")
    times, last = {"prefill": [], "decode": []}, {}

    def timed(kind, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times[kind].append(time.perf_counter() - t0)
            last[kind] = out
            return out
        return run

    eng.model.prefill = timed("prefill", eng.model.prefill)
    eng._decode = timed("decode", eng._decode)
    rng = np.random.default_rng(0)
    new_tokens, sid, batches = 32, 0, []
    torch.cuda.reset_peak_memory_stats()
    for prompt_len in (1024, 1000):
        reqs = []
        for _ in range(4):
            prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, prompt_len), dtype=torch.int64)
            reqs.append(Request(sid, prompt, max_new_tokens=new_tokens))
            sid += 1
        t0 = time.perf_counter()
        done = eng.run_batch(reqs)
        wall = time.perf_counter() - t0
        for r in done:
            if len(r.output) != new_tokens or not all(0 <= t < cfg.vocab_size for t in r.output):
                fail(f"request {r.seq_id}: {len(r.output)} tokens, range {min(r.output)}..{max(r.output)}")
        batches.append({"prompt_len": prompt_len, "requests": len(done), "wall_s": wall,
                        "tokens_per_s": sum(len(r.output) for r in done) / wall})

    if eng.cache_mgr.stats()["active"] != 0:
        fail(f"cache manager still holds {eng.cache_mgr.stats()['active']} sequences")
    logits = last["decode"][0]  # the step that produced each request's last token
    if logits.shape != (4, 1, cfg.vocab_padded) or torch.isnan(logits).any():
        fail(f"last logits: shape {tuple(logits.shape)} or NaN")
    steps = len(times["decode"]) // 2
    return {
        "batches": batches,
        "prefill_ms": [t * 1e3 for t in times["prefill"][:2]],
        "decode_ms_per_token": [sum(times["decode"][i * steps:(i + 1) * steps]) / steps * 1e3 for i in range(2)],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }


def phase_serve_mamba2() -> tuple[dict, int]:
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.models import get_model

    cfg = ARCHS["mamba2-780m"]
    params = get_model(cfg).init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = sum(p.numel() for p in params.parameters())
    model_check = check_model_f32(cfg, params)

    ops.LAUNCHES = 0
    served = serve_batches(cfg, params)  # 4 chunks of 256; 1000 is padded to them
    launches = ops.LAUNCHES
    if launches != 2 * cfg.num_layers:
        fail(f"ssd_scan launched {launches} times in serving, expected {2 * cfg.num_layers}")
    # where a prefill's time goes, outside the counted run: 4 x 1024 tokens
    tokens = torch.as_tensor(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (4, 1024)), dtype=torch.int64, device="cuda"
    )
    prefill = profile(lambda: get_model(cfg).prefill(cfg, params, {"tokens": tokens}, 2048), top=8, named="ssd_")
    return {
        "phase": "serve",
        "arch": cfg.name,
        "params": n_params,
        **served,
        "ssd_scan_launches": launches,
        "prefill_profile": prefill,
        "model_check_f32": model_check,
        "nvidia_smi": smi(),
    }, launches


def check_dense_f32(cfg, params) -> dict:
    """Full-width dense model in float32 on (2, 256) tokens: forward through the
    flash kernel against the same weights through the plain attention, and
    prefill(S) against prefill(S-1) + decode."""
    from repro_torch.models import get_model

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    m = get_model(cfg32)
    p32 = m.init_params(cfg32, torch.Generator(device="cuda").manual_seed(0), "cuda")
    p32.load_state_dict(params.state_dict())  # the same weights, computing in float32
    tokens = torch.as_tensor(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 256)), dtype=torch.int64, device="cuda"
    )
    flash, _ = m.forward(dataclasses.replace(cfg32, attention_impl="flash"), p32, {"tokens": tokens})
    plain, _ = m.forward(dataclasses.replace(cfg32, attention_impl="xla"), p32, {"tokens": tokens})
    _, cache = m.prefill(cfg32, p32, {"tokens": tokens[:, :-1]}, 512)
    dec, _ = m.decode_step(cfg32, p32, cache, tokens[:, -1:])
    del p32, cache
    torch.cuda.synchronize()
    if not torch.isfinite(flash).all():
        fail("f32 dense forward: logits not finite")
    scale = plain.abs().max().item()
    err = (flash - plain).abs().max().item()
    err_dec = (dec - plain[:, -1:]).abs().max().item()
    if err > 1e-3 * scale or err_dec > 1e-3 * scale:
        fail(f"f32 dense check: |flash - plain| {err}, |prefill - decode| {err_dec}, scale {scale}")
    return {"logit_scale": scale, "err_flash_vs_plain": err, "err_prefill_vs_decode": err_dec}


def phase_dense() -> tuple[dict, dict, int]:
    """qwen2.5-3b at full width: forward and loss_fn through the kernel, then serving."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import get_model

    cfg = ARCHS["qwen2.5-3b"]
    m = get_model(cfg)
    params = m.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = sum(p.numel() for p in params.parameters())
    model_check = check_dense_f32(cfg, params)

    fcfg = dataclasses.replace(cfg, attention_impl="flash")
    tokens = torch.as_tensor(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 1024)), dtype=torch.int64, device="cuda"
    )
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    calls = {  # the first forward warms cuBLAS and the allocator; the second is timed warm
        "forward_cold": lambda: m.forward(fcfg, params, batch)[0],
        "forward": lambda: m.forward(fcfg, params, batch)[0],
        "loss_fn": lambda: m.loss_fn(fcfg, params, batch),
    }
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ms, per_call, out = {}, {}, {}
    ops.LAUNCHES = 0
    for name, fn in calls.items():
        before = ops.LAUNCHES
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        per_call[name] = ops.LAUNCHES - before
    launches = ops.LAUNCHES
    if any(n != cfg.num_layers for n in per_call.values()):
        fail(f"flash_attention launches per call {per_call}, expected {cfg.num_layers} each")
    logits, loss = out["forward"], out["loss_fn"]
    if logits.shape != (4, 1024, cfg.vocab_padded) or not torch.isfinite(logits).all():
        fail(f"forward logits: shape {tuple(logits.shape)} or not finite")
    if loss.shape != () or not torch.isfinite(loss):
        fail(f"loss_fn: {loss}")
    del logits, out
    forward = {
        "phase": "dense_forward",
        "arch": fcfg.name,
        "attention_impl": fcfg.attention_impl,
        "params": n_params,
        "tokens": list(tokens.shape),
        "ms": ms,
        "loss": loss.item(),
        "flash_attention_launches_per_call": per_call,
        "flash_attention_launches": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "model_check_f32": model_check,
    }

    ops.LAUNCHES = 0
    served = serve_batches(cfg, params)
    serve_launches = ops.LAUNCHES
    if serve_launches != 0:
        fail(f"flash_attention launched {serve_launches} times in serving, expected 0")

    # where the time goes, outside the counted runs: forward, loss_fn and one decode step
    _, cache = m.prefill(cfg, params, {"tokens": tokens}, 2048)
    forward["profile"] = profile(lambda: m.forward(fcfg, params, batch), top=8, named="flash_attention")
    forward["loss_fn_profile"] = profile(lambda: m.loss_fn(fcfg, params, batch))
    step = profile(lambda: m.decode_step(cfg, params, cache, tokens[:, -1:]))
    del cache
    hd, e = cfg.resolved_head_dim, torch.finfo(torch.bfloat16).bits // 8
    serve = {
        "phase": "serve_dense",
        "arch": cfg.name,
        "params": n_params,
        **served,
        "flash_attention_launches": serve_launches,
        "kv_cache_bytes": cfg.num_layers * 2 * 4 * 2048 * cfg.num_kv_heads * hd * e,  # from the shapes
        "decode_step_profile": step,
        "nvidia_smi": smi(),
    }
    return forward, serve, launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.merge_runs import kernel as merge_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    t0 = time.perf_counter()
    kernels = {"ssd_scan": ssd_kernel, "flash_attention": fa_kernel, "merge_runs": merge_kernel}
    with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc per source, all at once
        list(pool.map(lambda k: k.build(), kernels.values()))
    emit({"phase": "device", "nvidia_smi": card, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0,
          "ptxas": {name: [ln.strip() for ln in _nvcc.BUILD_LOGS.get(name, "").splitlines()
                           if "registers" in ln or "spill" in ln] for name in kernels}})

    ssd_row = phase_ssd_kernel()
    fa_row = phase_fa_kernel()
    merge_row = phase_merge_kernel()
    merge_path, merge_row["launches"] = phase_merge_path()
    emit(merge_path)
    emit(phase_store())
    serve, ssd_row["launches"] = phase_serve_mamba2()
    emit(serve)
    forward, serve_dense, fa_row["launches"] = phase_dense()
    prof = forward["profile"]
    if not prof["flash_attention_ms"]:
        fail("the profiled forward shows no flash_attention kernel on the device")
    fa_row["forward_device_share"] = prof["flash_attention_ms"] / prof["device_busy_ms"]
    emit(forward)
    emit(serve_dense)
    emit({"kernels": [ssd_row, fa_row, merge_row]})
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
