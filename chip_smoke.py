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
- zamba2-2.7b (hybrid), full width and depth: an f32 twin holds both kernels'
  path against the plain scan and attention, ``forward`` and ``loss_fn`` run
  with ``attention_impl="flash"`` (54 ``ssd_scan`` and 9 ``flash_attention``
  launches a call), and it serves two batches (54 ``ssd_scan`` launches a
  prefill, no ``flash_attention``);
- deepseek-moe-16b and internvl2-26b (4 of their layers) and whisper-medium
  (full depth) at full width: an f32 twin's prefill against prefill + decode,
  and one batch through ``ServeEngine`` each (no kernel launch);
- training: mamba2-780m at full width and depth takes 5 AdamW steps of
  ``train/step.py::make_train_fn`` on 4 x 1024 tokens with ``remat`` on, as
  the registry sets it (96 ``ssd_scan`` launches a step, the forward and its
  recompute, and 48 plain backwards), then 5 with ``remat`` off (48 and 48)
  for their peak memory and time, after an f32 twin (one step through the
  kernel against one through the plain scan), a checkpoint restart at 2
  layers that must equal an uninterrupted run bitwise, and one
  ``make_train_step`` on the card's (1, 1) mesh at 2 layers, params and
  AdamW state as DTensors, bitwise equal to ``make_train_fn``'s; zamba2-2.7b
  at 6 of its 54 layers takes 2 steps through both kernels (12 ``ssd_scan``
  launches and 6 backwards, 2 ``flash_attention`` launches and 1 backward a
  step);
- the training launcher, ``python -m repro_torch.launch.train``, as a
  subprocess: mamba2-780m at full width and depth for 6 steps of 4 x 1024
  tokens (96 + 48 a step, counted by the launcher's ``--metrics-json``), then
  the reduced config killed at its first checkpoint and resumed with
  ``--resume``, ending bitwise where an uninterrupted run ends;
- the dry-run, ``python -m repro_torch.launch.dryrun``, on this machine's CPU
  (a fake process group and fake tensors): four full-width cells on the
  (16, 16) production mesh, one of each step kind (mamba2-780m train_4k,
  qwen2.5-3b prefill_32k, zamba2-2.7b long_500k, deepseek-moe-16b
  decode_32k), read back by ``bench_roofline``; then the dry-run of the
  training cell above on a (1, 1) mesh, whose peak must lie within 25% of
  the card's ``max_memory_allocated`` in one warm ``make_train_step`` of the
  same cell, with the step's model-FLOP share;
- tensor parallelism (``phase_tp``): two processes on the card as the (1, 2)
  mesh, a ``gloo`` group over CUDA tensors (probed first): ``ssd_scan`` and
  ``flash_attention`` held against their plain versions at one rank's local
  shapes (qwen2.5-3b's, internvl2-26b's and deepseek-moe-16b's flash); f32
  twins of every family, depth cut (mamba2-780m, qwen2.5-3b, zamba2-2.7b,
  internvl2-26b and deepseek-moe-16b through flash, whisper-medium), whose
  prefill and ``make_train_step`` on the (1, 2) mesh match the (1, 1) mesh's,
  MoE routing compared token by token; f32 decode twins of qwen2.5-3b,
  zamba2-2.7b, internvl2-26b, deepseek-moe-16b and whisper-medium, each rank
  attending over its half of the K/V cache's sequence (and of whisper's
  encoder frames), whose greedy decode matches the (1, 1) mesh's across the
  shard boundary; qwen2.5-3b (4 x 1024 tokens) and whisper-medium (4 x 256,
  1500 frames) at full width and depth serving in bf16 on both meshes (K/V
  bytes and memory a rank); f32 twins of mamba2-780m and deepseek-moe-16b
  whose ``make_train_step`` accumulates two microbatches and compresses its
  gradients (int8, then top-k) as ``make_train_fn`` does on the whole batch;
  and mamba2-780m at full width and depth and deepseek-moe-16b at 2 of its
  layers taking one warm step per rank (96 ``ssd_scan`` launches on 24 of 48
  heads; flash on 8 of 16 heads), then mamba2-780m one more step, two
  microbatches of 2 x 1024 tokens, int8-compressed (192 ``ssd_scan`` launches,
  the compression's own time);
- ``decode_attention`` at zamba2-7b-instruct's site shape (B = 32, H = K = 32,
  D = 224, Smax 1088): held against its plain version, then timed at pos 288,
  544 and 1056 beside its bound, the plain path and
  ``scaled_dot_product_attention`` (a yardstick only); zamba2-2.7b's serving
  launches it 9 times for each of the two decode steps run while its decode
  graph is captured, and not at all per replay;
- ``ssm_decode`` at the three chat cells' Mamba2 layer shapes (batch 32: H 48
  N 128, H 112 N 64 over 2 groups, H 128 N 128; P 64): its new state held to
  the plain step bit for bit, then timed in place beside its bound and the
  plain step with the stack's copy; mamba2-780m's and zamba2-2.7b's serving
  launch it once a Mamba2 layer for each of the two steps run while the decode
  graph is captured, and not at all per replay;
- ``merge_tiles`` merges sorted tiles through ``merge_runs`` at the bench and
  compaction shapes, and ``merge_sorted_runs`` an L1 run into an L2 run;
- the store engine (``repro_torch.api``, on the host as in the reference)
  reproduces the fig5 smoke rows of ``BENCH_BASELINE.json``, reads back every
  acknowledged write after GC, crash and recover, and classifies 2^24 sizes
  on the card exactly as on the CPU.
- the port's bench runner (``repro_torch.benchmarks.run --device cuda``)
  reproduces all 89 smoke rows of ``BENCH_BASELINE.json`` (also under
  ``scripts/check_bench.py --tol 0``), then runs the full suite: every claim
  holds, the three kernels run at the reference's bench shapes within its
  bars (``bench_kernels``), and ``debug_checks`` runs its race detector and
  protocol monitor on the host (``bench_analysis``).

Prints one JSON line per phase; the last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Exits non-zero, with no
result, when there is no card or when this file stands outside the repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

F32_PEAK_FLOPS = 67e12  # H100 SXM data sheet: float32 outside the tensor cores


def h100_peaks() -> tuple[float, dict]:
    """HBM bytes/s and FLOP/s by type: the H100 SXM's data-sheet HBM and bf16 peaks
    from ``repro_torch.launch.roofline``, with the float32 one it has no use for."""
    from repro_torch.launch import roofline

    return roofline.HBM_BW, {torch.bfloat16: roofline.PEAK_FLOPS, torch.float32: F32_PEAK_FLOPS}

SERVE_SHAPE = dict(b=4, s=1024, h=48, p=64, g=1, n=128, L=256)  # mamba2-780m prefill
ZAMBA2_SSD_SHAPE = dict(b=4, s=1024, h=80, p=64, g=1, n=64, L=256)  # zamba2-2.7b forward and prefill
GRANITE_SSD_SHAPE = dict(b=4, s=1024, h=128, p=64, g=1, n=128, L=256)  # granite-4.0-h-small prefill
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
FA_ZAMBA2_SHAPE = dict(b=4, s=1024, h=32, kh=32, d=80)  # zamba2-2.7b's shared block: MHA, D across two TMA boxes
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


# (arch, decoder layers kept or None for all, prompt length, max_len): each cut lets the
# params fit one 80 GB card beside their f32 twin
FAMILIES = (
    ("deepseek-moe-16b", 4, 1024, 2048),   # of 28 layers: the full depth is 16.9 G params, 68 GB in f32
    ("internvl2-26b", 4, 1024, 2048),      # of 48 layers: 19.9 G params, 79 GB in f32; 256 zero patch embeddings
    ("whisper-medium", None, 256, 512),    # full depth: 24 + 24 layers, 1500 encoder frames
)


# zamba2-7b-instruct.chat's decode: a site's cache (B, Smax, K, D), its 13 sites a step, the
# positions at the cycle's three prompt lengths plus half the answer (256, 512, 1024 + 32)
DA_SITE_SHAPE = dict(b=32, smax=1088, h=32, kh=32, d=224)
DA_SITES = 13
DA_POSITIONS = (288, 544, 1056)
# granite-4.0-h-small.chat's decode: GQA, 32 q heads over 8 kv heads of 128, scores scaled by its
# attention_multiplier 1/128, 4 attention layers a step, the same prompt lengths and max_len
DA_GRANITE_SHAPE = dict(b=32, smax=1088, h=32, kh=8, d=128)
DA_GRANITE_LAYERS = 4
# a chat cell's Mamba2 layer at batch 32, and the Mamba2 layers of its decode step
SD_SHAPES = {"mamba2-780m.chat": (dict(b=32, h=48, g=1, p=64, n=128), 48),
             "zamba2-7b-instruct.chat": (dict(b=32, h=112, g=2, p=64, n=64), 81),
             "granite-4.0-h-small.chat": (dict(b=32, h=128, g=1, p=64, n=128), 36)}
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
    hbm, peaks = h100_peaks()
    t_bytes, t_ops = nbytes / hbm, flops / peaks[dtype]
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


def time_ssd(sh, stages: bool = False) -> dict:
    """Kernel (CUDA events over 50 calls) and plain version (10) at one shape,
    bf16 and f32, with the bound; with ``stages`` each bf16 stage's device
    ms per call, over 20 profiled calls."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    timing = {}
    for dtype in (torch.bfloat16, torch.float32):
        args = ssd_inputs(sh["b"], sh["s"], sh["h"], sh["p"], sh["g"], sh["n"], 0, dtype)
        kernel_ms = cuda_ms(lambda: ops.ssd_scan(*args, chunk=sh["L"]), iters=50)
        ref_ms = cuda_ms(lambda: ssd_scan_ref(*args, chunk=sh["L"]), iters=10)
        bound_ms, bound_by, nbytes, flops = ssd_bound(*sh.values(), dtype)
        timing[dtype] = dict(ms=kernel_ms, plain_ms=ref_ms, bound_ms=bound_ms, bound_by=bound_by,
                             bytes=nbytes, flops=flops)
        if stages and dtype == torch.bfloat16:
            calls = 20
            prof = profile(lambda: [ops.ssd_scan(*args, chunk=sh["L"]) for _ in range(calls)], top=8)
            timing[dtype]["stages_ms"] = {
                stage: sum(k["ms"] for k in prof["top"] if stage in k["name"]) / calls for stage in SSD_STAGES
            }
    return timing


def phase_ssd_kernel() -> dict:
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs[dtype] = check_ssd(SERVE_SHAPE, dtype, seed=0)
        for i, shape in enumerate(TEST_SHAPES):
            check_ssd(shape, dtype, seed=1 + i)
        check_ssd({**SERVE_SHAPE, "s": 1000}, dtype, seed=9)  # S % L != 0
        errs[dtype, "zamba2"] = check_ssd(ZAMBA2_SSD_SHAPE, dtype, seed=10)
        errs[dtype, "granite"] = check_ssd(GRANITE_SSD_SHAPE, dtype, seed=11)

    timing = time_ssd(SERVE_SHAPE, stages=True)
    zamba2 = time_ssd(ZAMBA2_SSD_SHAPE)
    granite = time_ssd(GRANITE_SSD_SHAPE)
    bf, f32 = timing[torch.bfloat16], timing[torch.float32]
    return {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:75",
        "launches": None,  # filled from the main paths
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
        "shape": SERVE_SHAPE,
        "dtype": "bfloat16",
        "bytes": bf["bytes"],
        "flops": bf["flops"],
        "f32": {"max_abs_err": errs[torch.float32], "ms": f32["ms"], "plain_ms": f32["plain_ms"],
                "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"]},
        **{f"{model}_shape": {"shape": shape,
                              **{name: {"max_abs_err": errs[dtype, model], **times[dtype]}
                                 for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32))}}
           for model, shape, times in (("zamba2", ZAMBA2_SSD_SHAPE, zamba2), ("granite", GRANITE_SSD_SHAPE, granite))},
    }


def profile(fn, top: int = 6, names: tuple[str, ...] = (), ops: tuple[str, ...] = ()) -> dict:
    """One call of fn under torch.profiler: host wall ms, the device's busy ms
    (the union of kernel intervals), its idle share, the kernels that took
    the most device time and, for each of ``names``, the device ms of the
    kernels whose name holds it (as ``{name}_ms``); for each of ``ops``, the
    device ms under each host op whose name holds it, children included (as
    ``{op}_ops``).  The profiler slows the host, so the idle share is an upper
    bound.  Device numbers are null where the trace holds no kernel."""
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
                **{f"{n}_ms": None for n in names}, **{f"{op}_ops": {} for op in ops}}
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
    for name in names:
        out[f"{name}_ms"] = sum(t for n, t in by_name.items() if name in n)
    for op in ops:
        out[f"{op}_ops"] = {e.key: getattr(e, "device_time_total", 0.0) / 1e3
                            for e in prof.key_averages() if op in e.key}
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
    hbm, peaks = h100_peaks()
    t_bytes, t_ops = nbytes / hbm, flops / peaks[dtype]
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


def time_fa(sh) -> dict:
    """Kernel and SDPA (CUDA events over 50 calls), plain version (10) and the
    host's time per kernel call, at one shape, bf16 and f32, with the bound."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

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
    return timing


def phase_fa_kernel() -> dict:
    from repro_torch.kernels.flash_attention import ops

    errs, rels = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        errs[dtype], rels[dtype] = check_fa(FA_FORWARD_SHAPE, dtype, seed=0)
        for i, shape in enumerate(FA_TEST_SHAPES):
            check_fa(shape, dtype, seed=1 + i)
        errs[dtype, "zamba2"], rels[dtype, "zamba2"] = check_fa(FA_ZAMBA2_SHAPE, dtype, seed=20)
    # causality (tests/test_kernels.py): a changed tail leaves earlier rows as they were
    q, k, v = fa_inputs(1, 128, 2, 2, 32, 1, torch.float32)
    out1 = ops.flash_attention(q, k, v)
    k[:, 100:], v[:, 100:] = 99.0, -99.0
    out2 = ops.flash_attention(q, k, v)
    if not torch.allclose(out1[:, :100], out2[:, :100], atol=1e-6, rtol=0):
        fail("flash_attention: rows before a changed tail moved")

    timing = time_fa(FA_FORWARD_SHAPE)
    zamba2 = time_fa(FA_ZAMBA2_SHAPE)
    bf, f32 = timing[torch.bfloat16], timing[torch.float32]
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:76",
        "launches": None,  # filled from the main paths
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
        "shape": FA_FORWARD_SHAPE,
        "dtype": "bfloat16",
        "bytes": bf["bytes"],
        "flops": bf["flops"],
        "f32": {"max_abs_err": errs[torch.float32], "ms": f32["ms"], "plain_ms": f32["plain_ms"],
                "library_ms": f32["library_ms"], "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"]},
        "zamba2_shape": {"shape": FA_ZAMBA2_SHAPE,
                         **{name: {"max_abs_err": errs[dtype, "zamba2"], "rel_err_vs_f32": rels[dtype, "zamba2"],
                                   **zamba2[dtype]}
                            for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32))}},
    }


def da_inputs(b, smax, h, kh, d, seed):
    r = np.random.default_rng(seed)
    return [torch.tensor(r.standard_normal(shape), dtype=torch.float32, device="cuda").to(torch.bfloat16)
            for shape in ((b, 1, h, d), (b, smax, kh, d), (b, smax, kh, d))]


def da_bound(b, h, kh, d, pos) -> tuple[float, int]:
    """(bound_ms, bytes) of one call: rows 0..pos of K and V over every kv head read once, q read
    and the output written once, in bf16; bound by bytes (~4 x D operations a row and q head)."""
    nbytes = 2 * (b * (pos + 1) * 2 * kh * d + 2 * b * h * d)
    hbm, _ = h100_peaks()
    return nbytes / hbm * 1e3, nbytes


def da_at(sh: dict, scale: float, calls: int, seed: int) -> dict:
    """The decode-attention kernel at one cache shape: checked against its plain version at the
    last of ``DA_POSITIONS`` (the card tests' bars), then timed by CUDA events at each of them
    beside its bound, the plain path (``ref``: the gather, einsums and masked softmax of
    ``layers._attend_cache``) and ``scaled_dot_product_attention`` over rows 0..pos (a yardstick
    only: the port never calls it).  ``step_ms`` is ``calls`` calls, a decode step's."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models.layers import kv_head_map

    b, smax, h, kh, d = (sh[x] for x in ("b", "smax", "h", "kh", "d"))
    q, k, v = da_inputs(b, smax, h, kh, d, seed)
    kvm = kv_head_map(h, kh).to("cuda")
    at = torch.tensor(DA_POSITIONS[-1], dtype=torch.int32, device="cuda")
    out = ops.decode_attention(q, k, v, kvm, at, scale=scale)
    ref = decode_attention_ref(q, k, v, kvm, at, scale=scale)
    ref32 = decode_attention_ref(q.float(), k.float(), v.float(), kvm, at, scale=scale)
    torch.cuda.synchronize()
    err, err32 = ((out.float() - r.float()).abs().max().item() for r in (ref, ref32))
    if not torch.allclose(out.float(), ref.float(), atol=2e-2, rtol=2e-2) or \
            not torch.allclose(out.float(), ref32, atol=1e-5, rtol=2**-7):
        fail(f"decode_attention at {sh}: differs from the plain version by {err}, from float32 by {err32}")
    del ref32
    by_pos = {}
    for pos in DA_POSITIONS:
        at = torch.tensor(pos, dtype=torch.int32, device="cuda")
        qt = q.transpose(1, 2)                                        # (B, H, 1, D)
        kt, vt = (t[:, :pos + 1].transpose(1, 2) for t in (k, v))     # (B, K, pos + 1, D) views
        ms = cuda_ms(lambda: ops.decode_attention(q, k, v, kvm, at, scale=scale), iters=5 * calls)
        plain = cuda_ms(lambda: decode_attention_ref(q, k, v, kvm, at, scale=scale), iters=calls)
        lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, scale=scale, enable_gqa=True), iters=5 * calls)
        bound_ms, nbytes = da_bound(b, h, kh, d, pos)
        by_pos[pos] = dict(ms=ms, bound_ms=bound_ms, roofline=bound_ms / ms, plain_ms=plain, library_ms=lib,
                           bytes=nbytes, step_ms=calls * ms, step_bound_ms=calls * bound_ms,
                           step_plain_ms=calls * plain, host_ms=host_ms(
                               lambda: ops.decode_attention(q, k, v, kvm, at, scale=scale), iters=calls))
    return {"shape": sh, "scale": scale, "max_abs_err": err, "max_abs_err_vs_f32": err32, "by_pos": by_pos}


@torch.inference_mode()
def phase_decode_attention() -> dict:
    """The decode-attention kernel at zamba2-7b-instruct.chat's site shape (MHA, D 224, scale
    (D / 2)^-0.5, 13 sites a step) and at granite-4.0-h-small.chat's attention layers (GQA 32
    over 8, D 128, scale 1/128, 4 layers a step), each by ``da_at``."""
    site = da_at(DA_SITE_SHAPE, (DA_SITE_SHAPE["d"] / 2) ** -0.5, DA_SITES, seed=0)
    granite = da_at(DA_GRANITE_SHAPE, 1 / DA_GRANITE_SHAPE["d"], DA_GRANITE_LAYERS, seed=1)
    return {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        "replaces": None,  # no TPU kernel: the reference decodes through plain jnp
        "launches": None,  # filled from the main paths
        "shape": site["shape"],
        "dtype": "bfloat16",
        "max_abs_err": site["max_abs_err"],
        "max_abs_err_vs_f32": site["max_abs_err_vs_f32"],
        "by_pos": site["by_pos"],
        "granite_shape": granite,
        "bound_by": "bytes",
        "design": "two passes: chunks of 64 rows per (kv head, batch row) in f32, then a merge in chunk order",
        "nvidia_smi": smi(),
    }


def sd_inputs(b, h, g, p, n, seed, dtype=torch.bfloat16):
    """A layer's f32 state, and x, B and C sliced from one conv-output row as the Mixer's decode
    slices them, dt after softplus, a as initialised."""
    r = np.random.default_rng(seed)
    state = torch.tensor(r.standard_normal((b, h, p, n)), dtype=torch.float32, device="cuda")
    row = torch.tensor(r.standard_normal((b, h * p + 2 * g * n)), dtype=torch.float32, device="cuda").to(dtype)
    x, bvec, cvec = row[:, :h * p].reshape(b, h, p), row[:, h * p:h * p + g * n].reshape(b, g, n), \
        row[:, h * p + g * n:].reshape(b, g, n)
    dt = torch.nn.functional.softplus(torch.tensor(r.standard_normal((b, h)), dtype=torch.float32, device="cuda"))
    a = -torch.exp(torch.log(torch.linspace(1.0, 16.0, h, device="cuda")))
    return state, x, dt, a, bvec, cvec


def sd_bound(b, h, g, p, n, elem: int = 2) -> tuple[float, int]:
    """(bound_ms, bytes) of one layer's step: the f32 state read and written once, x read and y
    written in the compute dtype, B and C a group, dt in f32 (``ssm_decode_roofline.serve``'s
    count); bound by bytes (4 operations an element of 8 bytes)."""
    nbytes = b * (2 * h * p * n * 4 + 2 * h * p * elem + 2 * g * n * elem + h * 4)
    hbm, _ = h100_peaks()
    return nbytes / hbm * 1e3, nbytes


@torch.inference_mode()
def phase_ssm_decode() -> dict:
    """The Mamba2 decode-state kernel at the three chat cells' layer shapes (batch 32): its new
    state held to the plain step bit for bit and its y to 1e-5 x sum |new * C|, then timed by CUDA
    events in place (``ms``: the kernel's launcher; ``ops_ms``: ``ops.ssm_decode``, the model's call)
    beside the bound and the plain step it replaced (``ssm_decode_ref`` and the stack's copy of the
    new state into the cache); ``step_*`` are a decode step's Mamba2 layers."""
    from repro_torch.kernels.ssm_decode import kernel, ops
    from repro_torch.kernels.ssm_decode.ref import ssm_decode_ref

    by_cell = {}
    for cell, (sh, layers) in SD_SHAPES.items():
        b, h, g, p, n = (sh[k] for k in ("b", "h", "g", "p", "n"))
        state, x, dt, a, bvec, cvec = sd_inputs(b, h, g, p, n, seed=layers)
        want, want_y = ssm_decode_ref(state, x, dt, a, bvec, cvec)
        new, y = ops.ssm_decode(state.clone(), x, dt, a, bvec, cvec, out=torch.empty_like(state))
        cvec_h = cvec.repeat_interleave(h // g, dim=1).double()
        exact = torch.einsum("bhpn,bhn->bhp", want.double(), cvec_h)
        scale = torch.einsum("bhpn,bhn->bhp", want.double().abs(), cvec_h.abs())
        if not torch.equal(new, want) or not bool(((y.double() - exact).abs() <= 1e-5 * scale).all()):
            fail(f"ssm_decode at {sh}: the new state differs from the plain step's bits, or y lies outside "
                 f"1e-5 x sum |new * C| (max |y - exact| {float((y.double() - exact).abs().max())})")
        err = float((y - want_y).abs().max())
        del want, want_y, new, y, exact, scale, cvec_h
        ms = cuda_ms(lambda: kernel.ssm_decode_cuda(state, x, dt, a, bvec, cvec, state), iters=5 * layers)
        ops_ms = cuda_ms(lambda: ops.ssm_decode(state, x, dt, a, bvec, cvec, out=state), iters=5 * layers)
        slot = torch.empty_like(state)
        plain = cuda_ms(lambda: slot.copy_(ssm_decode_ref(state, x, dt, a, bvec, cvec)[0]), iters=layers)
        bound_ms, nbytes = sd_bound(b, h, g, p, n)
        by_cell[cell] = dict(shape=sh, layers=layers, ms=ms, ops_ms=ops_ms, bound_ms=bound_ms, roofline=bound_ms / ms,
                             plain_ms=plain, bytes=nbytes, y_max_abs_diff_vs_plain=err, step_ms=layers * ms,
                             step_ops_ms=layers * ops_ms, step_bound_ms=layers * bound_ms,
                             step_plain_ms=layers * plain)
        del state, x, dt, a, bvec, cvec, slot
        torch.cuda.empty_cache()
    return {
        "name": "ssm_decode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssm_decode/csrc/ssm_decode.cu",
        "replaces": None,  # no TPU kernel: the reference decodes through plain jnp (src/repro/models/ssm.py)
        "launches": None,  # filled from the main paths
        "dtype": "bfloat16 x, B, C; float32 state and y",
        "by_cell": by_cell,
        "bound_by": "bytes",
        "design": "one pass over the f32 state per (P tile, head, batch row), new state in place, y by warp shuffles",
        "nvidia_smi": smi(),
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
    return nbytes / h100_peaks()[0] * 1e3, nbytes


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
    merge_ms = profile(lambda: [kernel.merge_runs_cuda(*args) for _ in range(20)], names=("merge",))["merge_ms"]
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


def run_benches(args: list[str], out: Path) -> dict:
    """``python -m repro_torch.benchmarks.run ARGS --device cuda --json OUT``,
    in this process (so the kernels' launch counts can be read), its rows to a
    log beside OUT; fails with the log's tail if the runner exits non-zero."""
    from repro_torch.benchmarks import run

    log = out.with_suffix(".log")
    code = 0
    with open(log, "w") as f, contextlib.redirect_stdout(f):
        try:
            run.main([*args, "--device", "cuda", "--json", str(out)])
        except SystemExit as e:
            code = e.code
    if code:
        print("\n".join(log.read_text().splitlines()[-40:]), file=sys.stderr)
        fail(f"benchmarks.run {' '.join(args)} exited {code}")
    return json.loads(out.read_text())


def bench_fields(row: dict) -> dict:
    return dict(p.split("=", 1) for p in row["derived"].split(";") if "=" in p)


def phase_bench() -> tuple[dict, dict]:
    """The port's bench runner on the card: (a) the smoke suite equals all 89
    rows of BENCH_BASELINE.json, under ``baseline_mismatches`` and under
    ``scripts/check_bench.py --tol 0`` run with JAX and ``repro`` blocked;
    (b) the full suite passes every claim, and its three kernel rows ran the
    CUDA kernels at the reference's bench shapes within the reference's bars
    (the bench asserts them); (c) ``bench_analysis`` ran ``debug_checks``: the
    detector saw events and reported nothing.  Returns the phase's line and
    each kernel's launches in the full suite."""
    from repro_torch.benchmarks import bench_kernels, common
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.merge_runs import ops as merge_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        smoke = run_benches(["--smoke"], Path(tmp) / "smoke.json")
        smoke_s = time.perf_counter() - t0
        rows = [f"{r['name']},{r['us_per_call']},{r['derived']}" for r in smoke["rows"]]
        bad = common.baseline_mismatches(rows, ROOT / "BENCH_BASELINE.json")
        if len(rows) != 89 or bad:
            fail(f"bench smoke: {len(rows)} rows, mismatches against BENCH_BASELINE.json: {bad}")
        gate = subprocess.run(
            [sys.executable, "-c",
             "import runpy, sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
             "sys.argv = sys.argv[1:]; runpy.run_path(sys.argv[0], run_name='__main__')",
             str(ROOT / "scripts" / "check_bench.py"), str(Path(tmp) / "smoke.json"),
             str(ROOT / "BENCH_BASELINE.json"), "--tol", "0"],
            capture_output=True, text=True, timeout=120,
        )
        if gate.returncode != 0:
            fail(f"scripts/check_bench.py --tol 0 on the smoke rows: {gate.stdout[-2000:]}{gate.stderr[-2000:]}")

        counters = (fa_ops, ssd_ops, merge_ops)
        for ops in counters:
            ops.LAUNCHES = 0
        t0 = time.perf_counter()
        full = run_benches([], Path(tmp) / "full.json")
        full_s = time.perf_counter() - t0
        launches = dict(zip(("flash_attention", "ssd_scan", "merge_runs"), (ops.LAUNCHES for ops in counters)))
    by_name = {r["name"]: r for r in full["rows"]}
    totals = {r["name"][len("bench:"):-len("/total")]: r for r in full["rows"] if r["name"].startswith("bench:")}
    if len(totals) != 15 or any(r["derived"] != "ok" for r in totals.values()):
        fail(f"bench full suite: {({k: r['derived'] for k, r in totals.items()})}")
    kernel_rows = {}
    bounds_ms = {  # the same work at the bench shapes, f32 and int32
        "flash_attention": fa_bound(*bench_kernels.FLASH_SHAPE.values(), torch.float32)[0],
        "ssd_scan": ssd_bound(*bench_kernels.SSD_SHAPE.values(), torch.float32)[0],
        "merge_runs": merge_bound(*bench_kernels.MERGE_SHAPE.values())[0],
    }
    for name, row_name, check in (
        ("flash_attention", "kernel:flash_attn_b1s1024h8d64", "kernel_err"),
        ("ssd_scan", "kernel:ssd_scan_b2s2048h8p64n64", "kernel_err"),
        ("merge_runs", "kernel:merge_runs_g64t512", "kernel_exact"),
    ):
        f = bench_fields(by_name[row_name])
        if f.get("impl") != "cuda" or check not in f or f.get("kernel_exact", "True") != "True":
            fail(f"bench {row_name}: {by_name[row_name]['derived']}")
        if launches[name] != 1 + bench_kernels.REPS:
            fail(f"bench_kernels launched {name} {launches[name]} times, expected {1 + bench_kernels.REPS}")
        kernel_rows[name] = {"row": row_name, "kernel_us": float(f["kernel_us"]), check: f[check],
                             "plain_us": float(by_name[row_name]["us_per_call"]),
                             "bound_us": bounds_ms[name] * 1e3, "launches": launches[name]}
    detector = bench_fields(by_name["analysis/detector:gate"])
    if int(detector["events"]) <= 0 or detector["modeled_metrics_identical"] != "true":
        fail(f"bench_analysis: {detector}")
    return {
        "phase": "bench",
        "smoke_rows": len(rows),
        "smoke_rows_equal_baseline": True,
        "check_bench_tol0": gate.stdout.strip().splitlines()[-1],
        "smoke_host_wall_s": smoke_s,
        "full_rows": len(full["rows"]),
        "full_host_wall_s": full_s,
        "bench_wall_s": {k: int(r["us_per_call"]) / 1e6 for k, r in totals.items()},
        "kernels_at_bench_shapes": kernel_rows,
        "debug_checks_events": int(detector["events"]),
        "debug_checks_overhead_x": float(detector["overhead_x"]),
        "nvidia_smi": smi(),
    }, kernel_rows


def f32_twin(cfg, params, **changes):
    """(cfg32, p32): the same weights computing in float32 (and with ``changes``)."""
    from repro_torch.models import get_model

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32", **changes)
    p32 = get_model(cfg32).init_params(cfg32, torch.Generator(device="cuda").manual_seed(0), "cuda")
    p32.load_state_dict(params.state_dict())
    return cfg32, p32


def check_model_f32(cfg, params) -> dict:
    """Full-width model in float32 on a small input: the kernel path against the
    same model with the plain scan, and prefill(S) against prefill(S-1) + decode."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models import get_model

    cfg32, p32 = f32_twin(cfg, params)
    m = get_model(cfg32)
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


def serve_batches(cfg, params, prompt_lens=(1024, 1000), max_len: int = 2048) -> dict:
    """One batch of 4 requests per prompt length (32 new tokens each) through
    ServeEngine; times prefill and each decode step."""
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(cfg, params, max_len=max_len, batch_size=4, device="cuda")
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
    for prompt_len in prompt_lens:
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
    n = len(prompt_lens)
    steps = len(times["decode"]) // n
    return {
        "batches": batches,
        "max_len": max_len,
        "prefill_ms": [t * 1e3 for t in times["prefill"][:n]],
        "decode_ms_per_token": [sum(times["decode"][i * steps:(i + 1) * steps]) / steps * 1e3 for i in range(n)],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }


@torch.inference_mode()
def phase_serve_mamba2() -> tuple[dict, int]:
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssm_decode import ops as sd_ops
    from repro_torch.models import get_model

    cfg = ARCHS["mamba2-780m"]
    params = get_model(cfg).init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = sum(p.numel() for p in params.parameters())
    model_check = check_model_f32(cfg, params)

    ops.LAUNCHES = sd_ops.LAUNCHES = 0
    served = serve_batches(cfg, params)  # 4 chunks of 256; 1000 is padded to them
    launches = ops.LAUNCHES
    if launches != 2 * cfg.num_layers:
        fail(f"ssd_scan launched {launches} times in serving, expected {2 * cfg.num_layers}")
    # both batches fill one decode graph's shape: captured once, a warm-up step and the captured one
    if sd_ops.LAUNCHES != 2 * cfg.num_layers:
        fail(f"ssm_decode launched {sd_ops.LAUNCHES} times in serving, expected {2 * cfg.num_layers}")
    # where a prefill's time goes, outside the counted run: 4 x 1024 tokens
    tokens = torch.as_tensor(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (4, 1024)), dtype=torch.int64, device="cuda"
    )
    prefill = profile(lambda: get_model(cfg).prefill(cfg, params, {"tokens": tokens}, 2048), top=8, names=("ssd_",))
    return {
        "phase": "serve",
        "arch": cfg.name,
        "params": n_params,
        **served,
        "ssd_scan_launches": launches,
        "ssm_decode_launches": sd_ops.LAUNCHES,
        "prefill_profile": prefill,
        "model_check_f32": model_check,
        "nvidia_smi": smi(),
    }, launches


def check_dense_f32(cfg, params) -> dict:
    """Full-width dense model in float32 on (2, 256) tokens: forward through the
    flash kernel against the same weights through the plain attention, and
    prefill(S) against prefill(S-1) + decode."""
    from repro_torch.models import get_model

    cfg32, p32 = f32_twin(cfg, params)
    m = get_model(cfg32)
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


@torch.inference_mode()
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
    forward["profile"] = profile(lambda: m.forward(fcfg, params, batch), top=8, names=("flash_attention",))
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


def check_hybrid_f32(cfg, params) -> dict:
    """Full-width hybrid in float32 on (2, 256) tokens: forward through both
    kernels against forward through the plain scan and plain attention;
    forward with flash against forward with the plain attention (the scan
    kernel in both); prefill(S) against prefill(S-1) + decode."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models import get_model

    cfg32, p32 = f32_twin(cfg, params)
    m = get_model(cfg32)
    tokens = torch.as_tensor(
        np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 256)), dtype=torch.int64, device="cuda"
    )
    flash_cfg, xla_cfg = (dataclasses.replace(cfg32, attention_impl=i) for i in ("flash", "xla"))
    kernels, _ = m.forward(flash_cfg, p32, {"tokens": tokens})
    xla, _ = m.forward(xla_cfg, p32, {"tokens": tokens})
    kernel_scan = ssd_ops.ssd_scan
    ssd_ops.ssd_scan = lambda *a, chunk: ssd_scan_ref(*a, chunk=chunk)
    try:
        plain, _ = m.forward(xla_cfg, p32, {"tokens": tokens})
    finally:
        ssd_ops.ssd_scan = kernel_scan
    full, _ = m.prefill(cfg32, p32, {"tokens": tokens}, 512)
    _, cache = m.prefill(cfg32, p32, {"tokens": tokens[:, :-1]}, 512)
    dec, _ = m.decode_step(cfg32, p32, cache, tokens[:, -1:])
    del p32, cache
    torch.cuda.synchronize()
    if kernels.shape != (2, 256, cfg.vocab_padded) or not torch.isfinite(kernels).all():
        fail(f"f32 hybrid forward: logits of shape {tuple(kernels.shape)} or not finite")
    scale = plain.abs().max().item()
    errs = {
        "err_kernels_vs_plain": (kernels - plain).abs().max().item(),
        "err_flash_vs_plain_attention": (kernels - xla).abs().max().item(),
        "err_prefill_vs_decode": (dec - full).abs().max().item(),
        "err_prefill_vs_forward": (full[:, 0] - plain[:, -1]).abs().max().item(),
    }
    if any(e > 1e-3 * scale for e in errs.values()):
        fail(f"f32 hybrid check: {errs}, logit scale {scale}")
    return {"logit_scale": scale, **errs}


@torch.inference_mode()
def phase_hybrid() -> tuple[dict, dict, dict]:
    """zamba2-2.7b at full width and depth: forward and loss_fn through both
    kernels (54 ssd_scan and 9 flash_attention launches a call), then serving
    (54 ssd_scan launches a prefill, no flash_attention, and 9 decode_attention
    launches for each of the two decode steps run while the graph is captured)."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.ssm_decode import ops as sd_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import get_model

    cfg = ARCHS["zamba2-2.7b"]
    sites = cfg.num_layers // cfg.attn_every
    m = get_model(cfg)
    params = m.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = sum(p.numel() for p in params.parameters())
    model_check = check_hybrid_f32(cfg, params)

    fcfg = dataclasses.replace(cfg, attention_impl="flash")
    tokens = torch.as_tensor(
        np.random.default_rng(6).integers(0, cfg.vocab_size, (4, 1024)), dtype=torch.int64, device="cuda"
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
    ssd_ops.LAUNCHES = fa_ops.LAUNCHES = 0
    for name, fn in calls.items():
        before = (ssd_ops.LAUNCHES, fa_ops.LAUNCHES)
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        per_call[name] = {"ssd_scan": ssd_ops.LAUNCHES - before[0], "flash_attention": fa_ops.LAUNCHES - before[1]}
    launches = {"ssd_scan": ssd_ops.LAUNCHES, "flash_attention": fa_ops.LAUNCHES}
    want = {"ssd_scan": cfg.num_layers, "flash_attention": sites}
    if any(n != want for n in per_call.values()):
        fail(f"zamba2 launches per call {per_call}, expected {want} each")
    logits, loss = out["forward"], out["loss_fn"]
    if logits.shape != (4, 1024, cfg.vocab_padded) or not torch.isfinite(logits).all():
        fail(f"zamba2 forward logits: shape {tuple(logits.shape)} or not finite")
    if loss.shape != () or not torch.isfinite(loss):
        fail(f"zamba2 loss_fn: {loss}")
    peak = torch.cuda.max_memory_allocated()
    del logits, out
    forward = {
        "phase": "hybrid_forward",
        "arch": fcfg.name,
        "attention_impl": fcfg.attention_impl,
        "params": n_params,
        "tokens": list(tokens.shape),
        "ms": ms,
        "loss": loss.item(),
        "launches_per_call": per_call,
        "max_memory_allocated": peak,
        "model_check_f32": model_check,
    }

    ssd_ops.LAUNCHES = fa_ops.LAUNCHES = da_ops.LAUNCHES = sd_ops.LAUNCHES = 0
    served = serve_batches(cfg, params)
    serve_launches = {"ssd_scan": ssd_ops.LAUNCHES, "flash_attention": fa_ops.LAUNCHES,
                      "decode_attention": da_ops.LAUNCHES, "ssm_decode": sd_ops.LAUNCHES}
    # both batches fill one decode graph's shape: captured once, a warm-up step and the captured one
    want = {"ssd_scan": 2 * cfg.num_layers, "flash_attention": 0, "decode_attention": 2 * sites,
            "ssm_decode": 2 * cfg.num_layers}
    if serve_launches != want:
        fail(f"zamba2 serving launched {serve_launches}, expected {want}")

    # where the time goes, outside the counted runs: forward, loss_fn, one prefill and one decode step
    prof = profile(lambda: m.forward(fcfg, params, batch), top=8, names=("ssd_", "flash_attention"))
    if not prof["ssd__ms"] or not prof["flash_attention_ms"]:
        fail(f"the profiled zamba2 forward shows no kernel of the path on the device: {prof}")
    forward["profile"] = prof
    forward["device_share"] = {"ssd_scan": prof["ssd__ms"] / prof["device_busy_ms"],
                               "flash_attention": prof["flash_attention_ms"] / prof["device_busy_ms"]}
    forward["loss_fn_profile"] = profile(lambda: m.loss_fn(fcfg, params, batch))
    _, cache = m.prefill(cfg, params, {"tokens": tokens}, 2048)
    prefill_prof = profile(lambda: m.prefill(cfg, params, {"tokens": tokens}, 2048), top=8, names=("ssd_",))
    step = profile(lambda: m.decode_step(cfg, params, cache, tokens[:, -1:]))
    del cache
    hd, e = cfg.resolved_head_dim, torch.finfo(torch.bfloat16).bits // 8
    serve = {
        "phase": "serve_hybrid",
        "arch": cfg.name,
        "params": n_params,
        **served,
        "launches": serve_launches,
        "kv_cache_bytes": sites * 2 * 4 * 2048 * cfg.num_kv_heads * hd * e,  # from the shapes
        "prefill_profile": prefill_prof,
        "decode_step_profile": step,
        "nvidia_smi": smi(),
    }
    forward["nvidia_smi"] = serve["nvidia_smi"]
    return forward, serve, {"zamba2_forward": launches, "zamba2_serve": serve_launches}


def check_prefill_decode_f32(cfg, params) -> dict:
    """prefill(S) against prefill(S-1) + decode in float32 on (2, 256) tokens,
    with the stub frontends' inputs seeded.  The MoE twin routes with
    capacity_factor = E / K, which drops no (token, k) pair: capacity is set
    per dispatch group (a prompt row, or one decoded token), so with drops
    the two routes differ in the reference too."""
    from repro_torch.models import get_model

    changes = {"capacity_factor": cfg.num_experts / cfg.top_k} if cfg.family == "moe" else {}
    cfg32, p32 = f32_twin(cfg, params, **changes)
    m = get_model(cfg32)
    r = np.random.default_rng(7)
    tokens = torch.as_tensor(r.integers(0, cfg.vocab_size, (2, 256)), dtype=torch.int64, device="cuda")
    extra = {}
    if cfg.family == "vlm":
        extra["patch_embeds"] = torch.tensor(r.standard_normal((2, cfg.num_patches, cfg.d_model)) * 0.02,
                                             dtype=torch.float32, device="cuda")
    if cfg.family == "encdec":
        extra["frame_embeds"] = torch.tensor(r.standard_normal((2, cfg.encoder_frames, cfg.d_model)),
                                             dtype=torch.float32, device="cuda")
    full, _ = m.prefill(cfg32, p32, {"tokens": tokens, **extra}, 512)
    _, cache = m.prefill(cfg32, p32, {"tokens": tokens[:, :-1], **extra}, 512)
    dec, _ = m.decode_step(cfg32, p32, cache, tokens[:, -1:])
    del p32, cache
    torch.cuda.synchronize()
    if full.shape != (2, 1, cfg.vocab_padded) or not torch.isfinite(full).all():
        fail(f"f32 {cfg.name} prefill: logits of shape {tuple(full.shape)} or not finite")
    scale = full.abs().max().item()
    err = (dec - full).abs().max().item()
    if err > 1e-3 * scale:
        fail(f"f32 {cfg.name} check: |prefill - decode| {err}, logit scale {scale}")
    return {"logit_scale": scale, "err_prefill_vs_decode": err, **changes}


@torch.inference_mode()
def phase_families() -> list[dict]:
    """The other families at full width, each cut in depth as FAMILIES says:
    an f32-twin prefill-vs-decode check and one ServeEngine batch of 4.
    They run no custom kernel; the counts show it."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import get_model

    lines = []
    for name, layers, prompt_len, max_len in FAMILIES:
        full = ARCHS[name]
        cfg = full if layers is None else dataclasses.replace(full, num_layers=layers)
        params = get_model(cfg).init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        n_params = sum(p.numel() for p in params.parameters())
        model_check = check_prefill_decode_f32(cfg, params)
        ssd_ops.LAUNCHES = fa_ops.LAUNCHES = 0
        served = serve_batches(cfg, params, prompt_lens=(prompt_len,), max_len=max_len)
        launches = {"ssd_scan": ssd_ops.LAUNCHES, "flash_attention": fa_ops.LAUNCHES}
        if any(launches.values()):
            fail(f"{name} serving launched {launches}: this family runs no custom kernel")
        del params
        lines.append({
            "phase": "serve_family",
            "arch": name,
            "family": cfg.family,
            "layers": cfg.num_layers,
            "reduced": {} if layers is None else {"num_layers": [full.num_layers, layers]},
            "encoder_layers": cfg.encoder_layers or None,
            "params": n_params,
            **served,
            "launches": launches,
            "model_check_f32": model_check,
            "nvidia_smi": smi(),
        })
    return lines


TRAIN_OCFG = dict(lr=1e-3, warmup_steps=0)
TRAIN_DATA = dict(seq_len=1024, global_batch=4, seed=0)  # 4 x 1024 tokens a step, one batch repeated
TRAIN_STEPS = 5
TRAIN_RESTART_LAYERS = 2  # of mamba2-780m's 48, for the checkpoint-restart check
ZAMBA2_TRAIN_LAYERS = 6  # of zamba2-2.7b's 54: one shared-attention site


def cuda_batch(cfg, step: int = 0, **data) -> dict:
    """``host_batch`` of ``data`` (a DataConfig's fields) at ``step``, on the card."""
    from repro_torch.data.pipeline import DataConfig, host_batch

    batch = host_batch(cfg, DataConfig(**data), step)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to("cuda") for k, v in batch.items()}


def kernel_counts() -> dict:
    """Each kernel's launches and plain backwards since the counts were last set to 0."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    return {"ssd_scan": [ssd_ops.LAUNCHES, ssd_ops.BACKWARDS], "flash_attention": [fa_ops.LAUNCHES, fa_ops.BACKWARDS]}


def zero_counts() -> None:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    ssd_ops.LAUNCHES = ssd_ops.BACKWARDS = fa_ops.LAUNCHES = fa_ops.BACKWARDS = 0


def train_steps(step_fn, params, opt, batches) -> list[dict]:
    """One train step per batch, each timed by the host clock between two
    synchronisations, with its metrics and the kernels' launches and backwards
    (counts set to 0 just before the step, read just after)."""
    rows = []
    for batch in batches:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rows.append({"ms": ms, **{k: v.item() for k, v in metrics.items()}, **kernel_counts()})
    return rows


def plain_backward_ms(sh) -> float:
    """Device ms of one ``SSDScan`` backward at a bf16 path shape, by CUDA events:
    the plain scan recomputed from the inputs and differentiated (what
    ``ops.SSDScan.backward`` runs), the final state's gradient unused."""
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    ins = [t.requires_grad_() for t in ssd_inputs(sh["b"], sh["s"], sh["h"], sh["p"], sh["g"], sh["n"], 0, torch.bfloat16)]
    gy = torch.randn((sh["b"], sh["s"], sh["h"], sh["p"]), device="cuda")

    def backward():
        y, _ = ssd_scan_ref(*ins, chunk=sh["L"])
        torch.autograd.grad(y, ins, gy)

    return cuda_ms(backward, iters=10)


def check_train_f32(cfg) -> dict:
    """Full-width model in float32: one train step on 2 x 512 tokens through the
    kernel's forward, against the same step with the plain scan.  Loss within
    1e-4 relative, grad norm within 1e-3, and each leaf's clipped gradient
    within 1e-3 of its largest.  The updated params are held to 1e-3 lr after
    AdamW's first step is accounted for: that step moves each element by
    lr g / (|g| + eps) (plus weight decay, equal in both), so where g lies
    within a few eps of zero a gradient difference of float noise moves the
    element by up to 2 lr.  Each param difference must equal, within 1e-3 lr,
    the one AdamW gives for the two gradients; the elements that differ by
    more than 1e-3 lr are counted, with their largest clipped gradient."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_fn

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    ocfg = adamw.AdamWConfig(**TRAIN_OCFG)
    batch = cuda_batch(cfg32, seq_len=512, global_batch=2, seed=1)
    update, kernel_scan, out = adamw.update, ops.ssd_scan, {}
    for route in ("kernel", "plain"):
        params = get_model(cfg32).init_params(cfg32, torch.Generator(device="cuda").manual_seed(0), "cuda")
        seen = {}

        def spy(c, grads, state, p, seen=seen):
            seen["grads"] = grads
            return update(c, grads, state, p)

        adamw.update = spy
        if route == "plain":
            ops.ssd_scan = lambda *a, chunk: ssd_scan_ref(*a, chunk=chunk)
        try:
            _, _, metrics = make_train_fn(cfg32, ocfg)(params, adamw.init(params), batch)
        finally:
            adamw.update, ops.ssd_scan = update, kernel_scan
        metrics = {k: v.item() for k, v in metrics.items()}
        clip = min(1.0, ocfg.grad_clip / (metrics["grad_norm"] + 1e-9))
        out[route] = (params, metrics, {n: g * clip for n, g in seen["grads"].items()})
    (pk, mk, gk), (pp, mp, gp) = out["kernel"], out["plain"]
    bar = 1e-3 * ocfg.lr
    stats = {"grad_rel": 0.0, "param_vs_adamw": 0.0, "beyond_bar": 0, "beyond_bar_max_clipped_gradient": 0.0}
    for (name, a), b in zip(pk.named_parameters(), pp.parameters()):
        ga, gb = gk[name], gp[name]
        stats["grad_rel"] = max(stats["grad_rel"], ((ga - gb).abs().max() / gb.abs().max()).item())
        moved = -ocfg.lr * (ga / (ga.abs() + ocfg.eps) - gb / (gb.abs() + ocfg.eps))
        stats["param_vs_adamw"] = max(stats["param_vs_adamw"], ((a - b) - moved).abs().max().item())
        beyond = (a - b).abs() > bar
        if beyond.any():
            stats["beyond_bar"] += int(beyond.sum())
            stats["beyond_bar_max_clipped_gradient"] = max(stats["beyond_bar_max_clipped_gradient"],
                                                          gb.abs()[beyond].max().item())
    errs = {"loss_rel": abs(mk["loss"] - mp["loss"]) / abs(mp["loss"]),
            "grad_norm_rel": abs(mk["grad_norm"] - mp["grad_norm"]) / mp["grad_norm"]}
    if errs["loss_rel"] > 1e-4 or errs["grad_norm_rel"] > 1e-3 or stats["grad_rel"] > 1e-3 \
            or stats["param_vs_adamw"] > bar:
        fail(f"f32 train twin: {errs} {stats} (bars: loss 1e-4, grad norm and grads 1e-3, params {bar})")
    return {"tokens": [2, 512], "loss": [mk["loss"], mp["loss"]], "grad_norm": [mk["grad_norm"], mp["grad_norm"]],
            **errs, "param_bar": bar, **stats, "of_elements": sum(p.numel() for p in pk.parameters())}


def check_train_restart(cfg) -> dict:
    """Full width, depth cut to TRAIN_RESTART_LAYERS: two steps, a save with
    CheckpointManager, the module and AdamW state rebuilt from ``restore``, a
    third step; its params against an uninterrupted three-step run, bitwise."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_fn

    cut = dataclasses.replace(cfg, num_layers=TRAIN_RESTART_LAYERS)
    step_fn = make_train_fn(cut, adamw.AdamWConfig(**TRAIN_OCFG))
    batches = [cuda_batch(cut, step, **{**TRAIN_DATA, "seed": 2}) for step in range(3)]

    def fresh():
        return get_model(cut).init_params(cut, torch.Generator(device="cuda").manual_seed(0), "cuda")

    ref = fresh()
    train_steps(step_fn, ref, adamw.init(ref), batches)
    params = fresh()
    opt = adamw.init(params)
    train_steps(step_fn, params, opt, batches[:2])
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        t0 = time.perf_counter()
        mgr.save(2, {"params": dict(params.named_parameters()), "opt": opt})
        save_s = time.perf_counter() - t0
        stats = mgr.stats()
        del params, opt
        model = fresh()
        restored, step = mgr.restore({"params": dict(model.named_parameters()), "opt": adamw.init(model)})
    model.load_state_dict(restored["params"])
    train_steps(step_fn, model, restored["opt"], batches[2:])
    diffs = {n: (a - b).abs().max().item() for (n, a), b in zip(ref.named_parameters(), model.parameters())
             if not torch.equal(a, b)}
    if step != 2 or int(restored["opt"]["step"]) != 3 or diffs:
        fail(f"train restart: step {step}, AdamW step {int(restored['opt']['step'])}, params differ {diffs}")
    return {"layers": cut.num_layers, "reduced": {"num_layers": [cfg.num_layers, cut.num_layers]},
            "params": sum(p.numel() for p in model.parameters()), "bitwise_equal": True,
            "bytes_written": stats["device"]["bytes_written"], "write_amplification": stats["write_amplification"],
            "save_s": save_s}


def remat_launches(cfg, calls: int) -> list[int]:
    """[kernel launches, plain backwards] of a train step for a kernel called ``calls``
    times a forward: under ``cfg.remat`` each layer's forward runs again in the
    backward, so the kernel launches twice for each backward."""
    return [calls * (2 if cfg.remat else 1), calls]


def mamba2_steps(cfg, n: int) -> tuple[list[dict], int, tuple]:
    """``n`` AdamW steps of make_train_fn on one repeated batch at TRAIN_DATA, from
    seed 0; returns the step rows, the peak memory of the steps, and (step_fn,
    params, opt, batch).  Each step must be finite and launch what
    ``remat_launches`` says, and the loss must fall."""
    from repro_torch.models import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_fn

    params = get_model(cfg).init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    opt = adamw.init(params)
    step_fn = make_train_fn(cfg, adamw.AdamWConfig(**TRAIN_OCFG))
    batch = cuda_batch(cfg, **TRAIN_DATA)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = train_steps(step_fn, params, opt, [batch] * n)
    peak = torch.cuda.max_memory_allocated()
    want = {"ssd_scan": remat_launches(cfg, cfg.num_layers), "flash_attention": [0, 0]}
    for i, row in enumerate(steps):
        if not all(np.isfinite(row[k]) for k in ("loss", "grad_norm", "lr")):
            fail(f"mamba2 train step {i + 1} (remat={cfg.remat}): {row}")
        if {k: row[k] for k in want} != want:
            fail(f"mamba2 train step {i + 1} (remat={cfg.remat}): launches and backwards {row}, expected {want}")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        fail(f"mamba2 train (remat={cfg.remat}): loss did not fall, {[r['loss'] for r in steps]}")
    return steps, peak, (step_fn, params, opt, batch)


def phase_train() -> tuple[dict, dict, dict]:
    """mamba2-780m at full width and depth takes TRAIN_STEPS AdamW steps of
    make_train_fn on one repeated batch of 4 x 1024 tokens, with ``remat`` as the
    registry sets it (on): ssd_scan's kernel forward runs in every layer and
    again in its recompute, with the plain backward (96 launches and 48
    backwards a step); the f32 twin and the checkpoint restart first, and the
    same steps with ``remat`` off after (48 and 48), for their peak memory and
    time.  Then zamba2-2.7b, depth cut to ZAMBA2_TRAIN_LAYERS, takes two steps
    through both kernels' Functions (12 ssd_scan launches and 6 backwards, 2
    flash_attention launches and 1 backward a step)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_fn

    cfg = ARCHS["mamba2-780m"]
    if not cfg.remat:
        fail("mamba2-780m's registry config no longer sets remat")
    twin = check_train_f32(cfg)
    restart = check_train_restart(cfg)
    sharded = check_train_step_sharded(cfg)

    steps, peak, (step_fn, params, opt, batch) = mamba2_steps(cfg, TRAIN_STEPS)
    want = {"ssd_scan": remat_launches(cfg, cfg.num_layers), "flash_attention": [0, 0]}
    warm_ms = [r["ms"] for r in steps[1:]]
    ms = sum(warm_ms) / len(warm_ms)
    tokens = TRAIN_DATA["seq_len"] * TRAIN_DATA["global_batch"]
    # where a step's time goes, outside the counted run
    prof = profile(lambda: step_fn(params, opt, batch), top=10, names=("ssd_", *SSD_STAGES),
                   ops=("SSDScanBackward",))
    if not prof["ssd__ms"]:
        fail(f"the profiled mamba2 train step shows no ssd_scan kernel on the device: {prof}")
    profiled_bwd = prof["SSDScanBackward_ops"].get("SSDScanBackward")
    bwd_ms = plain_backward_ms(SERVE_SHAPE)
    n_params = sum(p.numel() for p in params.parameters())
    del params, opt, step_fn
    no_remat = dataclasses.replace(cfg, remat=False)
    steps_nr, peak_nr, held = mamba2_steps(no_remat, TRAIN_STEPS)
    del held
    ms_nr = sum(r["ms"] for r in steps_nr[1:]) / (len(steps_nr) - 1)
    card = smi()
    mamba2 = {
        "phase": "train",
        "arch": cfg.name,
        "params": n_params,
        "tokens_per_step": [TRAIN_DATA["global_batch"], TRAIN_DATA["seq_len"]],
        "optimizer": {**TRAIN_OCFG, "other": "AdamWConfig defaults"},
        "steps": steps,
        "remat": cfg.remat,
        "ms_per_step_warm": ms,
        "tokens_per_s": tokens / (ms / 1e3),
        "max_memory_allocated": peak,
        # the same steps with remat off, in this run
        "remat_off": {"steps": steps_nr, "ms_per_step_warm": ms_nr, "tokens_per_s": tokens / (ms_nr / 1e3),
                      "max_memory_allocated": peak_nr},
        "profile": prof,
        # the plain backward: device ms under the 48 SSDScanBackward nodes of the profiled
        # step, and one backward alone at the path shape by CUDA events
        "plain_backward": {"profiled_ms_per_step": profiled_bwd,
                           "profiled_share_of_device_busy": profiled_bwd / prof["device_busy_ms"]
                           if profiled_bwd and prof["device_busy_ms"] else None,
                           "profiled_share_of_step_ms": profiled_bwd / ms if profiled_bwd else None,
                           "alone_ms_per_call": bwd_ms, "calls_per_step": cfg.num_layers,
                           "alone_share_of_step_ms": bwd_ms * cfg.num_layers / ms},
        "model_check_f32": twin,
        "restart": restart,
        "train_step_sharded": sharded,
        "nvidia_smi": card,
    }

    full = ARCHS["zamba2-2.7b"]
    zcfg = dataclasses.replace(full, num_layers=ZAMBA2_TRAIN_LAYERS, attention_impl="flash")
    zparams = get_model(zcfg).init_params(zcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    zopt, zbatch = adamw.init(zparams), cuda_batch(zcfg, **TRAIN_DATA)
    zstep_fn = make_train_fn(zcfg, adamw.AdamWConfig(**TRAIN_OCFG))
    zsteps = train_steps(zstep_fn, zparams, zopt, [zbatch] * 2)
    zwant = {"ssd_scan": remat_launches(zcfg, zcfg.num_layers),
             "flash_attention": remat_launches(zcfg, zcfg.num_layers // zcfg.attn_every)}
    for i, row in enumerate(zsteps):
        if not all(np.isfinite(row[k]) for k in ("loss", "grad_norm", "lr")) or {k: row[k] for k in zwant} != zwant:
            fail(f"zamba2 train step {i + 1}: {row}, expected launches and backwards {zwant}")
    zamba2 = {
        "phase": "train",
        "arch": full.name,
        "layers": zcfg.num_layers,
        "reduced": {"num_layers": [full.num_layers, zcfg.num_layers]},
        "attention_impl": zcfg.attention_impl,
        "params": sum(p.numel() for p in zparams.parameters()),
        "tokens_per_step": [TRAIN_DATA["global_batch"], TRAIN_DATA["seq_len"]],
        "steps": zsteps,
        # outside the counted run: the device ms under each kernel's plain backward
        "profile": profile(lambda: zstep_fn(zparams, zopt, zbatch), top=8, names=("ssd_", "flash_attention"),
                           ops=("SSDScanBackward", "FlashAttentionBackward")),
        "nvidia_smi": smi(),
    }
    del zparams, zopt
    counts = {"mamba2_train": {k: [sum(r[k][i] for r in steps) for i in (0, 1)] for k in want},
              "zamba2_train": {k: [sum(r[k][i] for r in zsteps) for i in (0, 1)] for k in zwant}}
    return mamba2, zamba2, counts


def check_train_step_sharded(cfg) -> dict:
    """make_train_step on the card's (1, 1) mesh (``make_host_mesh``): one step at full
    width, depth cut to TRAIN_RESTART_LAYERS, with params and AdamW state as DTensors
    in the rules' placements, against make_train_fn's step on the same inputs from
    the same seed: loss, grad norm, lr and every param bitwise equal.  The kernels
    get plain local tensors (the gathered leaves), so each launches as on the
    unsharded path."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules
    from repro_torch.train.step import make_train_fn, make_train_step

    mesh = make_host_mesh()
    cut = rules.pad_config_for_mesh(dataclasses.replace(cfg, num_layers=TRAIN_RESTART_LAYERS), mesh)
    ocfg = adamw.AdamWConfig(**TRAIN_OCFG)
    batch = cuda_batch(cut, **{**TRAIN_DATA, "seed": 3})

    def fresh():
        return get_model(cut).init_params(cut, torch.Generator(device="cuda").manual_seed(0), "cuda")

    plain = fresh()
    zero_counts()
    _, _, want = make_train_fn(cut, ocfg)(plain, adamw.init(plain), batch)
    plain_counts = kernel_counts()
    step, _, pspecs, _, ospecs = make_train_step(cut, mesh, ocfg)
    model = fresh()
    params = rules.distribute(dict(model.named_parameters()), pspecs)
    opt = rules.distribute(adamw.init(model), ospecs)
    del model
    zero_counts()
    _, _, got = step(params, opt, batch)
    sharded_counts = kernel_counts()
    diffs = {n: (params[n].full_tensor() - p).abs().max().item() for n, p in plain.named_parameters()
             if not torch.equal(params[n].full_tensor(), p)}
    metrics = {k: [got[k].item(), want[k].item()] for k in want}
    placements = sorted({str(tuple(p.placements)) for p in params.values()})
    del params, opt
    torch.distributed.destroy_process_group()  # make_host_mesh started it
    if diffs or any(a != b for a, b in metrics.values()) or sharded_counts != plain_counts:
        fail(f"make_train_step on the (1, 1) mesh: params differ {diffs}, metrics {metrics}, "
             f"launches {sharded_counts} against {plain_counts}")
    return {"mesh": rules.mesh_axes(mesh), "layers": cut.num_layers,
            "reduced": {"num_layers": [cfg.num_layers, cut.num_layers]},
            "params": sum(p.numel() for p in plain.parameters()), "bitwise_equal": True,
            "metrics_sharded_vs_plain": metrics, "launches": sharded_counts, "placements": placements}


def run_launcher(args: list[str], *, kill_at: str | None = None, timeout: float = 600) -> tuple[int, list[str]]:
    """``python -m repro_torch.launch.train`` with ``args`` from the checkout's src, on
    the card; returns its exit code and stdout lines.  With ``kill_at``, the process
    is killed (SIGKILL) as soon as a line starts with it."""
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = []
    try:
        t0 = time.perf_counter()
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if kill_at and line.startswith(kill_at):
                proc.kill()
                break
            if time.perf_counter() - t0 > timeout:
                proc.kill()
                fail(f"launcher {args} ran past {timeout} s")
        err = proc.stderr.read()
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0 and not kill_at:
        fail(f"launcher {args} exited {rc}: {err[-3000:]}")
    return rc, lines


LAUNCH_FULL = ["--arch", "mamba2-780m", "--full", "--steps", "6", "--seq", "1024", "--batch", "4"]
# the reduced flow of tests/test_system.py:34 through the launcher: a checkpoint every
# 4 steps, a kill at the first, a --resume, and the end against an uninterrupted run
LAUNCH_RESUME = ["--arch", "mamba2-780m", "--steps", "40", "--seq", "64", "--batch", "8", "--ckpt-every", "4"]


def final_state(cfg, directory: str) -> tuple[dict[str, torch.Tensor], int]:
    """The launcher's last checkpoint under ``directory``, restored on the CPU, by leaf path."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models import get_model
    from repro_torch.optim import adamw

    model = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    like = {"params": dict(model.named_parameters()), "opt": adamw.init(model)}
    tree, step = CheckpointManager(directory).restore(like)

    def leaves(t, prefix=""):
        if isinstance(t, dict):
            return {path: leaf for k, v in t.items() for path, leaf in leaves(v, f"{prefix}{k}/").items()}
        return {prefix[:-1]: t}

    return leaves(tree), step


def phase_launch() -> dict:
    """``python -m repro_torch.launch.train`` as a user runs it, on the card.

    mamba2-780m at full width and depth, 6 steps of 4 x 1024 tokens, no
    checkpoint (a full save would write ~9.4 GB): exit 0, finite losses, and in
    every step the launches and plain backwards ``remat_launches`` gives (the
    launcher's ``--metrics-json`` counts them in its own process).  Then the
    reduced config: an uninterrupted run, and a run killed at its first
    checkpoint and resumed with ``--resume``, whose last checkpoints must be
    bitwise equal."""
    from repro_torch.configs import ARCHS
    from repro_torch.sharding import rules

    cfg = ARCHS["mamba2-780m"]
    with tempfile.TemporaryDirectory() as tmp:
        log = Path(tmp) / "steps.jsonl"
        t0 = time.perf_counter()
        _, lines = run_launcher([*LAUNCH_FULL, "--metrics-json", str(log)])
        wall_s = time.perf_counter() - t0
        steps = [json.loads(ln) for ln in log.read_text().splitlines()]
        want = {"ssd_scan": remat_launches(cfg, cfg.num_layers), "flash_attention": [0, 0]}
        if len(steps) != 6 or lines[-1] != "done":
            fail(f"launcher: {len(steps)} steps logged, last line {lines[-1:]}")
        for row in steps:
            if not all(np.isfinite(row[k]) for k in ("loss", "grad_norm", "lr")) or {k: row[k] for k in want} != want:
                fail(f"launcher step {row['step']}: {row}, expected finite values and launches {want}")
        warm = [r["ms"] for r in steps[1:]]
        ms = sum(warm) / len(warm)
        tokens = 4 * 1024

        one_card = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
        reduced = rules.pad_config_for_mesh(cfg.reduced(), one_card)
        whole, cut = Path(tmp) / "whole", Path(tmp) / "cut"
        run_launcher([*LAUNCH_RESUME, "--ckpt-dir", str(whole)])
        rc_killed, killed = run_launcher([*LAUNCH_RESUME, "--ckpt-dir", str(cut)], kill_at="checkpointed @")
        _, resumed = run_launcher([*LAUNCH_RESUME, "--ckpt-dir", str(cut), "--resume"])
        at = int(next(ln for ln in resumed if ln.startswith("resumed at step")).split()[-1])
        (a, sa), (b, sb) = final_state(reduced, str(whole)), final_state(reduced, str(cut))
        differ = [k for k, t in a.items() if not torch.equal(t, b[k])]
        if sa != sb or not 0 < at < sa or differ:
            fail(f"launcher resume: last checkpoints at {sa} and {sb}, resumed at {at}, leaves differ {differ}")
    return {"phase": "launch", "arch": cfg.name, "command": ["python", "-m", "repro_torch.launch.train", *LAUNCH_FULL],
            "remat": cfg.remat, "steps": steps, "ms_per_step_warm": ms, "tokens_per_s": tokens / (ms / 1e3),
            "wall_s": wall_s, "stdout": lines,
            "resume": {"command": LAUNCH_RESUME, "killed_rc": rc_killed, "killed_after": killed[-1],
                       "resumed_at": at, "last_checkpoint": sa, "leaves": len(a), "bitwise_equal": True},
            "nvidia_smi": smi()}


# one full-width cell of each step kind, over the families that carry a kernel
DRYRUN_CELLS = (("mamba2-780m", "train_4k"), ("qwen2.5-3b", "prefill_32k"), ("zamba2-2.7b", "long_500k"),
                ("deepseek-moe-16b", "decode_32k"))
# the dry-run of phase_train's cell: mamba2-780m, 4 x 1024 tokens, remat, the (1, 1) mesh, as
# tests/test_sharding_dryrun.py narrows SHAPES and patches make_production_mesh
DRYRUN_CARD_CELL = """
import dataclasses, json, torch
from torch.distributed.device_mesh import DeviceMesh
import repro_torch.configs.registry as reg
import repro_torch.launch.dryrun as dr
dr.fake_group(1)
mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1), mesh_dim_names=("data", "model"))
dr.make_production_mesh = lambda multi_pod=False, device=None: mesh
reg.SHAPES["train_4k"] = dataclasses.replace(reg.SHAPES["train_4k"], seq_len={seq_len}, global_batch={global_batch})
print(json.dumps(dr.run_cell("mamba2-780m", "train_4k", "single")))
"""
DRYRUN_MEMORY_BAR = 0.25  # the dry-run's peak against the card's max_memory_allocated, relative


def dryrun_ok(row: dict) -> None:
    rl = row.get("roofline", {})
    if row.get("status") != "ok" or not all(np.isfinite(v) for v in rl.values() if isinstance(v, float)) \
            or rl.get("bottleneck") not in ("compute", "memory", "collective"):
        fail(f"dry-run {row['arch']}/{row['shape']}: {row.get('status')} {row.get('error', '')} {rl}")


def dryrun_summary(row: dict) -> dict:
    rl = row["roofline"]
    return {"arch": row["arch"], "shape": row["shape"], "mesh": row["mesh"], "devices": row["devices"],
            "lower_s": row["lower_s"], "trace_s": row["trace_s"],
            "terms_s": {k: rl[k] for k in ("compute_s", "memory_s", "collective_s")}, "bottleneck": rl["bottleneck"],
            "traced_over_analytic_flops": rl["traced_flops_per_device"] / rl["flops_per_device"],
            "traced_wire_bytes": rl["traced_wire_bytes_per_device"], "collectives": rl["collectives"],
            "memory": row["memory"]}


def phase_dryrun() -> dict:
    """``python -m repro_torch.launch.dryrun`` as a user runs it, on this machine's
    CPU (a fake process group, fake tensors, no card): DRYRUN_CELLS on the
    (16, 16) production mesh at full width, one process each, all at once;
    every row ``ok`` with finite terms, and ``bench_roofline`` prints a row a
    cell from them.  Then the one link between the dry-run and the card: the
    dry-run of phase_train's cell on a (1, 1) mesh, against one warm
    ``make_train_step`` of the same cell on the card over ``make_host_mesh()``:
    the card's ``max_memory_allocated`` within DRYRUN_MEMORY_BAR of the
    dry-run's ``peak_bytes``, and the step's model-FLOP share at the H100's
    bf16 peak."""
    import os

    from repro_torch.benchmarks import bench_roofline
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules
    from repro_torch.train.step import make_train_step

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                                  "--mesh", "single", "--out", f"{tmp}/{arch}.{shape}.json"], cwd=ROOT, env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for arch, shape in DRYRUN_CELLS]
        card_cell = subprocess.Popen([sys.executable, "-c", DRYRUN_CARD_CELL.format(**{
            k: TRAIN_DATA[k] for k in ("seq_len", "global_batch")})], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        rows = []
        try:
            for (arch, shape), proc in zip(DRYRUN_CELLS, procs):
                out, err = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    fail(f"dry-run {arch}/{shape} exited {proc.returncode}: {out[-2000:]} {err[-2000:]}")
                rows += json.loads(Path(f"{tmp}/{arch}.{shape}.json").read_text())
            card_out, err = card_cell.communicate(timeout=600)
            if card_cell.returncode != 0:
                fail(f"dry-run of the card's cell exited {card_cell.returncode}: {err[-3000:]}")
        finally:
            for proc in (*procs, card_cell):
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall_s = time.perf_counter() - t0
        for row in rows:
            dryrun_ok(row)
        Path(tmp, "dryrun_single.json").write_text(json.dumps(rows))
        lines: list[str] = []
        bench_roofline.RESULTS = tmp
        bench_roofline.main(lines.append)
    printed = sorted(ln.split(",")[0] for ln in lines if ln.startswith("roofline:"))
    if printed != sorted(f"roofline:{a}:{s}" for a, s in DRYRUN_CELLS):
        fail(f"bench_roofline printed {lines}")
    dry = json.loads(card_out.strip().splitlines()[-1])
    dryrun_ok(dry)

    # the same cell on the card: one warm step after one to warm up
    mesh = make_host_mesh()
    cfg = rules.pad_config_for_mesh(ARCHS["mamba2-780m"], mesh)
    step, _, pspecs, _, ospecs = make_train_step(cfg, mesh, adamw.AdamWConfig(**TRAIN_OCFG))
    model = get_model(cfg).init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    params = rules.distribute(dict(model.named_parameters()), pspecs)
    opt = rules.distribute(adamw.init(model), ospecs)
    del model
    batch = cuda_batch(cfg, **TRAIN_DATA)
    step(params, opt, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t1 = time.perf_counter()
    _, _, metrics = step(params, opt, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    card_peak = torch.cuda.max_memory_allocated()
    launches = kernel_counts()
    loss = metrics["loss"].item()
    del params, opt, metrics
    torch.distributed.destroy_process_group()  # make_host_mesh started it
    spec = dataclasses.replace(SHAPES["train_4k"], **{k: TRAIN_DATA[k] for k in ("seq_len", "global_batch")})
    model_flops = roofline.model_flops_for(cfg, spec)
    dry_peak = dry["memory"]["peak_bytes"]
    rel = abs(dry_peak - card_peak) / card_peak
    if rel > DRYRUN_MEMORY_BAR or not np.isfinite(loss) or launches["ssd_scan"] != remat_launches(cfg, cfg.num_layers):
        fail(f"dry-run against the card: peak {dry_peak} against max_memory_allocated {card_peak} "
             f"({rel:.3f}, bar {DRYRUN_MEMORY_BAR}), loss {loss}, launches {launches}")
    return {"phase": "dryrun", "platform": "cpu (fake process group, fake tensors)",
            "peaks": {"flops": roofline.PEAK_FLOPS, "hbm_bytes_s": roofline.HBM_BW, "link_bytes_s": roofline.LINK_BW},
            "cells": [dryrun_summary(r) for r in rows], "wall_s": wall_s, "bench_roofline": lines,
            "card_cell": {"arch": cfg.name, "tokens_per_step": [TRAIN_DATA["global_batch"], TRAIN_DATA["seq_len"]],
                          "remat": cfg.remat, "mesh": rules.mesh_axes(mesh), "dryrun": dryrun_summary(dry),
                          "dryrun_peak_bytes": dry_peak, "max_memory_allocated": card_peak,
                          "peak_rel_diff": rel, "step_ms_warm": step_s * 1e3, "loss": loss, "launches": launches,
                          "model_flops": model_flops, "model_flop_share": model_flops / (step_s * roofline.PEAK_FLOPS)},
            "nvidia_smi": smi()}


TP_SIZE = 2  # the (1, 2) mesh of phase_tp: two ranks on the one card
TP_SSD_SHAPE = {**SERVE_SHAPE, "h": SERVE_SHAPE["h"] // TP_SIZE}  # mamba2-780m's scan on one rank's 24 heads
TP_FA_SHAPE = {**FA_FORWARD_SHAPE, "h": FA_FORWARD_SHAPE["h"] // TP_SIZE, "kh": FA_FORWARD_SHAPE["kh"] // TP_SIZE}
TP_FA_VLM_SHAPE = dict(b=4, s=1024, h=48 // TP_SIZE, kh=8 // TP_SIZE, d=128)  # internvl2-26b's flash on one rank
TP_FA_MOE_SHAPE = dict(b=4, s=1024, h=16 // TP_SIZE, kh=16 // TP_SIZE, d=128)  # deepseek-moe-16b's flash on one rank
TP_TWIN_DATA = dict(seq_len=512, global_batch=2, seed=1)  # the f32 twins' batch, as check_train_f32's
# (arch, layers, attention_impl) of each f32 twin: zamba2 keeps the 6 layers that reach its shared block;
# whisper keeps as many encoder layers as decoder layers and runs the plain attention, as the reference
TP_TWINS = (("mamba2-780m", TRAIN_RESTART_LAYERS, "xla"), ("qwen2.5-3b", TRAIN_RESTART_LAYERS, "flash"),
            ("zamba2-2.7b", ZAMBA2_TRAIN_LAYERS, "flash"), ("internvl2-26b", TRAIN_RESTART_LAYERS, "flash"),
            ("deepseek-moe-16b", TRAIN_RESTART_LAYERS, "flash"), ("whisper-medium", TRAIN_RESTART_LAYERS, "xla"))
TP_GRAD_BAR = 1e-3  # each leaf's gradient and each prefill leaf, of the leaf's largest; phase_train's bars
# (arch, layers) of each f32 decode twin, and their batch: a prompt of 28 tokens (after a vlm's 256
# patches) in a sequence of 2 x (prefix + 28 + 4), so that the 5th of 8 decode steps writes the first
# row of the second rank's shard
TP_DECODE_TWINS = (("qwen2.5-3b", TRAIN_RESTART_LAYERS), ("zamba2-2.7b", ZAMBA2_TRAIN_LAYERS),
                   ("internvl2-26b", TRAIN_RESTART_LAYERS), ("deepseek-moe-16b", TRAIN_RESTART_LAYERS),
                   ("whisper-medium", TRAIN_RESTART_LAYERS))
TP_DECODE = dict(batch=2, prompt=28, steps=8)
TP_DECODE_BAR = 1e-4  # each step's logits, of the logit scale, and each new cache leaf, of its largest
TP_SERVE = dict(batch=4, prompt=1024, max_len=2048, steps=32)  # qwen2.5-3b, full width and depth, bf16
TP_SERVE_WHISPER = dict(batch=4, prompt=256, max_len=512, steps=32)  # whisper-medium, 24 + 24 layers, 1500 frames
# deepseek-moe-16b's full-width step on (1, 2): 2 of its 28 layers.  At 4 each rank peaked at 38.9 GB (f32
# leaves, AdamW moments, gradients and the update's temporaries), and two such ranks beside this process's own
# allocations filled the card
TP_MOE_LAYERS = 2
TP_ROUTER_TIE = 1e-5  # a MoE twin's routing may differ from (1, 1) only where its probabilities lie this close
# (h) the hooked f32 twins: make_train_step with accum_steps and each compress method on (1, 2) against
# make_train_fn with the same keywords on the whole batch (TP_TWIN_DATA: two microbatches of 1 x 512)
TP_HOOK_TWINS = (("mamba2-780m", TRAIN_RESTART_LAYERS, "xla"), ("deepseek-moe-16b", TRAIN_RESTART_LAYERS, "flash"))
TP_HOOKS = dict(accum_steps=2)
TP_COMPRESS = ("int8", "topk")
TP_FLIPS = 1e-3  # of the elements, which may sit across a rounding or threshold boundary (then left out)


def tp_cfg(cfg):
    """``cfg`` padded for the (1, 2) mesh; the (1, 1) reference runs the same config,
    so that both draw the same leaves from one seed."""
    from repro_torch.sharding import rules

    return rules.pad_config_for_mesh(cfg, types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, TP_SIZE)))


def tp_twin_cfg(name: str, layers: int, impl: str):
    """The f32 twin of ``name`` at ``layers`` (an encoder-decoder's encoder too),
    padded for the (1, 2) mesh."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS[name]
    depth = {"num_layers": layers, **({"encoder_layers": layers} if cfg.family == "encdec" else {})}
    return tp_cfg(dataclasses.replace(cfg, **depth, compute_dtype="float32", attention_impl=impl))


def tp_whole(t) -> torch.Tensor:
    """A DTensor's whole value on this rank, gathered through ``sharding/tp.py``'s
    all-gather, which a ``gloo`` group takes on CUDA tensors (DTensor's own, the
    functional op, ends the process on them)."""
    from torch.distributed.tensor import Shard

    from repro_torch.sharding import tp

    local, mesh = t.to_local(), t.device_mesh
    for i, pl in enumerate(t.placements):
        if isinstance(pl, Shard) and mesh.size(i) > 1:
            local = tp._all_gather(local, pl.dim, tp.Group(mesh.get_group(i), mesh.get_local_rank(i), mesh.size(i)))
    return local


@contextlib.contextmanager
def tp_routing(record: list):
    """Each MoE routing while open (``models/moe.py::route``), in call order: the
    top-k experts and the k + 1 largest probabilities of every token, on the host."""
    from repro_torch.models import moe

    route = moe.route

    def spy(cfg, p, xt):
        out = route(cfg, p, xt)
        record.append({"topi": out[2].cpu(), "top": out[0].topk(cfg.top_k + 1, dim=-1).values.cpu()})
        return out

    moe.route = spy
    try:
        yield record
    finally:
        moe.route = route


def tp_routing_diff(got: list, ref: list) -> dict:
    """Where two runs' MoE routings differ: the tokens whose top-k experts differ
    and, at each, the reference run's smallest gap between its k + 1 largest
    probabilities (a flip where that gap is tiny is a near-tie)."""
    if len(got) != len(ref):
        return {"calls": [len(got), len(ref)], "flips": None, "margins": None}
    margins = []
    for g, r in zip(got, ref):
        differ = (g["topi"] != r["topi"]).any(dim=-1)
        gaps = (r["top"][..., :-1] - r["top"][..., 1:]).amin(dim=-1)
        margins += gaps[differ].tolist()
    return {"calls": len(got), "tokens": sum(r["topi"][..., 0].numel() for r in ref), "flips": len(margins),
            "margins": margins}


def tp_twin_run(cfg, mesh) -> dict:
    """A prefill of TP_TWIN_DATA's tokens, then one make_train_step on the batch, over
    ``mesh``, from seed 0's params: the logits and every cache leaf (each rank's
    whole view), the metrics, the gradients AdamW was given (this rank's shards),
    each kernel's launches and plain backwards in the step, and every MoE
    routing of both (``tp_routing``)."""
    from repro_torch.models import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_prefill_step, make_train_step

    ocfg = adamw.AdamWConfig(**TRAIN_OCFG)
    batch = cuda_batch(cfg, **TP_TWIN_DATA)
    model = get_model(cfg).init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    step, _, pspecs, _, ospecs = make_train_step(cfg, mesh, ocfg)
    params = tp_place(dict(model.named_parameters()), pspecs)
    opt = tp_opt_state(params, ospecs)
    del model
    prefill, _, _ = make_prefill_step(cfg, mesh, TP_TWIN_DATA["seq_len"])
    routing = []
    with tp_routing(routing):
        logits, cache = prefill(params, {k: v for k, v in batch.items() if k != "labels"})
    flat = {"logits": tp_whole(logits)}
    flat.update({f"cache/{k}": tp_whole(v) for k, v in cache.items() if not isinstance(v, dict)})
    flat.update({f"cache/ssm/{k}": tp_whole(v) for k, v in cache.get("ssm", {}).items()})
    del logits, cache
    seen = {}
    with tp_spy_update(seen), tp_routing(routing):
        zero_counts()
        _, _, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        counts = kernel_counts()
    return {"serve": flat, "metrics": {k: v.item() for k, v in metrics.items()}, "grads": dict(seen),
            "launches": counts, "specs": {n: s.spec for n, s in pspecs.items()}, "routing": routing}


def tp_hook_cfg(name: str, layers: int, impl: str):
    """The f32 twin of ``name`` for (h); a MoE's capacity at E / K, so that no token
    drops and a microbatch routes alike on (1, 1) and (1, 2)."""
    cfg = tp_twin_cfg(name, layers, impl)
    return dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k) if cfg.family == "moe" else cfg


@contextlib.contextmanager
def tp_spy_update(seen: dict):
    """The gradients AdamW is given while open (``optim/adamw.py::update``)."""
    from repro_torch.optim import adamw

    update = adamw.update

    def spy(c, grads, state, p, **kw):
        seen.update(grads)
        return update(c, grads, state, p, **kw)

    adamw.update = spy
    try:
        yield seen
    finally:
        adamw.update = update


def tp_hook_step(cfg, compress: str, mesh=None) -> dict:
    """One f32 step from seed 0's params on TP_TWIN_DATA with TP_HOOKS and ``compress``:
    ``make_train_step`` over ``mesh``, or ``make_train_fn`` on the whole batch where
    ``mesh`` is None.  The metrics, the compressed gradients AdamW was given (a
    rank's shards on a mesh), each kernel's launches and plain backwards."""
    from repro_torch.models import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_fn, make_train_step

    ocfg = adamw.AdamWConfig(**TRAIN_OCFG)
    batch = cuda_batch(cfg, **TP_TWIN_DATA)
    model = get_model(cfg).init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    if mesh is None:
        step, params, opt = make_train_fn(cfg, ocfg, compress=compress, **TP_HOOKS), model, adamw.init(model)
    else:
        step, _, pspecs, _, ospecs = make_train_step(cfg, mesh, ocfg, compress=compress, **TP_HOOKS)
        params = tp_place(dict(model.named_parameters()), pspecs)
        opt = tp_opt_state(params, ospecs)
        del model
    seen = {}
    with tp_spy_update(seen):
        zero_counts()
        _, _, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        counts = kernel_counts()
    return {"metrics": {k: v.item() for k, v in metrics.items()}, "grads": seen, "launches": counts,
            **({} if mesh is None else {"specs": {n: s.spec for n, s in pspecs.items()}})}


def tp_hook_bounds(grads: dict, compress: str) -> dict:
    """Per stacked tensor of the reference's tree (``train/step.py::_layer_groups``), the
    boundary a compressed element may sit across: int8's quantum (its largest |g| over
    127), top-k's threshold (its least kept |g|)."""
    from repro_torch.train.step import _layer_groups

    out = {}
    for key, names in _layer_groups(grads).items():
        mags = torch.cat([grads[n].abs().reshape(-1) for n in names])
        out[key] = (mags.max() / 127 if compress == "int8" else mags[mags > 0].min()).item()
    return out


def tp_hook_compare(got: dict, ref: dict, specs: dict, mesh, compress: str) -> dict:
    """This rank's compressed gradients against the whole-batch step's (their shards):
    the elements past TP_GRAD_BAR of their leaf's largest (flips), and their share
    of all elements, each of which must sit on its tensor's boundary (int8: within
    one quantum; top-k: the larger |g| of the two within TP_GRAD_BAR of the leaf's
    largest from the threshold), and the largest error elsewhere, of the leaf's
    largest."""
    from repro_torch.sharding import rules
    from repro_torch.train.step import _layer_groups

    worst, flips, off, elements = {}, {}, 0, 0
    for key, names in _layer_groups(got["grads"]).items():
        bound = ref["bounds"][key]
        for n in names:
            g, whole = got["grads"][n], ref["grads"][n].to("cuda")
            whole = whole.to_dense() if whole.is_sparse else whole
            shard = rules.model_shard(specs[n], tuple(whole.shape), mesh)
            want = whole if shard is None else whole.narrow(*shard)
            scale = want.abs().max().clamp(min=1e-30)
            miss = (g - want).abs() > TP_GRAD_BAR * scale
            if compress == "int8":
                off += int(((g - want).abs()[miss] > bound * (1 + 1e-3)).sum())
            else:
                off += int(((torch.maximum(g.abs(), want.abs())[miss] - bound).abs() > TP_GRAD_BAR * scale).sum())
            flips[n] = int(miss.sum())
            elements += g.numel()
            worst[n] = ((g - want).abs().masked_fill(miss, 0).max() / scale).item()
    return {"grad_rel_max": max(worst.values()), "grad_rel_worst_leaf": max(worst, key=worst.get),
            "flips": sum(flips.values()), "flips_share": sum(flips.values()) / elements,
            "flips_leaves": sum(v > 0 for v in flips.values()), "flips_off_boundary": off}


def tp_decode_batch(cfg) -> tuple[dict, int]:
    """A decode twin's prompt (TP_DECODE, a vlm's patch embeddings first, an
    encoder-decoder's ``encoder_frames`` frame embeddings beside it) and the
    ``max_len`` that makes its sequence 2 x (prefix + prompt + 4) long."""
    g = torch.Generator(device="cuda").manual_seed(3)
    b, p = TP_DECODE["batch"], TP_DECODE["prompt"]
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, p), generator=g, device="cuda", dtype=torch.int32)}
    prefix = cfg.num_patches if cfg.family == "vlm" else 0
    if prefix:
        batch["patch_embeds"] = 0.02 * torch.randn((b, prefix, cfg.d_model), generator=g, device="cuda")
    if cfg.family == "encdec":
        batch["frame_embeds"] = 0.02 * torch.randn((b, cfg.encoder_frames, cfg.d_model), generator=g, device="cuda")
    return batch, 2 * (prefix + p + 4) - prefix


def tp_serve_run(cfg, mesh, batch: dict, max_len: int, steps: int, record: bool = True) -> dict:
    """``make_prefill_step``, then ``steps`` greedy ``make_decode_step`` calls over
    ``mesh``, from seed 0's params: the next tokens, each kernel's launches in the
    prefill and ``ssm_decode``'s over the decode steps, the local shape and placements of the K/V leaf (and of whisper's
    cross K/V) and the bytes of all of them, the host times and
    ``max_memory_allocated`` from the prefill on, the first step's logits and
    each step's margin between its two largest logits; with ``record``, each
    step's logits and every new cache leaf (each rank's whole view)."""
    from repro_torch.kernels.ssm_decode import ops as sd_ops
    from repro_torch.models import encdec, get_model, transformer
    from repro_torch.train.step import make_decode_step, make_prefill_step

    module = encdec if cfg.family == "encdec" else transformer
    seen, decode_step = [], module.decode_step

    def spy(*args):  # the logits of each decode step, which the step itself reduces to the next tokens
        out = decode_step(*args)
        seen.append(out[0])
        return out

    module.decode_step = spy
    try:
        prefill, _, pspecs = make_prefill_step(cfg, mesh, max_len)
        decode, _, _ = make_decode_step(cfg, mesh)
    finally:
        module.decode_step = decode_step
    model = get_model(cfg).init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    params = tp_place(dict(model.named_parameters()), pspecs)
    del model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    kv = [k for k in ("k", "v", "cross_k", "cross_v") if k in cache]
    out = {"prefill_ms_host": (time.perf_counter() - t0) * 1e3, "prefill_launches": kernel_counts(),
           **{f"{k}_local": list(cache[k].to_local().shape) for k in kv if k in ("k", "cross_k")},
           **{f"{k}_placements": [str(p) for p in cache[k].placements] for k in kv if k in ("k", "cross_k")},
           "kv_bytes": sum(cache[k].to_local().numel() * cache[k].to_local().element_size() for k in kv),
           "pos": int(cache["pos"].to_local()), "steps": [], "decode_ms_host": [], "margins": []}
    tok = torch.argmax(tp_whole(logits)[:, -1].float(), dim=-1).to(torch.int32)[:, None]
    tokens = []
    sd_before = sd_ops.LAUNCHES
    for _ in range(steps):
        seen.clear()
        t0 = time.perf_counter()
        nxt, cache = decode(params, cache, tok)
        torch.cuda.synchronize()
        out["decode_ms_host"].append((time.perf_counter() - t0) * 1e3)
        tok = tp_whole(nxt)
        tokens.append(tok)
        top2 = seen[0][:, -1].float().topk(2, dim=-1).values
        out["margins"].append((top2[:, 0] - top2[:, 1]).tolist())
        if len(tokens) == 1:
            out["first_logits"] = seen[0].float().cpu()
        if record:
            leaves = {k: v for k, v in cache.items() if not isinstance(v, dict)}
            leaves.update({f"ssm/{k}": v for k, v in cache.get("ssm", {}).items()})
            out["steps"].append({"logits": seen[0].float().cpu(), "next": tok.cpu(),
                                 "cache": {k: tp_whole(v).cpu() for k, v in leaves.items() if k != "pos"}})
    out["tokens"] = torch.cat(tokens, dim=1).cpu()
    out["decode_launches"] = {"ssm_decode": sd_ops.LAUNCHES - sd_before}
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out


def tp_serve_cfg():
    from repro_torch.configs import ARCHS

    return tp_cfg(ARCHS["qwen2.5-3b"])


def tp_serve_batch(cfg, serve: dict = TP_SERVE) -> dict:
    """The prompt of a full-width serving run (and whisper's frame embeddings)."""
    batch = cuda_batch(cfg, seq_len=serve["prompt"], global_batch=serve["batch"], seed=5)
    return {k: v for k, v in batch.items() if k != "labels"}


def tp_opt_state(params: dict, ospecs: dict) -> dict:
    """AdamW's zero state (``adamw.init``) in ``ospecs``' placements, made from the
    placed params shard by shard: no rank holds the whole state, even for a
    moment (two ranks of a 2.8 G-param model share the one card)."""
    from repro_torch.sharding import rules

    mu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
    return {"mu": mu, "nu": {n: torch.zeros_like(t) for n, t in mu.items()},
            "step": rules.distribute(torch.zeros((), dtype=torch.int32), ospecs["step"])}


def tp_place(tree: dict, specs: dict) -> dict:
    """``rules.distribute`` without its scatter from rank 0: every rank drew the same
    ``tree`` from seed 0 on the card, so each cuts its own shards from its copy and
    no byte crosses the gloo group (which stages each through host memory)."""
    from torch.distributed.tensor import distribute_tensor

    return {n: distribute_tensor(t.detach(), specs[n].mesh, specs[n].placements, src_data_rank=None)
            for n, t in tree.items()}


def tp_serve_whisper_cfg():
    from repro_torch.configs import ARCHS

    return tp_cfg(ARCHS["whisper-medium"])


def tp_moe_cfg():
    """deepseek-moe-16b at full width, TP_MOE_LAYERS deep, through flash, padded for (1, 2)."""
    from repro_torch.configs import ARCHS

    return tp_cfg(dataclasses.replace(ARCHS["deepseek-moe-16b"], num_layers=TP_MOE_LAYERS, attention_impl="flash"))


# one rank of phase_tp's (1, 2) mesh: argv = rank, port, directory of the (1, 1) references
TP_RANK = r"""
import dataclasses, json, sys, time
import numpy as np
import torch
import torch.distributed as dist
import chip_smoke as cs

rank, port, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.cuda.set_device(0)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=cs.TP_SIZE)
from repro_torch.sharding import tp

# the collectives the TP path issues, as it issues them, on CUDA tensors
out = {"rank": rank, "probe": {}}
world = tp.Group(dist.group.WORLD, rank, cs.TP_SIZE)
x = torch.full((2, 2), float(rank + 1), device="cuda")
for name, fn in (("all_reduce", lambda: tp._all_reduce(x, world)),
                 ("all_reduce_max", lambda: tp._all_reduce(x, world, "max")),
                 ("all_gather", lambda: tp._all_gather(x, -1, world)),
                 ("all_to_all", lambda: tp._all_to_all(x, world))):
    print(f"rank {rank}: probe {name}", file=sys.stderr, flush=True)
    try:
        got = fn()
        out["probe"][name] = [got.device.type, got.cpu().tolist()]
    except Exception as e:
        out["probe"][name] = f"refused: {type(e).__name__}: {e}"[:300]
want = {"all_reduce": ["cuda", [[3.0] * 2] * 2], "all_reduce_max": ["cuda", [[2.0] * 2] * 2],
        "all_gather": ["cuda", [[1.0, 1.0, 2.0, 2.0]] * 2], "all_to_all": ["cuda", [[1.0, 1.0], [2.0, 2.0]]]}
if out["probe"] != want:
    print(json.dumps(out), flush=True)
    sys.exit(3)

from repro_torch.configs import ARCHS
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model
from repro_torch.optim import adamw
from repro_torch.sharding import rules
import repro_torch.train.step as S
from repro_torch.train.step import make_train_step

mesh = make_host_mesh(model=cs.TP_SIZE, device="cuda")
out["mesh"] = rules.mesh_axes(mesh)
heads = []
ssd_scan, flash = ssd_ops.ssd_scan, fa_ops.flash_attention


def spy_ssd(x, dt, a, b, c, chunk):
    heads.append(("ssd_scan", x.shape[2], str(x.dtype)))
    return ssd_scan(x, dt, a, b, c, chunk=chunk)


def spy_flash(q, k, v, window=0):
    heads.append(("flash_attention", q.shape[2], k.shape[2], str(q.dtype)))
    return flash(q, k, v, window=window)


ssd_ops.ssd_scan, fa_ops.flash_attention = spy_ssd, spy_flash

# (b) the f32 twins against the (1, 1) mesh's step
twins = {}
for name, layers, impl in cs.TP_TWINS:
    print(f"rank {rank}: twin {name}", file=sys.stderr, flush=True)
    cfg = cs.tp_twin_cfg(name, layers, impl)
    heads.clear()
    got = cs.tp_twin_run(cfg, mesh)
    ref = torch.load(f"{tmp}/{name}.pt", map_location="cpu", mmap=True)
    worst = {}
    for n, g in got["grads"].items():
        whole = ref["grads"][n]
        shard = rules.model_shard(got["specs"][n], tuple(whole.shape), mesh)
        want_g = (whole if shard is None else whole.narrow(*shard)).to("cuda")
        worst[n] = ((g - want_g).abs().max() / want_g.abs().max().clamp(min=1e-30)).item()
    serve = {k: ((v - ref["serve"][k].to("cuda")).abs().max() / ref["serve"][k].abs().max().clamp(min=1e-30)).item()
             for k, v in got["serve"].items()}
    m, rm = got["metrics"], ref["metrics"]
    routing = cs.tp_routing_diff(got["routing"], ref["routing"])
    routing["margins"] = routing["margins"] and sorted(routing["margins"])[:20]
    twins[name] = {"layers": layers, "attention_impl": impl, "loss": [m["loss"], rm["loss"]], "routing": routing,
                   "loss_rel": abs(m["loss"] - rm["loss"]) / abs(rm["loss"]),
                   "grad_norm_rel": abs(m["grad_norm"] - rm["grad_norm"]) / rm["grad_norm"],
                   "grad_rel_max": max(worst.values()), "grad_rel_worst_leaf": max(worst, key=worst.get),
                   "split_leaves": sum(rules.model_dim(s) is not None for s in got["specs"].values()),
                   "prefill_rel": serve, "launches": got["launches"], "launches_1x1": ref["launches"],
                   "heads": sorted(set(map(tuple, heads)))}
    del got, ref
    torch.cuda.empty_cache()
out["twins"] = twins

# (h) the hooked f32 twins: accum_steps and each compress method against make_train_fn's on the whole batch
hooked = {}
for name, layers, impl in cs.TP_HOOK_TWINS:
    cfg = cs.tp_hook_cfg(name, layers, impl)
    for compress in cs.TP_COMPRESS:
        print(f"rank {rank}: hooked twin {name} {compress}", file=sys.stderr, flush=True)
        heads.clear()
        got = cs.tp_hook_step(cfg, compress, mesh)
        ref = torch.load(f"{tmp}/hook_{name}_{compress}.pt", map_location="cpu", mmap=True)
        m, rm = got["metrics"], ref["metrics"]
        hooked[f"{name}/{compress}"] = {
            "layers": layers, "loss": [m["loss"], rm["loss"]],
            "loss_rel": abs(m["loss"] - rm["loss"]) / abs(rm["loss"]),
            "grad_norm_rel": abs(m["grad_norm"] - rm["grad_norm"]) / rm["grad_norm"],
            **cs.tp_hook_compare(got, ref, got["specs"], mesh, compress),
            "launches": got["launches"], "launches_1x1": ref["launches"], "launches_plain": twins[name]["launches"],
            "heads": sorted(set(map(tuple, heads)))}
        del got, ref
        torch.cuda.empty_cache()
out["hooked"] = hooked


def rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


# (d) the f32 decode twins against the (1, 1) mesh's, step by step
decode = {}
for name, layers in cs.TP_DECODE_TWINS:
    print(f"rank {rank}: decode twin {name}", file=sys.stderr, flush=True)
    cfg = cs.tp_twin_cfg(name, layers, "xla")
    batch, max_len = cs.tp_decode_batch(cfg)
    heads.clear()
    got = cs.tp_serve_run(cfg, mesh, batch, max_len, cs.TP_DECODE["steps"])
    ref = torch.load(f"{tmp}/decode_{name}.pt", mmap=True)
    pairs = list(zip(got["steps"], ref["steps"]))
    decode[name] = {"layers": layers, "max_len": max_len, "pos": got["pos"],
                    "logits_rel": [rel(g["logits"], r["logits"]) for g, r in pairs],
                    "cache_rel": [max(rel(v, r["cache"][k]) for k, v in g["cache"].items()) for g, r in pairs],
                    "leaves": sorted(got["steps"][0]["cache"]),
                    "next_equal": [torch.equal(g["next"], r["next"]) for g, r in pairs],
                    "k_local": got["k_local"], "k_local_1x1": ref["k_local"], "k_placements": got["k_placements"],
                    **{k: v for k, v in (("cross_k_local", got.get("cross_k_local")),
                                         ("cross_k_local_1x1", ref.get("cross_k_local")),
                                         ("cross_k_placements", got.get("cross_k_placements"))) if v is not None},
                    "prefill_launches": got["prefill_launches"], "prefill_launches_1x1": ref["prefill_launches"],
                    "decode_launches": got["decode_launches"], "decode_launches_1x1": ref["decode_launches"],
                    "heads": sorted(set(map(tuple, heads)))}
    del got, ref, pairs
    torch.cuda.empty_cache()
out["decode"] = decode

# (f) qwen2.5-3b (4 x 1024 tokens) and whisper-medium (4 x 256, 1500 frames) at full width and depth,
# bf16, serving, against the (1, 1) mesh's tokens
for key, cfg, serve in (("serve", cs.tp_serve_cfg(), cs.TP_SERVE),
                        ("serve_whisper", cs.tp_serve_whisper_cfg(), cs.TP_SERVE_WHISPER)):
    print(f"rank {rank}: {key}", file=sys.stderr, flush=True)
    got = cs.tp_serve_run(cfg, mesh, cs.tp_serve_batch(cfg, serve), serve["max_len"], serve["steps"], record=False)
    ref = torch.load(f"{tmp}/{key}.pt")
    same = got["tokens"] == ref["tokens"]
    out[key] = {k: got[k] for k in ("kv_bytes", "k_local", "k_placements", "cross_k_local", "cross_k_placements",
                                    "max_memory_allocated", "prefill_ms_host", "decode_ms_host", "prefill_launches")
                if k in got}
    forks = [int(row.logical_not().nonzero()[0]) if not row.all() else None for row in same]
    out[key].update(tokens_equal=int(same.sum()), tokens=same.numel(), first_fork=forks,
                    first_step_logits_rel=rel(got["first_logits"], ref["first_logits"]),
                    logit_scale=ref["first_logits"].abs().max().item(),
                    margin_at_fork_1x1=[None if f is None else ref["margins"][f][i] for i, f in enumerate(forks)],
                    median_margin_1x1=float(np.median(ref["margins"])))
    del got
    torch.cuda.empty_cache()

# (a) mamba2-780m at full width and depth, bf16, remat: one step to warm, one measured
print(f"rank {rank}: full width", file=sys.stderr, flush=True)
cfg = rules.pad_config_for_mesh(ARCHS["mamba2-780m"], mesh)
step, _, pspecs, _, ospecs = make_train_step(cfg, mesh, adamw.AdamWConfig(**cs.TRAIN_OCFG))
model = get_model(cfg).init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
params = cs.tp_place(dict(model.named_parameters()), pspecs)
opt = cs.tp_opt_state(params, ospecs)
del model
batch = cs.cuda_batch(cfg, **cs.TRAIN_DATA)
step(params, opt, batch)
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
heads.clear()
cs.zero_counts()
t0 = time.perf_counter()
_, _, metrics = step(params, opt, batch)
torch.cuda.synchronize()
out["full"] = {"step_ms_gloo": (time.perf_counter() - t0) * 1e3, "launches": cs.kernel_counts(),
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "metrics": {k: v.item() for k, v in metrics.items()}, "heads": sorted(set(map(tuple, heads))),
               "local_bytes": sum(p.to_local().numel() * p.to_local().element_size() for p in params.values()),
               "params": sum(p.numel() for p in params.values())}

# (i) one more step on the same params and batch, two microbatches of 2 x 1024 tokens, int8-compressed
print(f"rank {rank}: full width, accumulating and compressing", file=sys.stderr, flush=True)
step, *_ = make_train_step(cfg, mesh, adamw.AdamWConfig(**cs.TRAIN_OCFG), accum_steps=2, compress="int8")
compress_ms, compress_shards = [], S._compress_shards


def timed_compress(method, grads):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = compress_shards(method, grads)
    torch.cuda.synchronize()
    compress_ms.append((time.perf_counter() - t) * 1e3)
    return out


S._compress_shards = timed_compress
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
heads.clear()
cs.zero_counts()
t0 = time.perf_counter()
_, _, metrics = step(params, opt, batch)
torch.cuda.synchronize()
S._compress_shards = compress_shards
out["full_accum"] = {"step_ms_gloo": (time.perf_counter() - t0) * 1e3, "compress_ms_gloo": compress_ms,
                     "launches": cs.kernel_counts(), "max_memory_allocated": torch.cuda.max_memory_allocated(),
                     "metrics": {k: v.item() for k, v in metrics.items()}, "heads": sorted(set(map(tuple, heads)))}
del step, params, opt, batch, metrics
torch.cuda.empty_cache()

# (g) deepseek-moe-16b at full width, TP_MOE_LAYERS of its layers, bf16, flash, remat: one warm step, one measured
print(f"rank {rank}: moe full width", file=sys.stderr, flush=True)
cfg = cs.tp_moe_cfg()
step, _, pspecs, _, ospecs = make_train_step(cfg, mesh, adamw.AdamWConfig(**cs.TRAIN_OCFG))
model = get_model(cfg).init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
params = cs.tp_place(dict(model.named_parameters()), pspecs)
del model
opt = cs.tp_opt_state(params, ospecs)
batch = cs.cuda_batch(cfg, **cs.TRAIN_DATA)
step(params, opt, batch)
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
heads.clear()
cs.zero_counts()
t0 = time.perf_counter()
_, _, metrics = step(params, opt, batch)
torch.cuda.synchronize()
out["full_moe"] = {"step_ms_gloo": (time.perf_counter() - t0) * 1e3, "launches": cs.kernel_counts(),
                   "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "metrics": {k: v.item() for k, v in metrics.items()}, "heads": sorted(set(map(tuple, heads))),
                   "local_bytes": sum(p.to_local().numel() * p.to_local().element_size() for p in params.values()),
                   "params": sum(p.numel() for p in params.values())}
print(json.dumps(out), flush=True)
dist.destroy_process_group()
"""


def phase_tp() -> dict:
    """Tensor parallelism over the model axis (``sharding/tp.py``, ROADMAP P5) on the
    card: two processes on the one H100 as the (1, 2) mesh ("data" 1, "model" 2).
    NCCL refuses two ranks on one device, so the group is ``gloo`` over CUDA
    tensors, which stages every collective through host memory: the step times
    here are not a measure of TP's speed.  Each rank first probes that gloo's
    all-reduce (sum, max) and all-gather take CUDA tensors; a refusal fails the
    phase.

    (c) the kernels at the ranks' local shapes, against their plain versions at
    the kernel bars: ``ssd_scan`` at mamba2-780m's 24 heads a rank and
    ``flash_attention`` at qwen2.5-3b's 8 q heads over 1 kv head, (c′) at
    internvl2-26b's 24 over 4 and (c″) at deepseek-moe-16b's 8 over 8, with
    their times, bounds and SDPA's.  (b) and (e) f32 twins of every family,
    full width, depth cut (TP_TWINS: internvl2-26b's with its patch prefix and
    deepseek-moe-16b through flash, whisper-medium at 2 + 2 layers with 1500
    frames): a prefill and one ``make_train_step`` on the (1, 2) mesh against
    the same on the (1, 1) mesh (this process, ``make_host_mesh()``): loss
    1e-4 rel., grad norm 1e-3 rel., each leaf's gradient (each rank's shard)
    and each prefill leaf within TP_GRAD_BAR of its largest, each kernel
    launched as often as on (1, 1), on the rank's heads; every MoE routing
    compared token by token, a token whose top-k experts differ failing the
    phase unless its (1, 1) probabilities lie within TP_ROUTER_TIE (a near
    tie, which sums in another order may flip).  (d) f32 decode twins
    (TP_DECODE_TWINS): a prefill, then 8 greedy decode steps whose ``pos``
    crosses from the first rank's half of the sequence into the second's:
    each step's next tokens equal the (1, 1) mesh's, its logits and every new
    cache leaf within TP_DECODE_BAR, and each rank's K/V leaf is (L, B, S/2,
    K, D); whisper's cross K/V (L, B, F/2, K, D), its 1500 frames split too.
    (f) qwen2.5-3b (a prefill of 4 x 1024 tokens at ``max_len`` 2048) and
    whisper-medium (4 x 256 at 512, 24 + 24 layers, 1500 frames) at full
    width and depth, bf16, 32 greedy decode steps: K/V bytes a rank (with
    whisper's cross K/V; half the (1, 1) mesh's, held),
    ``max_memory_allocated`` a rank, and how many tokens equal the (1, 1)
    mesh's (reported: bf16 reductions in another order may fork a token).
    (a) mamba2-780m at full width and depth, bf16, ``remat`` on, 4 x 1024
    tokens: one warm ``make_train_step`` per rank, 96 ``ssd_scan`` launches
    (48 layers, forward and recompute) on 24 heads and 48 plain backwards,
    each rank's ``max_memory_allocated``.  (g) deepseek-moe-16b at full width,
    TP_MOE_LAYERS of its 28 layers, bf16, flash, ``remat`` on, 4 x 1024
    tokens: one warm step per rank, 2 flash launches a layer on 8 q over 8 kv
    heads and 1 plain backward, memory a rank.  (h) f32 twins of mamba2-780m
    and deepseek-moe-16b (TP_HOOK_TWINS, the MoE's capacity at E / K so that
    no token drops) whose ``make_train_step`` takes TP_HOOKS (two microbatches
    of 1 x 512) and each of TP_COMPRESS, against ``make_train_fn`` with the same
    keywords on the whole batch in this process: loss 1e-4 rel., grad norm
    1e-3 rel., each leaf's compressed gradient (each rank's shard) within
    TP_GRAD_BAR of its largest but for at most TP_FLIPS of all elements, each
    on its tensor's rounding or threshold boundary, each kernel launched twice
    as often as in the plain twin's step, on the rank's heads.  (i) after (a),
    one more step on the same params and batch with ``accum_steps=2`` and
    ``compress="int8"``: 2 x (96 + 48) ``ssd_scan`` launches and plain
    backwards per rank, memory a rank, the compression stage's host time
    (synchronised; gloo's), the same metrics on both ranks."""
    import os
    import socket

    from repro_torch.launch.mesh import make_host_mesh

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs["ssd_scan", dtype] = check_ssd(TP_SSD_SHAPE, dtype, seed=11)
        errs["flash_attention", dtype] = check_fa(TP_FA_SHAPE, dtype, seed=12)[0]
        errs["flash_attention_vlm", dtype] = check_fa(TP_FA_VLM_SHAPE, dtype, seed=13)[0]
        errs["flash_attention_moe", dtype] = check_fa(TP_FA_MOE_SHAPE, dtype, seed=14)[0]
    kernels = {name: {"shape": shape, **{str(dt).split(".")[1]: {"max_abs_err": errs[name, dt], **t}
                                         for dt, t in timer(shape).items()}}
               for name, shape, timer in (("ssd_scan", TP_SSD_SHAPE, time_ssd),
                                          ("flash_attention", TP_FA_SHAPE, time_fa),
                                          ("flash_attention_vlm", TP_FA_VLM_SHAPE, time_fa),
                                          ("flash_attention_moe", TP_FA_MOE_SHAPE, time_fa))}

    with tempfile.TemporaryDirectory() as tmp:
        mesh = make_host_mesh()  # the (1, 1) reference
        for name, layers, impl in TP_TWINS:
            ref = tp_twin_run(tp_twin_cfg(name, layers, impl), mesh)
            torch.save({k: ref[k] for k in ("serve", "metrics", "launches", "routing")}
                       | {"grads": {n: g.cpu() for n, g in ref["grads"].items()}}, f"{tmp}/{name}.pt")
            del ref
            torch.cuda.empty_cache()
        for name, layers, impl in TP_HOOK_TWINS:
            cfg = tp_hook_cfg(name, layers, impl)
            for compress in TP_COMPRESS:
                ref = tp_hook_step(cfg, compress)
                # top-k keeps 1% of each tensor: saved sparse, a fiftieth of the bytes
                torch.save({"metrics": ref["metrics"], "launches": ref["launches"],
                            "bounds": tp_hook_bounds(ref["grads"], compress),
                            "grads": {n: (g.to_sparse() if compress == "topk" else g).cpu()
                                      for n, g in ref["grads"].items()}}, f"{tmp}/hook_{name}_{compress}.pt")
                del ref
                torch.cuda.empty_cache()
        for name, layers in TP_DECODE_TWINS:
            cfg = tp_twin_cfg(name, layers, "xla")
            torch.save(tp_serve_run(cfg, mesh, *tp_decode_batch(cfg), TP_DECODE["steps"]), f"{tmp}/decode_{name}.pt")
            torch.cuda.empty_cache()
        served = {}
        for key, cfg, spec in (("serve", tp_serve_cfg(), TP_SERVE), ("serve_whisper", tp_serve_whisper_cfg(),
                                                                     TP_SERVE_WHISPER)):
            serve = tp_serve_run(cfg, mesh, tp_serve_batch(cfg, spec), spec["max_len"], spec["steps"], record=False)
            torch.save({k: serve.pop(k) for k in ("first_logits", "margins")} | {"tokens": serve["tokens"]},
                       f"{tmp}/{key}.pt")
            serve.pop("steps")
            serve["tokens"] = serve["tokens"].numel()
            served[key] = serve
            torch.cuda.empty_cache()
        torch.distributed.destroy_process_group()  # make_host_mesh started it
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", TP_RANK, str(r), str(port), tmp], cwd=ROOT, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(TP_SIZE)]
        ranks = []
        try:
            for r, proc in enumerate(procs):
                out, err = proc.communicate(timeout=900)
                lines = out.strip().splitlines()
                if proc.returncode != 0:
                    fail(f"phase_tp rank {r} exited {proc.returncode}: {lines[-1:] if lines else ''} {err[-3000:]}")
                ranks.append(json.loads(lines[-1]))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall_s = time.perf_counter() - t0

    from repro_torch.configs import ARCHS

    cfg = ARCHS["mamba2-780m"]
    moe_cfg = tp_moe_cfg()
    for r in ranks:
        for name, twin in r["twins"].items():
            if twin["loss_rel"] > 1e-4 or twin["grad_norm_rel"] > 1e-3 or twin["grad_rel_max"] > TP_GRAD_BAR \
                    or max(twin["prefill_rel"].values()) > TP_GRAD_BAR:
                fail(f"phase_tp rank {r['rank']} f32 twin {name}: {twin} (bars: loss 1e-4, grad norm 1e-3, "
                     f"grads and prefill {TP_GRAD_BAR})")
            routing = twin["routing"]
            if routing["flips"] is None or (ARCHS[name].family == "moe") != (routing["calls"] > 0) \
                    or any(m >= TP_ROUTER_TIE for m in routing["margins"]):
                fail(f"phase_tp rank {r['rank']} f32 twin {name}: MoE routing {routing} against (1, 1) "
                     f"(a flip is a near tie only within {TP_ROUTER_TIE})")
            tcfg = ARCHS[name]
            local = {"ssd_scan": tcfg.ssm_num_heads // TP_SIZE if tcfg.ssm_state else None,
                     "flash_attention": tcfg.num_heads // TP_SIZE if twin["attention_impl"] == "flash" else None}
            # each rank launches each kernel as often as the (1, 1) step, on its own heads
            idle = any(twin["launches"][k][0] == 0 for k, h in local.items() if h)
            wrong = [h for h in twin["heads"]
                     if h[1] != local[h[0]] or h[0] == "flash_attention" and h[2] != tcfg.num_kv_heads // TP_SIZE]
            if twin["launches"] != twin["launches_1x1"] or idle or wrong:
                fail(f"phase_tp rank {r['rank']} {name}: launches {twin['launches']}, on (1, 1) "
                     f"{twin['launches_1x1']}, heads {twin['heads']}, expected {local}")
        for key, h in r["hooked"].items():
            name = key.split("/")[0]
            tcfg = ARCHS[name]
            local = {"ssd_scan": tcfg.ssm_num_heads // TP_SIZE if tcfg.ssm_state else None,
                     "flash_attention": tcfg.num_heads // TP_SIZE if tcfg.family == "moe" else None}
            # one forward a microbatch: each kernel twice as often as in the plain twin's step, on the rank's heads
            doubled = {k: [2 * v for v in h["launches_plain"][k]] for k in h["launches_plain"]}
            wrong = [x for x in h["heads"] if x[1] != local[x[0]]]
            if h["loss_rel"] > 1e-4 or h["grad_norm_rel"] > 1e-3 or h["grad_rel_max"] > TP_GRAD_BAR \
                    or h["flips_share"] > TP_FLIPS or h["flips_off_boundary"] \
                    or h["launches"] != h["launches_1x1"] or h["launches"] != doubled or wrong \
                    or not any(h["launches"][k][0] for k, v in local.items() if v):
                fail(f"phase_tp rank {r['rank']} hooked twin {key}: {h} (bars: loss 1e-4, grad norm 1e-3, grads "
                     f"{TP_GRAD_BAR} but {TP_FLIPS} of the elements on a boundary; launches twice the plain "
                     f"step's {doubled}, "
                     f"heads {local})")
        for name, d in r["decode"].items():
            tcfg = ARCHS[name]
            half = (d["max_len"] + (tcfg.num_patches if tcfg.family == "vlm" else 0)) // TP_SIZE
            ssd = tcfg.ssm_num_heads // TP_SIZE if tcfg.ssm_state else None
            if max(d["logits_rel"] + d["cache_rel"]) > TP_DECODE_BAR or not all(d["next_equal"]) \
                    or not d["pos"] < half <= d["pos"] + TP_DECODE["steps"] - 1 \
                    or d["k_local"] != [*d["k_local_1x1"][:2], half, *d["k_local_1x1"][3:]] \
                    or d["k_placements"] != ["R", "S(2)"] or d["prefill_launches"] != d["prefill_launches_1x1"] \
                    or ("cross_k_local" in d) != (tcfg.family == "encdec") \
                    or "cross_k_local" in d and (d["cross_k_placements"] != ["R", "S(2)"] or d["cross_k_local"] != [
                        *d["cross_k_local_1x1"][:2], tcfg.encoder_frames // TP_SIZE, *d["cross_k_local_1x1"][3:]]) \
                    or (d["prefill_launches"]["ssd_scan"][0] > 0) != bool(ssd) \
                    or d["decode_launches"] != d["decode_launches_1x1"] \
                    or (d["decode_launches"]["ssm_decode"] > 0) != bool(ssd) \
                    or any(h[1] != ssd for h in d["heads"]):
                fail(f"phase_tp rank {r['rank']} f32 decode twin {name}: {d} (bar {TP_DECODE_BAR}, shard {half})")
        for key, serve in served.items():
            if r[key]["kv_bytes"] * TP_SIZE != serve["kv_bytes"]:
                fail(f"phase_tp rank {r['rank']} {key}: {r[key]['kv_bytes']} K/V bytes against {serve['kv_bytes']}"
                     " on (1, 1)")
        full = r["full"]
        want = {"ssd_scan": remat_launches(cfg, cfg.num_layers), "flash_attention": [0, 0]}
        if full["launches"] != want or full["heads"] != [["ssd_scan", cfg.ssm_num_heads // TP_SIZE, "torch.bfloat16"]] \
                or not np.isfinite(full["metrics"]["loss"]) or full["metrics"] != ranks[0]["full"]["metrics"]:
            fail(f"phase_tp rank {r['rank']} full-width step: {full}, expected launches {want}")
        acc = r["full_accum"]
        want = {"ssd_scan": [2 * n for n in remat_launches(cfg, cfg.num_layers)], "flash_attention": [0, 0]}
        if acc["launches"] != want or acc["heads"] != full["heads"] or len(acc["compress_ms_gloo"]) != 1 \
                or not np.isfinite(acc["metrics"]["loss"]) or acc["metrics"] != ranks[0]["full_accum"]["metrics"]:
            fail(f"phase_tp rank {r['rank']} full-width accumulating, compressing step: {acc}, "
                 f"expected launches {want}")
        moe = r["full_moe"]
        want = {"ssd_scan": [0, 0], "flash_attention": remat_launches(moe_cfg, moe_cfg.num_layers)}
        local = ["flash_attention", moe_cfg.num_heads // TP_SIZE, moe_cfg.num_kv_heads // TP_SIZE, "torch.bfloat16"]
        if moe["launches"] != want or moe["heads"] != [local] or not np.isfinite(moe["metrics"]["loss"]) \
                or moe["metrics"] != ranks[0]["full_moe"]["metrics"]:
            fail(f"phase_tp rank {r['rank']} full-width MoE step: {moe}, expected launches {want}, heads {local}")
    return {"phase": "tp", "mesh": ranks[0]["mesh"], "backend": "gloo over CUDA tensors (two ranks on one card)",
            "probe": ranks[0]["probe"], "kernels_at_local_shapes": kernels,
            "twins": {r["rank"]: r["twins"] for r in ranks},
            "decode_twins": {r["rank"]: r["decode"] for r in ranks},
            **{key: {"arch": arch, **spec, "dtype": "bfloat16", "1x1": served[key],
                     "note": "host times stage every collective through host memory: not TP's speed",
                     **{r["rank"]: r[key] for r in ranks}}
               for key, arch, spec in (("serve", "qwen2.5-3b", TP_SERVE),
                                       ("serve_whisper", "whisper-medium", TP_SERVE_WHISPER))},
            "full": {"arch": cfg.name, "tokens_per_step": [TRAIN_DATA["global_batch"], TRAIN_DATA["seq_len"]],
                     "remat": cfg.remat,
                     "note": "step_ms_gloo stages every collective through host memory: not TP's speed",
                     **{r["rank"]: r["full"] for r in ranks}},
            "hooked_twins": {r["rank"]: r["hooked"] for r in ranks},
            "full_accum": {"arch": cfg.name, "tokens_per_step": [TRAIN_DATA["global_batch"], TRAIN_DATA["seq_len"]],
                           "accum_steps": 2, "compress": "int8", "remat": cfg.remat,
                           "note": "host times stage every collective through host memory: not TP's speed",
                           **{r["rank"]: r["full_accum"] for r in ranks}},
            "full_moe": {"arch": moe_cfg.name, "layers": [moe_cfg.num_layers, ARCHS[moe_cfg.name].num_layers],
                         "tokens_per_step": [TRAIN_DATA["global_batch"], TRAIN_DATA["seq_len"]], "remat": moe_cfg.remat,
                         "note": "step_ms_gloo stages every collective through host memory: not TP's speed",
                         **{r["rank"]: r["full_moe"] for r in ranks}},
            "wall_s": wall_s, "nvidia_smi": smi()}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.merge_runs import kernel as merge_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssm_decode import kernel as sd_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    t0 = time.perf_counter()
    kernels = {"ssd_scan": ssd_kernel, "flash_attention": fa_kernel, "merge_runs": merge_kernel,
               "decode_attention": da_kernel, "ssm_decode": sd_kernel}
    with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc per source, all at once
        list(pool.map(lambda k: k.build(), kernels.values()))
    emit({"phase": "device", "nvidia_smi": card, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0,
          "ptxas": {name: [ln.strip() for ln in _nvcc.BUILD_LOGS.get(name, "").splitlines()
                           if "registers" in ln or "spill" in ln] for name in kernels}})

    ssd_row = phase_ssd_kernel()
    fa_row = phase_fa_kernel()
    da_row = phase_decode_attention()
    sd_row = phase_ssm_decode()
    merge_row = phase_merge_kernel()
    merge_path, merge_row["launches"] = phase_merge_path()
    emit(merge_path)
    emit(phase_store())
    bench, bench_kernel_rows = phase_bench()
    emit(bench)
    serve, mamba2_launches = phase_serve_mamba2()
    emit(serve)
    forward, serve_dense, dense_launches = phase_dense()
    prof = forward["profile"]
    if not prof["flash_attention_ms"]:
        fail("the profiled forward shows no flash_attention kernel on the device")
    fa_row["forward_device_share"] = prof["flash_attention_ms"] / prof["device_busy_ms"]
    emit(forward)
    emit(serve_dense)
    hybrid, serve_hybrid, hybrid_launches = phase_hybrid()
    emit(hybrid)
    emit(serve_hybrid)
    for line in phase_families():
        emit(line)
    train, train_zamba2, train_launches = phase_train()
    emit(train)
    emit(train_zamba2)
    launch = phase_launch()
    emit(launch)
    emit(phase_dryrun())
    tp = phase_tp()
    emit(tp)
    # each kernel's launches in the counted runs of the main paths, by path
    ssd_row["launches_by_path"] = {"mamba2_serve": mamba2_launches,
                                   **{k: v["ssd_scan"] for k, v in hybrid_launches.items()},
                                   **{k: v["ssd_scan"][0] for k, v in train_launches.items()},
                                   "mamba2_launch": sum(r["ssd_scan"][0] for r in launch["steps"])}
    fa_row["launches_by_path"] = {"qwen2.5-3b_forward": dense_launches,
                                  **{k: v["flash_attention"] for k, v in hybrid_launches.items()},
                                  **{k: v["flash_attention"][0] for k, v in train_launches.items()}}
    # the tensor-parallel paths, per rank of the (1, 2) mesh: the full-width mamba2 and MoE steps and the twins
    for rank, twins in tp["twins"].items():
        ssd_row["launches_by_path"][f"mamba2_tp_train_rank{rank}"] = tp["full"][rank]["launches"]["ssd_scan"][0]
        ssd_row["launches_by_path"][f"mamba2_tp_train_accum_rank{rank}"] = \
            tp["full_accum"][rank]["launches"]["ssd_scan"][0]
        fa_row["launches_by_path"][f"moe_tp_train_rank{rank}"] = tp["full_moe"][rank]["launches"]["flash_attention"][0]
        for name, row in (("ssd_scan", ssd_row), ("flash_attention", fa_row)):
            row["launches_by_path"][f"tp_twins_rank{rank}"] = sum(t["launches"][name][0] for t in twins.values())
            row["launches_by_path"][f"tp_hooked_twins_rank{rank}"] = sum(
                h["launches"][name][0] for h in tp["hooked_twins"][rank].values())
            row["launches_by_path"][f"tp_decode_twins_rank{rank}"] = sum(
                d["prefill_launches"][name][0] for d in tp["decode_twins"][rank].values())
    for name, row in (("ssd_scan", ssd_row), ("flash_attention", fa_row)):  # the plain recomputes in training
        row["backwards_by_path"] = {k: v[name][1] for k, v in train_launches.items()}
        row["tp_local_shape"] = tp["kernels_at_local_shapes"][name]
    fa_row["tp_vlm_local_shape"] = tp["kernels_at_local_shapes"]["flash_attention_vlm"]
    fa_row["tp_moe_local_shape"] = tp["kernels_at_local_shapes"]["flash_attention_moe"]
    fa_row["launches_by_rank_vlm_twin"] = {rank: twins["internvl2-26b"]["launches"]["flash_attention"]
                                           for rank, twins in tp["twins"].items()}
    ssd_row["train_plain_backward"] = train["plain_backward"]
    for row in (ssd_row, fa_row):
        row["launches"] = sum(row["launches_by_path"].values())
    fa_row["zamba2_forward_device_share"] = hybrid["device_share"]["flash_attention"]
    ssd_row["zamba2_forward_device_share"] = hybrid["device_share"]["ssd_scan"]
    for name, row in (("ssd_scan", ssd_row), ("flash_attention", fa_row), ("merge_runs", merge_row)):
        row["bench_shape"] = bench_kernel_rows[name]
    da_row["launches_by_path"] = {"zamba2_serve": hybrid_launches["zamba2_serve"]["decode_attention"]}
    da_row["launches"] = sum(da_row["launches_by_path"].values())
    sd_row["launches_by_path"] = {"mamba2_serve": serve["ssm_decode_launches"],
                                  "zamba2_serve": hybrid_launches["zamba2_serve"]["ssm_decode"],
                                  **{f"tp_decode_twins_rank{rank}": sum(d["decode_launches"]["ssm_decode"]
                                                                        for d in twins.values())
                                     for rank, twins in tp["decode_twins"].items()}}
    sd_row["launches"] = sum(sd_row["launches_by_path"].values())
    emit({"kernels": [ssd_row, fa_row, merge_row, da_row, sd_row]})
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
