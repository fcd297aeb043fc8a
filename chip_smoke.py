#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port's serving path from the sources beside
this file, holds each against its plain PyTorch version on the card, then
serves two batches with mamba2-780m at full width (random weights from seed 0)
through ``ServeEngine`` and checks that the path went through the kernels.
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
]
# y at the reference tests' bars (f32: 2e-4, bf16: 2e-2); the state is f32 in
# both versions, so in bf16 only the order of its sums differs
TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (2e-2, 1e-3)}


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


def phase_kernels() -> dict:
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
        "kernel_ms": bf["ms"],
        "ref_ms": bf["plain_ms"],
        "shape": sh,
        "dtype": "bfloat16",
        "bytes": bf["bytes"],
        "flops": bf["flops"],
        "f32": {"max_abs_err": errs[torch.float32], "ms": f32["ms"], "plain_ms": f32["plain_ms"],
                "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"]},
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


def phase_serve() -> tuple[dict, int]:
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.models import get_model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = ARCHS["mamba2-780m"]
    params = get_model(cfg).init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = sum(p.numel() for p in params.parameters())
    model_check = check_model_f32(cfg, params)

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
    ops.LAUNCHES = 0
    for prompt_len in (1024, 1000):  # 4 chunks of 256; 1000 is padded to them
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
    launches = ops.LAUNCHES

    if launches != 2 * cfg.num_layers:
        fail(f"ssd_scan launched {launches} times in serving, expected {2 * cfg.num_layers}")
    if eng.cache_mgr.stats()["active"] != 0:
        fail(f"cache manager still holds {eng.cache_mgr.stats()['active']} sequences")
    logits = last["decode"][0]  # the step that produced each request's last token
    if logits.shape != (4, 1, cfg.vocab_padded) or torch.isnan(logits).any():
        fail(f"last logits: shape {tuple(logits.shape)} or NaN")
    steps = len(times["decode"]) // 2
    return {
        "phase": "serve",
        "arch": cfg.name,
        "params": n_params,
        "batches": batches,
        "prefill_ms": [t * 1e3 for t in times["prefill"][:2]],
        "decode_ms_per_token": [sum(times["decode"][i * steps:(i + 1) * steps]) / steps * 1e3 for i in range(2)],
        "ssd_scan_launches": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "model_check_f32": model_check,
        "nvidia_smi": smi(),
    }, launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.ssd_scan import kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    t0 = time.perf_counter()
    kernel.build()
    emit({"phase": "device", "nvidia_smi": card, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in kernel.BUILD_LOG.splitlines() if "registers" in ln]})

    ssd_row = phase_kernels()
    serve, launches = phase_serve()
    emit(serve)
    ssd_row["launches"] = launches
    emit({"kernels": [ssd_row]})
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
