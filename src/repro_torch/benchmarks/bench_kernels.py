"""Kernel microbenchmarks at the reference's bench shapes (``benchmarks/bench_kernels.py``).

On the card each row runs the port's CUDA kernel at the full bench shape,
holds it to its plain PyTorch version on the same inputs at the reference
tests' bars (flash f32 2e-5; ssd f32 2e-4 with ``chunk=128``; merge keys and
payloads exact) and reports the kernel's time (``kernel_us``, CUDA events)
beside the plain version's throughput (``gflops_oracle``,
``tokens_per_s_oracle``, ``keys_per_s_oracle``), as the reference reports its
oracle's.  Each row names what ran: ``impl=cuda``.  On the CPU, asked for with
``device="cpu"``, only the plain version runs: the row says ``impl=plain``
and carries no kernel error.  A kernel that fails to build or launch raises.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.merge_runs import ops as merge_ops
from repro_torch.kernels.merge_runs.ref import merge_runs_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

FLASH_SHAPE = dict(b=1, s=1024, h=8, kh=2, d=64)  # serving-like
SSD_SHAPE = dict(b=2, s=2048, h=8, p=64, g=1, n=64, L=128)  # a mamba2-like head block
MERGE_SHAPE = dict(g=64, t=512)  # compaction tiles
FLASH_TOL = 2e-5
SSD_TOL = 2e-4
REPS = 5  # timed calls after one warm-up call


def timeit(fn, device: str, reps: int = REPS) -> tuple[float, object]:
    """Seconds per call of ``fn`` after one warm-up call: CUDA events on the
    card, the host clock on the CPU."""
    out = fn()
    if device == "cpu":
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        return (time.perf_counter() - t0) / reps, out
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps, out


def main(emit, device: str = "cuda") -> None:
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available; pass device='cpu' to run the plain versions explicitly")
    on_card = device != "cpu"
    impl = f";impl={'cuda' if on_card else 'plain'}"
    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(device)

    # flash attention: serving-like shape
    b, s, h, kh, d = FLASH_SHAPE.values()
    q, k, v = randn(b, s, h, d), randn(b, s, kh, d), randn(b, s, kh, d)
    tref, ref = timeit(lambda: flash_attention_ref(q, k, v), device)
    flops = 4 * b * s * s // 2 * h * d
    row = f"kernel:flash_attn_b{b}s{s}h{h}d{d},{tref*1e6:.1f},gflops_oracle={flops/tref/1e9:.1f}"
    if on_card:
        tk, out = timeit(lambda: fa_ops.flash_attention(q, k, v), device)
        err = (out - ref).abs().max().item()
        assert torch.allclose(out, ref, atol=FLASH_TOL, rtol=FLASH_TOL), f"flash_attention kernel err {err}"
        row += f";kernel_err={err:.1e};kernel_us={tk*1e6:.1f}"
    emit(row + impl)

    # ssd scan: mamba2-like head block
    b, s, hh, p, gg, n, L = SSD_SHAPE.values()
    x = randn(b, s, hh, p)
    dt = torch.nn.functional.softplus(randn(b, s, hh)) * 0.5
    a = -torch.exp(randn(hh, scale=0.3))
    bm, cm = randn(b, s, gg, n, scale=0.5), randn(b, s, gg, n, scale=0.5)
    tref, (yref, sref) = timeit(lambda: ssd_scan_ref(x, dt, a, bm, cm, chunk=L), device)
    row = f"kernel:ssd_scan_b{b}s{s}h{hh}p{p}n{n},{tref*1e6:.1f},tokens_per_s_oracle={b*s/tref:.0f}"
    if on_card:
        tk, (y, st) = timeit(lambda: ssd_ops.ssd_scan(x, dt, a, bm, cm, chunk=L), device)
        err = max((y - yref).abs().max().item(), (st - sref).abs().max().item())
        assert torch.allclose(y, yref, atol=SSD_TOL, rtol=SSD_TOL), f"ssd_scan kernel y err {err}"
        assert torch.allclose(st, sref, atol=SSD_TOL, rtol=SSD_TOL), f"ssd_scan kernel state err {err}"
        row += f";kernel_err={err:.1e};kernel_us={tk*1e6:.1f}"
    emit(row + impl)

    # merge runs: compaction tile merge
    g_, t_ = MERGE_SHAPE.values()
    rng = np.random.default_rng(0)
    ak, bk = (torch.from_numpy(np.sort(rng.integers(0, 1 << 30, (g_, t_)).astype(np.int32), axis=1)).to(device)
              for _ in range(2))
    av, bv = (torch.from_numpy(rng.integers(0, 1 << 30, (g_, t_)).astype(np.int32)).to(device) for _ in range(2))
    tref, (rk, rv) = timeit(lambda: merge_runs_ref(ak, bk, av, bv), device)
    row = f"kernel:merge_runs_g{g_}t{t_},{tref*1e6:.1f},keys_per_s_oracle={g_ * 2 * t_ / tref / 1e6:.1f}M"
    if on_card:
        tk, (ok, ov) = timeit(lambda: merge_ops.merge_tiles(ak, bk, av, bv, impl="cuda"), device)
        exact = torch.equal(ok, rk) and torch.equal(ov, rv)
        assert exact, "merge_runs kernel: keys or payloads differ from the plain version"
        row += f";kernel_exact={exact};kernel_us={tk*1e6:.1f}"
    emit(row + impl)
