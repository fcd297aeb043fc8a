"""Reading a ``torch.profiler`` trace of the card, and the least time of a kernel call.

The arithmetic of the device's busy time (the union of kernel intervals), of
kernel time by name and of device time under a host op is the one
``chip_smoke.py::profile`` uses, kept here as a frozen copy.  The profiler slows
the host, so an idle share read from it is an upper bound.
"""
from __future__ import annotations

import bisect
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

from .env import PEAK_BF16_FLOPS, PEAK_HBM_BYTES


@dataclass
class Trace:
    """What the metric readers take from one profiled stretch of a run."""

    window_s: float                                          # host wall time of the profiled stretch
    busy_s: float                                            # union of the kernels' intervals
    kernel_s: dict[str, float] = field(default_factory=dict)  # device time by kernel name
    kernels: int = 0
    idle_gaps: list = field(default_factory=list)            # [[host op, s], ...] longest first
    ops: list = field(default_factory=list)                  # host ops: (start, end, name, thread), by start
    launches: list = field(default_factory=list)             # kernels: (launching op's start, its thread, s)

    def kernel_time(self, part: str) -> float:
        """Device seconds of the kernels whose name holds ``part``."""
        return sum(t for name, t in self.kernel_s.items() if part in name)

    def device_time_under(self, op: str) -> float | None:
        """Device seconds of the kernels launched inside a host op named ``op`` (its children's
        too), on the op's thread; None where the trace holds no such op."""
        spans: dict[int, list] = {}
        for start, end, name, thread in self.ops:
            if name == op:
                spans.setdefault(thread, []).append((start, end))
        if not spans:
            return None
        starts = {t: [s for s, _ in v] for t, v in spans.items()}
        total = 0.0
        for at, thread, seconds in self.launches:
            v = spans.get(thread)
            if v:
                i = bisect.bisect_right(starts[thread], at) - 1
                if i >= 0 and v[i][0] <= at <= v[i][1]:
                    total += seconds
        return total


def kernel_counts() -> dict[str, dict[str, int]]:
    """Each of the program's kernels' counters so far, by package name:
    ``repro_torch.kernels.<name>.ops``'s ``LAUNCHES`` and ``BACKWARDS``, where it has them."""
    import importlib
    import pkgutil

    import repro_torch.kernels as kernels

    out = {}
    for m in pkgutil.iter_modules(kernels.__path__):
        if not m.ispkg:
            continue
        try:
            ops = importlib.import_module(f"repro_torch.kernels.{m.name}.ops")
        except ModuleNotFoundError:
            continue
        counts = {c: getattr(ops, c) for c in ("LAUNCHES", "BACKWARDS") if isinstance(getattr(ops, c, None), int)}
        if counts:
            out[m.name] = counts
    return out


def counted(before: dict, after: dict) -> dict[str, dict[str, int]]:
    """What each kernel's counters rose by between two ``kernel_counts`` readings."""
    return {k: {c: n - before.get(k, {}).get(c, 0) for c, n in v.items()} for k, v in after.items()}


@contextmanager
def profiled(holder: dict):
    """Profile the block's CPU ops and CUDA kernels; ``holder["trace"]`` is its ``Trace`` after,
    and ``holder["kernels"]`` what each of the program's kernel counters rose by in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = kernel_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    holder["kernels"] = counted(before, kernel_counts())
    holder["trace"] = summarise(prof.profiler.kineto_results.events(), wall)


def _union(intervals):
    """(busy, gaps) of sorted (start, end) intervals: their union's length and the holes between."""
    busy, end, gaps = 0.0, None, []
    for start, stop in intervals:
        if end is not None and start > end:
            gaps.append((end, start))
        busy += max(0.0, stop - (start if end is None else max(start, end)))
        end = stop if end is None else max(end, stop)
    return busy, gaps


def summarise(events, wall_s: float) -> Trace:
    """A ``Trace`` from the profiler's raw events (nanoseconds; host and device on one clock).
    The raw events are read as they are: building the profiler's event tree takes minutes
    for a batch of decode steps."""
    from torch.autograd import DeviceType

    ops, kernels = [], []
    for e in events:
        if e.device_type() == DeviceType.CPU:
            # a host op's correlation id names it to its kernels; a runtime call (linked to its op) has none of its own
            corr = e.correlation_id() if e.linked_correlation_id() == 0 else -1
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.start_thread_id(), corr))
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            kernels.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.linked_correlation_id()))
    ops.sort(key=lambda r: (r[0], -r[1]))
    busy_ns, gaps = _union(sorted((k[0], k[1]) for k in kernels))
    by_name: dict[str, float] = {}
    for start, end, name, _ in kernels:
        by_name[name[:90]] = by_name.get(name[:90], 0.0) + (end - start) / 1e9
    launched_by = {corr: (start, thread) for start, _, _, thread, corr in ops if corr > 0}
    launches = [(*launched_by[corr], (end - start) / 1e9) for start, end, _, corr in kernels if corr in launched_by]
    ops = [op[:4] for op in ops]
    return Trace(window_s=wall_s, busy_s=busy_ns / 1e9, kernel_s=by_name, kernels=len(kernels),
                 idle_gaps=_gap_owners(gaps, ops), ops=ops, launches=launches)


def _gap_owners(gaps, cpu, top: int = 10) -> list:
    """Idle time on the device grouped by the innermost host op running at each gap's
    midpoint (on any thread; the one that started last).  One sweep: a stack of open
    ops a thread, popped as they end."""
    stacks: dict[int, list] = {}
    owners: dict[str, float] = {}
    i = 0
    for lo, hi in sorted(gaps):
        mid = (lo + hi) / 2
        while i < len(cpu) and cpu[i][0] <= mid:
            start, end, name, thread = cpu[i]
            stack = stacks.setdefault(thread, [])
            while stack and stack[-1][1] < start:
                stack.pop()
            stack.append((start, end, name))
            i += 1
        best = None
        for stack in stacks.values():
            while stack and stack[-1][1] < mid:
                stack.pop()
            if stack and (best is None or stack[-1][0] > best[0]):
                best = stack[-1]
        name = best[2] if best else "(no host op)"
        owners[name] = owners.get(name, 0.0) + (hi - lo) / 1e9
    return [[n, t] for n, t in sorted(owners.items(), key=lambda kv: -kv[1])[:top]]


def top_kernels(trace: Trace, n: int = 10) -> list:
    return [[k, t] for k, t in sorted(trace.kernel_s.items(), key=lambda kv: -kv[1])[:n]]


# ------------------------------------------------------------------ bounds
def ssd_bytes_flops(b: int, s: int, h: int, p: int, g: int, n: int, L: int, elem_bytes: int) -> tuple[int, int]:
    """Least bytes and operations of one ``ssd_scan`` call (``chip_smoke.py::ssd_bound``,
    frozen): each input read and each output written once; the operations of the
    causal half of the L x L form and of the chunk states."""
    nbytes = elem_bytes * (2 * b * s * h * p + 2 * b * s * g * n) + 4 * (b * s * h + h + b * h * p * n)
    tri = L * (L + 1) // 2
    return nbytes, b * h * (s // L) * 2 * (tri * n + tri * p + 2 * L * p * n)


def ssd_bound(b: int, s: int, h: int, p: int, g: int, n: int, L: int, elem_bytes: int) -> tuple[float, str]:
    """(least seconds, what bounds it) of one ``ssd_scan`` call at the H100's bf16 and HBM peaks."""
    nbytes, flops = ssd_bytes_flops(b, s, h, p, g, n, L, elem_bytes)
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
