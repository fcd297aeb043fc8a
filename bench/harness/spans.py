"""The benchmark's spans: wrappers around the calls into the program's layers.

With ``sync`` off (the end-to-end runs) a wrapper only notes when a call
starts, which costs no synchronisation: the serving loop reads each token's
arrival on the host from it.  With ``sync`` on (the traced runs) each call is
timed between two ``torch.cuda.synchronize()``, as ``chip_smoke.py::serve_batches``
times prefill and decode, and marked for the profiler by name.
"""
from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext

import torch


class Spans:
    def __init__(self, sync: bool, device_type: str = "cuda"):
        self.sync = sync and device_type == "cuda"
        self.durations: dict[str, list[float]] = {}
        self.starts: dict[str, list[float]] = {}

    def snapshot(self) -> "Spans":
        """A copy of what was recorded so far, which later calls do not change."""
        copy = Spans(self.sync)
        copy.durations = {k: list(v) for k, v in self.durations.items()}
        copy.starts = {k: list(v) for k, v in self.starts.items()}
        return copy

    def reset(self) -> None:
        self.durations.clear()
        self.starts.clear()

    @contextmanager
    def timed(self, name: str):
        """A block timed like a wrapped call (``with spans.timed("step"): ...``)."""
        if self.sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}") if self.sync else nullcontext():
            yield
        if self.sync:
            torch.cuda.synchronize()
        self.durations.setdefault(name, []).append(time.perf_counter() - t0)

    def wrap(self, name: str, fn):
        """``fn`` with its start noted, and in ``sync`` mode timed as a span."""
        def run(*args, **kwargs):
            self.starts.setdefault(name, []).append(time.perf_counter())
            if not self.sync:
                return fn(*args, **kwargs)
            with self.timed(name):
                return fn(*args, **kwargs)
        return run

    def total(self, name: str) -> float:
        return sum(self.durations.get(name, ()))

    def count(self, name: str) -> int:
        return len(self.durations.get(name, ()))
