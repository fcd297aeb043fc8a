"""The program's own spans in a profiled stretch.

The program marks its layer boundaries with ``torch.profiler`` ranges
(``repro_torch.obs.span``: ``serve.*``, ``model.*``, ``train.*``), which the
trace holds as host ops on the device's clock.  A program without them (an
older commit) leaves nothing to find here, and each reader then returns None.
"""
from __future__ import annotations

import bisect

from .trace import Trace


def _holder(ranges: list, at: int) -> tuple | None:
    """The one of the sorted, non-overlapping ``ranges`` that holds the instant ``at``, if any."""
    i = bisect.bisect_right(ranges, (at, float("inf"))) - 1
    return ranges[i] if i >= 0 and ranges[i][0] <= at <= ranges[i][1] else None


def ranges(trace: Trace, name: str, within: dict | None = None) -> dict[int, list]:
    """The ranges named ``name``, as {thread: [(start, end), ...] by start}; with ``within``
    (ranges by thread), only those that start inside one of them on the same thread."""
    out: dict[int, list] = {}
    for start, end, op, thread in trace.ops:
        if op == name and (within is None or _holder(within.get(thread, []), start)):
            out.setdefault(thread, []).append((start, end))
    return out


def launched(trace: Trace, spans: dict) -> list[float]:
    """The device seconds of each operation (kernel, copy or set) launched inside one of
    ``spans`` on its thread."""
    return [seconds for at, thread, seconds in trace.launches if _holder(spans.get(thread, []), at)]


def launches_each(trace: Trace, spans: dict) -> list[int]:
    """The number of device operations launched inside each of ``spans``, on its thread."""
    counts = {(thread, r): 0 for thread, v in spans.items() for r in v}
    for at, thread, _ in trace.launches:
        r = _holder(spans.get(thread, []), at)
        if r is not None:
            counts[(thread, r)] += 1
    return list(counts.values())
