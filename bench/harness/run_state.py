"""What one run hands to the metric readers and to the result line."""
from __future__ import annotations

from dataclasses import dataclass, field

from .spans import Spans
from .trace import Trace


@dataclass
class Run:
    """One run of a cell.  ``spans`` cover the measured window; ``trace`` the profiled
    stretch that follows it (traced runs only); ``info`` the counts the readers need:
    operations and shapes worked out from the benchmark's own weights and traffic."""

    spans: Spans
    trace: Trace | None = None
    info: dict = field(default_factory=dict)
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    end_to_end: dict = field(default_factory=dict)   # {metric: value}
    checks: dict = field(default_factory=dict)       # {number compared: (value, limit)}
    memory_peak: int = 0
    notes: list = field(default_factory=list)        # why a run is not correct, beside its checks
    served: list = field(default_factory=list)       # serving: (prompt, tokens) of each finished request
    checked: list = field(default_factory=list)      # serving: the indices of ``served`` held to the reference
    reference: dict = field(default_factory=dict)    # training: the reference's readings

    @property
    def correct(self) -> bool:
        return not self.notes and bool(self.checks) and all(v <= lim for v, lim in self.checks.values())
