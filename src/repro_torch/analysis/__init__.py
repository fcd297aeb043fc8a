"""Static + dynamic checkers for the engine's concurrency/durability contracts.

The async sharded engine's correctness rests on invariants that used to live
only in comments and after-the-fact differential tests: single-coordinator
submission, per-store exclusivity locks created coordinator-side only,
front-end counters mutated only under ``_stats_lock``, metadata-WAL
record-then-apply and flush-before-record ordering, and the determinism rules
(crc32 not ``hash()``, no wall-clock in modeled paths).  This package checks
them mechanically:

* :mod:`repro.analysis.lint` — a stdlib-``ast`` static linter with pluggable
  rules keyed on ``# contract:`` source annotations; run it as
  ``scripts/lint_contracts.py`` (a CI hard gate with a seeded-violation
  self-test under ``tests/fixtures/``).
* :mod:`repro.analysis.racecheck` — an Eraser-style dynamic lockset race
  detector, enabled with ``EngineConfig(debug_checks=True)`` or the
  ``REPRO_DEBUG_CHECKS`` env var.  Nothing here is imported unless a checker
  is switched on, so the production path provably pays nothing.
* :mod:`repro.analysis.protocol` — the metadata-WAL record protocol declared
  once (:data:`~repro.analysis.protocol.spec.WAL_SPEC`) and enforced three
  ways: a static conformance pass over every append site
  (``scripts/check_protocol.py``, a CI hard gate), a runtime stream monitor
  behind the same debug switch as the race detector, and the spec-derived
  coverage requirement of the crash-point sweep.

See ``docs/analysis.md`` for the annotation vocabulary, the protocol spec,
and how to add rules or record kinds.
"""

__all__ = ["lint", "protocol", "racecheck"]
