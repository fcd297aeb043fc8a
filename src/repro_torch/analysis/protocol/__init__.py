"""Spec-driven WAL protocol checking: one spec, three enforcement layers.

The metadata-WAL protocol (``docs/durability.md``) is declared once, in
:mod:`repro.analysis.protocol.spec` (:data:`~repro.analysis.protocol.spec.WAL_SPEC`:
record kinds, payload schemas, the legal ordering automaton, per-kind
fences), and enforced three ways:

* :mod:`~repro.analysis.protocol.static_check` — an ``ast`` CFG/dataflow
  pass proving the *implementation* conforms (every append site resolved,
  ordered, fenced, schema-checked); CLI: ``scripts/check_protocol.py``, a CI
  hard gate with a planted-fixture self-test.
* :mod:`~repro.analysis.protocol.monitor` — a runtime stream validator
  proving each *run* conforms, behind ``EngineConfig(debug_checks=True)``;
  never imported when checks are off.
* the crash harness (``tests/test_crashpoints.py``) derives its required
  record-kind coverage from the spec's append-site inventory, so a new kind
  without crash enumeration is a test failure, not an oversight.

Import discipline: this package (like :mod:`repro.analysis` itself) is never
imported by the engine unless a checker is switched on — keep submodule
imports lazy.
"""

__all__ = ["monitor", "spec", "static_check"]
