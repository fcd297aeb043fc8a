"""The metadata-WAL protocol as a declarative, checkable specification.

Every durability argument in ``docs/durability.md`` is phrased over the WAL
record stream: which kinds exist, what payload each carries, what order they
may appear in, and which fence (a flush, a deferred apply, a deferred
truncate) brackets each append.  Until now those rules lived in three
disconnected places — per-function ``# contract:`` annotations, the replay
switch statements, and the hand-written crash scenarios — so a new record
kind could be wired into the code while every checker stayed silent.  This
module is the single source of truth the three enforcement layers derive
from:

* :mod:`repro.analysis.protocol.static_check` proves the *code* conforms —
  every ``metalog.append`` site resolved, ordered, fenced, and schema-checked
  against :data:`WAL_SPEC` (CI hard gate via ``scripts/check_protocol.py``);
* :mod:`repro.analysis.protocol.monitor` proves each *run* conforms — the
  automaton replayed over live appends and recovery replay when
  ``EngineConfig(debug_checks=True)``;
* ``tests/test_crashpoints.py`` proves the *crash sweep* is complete — every
  non-genesis kind in the spec must appear in some scenario's site list.

The automaton is deliberately abstract: four coordinator states
(:data:`START` pre-genesis, :data:`IDLE` quiescent, :data:`LEG` one legacy
split/merge leg in flight, :data:`RESCALE` a multi-leg rescale in flight)
and per-kind transitions between them.  The monitor refines it with concrete
payload tracking (which leg, which destination shard); the static pass runs
it over feasible-state *sets* so intraprocedural paths that cannot know the
caller's state are judged against every state they could legally start in.
"""
from __future__ import annotations

import dataclasses

# ------------------------------------------------------------ abstract states
START = "START"      # no record durable yet (pre-genesis / lazy hash metalog)
IDLE = "IDLE"        # topology stable, no migration leg in flight
LEG = "LEG"          # exactly one legacy split/merge leg draining
RESCALE = "RESCALE"  # a multi-leg elastic rescale draining

STATES = (START, IDLE, LEG, RESCALE)

# -------------------------------------------------------------------- fences
#: the data a record covers must be durable (``flush_all``) before the append
FLUSH_BEFORE_APPEND = "flush-before-append"
#: the topology mutation the record describes must *follow* the append
RECORD_THEN_APPLY = "record-then-apply"
#: WAL truncation may only follow this record's append (rename-before-truncate)
TRUNCATE_AFTER_APPEND = "truncate-after-append"

FENCES = (FLUSH_BEFORE_APPEND, RECORD_THEN_APPLY, TRUNCATE_AFTER_APPEND)


@dataclasses.dataclass(frozen=True)
class RecordKind:
    """One WAL record kind: payload schema, automaton edges, fences.

    ``transitions`` is the kind's edge set over the abstract states — a
    ``(from, to)`` pair per legal occurrence.  ``required`` keys must be
    present in every record of this kind; ``optional`` keys may be; anything
    else (beyond ``"kind"`` itself) is a schema violation.  ``stream_start``
    marks kinds that may legally open a WAL stream: ``init`` at genesis,
    ``snapshot`` after truncation rooted the stream at it, ``rescale_start``
    on the hash front-end's lazily created metalog.  ``genesis`` exempts the
    kind from crash-sweep coverage (a crash at the construction-time record
    precedes all data-path work — there is no window to cover).
    """

    name: str
    required: frozenset
    optional: frozenset
    transitions: tuple
    fences: frozenset = frozenset()
    stream_start: bool = False
    genesis: bool = False
    doc: str = ""

    def step(self, states: frozenset) -> frozenset:
        """Automaton step over a feasible-state set (empty = infeasible)."""
        return frozenset(to for frm, to in self.transitions if frm in states)

    @property
    def payload_keys(self) -> frozenset:
        return self.required | self.optional | {"kind"}


class ProtocolSpec:
    """A named collection of :class:`RecordKind` forming one automaton."""

    def __init__(self, name: str, kinds: tuple):
        self.name = name
        self.kinds = {k.name: k for k in kinds}
        for k in kinds:
            for frm, to in k.transitions:
                if frm not in STATES or to not in STATES:
                    raise ValueError(f"{name}/{k.name}: unknown state in "
                                     f"transition {(frm, to)!r}")
            bad = k.fences - set(FENCES)
            if bad:
                raise ValueError(f"{name}/{k.name}: unknown fence(s) {sorted(bad)}")

    def __contains__(self, kind: str) -> bool:
        return kind in self.kinds

    def __getitem__(self, kind: str) -> RecordKind:
        return self.kinds[kind]

    @property
    def kind_names(self) -> frozenset:
        return frozenset(self.kinds)

    def stream_start_kinds(self) -> frozenset:
        return frozenset(n for n, k in self.kinds.items() if k.stream_start)

    def crash_coverage_kinds(self) -> frozenset:
        """Kinds the crash-point sweep must exercise (non-genesis)."""
        return frozenset(n for n, k in self.kinds.items() if not k.genesis)

    def initial_states(self) -> frozenset:
        """Feasible-state set for code whose entry state is unknown."""
        return frozenset(STATES)

    def step(self, states: frozenset, kind: str) -> frozenset:
        return self.kinds[kind].step(states)


def _k(name, required=(), optional=(), transitions=(), fences=(),
       stream_start=False, genesis=False, doc=""):
    return RecordKind(
        name=name, required=frozenset(required), optional=frozenset(optional),
        transitions=tuple(transitions), fences=frozenset(fences),
        stream_start=stream_start, genesis=genesis, doc=doc)


#: The shard-metadata WAL protocol (see the record table in
#: ``docs/durability.md``, whose rows map 1:1 onto these entries).
WAL_SPEC = ProtocolSpec("shard-metadata-wal", (
    _k("init",
       required=("boundaries", "shards"),
       transitions=((START, IDLE),),
       stream_start=True, genesis=True,
       doc="front-end construction: the genesis topology; only ever the "
           "first record of a stream"),
    _k("snapshot",
       required=("boundaries", "shards", "next_shard_id", "migration",
                 "cutoffs"),
       optional=("rescale",),
       # a full-state reset: legal in any live state, preserving it; also a
       # legal stream root once truncation dropped the prefix it replaces
       transitions=((START, IDLE), (IDLE, IDLE), (LEG, LEG),
                    (RESCALE, RESCALE)),
       fences=(FLUSH_BEFORE_APPEND, TRUNCATE_AFTER_APPEND),
       stream_start=True,
       doc="the whole topology in one self-contained record; every shard "
           "store flushed first, WAL truncation only after it commits"),
    _k("cutoff",
       required=("shard", "t_sm", "t_ml"),
       transitions=((IDLE, IDLE), (LEG, LEG), (RESCALE, RESCALE)),
       fences=(RECORD_THEN_APPLY,),
       doc="adaptive lifetime-cutoff cutover, journaled before the shard "
           "installs the policy; replay applies the last record per shard"),
    _k("gc_reclaim",
       required=("shard", "log", "segment"),
       transitions=((IDLE, IDLE), (LEG, LEG), (RESCALE, RESCALE)),
       fences=(FLUSH_BEFORE_APPEND,),
       doc="GC fence between relocation durability and segment reclaim; a "
           "crash here leaves both copies and newest-LSN replay picks one"),
    _k("split_start",
       required=("src", "dst", "at", "hi", "epoch"),
       transitions=((IDLE, LEG),),
       fences=(RECORD_THEN_APPLY,),
       doc="legacy single-leg split: the record is the boundary flip"),
    _k("merge_start",
       required=("src", "dst", "lo", "hi", "epoch"),
       transitions=((IDLE, LEG),),
       fences=(RECORD_THEN_APPLY,),
       doc="legacy single-leg merge: the record drops the boundary"),
    _k("rescale_start",
       required=("scheme", "from", "to", "legs"),
       optional=("boundaries", "shards", "budget"),
       # START -> RESCALE: the hash front-end creates its metalog lazily at
       # the first rescale, so this kind can legally open a stream
       transitions=((START, RESCALE), (IDLE, RESCALE)),
       fences=(RECORD_THEN_APPLY,),
       stream_start=True,
       doc="elastic N->M rescale: full post-rescale topology plus every "
           "leg in one append, before the routing flip"),
    _k("checkpoint",
       required=("cursor",),
       optional=("leg",),
       transitions=((LEG, LEG), (RESCALE, RESCALE)),
       fences=(FLUSH_BEFORE_APPEND, RECORD_THEN_APPLY),
       doc="per-batch ownership flip: the destination's logs are flushed "
           "before the record; `leg` names one of a rescale's legs"),
    _k("finish",
       required=(),
       optional=("leg",),
       transitions=((LEG, IDLE), (RESCALE, RESCALE)),
       fences=(FLUSH_BEFORE_APPEND, RECORD_THEN_APPLY),
       doc="a migration leg drained (a merge's source retires here); under "
           "a rescale the coordinator stays live until rescale_finish"),
    _k("rescale_finish",
       required=(),
       transitions=((RESCALE, IDLE),),
       fences=(RECORD_THEN_APPLY,),
       doc="the last rescale leg drained; the coordinator retires"),
))


__all__ = [
    "FENCES", "FLUSH_BEFORE_APPEND", "IDLE", "LEG", "RECORD_THEN_APPLY",
    "RESCALE", "START", "STATES", "TRUNCATE_AFTER_APPEND", "ProtocolSpec",
    "RecordKind", "WAL_SPEC",
]
