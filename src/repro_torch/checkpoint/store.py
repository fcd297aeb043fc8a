"""Log-structured incremental checkpointing — the paper's technique as a
first-class training substrate.

Checkpoint state is a KV store problem: keys are tensor paths + shard ids,
values are shard bytes, and every training step *updates* every key — the
update-heavy workload where the paper shows naive KV separation drowns in GC
and naive in-place writes drown in write amplification.  We apply Parallax's
hybrid placement verbatim, with ``p = manifest_entry / (manifest_entry +
payload)``:

* **small** tensors (scalars, norm gains; p > T_SM): inlined in the manifest
  ("in place") — a log pointer would cost as much as the data.
* **large** tensors (embeddings, FFN shards; p < T_ML): appended to a value
  log with per-segment garbage accounting and threshold GC, exactly like the
  paper's Large log.
* **medium** tensors: a *transient log* reclaimed wholesale at every
  consolidation ("last-level compaction") — zero GC walks.

Incremental checkpoints append only changed tensors; ``consolidate()`` is the
last-level compaction: it rewrites live state into a fresh generation and
reclaims every transient segment.  Recovery replays manifests by LSN and
tolerates torn tails (paper §3.4 semantics: recover to a consistent,
possibly-not-last, step).

The same byte-accounting Device model used by the reproduction quantifies
write amplification, so EXPERIMENTS.md can compare hybrid placement against
all-inline and all-log checkpointing on real training traces.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct

import numpy as np

from repro_torch.core.io import Device
from repro_torch.core.model import SizePolicy

from .atomic import atomic_write_bytes

MANIFEST_ENTRY = 64  # key path + offset + len + lsn + crc


@dataclasses.dataclass
class _Entry:
    lsn: int
    step: int
    kind: str          # inline | log | transient
    payload: bytes | None = None   # inline
    segment: int = -1              # log/transient
    offset: int = 0
    length: int = 0


class LogStructuredCheckpointer:
    """Single-host checkpoint region (per host-slice in multi-host runs).

    ``directory`` layout:
        MANIFEST            — append-only JSON-lines redo log (LSN ordered)
        seg-<n>.log         — 2 MB-aligned value-log segments (large tensors)
        tseg-<n>.log        — transient segments (medium tensors)
        gen-<n>/            — consolidated generations (last-level)
    """

    def __init__(
        self,
        directory: str,
        *,
        policy: SizePolicy | None = None,
        t_sm: float = 0.2,
        t_ml: float = 0.02,
        gc_threshold: float = 0.10,
        consolidate_every: int = 8,
        mode: str = "hybrid",  # hybrid | inline (RocksDB-like) | log (BlobDB-like)
    ):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.policy = policy or SizePolicy(t_sm=t_sm, t_ml=t_ml, prefix_size=MANIFEST_ENTRY, pointer_size=16)
        self.gc_threshold = gc_threshold
        self.consolidate_every = consolidate_every
        self.mode = mode
        self.device = Device(cache_bytes=0)
        self.lsn = 0
        self.index: dict[str, _Entry] = {}
        self._seg_live: dict[int, int] = {}
        self._seg_dead: dict[int, int] = {}
        self._seg_size: dict[int, int] = {}
        self._next_seg = 0
        self._tseg_entries: dict[int, int] = {}
        self._next_tseg = 0
        self._steps_since_consolidate = 0
        self.app_bytes = 0

    # ---------------------------------------------------------- classification
    def _classify(self, nbytes: int) -> str:
        if self.mode == "inline":
            return "inline"
        if self.mode == "log":
            return "log"
        p = MANIFEST_ENTRY / (MANIFEST_ENTRY + nbytes)
        if p > self.policy.t_sm:
            return "inline"
        if p < self.policy.t_ml:
            return "log"
        return "transient"

    # ----------------------------------------------------------------- writes
    def save(self, step: int, tree: dict[str, np.ndarray], *, changed: set[str] | None = None) -> dict:
        """Incremental checkpoint: write (changed) tensors + manifest record.

        Both new segment files are published atomically (buffered in full,
        then write-temp/fsync/rename) and the manifest append is fsync'd, so
        a crash mid-save leaves either no trace of the step or complete
        payload files — never a torn segment a later restore would trip on
        (a torn manifest *tail* is fine: restore stops at the last durable
        record, and its payload files were renamed into place first).
        """
        manifest_records = []
        seg_buf = bytearray()
        seg_id = None
        tseg_buf = bytearray()
        tseg_id = None
        for key in sorted(tree):
            if changed is not None and key not in changed and key in self.index:
                continue
            arr = np.asarray(tree[key])
            payload = arr.tobytes() + _meta(arr)
            self.app_bytes += len(payload)
            self.lsn += 1
            kind = self._classify(len(payload))
            old = self.index.get(key)
            if old is not None and old.kind == "log":
                self._seg_dead[old.segment] = self._seg_dead.get(old.segment, 0) + old.length
            if kind == "inline":
                e = _Entry(self.lsn, step, "inline", payload=payload)
                self.device.sequential_write(len(payload) + MANIFEST_ENTRY, 1 << 18, kind="log")
            elif kind == "log":
                if seg_id is None:
                    seg_id = self._next_seg
                    self._next_seg += 1
                off = len(seg_buf)
                seg_buf += payload
                e = _Entry(self.lsn, step, "log", segment=seg_id, offset=off, length=len(payload))
                self._seg_live[seg_id] = self._seg_live.get(seg_id, 0) + len(payload)
                self._seg_size[seg_id] = self._seg_size.get(seg_id, 0) + len(payload)
                self.device.sequential_write(len(payload), 1 << 18, kind="log")
            else:  # transient
                if tseg_id is None:
                    tseg_id = self._next_tseg
                    self._next_tseg += 1
                off = len(tseg_buf)
                tseg_buf += payload
                e = _Entry(self.lsn, step, "transient", segment=tseg_id, offset=off, length=len(payload))
                self._tseg_entries[tseg_id] = self._tseg_entries.get(tseg_id, 0) + 1
                self.device.sequential_write(len(payload), 1 << 18, kind="log")
            self.index[key] = e
            manifest_records.append(_manifest_row(key, e))
        # payloads become durable before the manifest records that point at
        # them (flush-before-record, file edition)
        if seg_id is not None:
            atomic_write_bytes(os.path.join(self.dir, f"seg-{seg_id}.log"), bytes(seg_buf))
        if tseg_id is not None:
            atomic_write_bytes(os.path.join(self.dir, f"tseg-{tseg_id}.log"), bytes(tseg_buf))
        self._append_manifest(manifest_records)
        self.device.sequential_write(len(manifest_records) * MANIFEST_ENTRY, 4096, kind="log")
        self._steps_since_consolidate += 1
        stats = {"written": len(manifest_records), "step": step}
        if self._steps_since_consolidate >= self.consolidate_every:
            stats["consolidated"] = True
            self.consolidate(step)
        self.gc_tick()
        return stats

    def _append_manifest(self, rows: list[dict]) -> None:
        """Durably append manifest records (fsync'd group commit).

        A crash can still tear the appended *tail* — that is the torn-tail
        window restore's JSON replay tolerates by design — but an acked save
        is never lost, and the rows land only after their payload files were
        atomically renamed into place.
        """
        if not rows:
            return
        with open(os.path.join(self.dir, "MANIFEST"), "a") as mf:
            for r in rows:
                mf.write(json.dumps(r) + "\n")
            mf.flush()
            os.fsync(mf.fileno())

    # ----------------------------------------------- last-level consolidation
    def consolidate(self, step: int) -> None:
        """The 'last-level compaction': rewrite live state into gen-<step>,
        reclaim ALL transient segments wholesale (no GC walk), and start a
        fresh manifest.

        Rename-before-truncate ordering: the generation file and the rewritten
        MANIFEST are each published atomically (temp/fsync/rename), and only
        after the new MANIFEST is in place are the transient segments and old
        generations it no longer references destroyed.  A crash anywhere
        leaves either the old MANIFEST (pointing at still-present old files)
        or the new one (pointing at the complete new generation).
        """
        gen_dir = os.path.join(self.dir, f"gen-{step}")
        os.makedirs(gen_dir, exist_ok=True)
        rows = []
        data_buf = bytearray()
        for key, e in sorted(self.index.items()):
            payload = self._read_entry(e)
            if e.kind in ("transient", "gen"):
                # merged in place into the (new) generation file; old
                # generations are deleted below, so 'gen' entries move too
                off = len(data_buf)
                data_buf += payload
                self.device.sequential_write(len(payload), 1 << 21, kind="compaction")
                ne = _Entry(e.lsn, e.step, "gen", segment=step, offset=off, length=len(payload))
            else:
                # inline stays in the manifest; large stays in the value
                # log (its GC handles reclamation)
                ne = e
            self.index[key] = ne
            rows.append(_manifest_row(key, ne))
        atomic_write_bytes(os.path.join(gen_dir, "data.bin"), bytes(data_buf))
        manifest = [json.dumps({"consolidated": step})]
        manifest.extend(json.dumps(r) for r in rows)
        atomic_write_bytes(os.path.join(self.dir, "MANIFEST"),
                           ("\n".join(manifest) + "\n").encode())
        # wholesale transient reclaim — the paper's zero-GC medium path
        for t in list(self._tseg_entries):
            path = os.path.join(self.dir, f"tseg-{t}.log")
            if os.path.exists(path):
                os.unlink(path)
        self._tseg_entries.clear()
        # drop superseded generations
        for d in os.listdir(self.dir):
            if d.startswith("gen-") and d != f"gen-{step}":
                for f in os.listdir(os.path.join(self.dir, d)):
                    os.unlink(os.path.join(self.dir, d, f))
                os.rmdir(os.path.join(self.dir, d))
        self._steps_since_consolidate = 0

    # --------------------------------------------------------------------- GC
    def gc_tick(self) -> int:
        """Threshold GC for the large-tensor value log (paper §3.2).

        Relocation is rename-before-truncate: each surviving payload is
        published in a fresh atomically-written segment and its new location
        durably appended to the MANIFEST *before* the victim segment is
        unlinked — previously the on-disk manifest kept pointing at the
        unlinked file, so any restore after a GC of a mixed live/dead
        segment failed with a missing payload.
        """
        reclaimed = 0
        live_by_seg: dict[int, list[str]] = {}
        for k, e in self.index.items():
            if e.kind == "log":
                live_by_seg.setdefault(e.segment, []).append(k)
        for seg, size in list(self._seg_size.items()):
            dead = self._seg_dead.get(seg, 0)
            if size == 0 or dead / size < self.gc_threshold:
                continue
            self.device.sequential_read(size, 1 << 21, kind="gc")
            moved_rows = []
            for k in live_by_seg.get(seg, []):
                e = self.index[k]
                payload = self._read_entry(e)
                nseg = self._next_seg
                self._next_seg += 1
                atomic_write_bytes(os.path.join(self.dir, f"seg-{nseg}.log"), payload)
                self.device.sequential_write(len(payload), 1 << 18, kind="gc")
                ne = _Entry(e.lsn, e.step, "log", segment=nseg, offset=0, length=len(payload))
                self.index[k] = ne
                self._seg_live[nseg] = len(payload)
                self._seg_size[nseg] = len(payload)
                moved_rows.append(_manifest_row(k, ne))
            self._append_manifest(moved_rows)
            self.device.sequential_write(len(moved_rows) * MANIFEST_ENTRY, 4096, kind="gc")
            path = os.path.join(self.dir, f"seg-{seg}.log")
            if os.path.exists(path):
                os.unlink(path)
            self._seg_size.pop(seg, None)
            self._seg_live.pop(seg, None)
            self._seg_dead.pop(seg, None)
            reclaimed += 1
        return reclaimed

    # ----------------------------------------------------------------- reads
    def _read_entry(self, e: _Entry) -> bytes:
        if e.kind == "inline":
            return e.payload or b""
        if e.kind == "gen":
            path = os.path.join(self.dir, f"gen-{e.segment}", "data.bin")
        elif e.kind == "transient":
            path = os.path.join(self.dir, f"tseg-{e.segment}.log")
        else:
            path = os.path.join(self.dir, f"seg-{e.segment}.log")
        with open(path, "rb") as f:
            f.seek(e.offset)
            return f.read(e.length)

    def restore(self) -> tuple[dict[str, np.ndarray], int]:
        """Replay the manifest (LSN order), falling back step by step.

        Two corruption classes are survivable by construction (paper §3.4:
        recover to a consistent, possibly-not-last, step):

        * a torn manifest *tail* — the JSON replay stops at the last durable
          record;
        * a torn or missing *payload file* (e.g. a segment truncated by a
          crash that predates the atomic-rename discipline) — the replay is
          retried at descending step cutoffs, dropping the newest step's
          records each time, until every referenced payload reads back
          intact.  Earlier rows for the same keys (the previous consistent
          step) win again, exactly as if the bad step had never been saved.

        Raises ``RuntimeError`` only when no cutoff yields a fully readable
        tree — e.g. a shard payload deleted outright, which must fail loudly
        rather than restore zeros.
        """
        self.index.clear()
        path = os.path.join(self.dir, "MANIFEST")
        rows = []
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    try:
                        rows.append(json.loads(line))
                    except json.JSONDecodeError:
                        break  # torn tail: stop at the last durable record
        data_rows = [r for r in rows if "consolidated" not in r]
        cutoffs = sorted({r["step"] for r in data_rows}, reverse=True) or [0]
        first_err: tuple[str, Exception] | None = None
        for cutoff in cutoffs:
            index: dict[str, _Entry] = {}
            step = 0
            for r in data_rows:
                if r["step"] > cutoff:
                    continue
                e = _Entry(r["lsn"], r["step"], r["kind"], segment=r.get("segment", -1),
                           offset=r.get("offset", 0), length=r.get("length", 0))
                if r["kind"] == "inline":
                    e.payload = bytes.fromhex(r["payload"])
                index[r["key"]] = e
                step = max(step, r["step"])
            out = {}
            try:
                for k, e in index.items():
                    out[k] = _unmeta(self._read_entry(e))
            except (FileNotFoundError, ValueError, struct.error) as err:
                if first_err is None:
                    first_err = (k, err)
                continue  # torn/missing payload at this step: fall back one
            self.index = index
            return out, step
        bad = f" for {first_err[0]} ({first_err[1]})" if first_err else ""
        raise RuntimeError(f"checkpoint corrupt: missing payload{bad}")

    # ------------------------------------------------------------------ stats
    def write_amplification(self) -> float:
        return self.device.stats.total / max(self.app_bytes, 1)

    def space_bytes(self) -> int:
        total = 0
        for f in os.listdir(self.dir):
            p = os.path.join(self.dir, f)
            if os.path.isfile(p):
                total += os.path.getsize(p)
            else:
                total += sum(os.path.getsize(os.path.join(p, g)) for g in os.listdir(p))
        return total


# bfloat16 as its raw 16-bit words: numpy has no bfloat16 without ml_dtypes, which the
# port does not need.  The header names it "bfloat16", as the reference's does for an
# ml_dtypes array, and the words are the same bytes.
BF16_WORDS = np.dtype(np.uint16, metadata={"dtype": "bfloat16"})


def _meta(arr: np.ndarray) -> bytes:
    dtype = (arr.dtype.metadata or {}).get("dtype", str(arr.dtype))
    h = json.dumps({"dtype": dtype, "shape": list(arr.shape)}).encode()
    return h + struct.pack("<I", len(h))


def _unmeta(payload: bytes) -> np.ndarray:
    (hlen,) = struct.unpack("<I", payload[-4:])
    h = json.loads(payload[-4 - hlen : -4])
    data = payload[: -4 - hlen]
    dtype = BF16_WORDS if h["dtype"] == "bfloat16" else np.dtype(h["dtype"])
    return np.frombuffer(data, dtype=dtype).reshape(h["shape"]).copy()


def _manifest_row(key: str, e: _Entry) -> dict:
    row = {"key": key, "lsn": e.lsn, "step": e.step, "kind": e.kind,
           "segment": e.segment, "offset": e.offset, "length": e.length}
    if e.kind == "inline":
        row["payload"] = (e.payload or b"").hex()
    return row
