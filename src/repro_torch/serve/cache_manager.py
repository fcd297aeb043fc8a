"""Hybrid KV-cache placement for serving (the paper's idea, HBM edition).

A serving engine's KV-cache pool has the paper's exact tension: *paged*
(log-structured) placement gives allocation flexibility but needs free-list
maintenance and fragmentation GC; *contiguous in-place* slabs are scan/attend
-friendly but waste reserved space.  We classify sequences by context length
with the same thresholds-on-p structure (p = metadata / (metadata + bytes)):

* **short** contexts (p > T_SM): a fixed contiguous slab — block-table
  overhead would rival the payload (the paper's small-KV argument).
* **long** contexts (p < T_ML): the paged pool — pages reclaimed by
  free-list GC on sequence completion (the Large-log economy).
* **medium** contexts: a *transient arena* attached to the decode batch and
  reclaimed **wholesale** when the batch generation completes — no per-page
  GC walk (the transient-log economy).

The manager does placement and reclaim accounting (``stats()``: free slabs
and pages, the arena's use, per-page GC operations and wholesale reclaims);
attention kernels consume the block tables.
"""
from __future__ import annotations

import dataclasses

PAGE = 16  # tokens per page (paged pool granularity)
BLOCK_TABLE_ENTRY = 4  # bytes per page pointer
SLAB_RESERVE = 512  # tokens reserved per slab slot


@dataclasses.dataclass
class SeqAlloc:
    seq_id: int
    kind: str             # slab | transient | paged
    start: int = 0        # slab slot or arena offset (tokens)
    pages: list[int] = dataclasses.field(default_factory=list)
    length: int = 0


@dataclasses.dataclass
class CacheConfig:
    bytes_per_token: int          # 2 * K * hd * dtype * layers (model-derived)
    slab_slots: int = 64
    slab_tokens: int = SLAB_RESERVE
    arena_tokens: int = 65536
    pool_pages: int = 16384
    t_sm: float = 0.2
    t_ml: float = 0.02

    def classify(self, expected_len: int) -> str:
        meta = BLOCK_TABLE_ENTRY * max(1, expected_len // PAGE)
        payload = expected_len * self.bytes_per_token
        p = meta / (meta + payload)
        # short contexts: meta dominates relative to a slab reservation
        if expected_len <= self.slab_tokens:
            return "slab"
        if expected_len >= self.arena_tokens:
            return "paged"
        return "transient"


class HybridCacheManager:
    def __init__(self, cfg: CacheConfig):
        self.cfg = cfg
        self._free_slabs = list(range(cfg.slab_slots))
        self._arena_used = 0
        self._arena_seqs: set[int] = set()
        self._free_pages = list(range(cfg.pool_pages))
        self.allocs: dict[int, SeqAlloc] = {}
        # accounting
        self.gc_page_ops = 0
        self.wholesale_reclaims = 0

    # ------------------------------------------------------------------ admit
    def admit(self, seq_id: int, expected_len: int) -> SeqAlloc | None:
        kind = self.cfg.classify(expected_len)
        if kind == "slab":
            if not self._free_slabs:
                kind = "transient"  # overflow path
            else:
                slot = self._free_slabs.pop()
                a = SeqAlloc(seq_id, "slab", start=slot)
                self.allocs[seq_id] = a
                return a
        if kind == "transient":
            if self._arena_used + expected_len > self.cfg.arena_tokens:
                kind = "paged"      # arena full: spill to the pool
            else:
                a = SeqAlloc(seq_id, "transient", start=self._arena_used)
                self._arena_used += expected_len
                self._arena_seqs.add(seq_id)
                self.allocs[seq_id] = a
                return a
        npages = -(-expected_len // PAGE)
        if len(self._free_pages) < npages:
            return None  # admission control: no capacity
        a = SeqAlloc(seq_id, "paged", pages=[self._free_pages.pop() for _ in range(npages)])
        self.allocs[seq_id] = a
        return a

    def extend(self, seq_id: int, new_len: int) -> bool:
        """Grow a sequence during decode; paged seqs take pages on demand."""
        a = self.allocs[seq_id]
        a.length = new_len
        if a.kind == "paged" and new_len > len(a.pages) * PAGE:
            if not self._free_pages:
                return False
            a.pages.append(self._free_pages.pop())
        if a.kind == "slab" and new_len > self.cfg.slab_tokens:
            # slab overflow: promote to paged (rare by classification)
            npages = -(-new_len // PAGE)
            if len(self._free_pages) < npages:
                return False
            self._free_slabs.append(a.start)
            a.kind, a.pages = "paged", [self._free_pages.pop() for _ in range(npages)]
        return True

    # ---------------------------------------------------------------- release
    def release(self, seq_id: int) -> None:
        a = self.allocs.pop(seq_id)
        if a.kind == "slab":
            self._free_slabs.append(a.start)
        elif a.kind == "paged":
            # free-list GC: per-page reclamation (the Large-log economy)
            self.gc_page_ops += len(a.pages)
            self._free_pages.extend(a.pages)
        else:
            self._arena_seqs.discard(seq_id)
            if not self._arena_seqs:
                # wholesale arena reset — the transient-log zero-GC reclaim
                self._arena_used = 0
                self.wholesale_reclaims += 1

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict:
        return {
            "free_slabs": len(self._free_slabs),
            "free_pages": len(self._free_pages),
            "arena_used_tokens": self._arena_used,
            "gc_page_ops": self.gc_page_ops,
            "wholesale_reclaims": self.wholesale_reclaims,
            "active": len(self.allocs),
        }
