"""The port's serving tier on the CPU.

The reference's cache-manager cases (``tests/test_serve.py``) and its
hypothesis property tests (``tests/test_cache_property.py``) run against
``repro_torch.serve.cache_manager``, and ``ServeEngine`` serves the reduced
config of every registered arch end to end.  The property tests skip where
``hypothesis`` is not installed; their invariants, under arbitrary
admit/extend/release interleavings:

  1. Page conservation: free + allocated pages == pool size, no double-free.
  2. Slab conservation: free + in-use slab slots == slab count.
  3. The transient arena resets to zero exactly when its last resident leaves.
  4. Admission control never corrupts state (rejected admits change nothing).
"""
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.models import get_model
from repro_torch.serve.cache_manager import CacheConfig, HybridCacheManager
from repro_torch.serve.engine import Request, ServeEngine


def test_cache_manager_placement_classes():
    cfg = CacheConfig(bytes_per_token=1024, slab_tokens=256, arena_tokens=8192)
    mgr = HybridCacheManager(cfg)
    a = mgr.admit(1, 100)       # short -> slab
    b = mgr.admit(2, 2000)      # medium -> transient arena
    c = mgr.admit(3, 20000)     # long -> paged pool
    assert (a.kind, b.kind, c.kind) == ("slab", "transient", "paged")
    assert len(c.pages) == -(-20000 // 16)


def test_cache_manager_wholesale_arena_reclaim():
    cfg = CacheConfig(bytes_per_token=64, slab_tokens=16, arena_tokens=4096)
    mgr = HybridCacheManager(cfg)
    for i in range(4):
        assert mgr.admit(i, 1000).kind == "transient"
    assert mgr.stats()["arena_used_tokens"] == 4000
    for i in range(4):
        mgr.release(i)
    s = mgr.stats()
    # zero per-page GC for mediums; one wholesale reset (the paper's economy)
    assert s["arena_used_tokens"] == 0
    assert s["wholesale_reclaims"] == 1
    assert s["gc_page_ops"] == 0


def test_cache_manager_paged_gc_and_reuse():
    cfg = CacheConfig(bytes_per_token=64, slab_tokens=16, arena_tokens=32, pool_pages=64)
    mgr = HybridCacheManager(cfg)
    a = mgr.admit(1, 512)
    assert a.kind == "paged"
    before = mgr.stats()["free_pages"]
    mgr.release(1)
    assert mgr.stats()["free_pages"] == before + len(a.pages)
    assert mgr.stats()["gc_page_ops"] == len(a.pages)
    # pages are reusable
    b = mgr.admit(2, 512)
    assert b.kind == "paged"


def test_cache_manager_slab_overflow_promotes():
    cfg = CacheConfig(bytes_per_token=64, slab_tokens=32, arena_tokens=64, pool_pages=128)
    mgr = HybridCacheManager(cfg)
    a = mgr.admit(1, 20)
    assert a.kind == "slab"
    assert mgr.extend(1, 40)  # grew past the slab: promoted to paged
    assert mgr.allocs[1].kind == "paged"


def test_admission_control():
    cfg = CacheConfig(bytes_per_token=64, slab_tokens=4, slab_slots=1, arena_tokens=8, pool_pages=2)
    mgr = HybridCacheManager(cfg)
    assert mgr.admit(1, 4096) is None  # no capacity -> rejected, not corrupted
    assert mgr.stats()["active"] == 0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_engine_end_to_end(arch):
    cfg = ARCHS[arch].reduced()
    m = get_model(cfg)
    params = m.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(cfg, params, max_len=64, batch_size=2, device="cpu")
    reqs = [
        Request(0, torch.arange(8, dtype=torch.int32) % cfg.vocab_size, max_new_tokens=6),
        Request(1, (torch.arange(8, dtype=torch.int32) + 3) % cfg.vocab_size, max_new_tokens=6),
    ]
    done = eng.run_batch(reqs)
    assert all(len(r.output) == 6 for r in done)
    assert all(0 <= t < cfg.vocab_padded for r in done for t in r.output)
    assert eng.cache_mgr.stats()["active"] == 0  # everything released


# ------------------------------------------------------- property tests
def _check_allocator(ops):
    cfg = CacheConfig(bytes_per_token=256, slab_slots=4, slab_tokens=128,
                      arena_tokens=4096, pool_pages=512)
    mgr = HybridCacheManager(cfg)
    live: dict[int, int] = {}
    for kind, sid, arg in ops:
        if kind == "admit" and sid not in live:
            a = mgr.admit(sid, arg)
            if a is not None:
                live[sid] = arg
        elif kind == "extend" and sid in live:
            a = mgr.allocs[sid]
            new_len = a.length + arg
            if mgr.extend(sid, new_len):
                live[sid] = new_len
        elif kind == "release" and sid in live:
            mgr.release(sid)
            del live[sid]
        # ---- invariants after every op
        s = mgr.stats()
        used_pages = sum(len(a.pages) for a in mgr.allocs.values())
        assert s["free_pages"] + used_pages == cfg.pool_pages
        assert len(set(mgr._free_pages)) == len(mgr._free_pages)  # no dup frees
        slab_used = sum(1 for a in mgr.allocs.values() if a.kind == "slab")
        assert s["free_slabs"] + slab_used == cfg.slab_slots
        assert s["active"] == len(live)
    # drain everything: all resources return
    for sid in list(live):
        mgr.release(sid)
    s = mgr.stats()
    assert s["free_pages"] == cfg.pool_pages
    assert s["free_slabs"] == cfg.slab_slots
    assert s["arena_used_tokens"] == 0
    assert s["active"] == 0


def _check_classification(lens):
    cfg = CacheConfig(bytes_per_token=512)
    for ln in lens:
        assert cfg.classify(ln) in ("slab", "transient", "paged")
    # monotone: longer contexts never move toward slab
    order = {"slab": 0, "transient": 1, "paged": 2}
    classes = [order[cfg.classify(ln)] for ln in sorted(lens)]
    assert classes == sorted(classes)


def test_allocator_invariants():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies
    ops = st.lists(
        st.one_of(
            st.tuples(st.just("admit"), st.integers(0, 15), st.integers(1, 40_000)),
            st.tuples(st.just("extend"), st.integers(0, 15), st.integers(1, 2_000)),
            st.tuples(st.just("release"), st.integers(0, 15), st.just(0)),
        ),
        min_size=1,
        max_size=120,
    )
    settings = hyp.settings(max_examples=120, deadline=None, suppress_health_check=[hyp.HealthCheck.too_slow])
    settings(hyp.given(ops=ops)(_check_allocator))()


def test_classification_total():
    hyp = pytest.importorskip("hypothesis")
    lens = hyp.strategies.lists(hyp.strategies.integers(1, 100_000), min_size=1, max_size=30)
    hyp.settings(max_examples=60, deadline=None)(hyp.given(lens=lens)(_check_classification))()
