"""Framework-substrate benchmark (beyond paper): the paper's placement
economics applied to incremental checkpointing.  Compares write
amplification and on-disk space for hybrid / inline / log placements over a
training-like trace (large embeddings rarely change layout, medium tensors
update every step, scalars every step).

The ``ckpt:recovery`` row (PR 7, gated in the smoke baseline) measures the
snapshot/truncation win on the shard-metadata WAL: after topology churn, a
``snapshot_metadata(truncate=True)`` cuts recovery replay from the genesis
record count down to the O(delta) post-snapshot tail — the record counts are
deterministic and diffed by ``scripts/check_bench.py``; the ``*_s`` replay
timings are informational."""
from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np

from repro_torch.checkpoint.store import LogStructuredCheckpointer
from repro_torch.core import RangeShardedStore, StoreConfig
from repro_torch.core.ycsb import make_key, payload


def trace_state(rng):
    return {
        # a few large tensors (change every step — grads flow everywhere)
        **{f"block{i}/ffn": rng.standard_normal((128, 256)).astype(np.float32) for i in range(4)},
        # many medium tensors
        **{f"block{i}/norm": rng.standard_normal((96,)).astype(np.float32) for i in range(12)},
        # tiny scalars
        **{f"block{i}/step_scale": np.float32(i) for i in range(12)},
    }


def _time_replay(st: RangeShardedStore, repeats: int = 5) -> float:
    """Best-of-N wall time of one full metadata-WAL topology replay."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        st._replay_metalog()
        best = min(best, time.perf_counter() - t0)
    return best


def recovery_bench(emit, smoke: bool = False) -> None:
    """WAL-truncation economics: genesis replay vs post-snapshot replay."""
    nk = 240 if smoke else 720
    rounds = 4 if smoke else 16
    cfg = StoreConfig(l0_capacity=1 << 12, cache_bytes=1 << 15,
                      segment_bytes=1 << 14, chunk_bytes=1 << 11)
    st = RangeShardedStore.for_keys(
        [make_key(i) for i in range(nk)], 2, cfg,
        auto_rebalance=False, migration_batch_keys=16,
    )
    st.put_many([(make_key(i), payload(104)) for i in range(nk)])
    st.flush_all()
    t0 = time.time()
    for _ in range(rounds):  # topology churn: every round appends WAL records
        assert st._split(0)
        st._merge(0)
    genesis_records = st.metalog.n_records
    genesis_replay = _time_replay(st)
    st.snapshot_metadata(truncate=True)
    assert st._split(0)  # post-snapshot delta: the only history left to replay
    delta_records = st.metalog.n_records
    delta_replay = _time_replay(st)
    wall = time.time() - t0
    emit(
        f"ckpt:recovery,{1e6*wall/rounds:.1f},"
        f"genesis_records={genesis_records};delta_records={delta_records};"
        f"genesis_replay_s={genesis_replay:.6f};delta_replay_s={delta_replay:.6f};"
        f"speedup={genesis_replay/max(delta_replay, 1e-9):.1f}"
    )
    # the paper-level claim: recovery replays O(delta), not O(history)
    assert delta_records * 4 <= genesis_records, (delta_records, genesis_records)
    if not smoke:  # timing claims need scale; the smoke run only gates counts
        assert delta_replay < genesis_replay, (delta_replay, genesis_replay)


def main(emit, smoke: bool = False) -> None:
    for mode in ("hybrid", "inline", "log"):
        d = tempfile.mkdtemp(prefix=f"ckpt-{mode}-")
        try:
            ck = LogStructuredCheckpointer(d, mode=mode, consolidate_every=8)
            rng = np.random.default_rng(0)
            state = trace_state(rng)
            t0 = time.time()
            steps = 8 if smoke else 24
            for step in range(steps):
                for k in state:
                    if "ffn" in k or "norm" in k or "scale" in k:
                        state[k] = np.asarray(state[k]) * 0.999
                ck.save(step, state)
            out, got_step = ck.restore()
            assert got_step == steps - 1
            for k in state:
                np.testing.assert_allclose(out[k], state[k], rtol=1e-6)
            wall = time.time() - t0
            live = sum(np.asarray(v).nbytes for v in state.values())
            emit(
                f"ckpt:{mode},{1e6*wall/steps:.1f},write_amp={ck.write_amplification():.2f};"
                f"space_x_live={ck.space_bytes()/live:.2f};gc_reads={ck.device.stats.gc_read}"
            )
        finally:
            shutil.rmtree(d, ignore_errors=True)
    recovery_bench(emit, smoke=smoke)
