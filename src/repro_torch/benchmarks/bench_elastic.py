"""Elastic rescale: online 4→8 under sustained YCSB C vs stop-the-world.

The topology API (PR 9) lets a running fleet grow N→M with the per-leg
migrations metered by a shared device-byte budget per tick.  The pause a
client sees is bounded by the *worst single tick* of foreground device
traffic — the stop-the-world alternative charges the entire remap in one
burst.  This bench measures both over the same loaded keyspace:

* ``stw``    — ``rescale(8)`` unthrottled, drained with no serving traffic
  interleaved: its total remap bytes are the one-burst pause cost;
* ``online`` — ``rescale(8, budget=remap/16)`` with YCSB run C chunks served
  between ticks; per-tick fleet device bytes are sampled around each
  ``migration_tick`` alone, so serving reads don't pollute the pause proxy.

Claims asserted (the ISSUE's acceptance gate):
* worst-tick foreground device bytes ≤ 25%% of the stop-the-world remap;
* serving genuinely overlapped the rescale (reads landed while legs were
  in flight) and every key remained reachable afterwards;
* both paths converge to the same 8-shard topology with keys moved.
"""
from __future__ import annotations

import time

import repro_torch.api as api
from repro_torch.core.ycsb import Workload

from .common import AVG_KV, open_engine, scaled_config, tagged

MIX = "SD"
FROM_SHARDS = 4
TO_SHARDS = 8
BUDGET_DIV = 16   # online budget = stop-the-world remap bytes / 16
CHUNK = 100       # run C ops served between consecutive ticks
GATE = 0.25       # worst online tick must stay under this fraction of stw


def _open(keys: int) -> api.Engine:
    cfg = scaled_config("parallax", dataset_keys=keys, avg_kv_bytes=AVG_KV[MIX])
    return open_engine(
        cfg, partitioning=api.PartitioningConfig.parse(f"hash:{FROM_SHARDS}"))


def _load(db: api.Engine, keys: int) -> None:
    load = Workload("load_a", MIX, num_keys=keys, num_ops=0)
    api.execute(db, load.load_ops())
    db.store.flush_all()


def main(emit, smoke: bool = False) -> None:
    keys = 1500 if smoke else 6000
    num_ops = keys

    # --- stop-the-world: unthrottled remap, nothing served in between -----
    stw = _open(keys)
    _load(stw, keys)
    t0 = time.time()
    b0 = stw.store._fleet_bytes()
    stw.rescale(TO_SHARDS)
    ticks = 0
    while stw.topology()["rescale"] is not None:
        stw.migration_tick()
        ticks += 1
    stw_bytes = stw.store._fleet_bytes() - b0
    emit(f"{tagged('elastic:rescale/stw', stw)},"
         f"{1e6 * (time.time() - t0):.0f},"
         f"remap_bytes={stw_bytes};ticks={ticks};"
         f"keys_moved={stw.store.migrated_keys}")
    assert stw.topology()["shards"] == TO_SHARDS
    assert stw.store.migrated_keys > 0
    stw.close()

    # --- online: budgeted legs with YCSB run C served between ticks -------
    db = _open(keys)
    _load(db, keys)
    ops = list(Workload("run_c", MIX, num_keys=keys, num_ops=num_ops).run_ops())
    budget = max(1, stw_bytes // BUDGET_DIV)
    t0 = time.time()
    db.rescale(TO_SHARDS, budget=budget)
    worst_tick = 0
    online_ticks = 0
    served_in_flight = 0
    served = 0
    while db.topology()["rescale"] is not None or served < len(ops):
        if served < len(ops):
            chunk = ops[served:served + CHUNK]
            if db.topology()["rescale"] is not None:
                served_in_flight += len(chunk)
            api.execute(db, chunk)
            served += len(chunk)
        if db.topology()["rescale"] is not None:
            b0 = db.store._fleet_bytes()
            db.migration_tick()
            worst_tick = max(worst_tick, db.store._fleet_bytes() - b0)
            online_ticks += 1
    worst_frac = worst_tick / max(stw_bytes, 1)
    emit(f"{tagged('elastic:rescale/online', db)},"
         f"{1e6 * (time.time() - t0):.0f},"
         f"budget={budget};worst_tick={worst_tick};ticks={online_ticks};"
         f"keys_moved={db.store.migrated_keys};served_in_flight={served_in_flight}")

    # claim 1: the per-tick pause proxy stays under the gate fraction
    assert worst_tick <= GATE * stw_bytes, (worst_tick, stw_bytes)
    # claim 2: serving genuinely overlapped the in-flight legs
    assert served_in_flight > 0 and online_ticks > 1
    # claim 3: same destination topology, every key still reachable
    topo = db.topology()
    assert topo["shards"] == TO_SHARDS and topo["rescale"] is None
    assert db.store.migrated_keys > 0
    assert len(db.scan(b"", keys + 8)) == keys
    emit(f"elastic/claims,0,"
         f"worst_frac={worst_frac:.4f};gate={GATE};served_ops={served};"
         f"shards={topo['shards']}")
    db.close()
