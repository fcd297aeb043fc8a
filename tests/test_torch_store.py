"""The port's store engine (``repro_torch.api`` over ``repro_torch.core``)
against the reference's, byte for byte: the same YCSB op streams, the same
results, ``StoreStats`` and ``DeviceStats``, crash and recover outcomes,
``Engine.stats()`` for the six engine combos, snapshot manifests that are
byte-identical and restore across the two packages, the same public surface,
and the fig5 smoke rows of ``BENCH_BASELINE.json``."""
import dataclasses
import inspect
from pathlib import Path

import pytest

import repro.api as japi
import repro.core as jcore
import repro_torch.api as tapi
import repro_torch.core as tcore
from repro.core import ycsb as jycsb
from repro_torch.benchmarks import bench_ycsb, common
from repro_torch.core import ycsb as tycsb

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"ref": (japi, jcore), "port": (tapi, tcore)}
# pure-Python modules the port copies as they are (their imports are relative)
COPIED = [f"core/{m}.py" for m in ("__init__", "io", "logs", "lsm", "lifetime", "metalog", "store", "ycsb",
                                   "shard", "range_shard", "exec")] + ["elastic/remap.py", "checkpoint/atomic.py"]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_the_reference(rel):
    assert (ROOT / "src" / "repro_torch" / rel).read_bytes() == (ROOT / "src" / "repro" / rel).read_bytes()


def test_namespace_packages_as_in_the_reference():
    for pkg in ("checkpoint", "elastic"):
        assert not (ROOT / "src" / "repro" / pkg / "__init__.py").exists()
        assert not (ROOT / "src" / "repro_torch" / pkg / "__init__.py").exists()


def _config(core, **kw):
    """tests/test_differential.py's small store, so flushes, compactions and
    GC all happen within a few hundred ops."""
    defaults = dict(l0_capacity=1 << 12, cache_bytes=1 << 15, segment_bytes=1 << 14, chunk_bytes=1 << 11)
    defaults.update(kw)
    if defaults.get("lifetime") is not None:
        defaults["lifetime"] = core.LifetimeConfig(**defaults["lifetime"])
    return core.StoreConfig(**defaults)


LIFETIME_SMALL = dict(window=128, adapt_every=32, min_ring=8, ring_size=32)


@pytest.mark.parametrize("mix", sorted(jycsb.MIXES))
def test_op_streams_equal(mix):
    assert tycsb.MIXES == jycsb.MIXES and tycsb.OP_MIXES == jycsb.OP_MIXES
    for phase in jycsb.OP_MIXES:
        for hot in (0.0, 0.5):
            kw = dict(num_keys=300, num_ops=400, seed=11, hot_update_frac=hot)
            jw, tw = jycsb.Workload(phase, mix, **kw), tycsb.Workload(phase, mix, **kw)
            got = [dataclasses.astuple(op) for op in tw.load_ops()] + [dataclasses.astuple(op) for op in tw.run_ops()]
            exp = [dataclasses.astuple(op) for op in jw.load_ops()] + [dataclasses.astuple(op) for op in jw.run_ops()]
            assert got == exp, (phase, hot)


def _store_state(store, nk: int):
    stats = (dataclasses.asdict(store.stats), dataclasses.asdict(store.device.stats))
    probe = [tycsb.make_key(i) for i in range(nk + 60)]
    reads = ([store.get(k) for k in probe], store.scan(b"", 2 * nk + 100),
             store.scan(tycsb.make_key(nk // 3), 40))
    return stats, reads, (dataclasses.asdict(store.stats), dataclasses.asdict(store.device.stats))


STORE_CASES = [
    ("parallax", "SD", False),
    ("parallax", "MD", True),
    ("parallax", "LD", True),
    ("rocksdb", "SD", False),
    ("blobdb", "MD", False),
    ("nomerge", "LD", False),
]


@pytest.mark.parametrize("mode,mix,lifetime", STORE_CASES)
def test_store_equal_through_ops_gc_crash_and_recover(mode, mix, lifetime):
    nk = 700
    stores = {}
    for name, (api, core) in PACKAGES.items():
        cfg = _config(core, mode=mode, lifetime=LIFETIME_SMALL if lifetime else None)
        stores[name] = api.open(api.EngineConfig(store=cfg))
    try:
        ref, port = (stores[k].store for k in ("ref", "port"))
        for phase, n in (("load_a", 0), ("run_a", 600), ("run_e", 80), ("run_b", 300)):
            for (api, _), ycsb, eng in zip(PACKAGES.values(), (jycsb, tycsb), stores.values()):
                w = ycsb.Workload(phase, mix, num_keys=nk, num_ops=n, seed=5, hot_update_frac=0.3)
                api.execute(eng, w.load_ops() if n == 0 else w.run_ops())
            assert _store_state(port, nk) == _store_state(ref, nk), phase
        # the history flushed and compacted, collected garbage in the modes that
        # run GC (rocksdb and the nomerge ideal run none), and lifetime placement adapted
        assert ref.stats.compactions > 0 and (ref.stats.gc_lookups > 0) == (mode in ("parallax", "blobdb"))
        assert (ref.stats.cutoff_adaptations > 0) == lifetime
        assert port.gc_tick(force=True) == ref.gc_tick(force=True)
        assert port.lifetime_state() == ref.lifetime_state()
        assert port.crash() == ref.crash()
        port.recover()
        ref.recover()
        assert _store_state(port, nk + 80) == _store_state(ref, nk + 80)
        assert tapi.Engine.stats(stores["port"]) == japi.Engine.stats(stores["ref"])
    finally:
        for eng in stores.values():
            eng.close()


def _engine_fleet(api, core, nk: int) -> dict:
    """tests/test_differential.py's six combos: none, hash:3, range:3 x serial, async."""
    keys = [tycsb.make_key(i) for i in range(nk)]
    part = api.PartitioningConfig.range_for_keys(keys, 3, rebalance_window=150, split_factor=1.05,
                                                 merge_factor=0.9)
    fleet = {}
    for mode in ("serial", "async"):
        fleet[f"none-{mode}"] = api.open(api.EngineConfig(store=_config(core), execution=mode))
        fleet[f"hash-{mode}"] = api.open(api.EngineConfig(
            store=_config(core, bloom_bits_per_key=10), partitioning="hash:3", execution=mode))
        fleet[f"range-{mode}"] = api.open(api.EngineConfig(
            store=_config(core, bloom_bits_per_key=10), partitioning=part, execution=mode))
    return fleet


def _drive(api, ycsb, fleet: dict, nk: int, seed: int) -> None:
    for phase, n in (("load_a", 0), ("run_a", 400), ("run_e", 60)):
        for name, eng in fleet.items():
            w = ycsb.Workload(phase, "SD", num_keys=nk, num_ops=n, seed=seed)
            api.execute(eng, w.load_ops() if n == 0 else w.run_ops(), batch_size=0 if name == "none-serial" else 32)


def test_engine_combos_equal_and_snapshots_cross_restore(tmp_path):
    nk = 600
    fleets = {name: _engine_fleet(api, core, nk) for name, (api, core) in PACKAGES.items()}
    restored = []
    try:
        _drive(japi, jycsb, fleets["ref"], nk, seed=41)
        _drive(tapi, tycsb, fleets["port"], nk, seed=41)
        assert fleets["ref"]["range-serial"].stats()["topology"]["splits"] + \
            fleets["ref"]["range-serial"].stats()["topology"]["merges"] > 0  # the rebalancer ran
        probe = [tycsb.make_key(i) for i in range(nk + 40)]
        for combo, ref in fleets["ref"].items():
            port = fleets["port"][combo]
            assert port.stats() == ref.stats(), combo
            assert [port.get(k) for k in probe] == [ref.get(k) for k in probe], combo
            assert list(port.iterator()) == list(ref.iterator()), combo
            paths = {name: str(tmp_path / f"{combo}-{name}.json") for name in PACKAGES}
            ref.snapshot(paths["ref"])
            port.snapshot(paths["port"])
            assert Path(paths["port"]).read_bytes() == Path(paths["ref"]).read_bytes(), combo
            # a manifest from either package restores in the other, to equal engines
            for api, src in ((tapi, "ref"), (japi, "port")):
                eng = api.restore(paths[src])
                restored.append(eng)
                assert [eng.get(k) for k in probe] == [ref.get(k) for k in probe], (combo, src)
                assert list(eng.iterator()) == list(ref.iterator()), (combo, src)
            again = {}
            for api, eng in zip((tapi, japi), restored[-2:]):
                again[api] = str(tmp_path / f"{combo}-{api.__name__}-again.json")
                eng.snapshot(again[api])
            assert Path(again[tapi]).read_bytes() == Path(again[japi]).read_bytes(), combo
    finally:
        for eng in restored + [e for f in fleets.values() for e in f.values()]:
            eng.close()


def _surface(module) -> dict:
    out = {}
    for name in module.__all__:
        obj = getattr(module, name)
        if inspect.isclass(obj):
            members = {m: v for m, v in vars(obj).items() if not m.startswith("_") or m == "__init__"}
            out[name] = {
                m: "<property>" if isinstance(v, property) else str(inspect.signature(v))
                for m, v in members.items() if callable(v) or isinstance(v, property)
            }
        elif callable(obj):
            out[name] = str(inspect.signature(obj))
        else:
            out[name] = repr(obj)
    return out


def test_public_surface_equals_reference():
    assert tapi.__all__ == japi.__all__
    assert _surface(tapi) == _surface(japi)
    assert tcore.__all__ == jcore.__all__
    # model.py takes tensors and a device: its vectorized functions differ by that keyword only
    port_core = {k: v for k, v in _surface(tcore).items() if k not in ("SizePolicy", "separation_benefit")}
    ref_core = {k: v for k, v in _surface(jcore).items() if k not in ("SizePolicy", "separation_benefit")}
    assert port_core == ref_core


@pytest.mark.parametrize("switch", ["config", "open", "env"])
def test_debug_checks_attach_the_ports_checkers_as_in_the_reference(monkeypatch, switch):
    """Each of the reference's three switches attaches the port's own race
    detector and protocol monitor; the run's results and stats equal the
    reference's under its checks."""
    stats = {}
    for name, (api, core) in PACKAGES.items():
        kw = dict(store=_config(core, bloom_bits_per_key=10), partitioning="range:3", execution="async")
        if switch == "env":
            monkeypatch.setenv("REPRO_DEBUG_CHECKS", "1")
            eng = api.open(api.EngineConfig(**kw))
        elif switch == "open":
            eng = api.open(debug_checks=True, **kw)
        else:
            eng = api.open(api.EngineConfig(debug_checks=True, **kw))
        with eng:
            assert type(eng.race_checker).__module__ == f"{api.__name__.split('.')[0]}.analysis.racecheck"
            assert type(eng.protocol_monitor).__module__.startswith(f"{api.__name__.split('.')[0]}.analysis.protocol")
            _drive(api, tycsb if name == "port" else jycsb, {"range-async": eng}, 300, seed=3)
            stats[name] = (eng.stats(), eng.race_checker.reports, eng.race_checker.events > 0)
    assert stats["port"] == stats["ref"]
    assert stats["ref"][1:] == ([], True)


def test_fig5_smoke_rows_equal_the_baseline():
    rows = []
    bench_ycsb.main(rows.append, smoke=True)
    assert len(rows) == 18 and all(r.startswith("fig5:SD:") for r in rows)
    assert common.baseline_mismatches(rows, ROOT / "BENCH_BASELINE.json") == []
