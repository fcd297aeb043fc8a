"""The port's analysis package (``repro_torch.analysis``) and ``debug_checks``
against the reference's: the copied modules byte for byte, the port's tree
linted and protocol-checked clean through the port's two CLIs, the same rule
sets on the same fixtures, and the race detector and the WAL protocol monitor
attached to the port's own classes, silent on clean engines, loud on a planted
race, and invisible when off."""
from __future__ import annotations

import json
import re
import subprocess
import sys
import threading
from pathlib import Path

import pytest

import repro.api as japi
import repro_torch.api as tapi
from repro.analysis.lint import lint_paths as ref_lint_paths
from repro.analysis.protocol import static_check as ref_static
from repro_torch.analysis.lint import lint_paths
from repro_torch.analysis.protocol import static_check
from repro_torch.analysis.racecheck import ChecksafeLock, RaceViolation
from repro.core import StoreConfig as JStoreConfig
from repro_torch.core import StoreConfig as TStoreConfig

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
ENV = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}
# stdlib-only or relative imports: copied as they are
COPIED = ["analysis/__init__.py", "analysis/contracts.py", "analysis/lint.py",
          "analysis/protocol/__init__.py", "analysis/protocol/spec.py", "analysis/protocol/monitor.py"]
# absolute imports of the package, or paths into it: equal after the rename
RENAMED = {f"src/repro_torch/{m}": f"src/repro/{m}"
           for m in ("analysis/racecheck.py", "analysis/protocol/static_check.py", "api.py")}
RENAMED.update({f"scripts/{s}_torch.py": f"scripts/{s}.py" for s in ("lint_contracts", "check_protocol")})
CLIS = {"lint": "lint_contracts", "protocol": "check_protocol"}
COMBOS = [("none", "serial"), ("none", "async"), ("hash:2", "serial"), ("hash:2", "async"),
          ("range:2", "serial"), ("range:2", "async")]


def renamed(text: str) -> str:
    """The reference's text as the port spells it: the package ``repro`` as
    ``repro_torch`` (module paths and file paths), and the reference CLIs'
    names as the port's."""
    text = re.sub(r"\brepro(?=[./])", "repro_torch", text)
    for script in CLIS.values():
        text = text.replace(f"scripts/{script}.py", f"scripts/{script}_torch.py")
    return text


@pytest.mark.parametrize("rel", COPIED)
def test_copied_analysis_module_equals_the_reference(rel):
    assert (SRC / "repro_torch" / rel).read_bytes() == (SRC / "repro" / rel).read_bytes()


@pytest.mark.parametrize("port", sorted(RENAMED))
def test_module_equals_the_reference_after_the_rename(port):
    assert (ROOT / port).read_text() == renamed((ROOT / RENAMED[port]).read_text())


def _cli(which: str, *args: str, port: bool = True) -> subprocess.CompletedProcess:
    script = ROOT / "scripts" / f"{CLIS[which]}{'_torch' if port else ''}.py"
    return subprocess.run([sys.executable, str(script), *args], capture_output=True, text=True,
                          env=ENV, timeout=120)


@pytest.mark.parametrize("which", sorted(CLIS))
def test_port_cli_checks_the_port_tree_clean(which):
    out = _cli(which, "--json")
    assert out.returncode == 0, out.stdout + out.stderr
    report = json.loads(out.stdout)
    assert report["violations"] == []
    if which == "lint":  # core/*.py and api.py of the port
        assert report["files"] == len(list((SRC / "repro_torch" / "core").glob("*.py"))) + 1
    else:
        assert report["files"] == len(static_check.default_targets()) == 5


@pytest.mark.parametrize("which", sorted(CLIS))
def test_port_cli_self_test_equals_the_reference(which):
    port, ref = _cli(which, "--self-test"), _cli(which, "--self-test", port=False)
    assert port.returncode == ref.returncode == 0, port.stdout + port.stderr
    assert port.stdout == ref.stdout


@pytest.mark.parametrize("which", sorted(CLIS))
def test_port_cli_exit_codes(which):
    bad = sorted((ROOT / "tests" / "fixtures" / f"{which}_bad").glob("*.py"))[0]
    assert _cli(which, str(bad)).returncode == 1
    assert _cli(which, "--no-such-flag").returncode == 2
    assert _cli(which, "--self-test", str(bad)).returncode == 2


def test_fixture_rule_sets_equal_the_reference():
    fixtures = ROOT / "tests" / "fixtures"
    for path in sorted(fixtures.glob("lint_*/*.py")):
        assert {v.rule for v in lint_paths([path])} == {v.rule for v in ref_lint_paths([path])}, path
    for path in sorted(fixtures.glob("protocol_*/*.py")):
        for complete in (False, True):
            got = {v.rule for v in static_check.check_paths([path], require_complete=complete)}
            assert got == {v.rule for v in ref_static.check_paths([path], require_complete=complete)}, path


def test_append_sites_resolve_as_in_the_reference():
    targets = static_check.default_targets()
    assert all(p.is_file() and "repro_torch" in p.parts for p in targets)
    assert [p.relative_to(SRC / "repro_torch") for p in targets] == \
        [p.relative_to(SRC / "repro") for p in ref_static.default_targets()]
    assert static_check.check_paths(require_complete=True) == []

    def sites(mod):
        return [(Path(s.path).name, s.lineno, s.func, s.kind) for s in mod.append_site_inventory()]

    assert len(sites(static_check)) == 14
    assert sites(static_check) == sites(ref_static)


# ----------------------------------------------------------- live engines --


def _open(api, config_cls, partitioning, execution, **kw):
    cfg = config_cls(l0_capacity=1 << 12, cache_bytes=1 << 15, segment_bytes=1 << 14, chunk_bytes=1 << 11)
    return api.open(api.EngineConfig(store=cfg, partitioning=partitioning, execution=execution, **kw))


def _workload(eng) -> tuple[list, dict]:
    """tests/test_analysis_racecheck.py's workload: puts, migration ticks,
    reads, a scan and a forced GC."""
    out = []
    for i in range(150):
        eng.put(b"w%04d" % i, b"x" * (i % 17 + 1))
    for _ in range(4):
        eng.migration_tick()
    for i in range(0, 150, 5):
        out.append(eng.get(b"w%04d" % i))
    out.append(eng.scan(b"w0000", 25))
    eng.gc_tick(force=True)
    return out, eng.stats()


@pytest.mark.parametrize("partitioning,execution", COMBOS)
def test_checks_are_transparent_and_silent_as_in_the_reference(partitioning, execution):
    """Checks off and on give the same results and stats, in the port and in
    the reference alike; the detector sees events and reports nothing, and
    the monitor raises nothing (a ProtocolViolation would be a false positive)."""
    results, events, monitored = {}, {}, {}
    for name, api, cfg in (("port", tapi, TStoreConfig), ("ref", japi, JStoreConfig)):
        for debug in (False, True):
            with _open(api, cfg, partitioning, execution, debug_checks=debug) as eng:
                results[name, debug] = _workload(eng)
                if debug:
                    assert eng.race_checker.reports == []
                    events[name] = eng.race_checker.events
                    monitored[name] = eng.protocol_monitor is not None
    assert results["port", True] == results["port", False] == results["ref", True] == results["ref", False]
    assert events["port"] > 0 and events["ref"] > 0
    assert monitored["port"] == monitored["ref"] == ((partitioning, execution) != ("none", "serial"))


@pytest.mark.parametrize("partitioning", ["hash:2", "range:2"])
def test_front_ends_are_instrumented_as_front_ends(partitioning):
    """``attach_engine`` picks its instrumentation by the port's classes: a
    port front-end gets the front-end path, not the solo store's."""
    with _open(tapi, TStoreConfig, partitioning, "async", debug_checks=True) as eng:
        store = eng.store
        assert type(store).__name__.startswith("Checked")
        assert store._race_checker is eng.race_checker
        assert isinstance(store._stats_lock, ChecksafeLock)
        assert all(getattr(s, "_race_wrapped", False) for s in store._all_stores())
        for i in range(120):
            eng.put(b"f%04d" % i, b"v" * 9)
        assert [eng.get(b"f%04d" % i) for i in range(0, 120, 7)] == [b"v" * 9] * 18
        assert eng.race_checker.events > 0
        assert eng.race_checker.reports == []


@pytest.mark.parametrize("partitioning", ["hash:2", "range:2"])
def test_async_rescale_is_race_and_protocol_clean(partitioning):
    keys = [b"k%05d" % i for i in range(300)]
    with _open(tapi, TStoreConfig, partitioning, "async", debug_checks=True) as eng:
        for k in keys:
            eng.put(k, b"v" + k)
        eng.rescale(4)
        for _ in range(300):
            if eng.topology()["rescale"] is None:
                break
            eng.migration_tick()
            assert all(eng.get(k) == b"v" + k for k in keys[::61])
        assert eng.topology()["rescale"] is None and eng.topology()["shards"] == 4
        assert all(eng.get(k) == b"v" + k for k in keys[::7])
        assert eng.race_checker.events > 0 and eng.race_checker.reports == []
        assert eng.protocol_monitor.records_checked > 0


def test_crash_recover_and_snapshot_truncate_under_the_checks(tmp_path):
    with _open(tapi, TStoreConfig, "range:2", "serial", debug_checks=True, snapshot_dir=str(tmp_path)) as eng:
        for i in range(150):
            eng.put(b"c%05d" % i, b"x" * 40)
        eng.flush_all()
        eng.migration_tick()
        eng.snapshot()
        eng.crash()
        eng.recover()
        for i in range(150, 190):
            eng.put(b"c%05d" % i, b"x" * 40)
        eng.snapshot()
        assert all(eng.get(b"c%05d" % i) == b"x" * 40 for i in range(0, 190, 7))
        assert eng.protocol_monitor.replays_checked >= 1
        assert eng.protocol_monitor.records_checked > 0
        assert eng.race_checker.reports == []


def test_planted_unlocked_counter_bump_is_flagged():
    eng = _open(tapi, TStoreConfig, "hash:2", "async", debug_checks=True)
    store = eng.store
    t = threading.Thread(target=lambda: store.__setattr__("gets", store.gets + 1))
    t.start()
    t.join()
    store.gets += 1  # the main thread, also unlocked: no common lock
    assert any(r.var == "frontend.gets" for r in eng.race_checker.reports)
    with pytest.raises(RaceViolation):
        eng.close()


def test_checks_off_never_import_the_analysis_package():
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.api as api\n"
        "from repro_torch.core import StoreConfig\n"
        "cfg = StoreConfig(l0_capacity=1 << 12, cache_bytes=1 << 15, segment_bytes=1 << 14, chunk_bytes=1 << 11)\n"
        "for part, ex in (('hash:2', 'async'), ('range:2', 'serial')):\n"
        "    with api.open(api.EngineConfig(store=cfg, partitioning=part, execution=ex)) as eng:\n"
        "        for i in range(64):\n"
        "            eng.put(b'k%03d' % i, b'v')\n"
        "        eng.migration_tick()\n"
        "        assert eng.get(b'k007') == b'v' and eng.race_checker is None and eng.protocol_monitor is None\n"
        "loaded = sorted(m for m in sys.modules if m.startswith('repro_torch.analysis'))\n"
        "assert not loaded, loaded\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", script], env=ENV, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_env_var_switches_the_checks_on(monkeypatch):
    monkeypatch.setenv("REPRO_DEBUG_CHECKS", "1")
    with _open(tapi, TStoreConfig, "range:2", "serial") as eng:
        assert eng.race_checker is not None and eng.protocol_monitor is not None
        assert type(eng.race_checker).__module__ == "repro_torch.analysis.racecheck"
    for off in ("", "0", "false", "off"):
        monkeypatch.setenv("REPRO_DEBUG_CHECKS", off)
        with _open(tapi, TStoreConfig, "range:2", "serial") as eng:
            assert eng.race_checker is None and eng.protocol_monitor is None
