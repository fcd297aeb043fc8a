"""The port's ``LogStructuredCheckpointer`` (``repro_torch.checkpoint.store``)
against the reference's: the cases of ``tests/test_checkpoint.py`` that need
no JAX run on the port, the same saves leave byte-identical directories in
both packages, and a checkpoint written by either restores bitwise in the other."""
from __future__ import annotations

import dataclasses
import os
import re
from pathlib import Path

import numpy as np
import pytest

from repro.checkpoint.store import LogStructuredCheckpointer as RefCheckpointer
from repro_torch.checkpoint.store import LogStructuredCheckpointer

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"ref": RefCheckpointer, "port": LogStructuredCheckpointer}


def make_state(rng, step=0):
    """tests/test_checkpoint.py's state: two large tensors, a medium one, a
    medium-or-small one and a scalar that goes inline."""
    return {
        "embed": rng.standard_normal((2000, 64)).astype(np.float32),
        "ffn_w": rng.standard_normal((64, 256)).astype(np.float32),
        "medium": rng.standard_normal((80,)).astype(np.float32),
        "gain": rng.standard_normal((8,)).astype(np.float32),
        "scalar": np.float32(step),
    }


def assert_bitwise_equal(out: dict, state: dict) -> None:
    assert sorted(out) == sorted(state)
    for k, v in state.items():
        v = np.asarray(v)
        assert out[k].dtype == v.dtype and out[k].shape == v.shape, k
        assert out[k].tobytes() == v.tobytes(), k


def test_module_equals_the_reference_after_the_rename():
    ref = (ROOT / "src" / "repro" / "checkpoint" / "store.py").read_text()
    port = (ROOT / "src" / "repro_torch" / "checkpoint" / "store.py").read_text()
    assert port == re.sub(r"\brepro(?=[./])", "repro_torch", ref)


def test_roundtrip(tmp_path):
    ck = LogStructuredCheckpointer(str(tmp_path), consolidate_every=100)
    state = make_state(np.random.default_rng(0))
    ck.save(0, state)
    out, step = ck.restore()
    assert step == 0
    assert_bitwise_equal(out, state)


def test_incremental_and_consolidation(tmp_path):
    ck = LogStructuredCheckpointer(str(tmp_path), consolidate_every=4)
    state = make_state(np.random.default_rng(1))
    for step in range(10):
        state["ffn_w"] = state["ffn_w"] * 0.9
        state["scalar"] = np.float32(step)
        ck.save(step, state, changed={"ffn_w", "scalar"})
    out, step = ck.restore()
    assert step == 9
    assert_bitwise_equal(out, state)
    # transient segments were reclaimed wholesale at consolidation
    assert len([f for f in os.listdir(tmp_path) if f.startswith("tseg-")]) <= 2


def test_torn_manifest_tail(tmp_path):
    ck = LogStructuredCheckpointer(str(tmp_path), consolidate_every=100)
    state = make_state(np.random.default_rng(2))
    ck.save(0, state)
    ck.save(1, state)
    with open(tmp_path / "MANIFEST", "a") as f:
        f.write('{"key": "embed", "lsn": 999, "step"')  # a torn write
    out, step = ck.restore()
    assert step == 1
    assert_bitwise_equal(out, state)


def test_torn_payload_falls_back_to_previous_step(tmp_path):
    # gc_threshold > 1 disables GC, so step 0's segment survives as the fallback
    ck = LogStructuredCheckpointer(str(tmp_path), consolidate_every=100, gc_threshold=1.1)
    state = make_state(np.random.default_rng(5))
    ck.save(0, state)
    prev = dict(state)
    state["embed"] = state["embed"] + 1.0
    ck.save(1, state, changed={"embed"})  # embed lands alone in seg-1.log
    seg = tmp_path / "seg-1.log"
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) // 2)  # a torn in-place write
    out, step = ck.restore()
    assert step == 0
    assert_bitwise_equal(out, prev)


def test_gc_reclaims_large_segments(tmp_path):
    ck = LogStructuredCheckpointer(str(tmp_path), consolidate_every=1000, gc_threshold=0.1)
    state = make_state(np.random.default_rng(3))
    for step in range(6):
        state["embed"] = state["embed"] + 1.0  # rewrite the large tensor
        ck.save(step, state)
    on_disk = sum(os.path.getsize(tmp_path / s) for s in os.listdir(tmp_path) if s.startswith("seg-"))
    assert on_disk < 3 * (state["embed"].nbytes + state["ffn_w"].nbytes)  # the live generation, not 6 copies
    out, _ = ck.restore()
    assert_bitwise_equal(out, state)


def test_hybrid_beats_inline_write_amp(tmp_path):
    amps = {}
    for mode in ("hybrid", "inline"):
        ck = LogStructuredCheckpointer(str(tmp_path / mode), mode=mode, consolidate_every=8)
        state = make_state(np.random.default_rng(4))
        for step in range(16):
            state["medium"] = state["medium"] + 0.1
            state["scalar"] = np.float32(step)
            ck.save(step, state, changed={"medium", "scalar"})
        amps[mode] = ck.device.stats.bytes_written
    assert amps["hybrid"] <= amps["inline"]


def _trace(cls, directory: Path, mode: str, gc_threshold: float) -> tuple:
    """A training-like trace through each placement path: full saves, partial
    saves, GC of large segments, consolidations that reclaim transient ones."""
    ck = cls(str(directory), mode=mode, consolidate_every=3, gc_threshold=gc_threshold)
    rng = np.random.default_rng(7)
    state = make_state(rng)
    state["steps"] = np.arange(5, dtype=np.int64)
    for step in range(8):
        state["embed"] = state["embed"] + np.float32(0.5)
        state["medium"] = rng.standard_normal((80,)).astype(np.float32)
        state["scalar"] = np.float32(step)
        ck.save(step, state, changed=None if step % 4 == 0 else {"embed", "medium", "scalar"})
    return ck, state


@pytest.mark.parametrize("mode,gc_threshold", [("hybrid", 0.1), ("hybrid", 1.1), ("inline", 0.1), ("log", 0.1)])
def test_directories_byte_identical_and_cross_restore(tmp_path, mode, gc_threshold):
    runs = {name: _trace(cls, tmp_path / name, mode, gc_threshold) for name, cls in PACKAGES.items()}
    files = {name: sorted(p.relative_to(tmp_path / name) for p in (tmp_path / name).rglob("*") if p.is_file())
             for name in PACKAGES}
    assert files["port"] == files["ref"] and files["ref"]
    assert {p.parts[0].split("-")[0] for p in files["ref"]} >= {"MANIFEST", "gen"}
    for rel in files["ref"]:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "ref" / rel).read_bytes(), rel
    stats = {name: dataclasses.asdict(ck.device.stats) for name, (ck, _) in runs.items()}
    assert stats["port"] == stats["ref"]
    assert runs["port"][0].app_bytes == runs["ref"][0].app_bytes
    # a directory from either package restores bitwise in the other
    state = runs["ref"][1]
    for writer, reader in (("ref", "port"), ("port", "ref")):
        out, step = PACKAGES[reader](str(tmp_path / writer), mode=mode).restore()
        assert step == 7
        assert_bitwise_equal(out, state)
