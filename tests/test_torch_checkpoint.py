"""The port's ``LogStructuredCheckpointer`` (``repro_torch.checkpoint.store``)
and ``CheckpointManager`` (``repro_torch.checkpoint.manager``) against the
reference's: the cases of ``tests/test_checkpoint.py`` run on the port, the
same saves leave byte-identical directories in both packages, and a
checkpoint written by either restores bitwise in the other."""
from __future__ import annotations

import dataclasses
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.checkpoint.store import LogStructuredCheckpointer as RefCheckpointer
from repro_torch.checkpoint.manager import CheckpointManager, _assemble
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


# ------------------------------------------------------------- the manager
def test_manager_with_torch_tree(tmp_path):
    """tests/test_checkpoint.py::test_manager_with_jax_pytree, on tensors."""
    mgr = CheckpointManager(str(tmp_path), consolidate_every=4)
    params = {
        "layer": {"w": torch.arange(128, dtype=torch.float32).reshape(8, 16), "b": torch.ones((16,))},
        "step_count": torch.zeros((), dtype=torch.int32),
    }
    mgr.save(3, params)
    like = {"layer": {"w": torch.empty((8, 16), device="meta"), "b": torch.empty((16,), device="meta")},
            "step_count": torch.empty((), dtype=torch.int32, device="meta")}
    restored, step = mgr.restore(like, device="cpu")
    assert step == 3
    for key in ("w", "b"):
        assert torch.equal(restored["layer"][key], params["layer"][key])
    assert restored["step_count"].dtype == torch.int32 and restored["step_count"].shape == ()
    stats = mgr.stats()
    assert stats["write_amplification"] >= 1.0


def test_assemble_refuses_partial_coverage():
    """Regression: a missing shard part must raise, never restore zeros."""
    half = np.ones((4, 8), np.float32)
    with pytest.raises(RuntimeError, match="uncovered"):
        _assemble({"0-4_0-8": half}, (8, 8), np.float32)
    # the same parts with full coverage assemble fine
    got = _assemble({"0-4_0-8": half, "4-8_0-8": 2 * half}, (8, 8), np.float32)
    np.testing.assert_array_equal(got, np.vstack([half, 2 * half]))


def _train_like_tree(step):
    """A trainer's tree: params and AdamW state (int32 0-d step), a 0-d float leaf and a numpy leaf."""
    r = np.random.default_rng(step)
    params = {"embed": r.standard_normal((300, 64)), "layers.0.w": r.standard_normal((64, 32)),
              "layers.0.scale": r.standard_normal(32), "bias": r.standard_normal(5)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    return {
        "params": params,
        "opt": {"mu": {k: 0.1 * v for k, v in params.items()}, "nu": {k: v * v for k, v in params.items()},
                "step": np.int32(step)},
        "loss_scale": np.float32(step + 0.5),
        "host_rows": np.arange(6, dtype=np.int64),  # a numpy leaf: keyed "full" in both packages
    }


def _as(tree, tensor, numpy_keys=("host_rows",)):
    return {k: _as(v, tensor, ()) if isinstance(v, dict) else (np.asarray(v) if k in numpy_keys else tensor(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("mode", ["hybrid", "inline", "log"])
def test_manager_directories_byte_identical_and_cross_restore(tmp_path, mode):
    mgrs = {"ref": RefManager(str(tmp_path / "ref"), mode=mode, consolidate_every=2),
            "port": CheckpointManager(str(tmp_path / "port"), mode=mode, consolidate_every=2)}
    to_ref = lambda t: _as(t, lambda a: jnp.asarray(a))  # noqa: E731
    to_port = lambda t: _as(t, lambda a: torch.from_numpy(np.array(a)))  # noqa: E731
    for step in range(3):
        tree = _train_like_tree(step)
        mgrs["ref"].save(step, to_ref(tree))
        mgrs["port"].save(step, to_port(tree))
    files = {k: sorted(p.relative_to(tmp_path / k) for p in (tmp_path / k).rglob("*") if p.is_file()) for k in mgrs}
    assert files["port"] == files["ref"] and any(p.name == "MANIFEST" for p in files["ref"])
    for rel in files["ref"]:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "ref" / rel).read_bytes(), rel
    manifest = next(p for p in files["ref"] if p.name == "MANIFEST")
    text = (tmp_path / "ref" / manifest).read_text()
    assert "opt/step@scalar" in text and "params/embed@0-end_0-end" in text and "host_rows@full" in text

    want = tree
    # the port restores the reference's directory, and the reference the port's, bitwise
    restored, step = CheckpointManager(str(tmp_path / "ref"), mode=mode).restore(to_port(want), device="cpu")
    assert step == 2
    jrestored, jstep = RefManager(str(tmp_path / "port"), mode=mode).restore(
        jax.tree.map(lambda a: jax.ShapeDtypeStruct(np.shape(a), np.asarray(a).dtype), to_ref(want)))
    assert jstep == 2
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in flat:
        keys = [p.key for p in path]
        got, jgot = restored, jrestored
        for k in keys:
            got, jgot = got[k], jgot[k]
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        for arr in (got.numpy(), np.asarray(jgot)):
            assert arr.dtype == np.asarray(leaf).dtype and arr.shape == np.shape(leaf), keys
            assert arr.tobytes() == np.asarray(leaf).tobytes(), keys


def test_manager_refuses_bfloat16_and_restores_to_like_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.save(0, {"w": torch.ones(4, dtype=torch.bfloat16)})
    mgr.save(1, {"w": torch.arange(4.0)})
    restored, _ = mgr.restore({"w": torch.zeros(4)})  # a real tensor: restored on its device
    assert restored["w"].device.type == "cpu" and torch.equal(restored["w"], torch.arange(4.0))
    with pytest.raises(KeyError, match="missing v"):
        mgr.restore({"v": torch.zeros(4)})
