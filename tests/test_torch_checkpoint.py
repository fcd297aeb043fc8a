"""The port's ``LogStructuredCheckpointer`` (``repro_torch.checkpoint.store``)
and ``CheckpointManager`` (``repro_torch.checkpoint.manager``) against the
reference's: the cases of ``tests/test_checkpoint.py`` run on the port, the
same saves leave byte-identical directories in both packages, and a
checkpoint written by either restores bitwise in the other."""
from __future__ import annotations

import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.checkpoint.store import LogStructuredCheckpointer as RefCheckpointer
from repro_torch.checkpoint.manager import CheckpointManager, _assemble
from repro_torch.checkpoint.store import LogStructuredCheckpointer
from repro_torch.sharding import rules
from torch_parity import run_ranks

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
    """The port's store is the reference's with its imports renamed, apart from the
    payload header (``BF16_WORDS``, ``_meta``, ``_unmeta``), which also carries
    bfloat16 without ml_dtypes; for every other dtype the header is the same bytes."""
    from repro.checkpoint import store as ref_store
    from repro_torch.checkpoint import store as port_store

    ref = re.sub(r"\brepro(?=[./])", "repro_torch", (ROOT / "src" / "repro" / "checkpoint" / "store.py").read_text())
    port = (ROOT / "src" / "repro_torch" / "checkpoint" / "store.py").read_text()
    head, tail = "\ndef _meta(", "\ndef _manifest_row("
    port_head = port.index("\n# bfloat16 as its raw 16-bit words")
    assert port[:port_head] == ref[:ref.index(head)]
    assert port[port.index(tail):] == ref[ref.index(tail):]
    for arr in (np.arange(6, dtype=np.float32).reshape(2, 3), np.int32(7), np.arange(3, dtype=np.int64),
                np.ones((2, 2), np.float16), np.zeros(4, np.uint16)):
        assert port_store._meta(np.asarray(arr)) == ref_store._meta(np.asarray(arr))
        payload = np.asarray(arr).tobytes() + ref_store._meta(np.asarray(arr))
        got, want = port_store._unmeta(payload), ref_store._unmeta(payload)
        assert got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()


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
    """Once the manager refused bfloat16 leaves; now it saves their raw 16-bit words
    and restores them bitwise as bfloat16 (never cast to or from another dtype),
    each leaf on its ``like`` leaf's device."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.tensor([1.5, -2.25, 3e38, 1e-40, float("inf"), -0.0], dtype=torch.bfloat16)
    mgr.save(1, {"w": w, "f": torch.arange(4.0)})
    restored, _ = mgr.restore({"w": torch.zeros(6, dtype=torch.bfloat16), "f": torch.zeros(4)})
    assert restored["w"].dtype == torch.bfloat16 and restored["w"].device.type == "cpu"
    assert torch.equal(restored["w"].view(torch.int16), w.view(torch.int16))
    assert restored["f"].device.type == "cpu" and torch.equal(restored["f"], torch.arange(4.0))
    with pytest.raises(TypeError, match="restoring as"):
        mgr.restore({"w": torch.zeros(6), "f": torch.zeros(4)})
    with pytest.raises(TypeError, match="restoring as"):
        mgr.restore({"w": torch.zeros(6, dtype=torch.bfloat16), "f": torch.zeros(4, dtype=torch.bfloat16)})
    with pytest.raises(KeyError, match="missing v"):
        mgr.restore({"v": torch.zeros(4)})


def test_bfloat16_checkpoints_cross_restore_with_reference(tmp_path):
    """A bf16 leaf: the reference (an ml_dtypes array) and the port (a torch tensor)
    leave byte-identical directories, and each restores the other's bitwise."""
    r = np.random.default_rng(3)
    f32 = r.standard_normal((40, 24)).astype(np.float32)
    small = r.standard_normal(3).astype(np.float32)
    ref_tree = {"w": jnp.asarray(f32).astype(jnp.bfloat16), "s": jnp.asarray(small).astype(jnp.bfloat16),
                "f": jnp.asarray(f32)}
    port_tree = {"w": torch.from_numpy(f32).to(torch.bfloat16), "s": torch.from_numpy(small).to(torch.bfloat16),
                 "f": torch.from_numpy(f32)}
    for step in range(2):
        RefManager(str(tmp_path / "ref"), consolidate_every=2).save(step, ref_tree)
        CheckpointManager(str(tmp_path / "port"), consolidate_every=2).save(step, port_tree)
    files = {k: sorted(p.relative_to(tmp_path / k) for p in (tmp_path / k).rglob("*") if p.is_file())
             for k in ("ref", "port")}
    assert files["port"] == files["ref"] and files["ref"]
    for rel in files["ref"]:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "ref" / rel).read_bytes(), rel
    like = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in port_tree.items()}
    got, step = CheckpointManager(str(tmp_path / "ref")).restore(like, device="cpu")
    jgot, jstep = RefManager(str(tmp_path / "port")).restore(
        {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in ref_tree.items()})
    assert step == jstep == 1
    for k, v in port_tree.items():
        assert got[k].dtype == v.dtype and got[k].view(-1).view(torch.uint8).numpy().tobytes() == \
            v.view(-1).view(torch.uint8).numpy().tobytes(), k
        assert np.asarray(jgot[k]).tobytes() == np.asarray(ref_tree[k]).tobytes(), k


# ------------------------------------------------------ sharded checkpoints
MESH = ((2, 2), ("data", "model"))
# leaf -> (shape, dtype, the spec it is saved under, the spec of the other layout)
LEAVES = {
    "w": ((8, 6), "float32", ("data", "model"), ("model", None)),
    "v": ((8,), "float32", (("data", "model"),), (None,)),
    "r": ((4, 4), "float32", (None, None), ("data", "model")),
    "h": ((4, 8), "bfloat16", (None, "model"), ("data", None)),
    "step": ((), "int32", (), ()),
}


def _tree_values() -> dict[str, np.ndarray]:
    """The leaves as float32 / int32 numpy, from a seed (bf16 leaves rounded from float32)."""
    r = np.random.default_rng(11)
    return {k: (r.integers(0, 100, shape).astype(np.int32) if dt == "int32"
                else r.standard_normal(shape).astype(np.float32)) for k, (shape, dt, _, _) in LEAVES.items()}


SHARDED_SAVE = f"""
import numpy as np
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding import rules

LEAVES = {LEAVES!r}
r = np.random.default_rng(11)
values = {{k: (r.integers(0, 100, shape).astype(np.int32) if dt == "int32"
              else r.standard_normal(shape).astype(np.float32)) for k, (shape, dt, _, _) in LEAVES.items()}}
tree = {{k: torch.from_numpy(v).to(getattr(torch, LEAVES[k][1])) for k, v in values.items()}}
mesh = make_host_mesh(model=2, device="cpu")
saved = rules.to_shardings(mesh, {{k: v[2] for k, v in LEAVES.items()}})
other = rules.to_shardings(mesh, {{k: v[3] for k, v in LEAVES.items()}})
CheckpointManager(out + "/sharded").save(3, rules.distribute(tree, saved))
dist.barrier()
like = {{k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in tree.items()}}
unsharded, s1 = CheckpointManager(out + "/sharded").restore(like, device="cpu")
relaid, s2 = CheckpointManager(out + "/sharded").restore(like, other)
if rank == 0:
    CheckpointManager(out + "/plain").save(5, tree)
dist.barrier()
sharded, s3 = CheckpointManager(out + "/plain").restore(like, saved)
result = {{
    "steps": (s1, s2, s3),
    "unsharded": unsharded,
    "relaid": {{k: (v.full_tensor(), [str(p) for p in v.placements], tuple(v.to_local().shape))
               for k, v in relaid.items()}},
    "sharded": {{k: (v.full_tensor(), [str(p) for p in v.placements], tuple(v.to_local().shape))
                for k, v in sharded.items()}},
}}
"""

REF_SHARDED_SAVE = f"""
import sys
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint.manager import CheckpointManager

LEAVES = {LEAVES!r}
r = np.random.default_rng(11)
values = {{k: (r.integers(0, 100, shape).astype(np.int32) if dt == "int32"
              else r.standard_normal(shape).astype(np.float32)) for k, (shape, dt, _, _) in LEAVES.items()}}
mesh = jax.make_mesh({MESH[0]!r}, {MESH[1]!r})
tree = {{k: jax.device_put(jnp.asarray(v).astype(LEAVES[k][1]), NamedSharding(mesh, P(*LEAVES[k][2])))
        for k, v in values.items()}}
CheckpointManager(sys.argv[1]).save(3, tree)
"""


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    """The 4-rank save and restores above, and the reference's save of the same
    tree under the same mesh shape and specs (4 forced XLA host devices)."""
    tmp = tmp_path_factory.mktemp("sharded_ckpt")
    ref = subprocess.Popen([sys.executable, "-c", REF_SHARDED_SAVE, str(tmp / "ref")], stderr=subprocess.PIPE,
                           text=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
                                           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    ranks = run_ranks(SHARDED_SAVE, 4, tmp)
    _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    return tmp, ranks


def _full(name: str, value: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(value).to(getattr(torch, LEAVES[name][1]))


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()


def test_sharded_save_restores_bitwise_unsharded_and_into_another_layout_and_back(sharded_run):
    """Saved as DTensor shards on a (2, 2) mesh: restored whole, and as DTensors in
    another layout; saved whole: restored as DTensors in the first layout.  Every
    leaf bitwise, each rank holding the shard its placements give."""
    _, ranks = sharded_run
    values = _tree_values()
    for rank, r in enumerate(ranks):
        assert r["steps"] == (3, 3, 5)
        for k, v in values.items():
            want = _full(k, v)
            got = r["unsharded"][k]
            assert isinstance(got, torch.Tensor) and got.dtype == want.dtype and _bits(got) == _bits(want), k
            for part in ("relaid", "sharded"):
                full, placements, local = r[part][k]
                assert full.dtype == want.dtype and _bits(full) == _bits(want), (part, k)
                spec = LEAVES[k][3] if part == "relaid" else LEAVES[k][2]
                assert placements == [str(p) for p in rules.to_placements(spec, SimpleNamespace(
                    mesh_dim_names=MESH[1], shape=MESH[0]))], (part, k)
                parts = [1] * len(want.shape)
                for d, entry in enumerate(spec):
                    parts[d] *= 4 if isinstance(entry, tuple) else 2 if entry else 1
                assert local == tuple(n // p for n, p in zip(want.shape, parts)), (part, k, local)


def _keys_and_bytes(directory: Path) -> dict[str, tuple]:
    """Each key of a host directory with its payload's dtype, shape and bytes."""
    flat, _ = LogStructuredCheckpointer(str(directory)).restore()
    return {k: (str(v.dtype.metadata or v.dtype), v.shape, v.tobytes()) for k, v in flat.items()}


def test_sharded_keys_and_bytes_equal_reference(sharded_run):
    """The union of (key, bytes) over the port's host-* directories (one per rank)
    equals the reference's single host directory for the same mesh shape and specs:
    each shard keyed by its region, replicas of a region under one key."""
    tmp, _ = sharded_run
    hosts = sorted((tmp / "sharded").glob("host-*"))
    assert [h.name for h in hosts] == [f"host-{r}" for r in range(4)]
    union: dict[str, tuple] = {}
    for h in hosts:
        for k, v in _keys_and_bytes(h).items():
            assert union.setdefault(k, v) == v, k  # replicas of one region agree
    ref = _keys_and_bytes(tmp / "ref" / "host-0")
    assert sorted(union) == sorted(ref)
    assert "w@0-4_0-3" in union and "v@6-8" in union and "r@0-end_0-end" in union and "step@scalar" in union
    for k in ref:
        assert union[k] == ref[k], k


def test_restore_reads_every_host_directory_where_its_own_does_not_cover(sharded_run, tmp_path):
    """A process that holds one rank's shards (here the only one left, host-0)
    reads the other host-* directories under the root; with one of them gone the
    leaves it held are uncovered, and restore raises rather than fill zeros."""
    src, _ = sharded_run
    values = _tree_values()
    like = {k: torch.empty(v.shape, dtype=getattr(torch, LEAVES[k][1]), device="meta") for k, v in values.items()}
    got, step = CheckpointManager(str(src / "sharded")).restore(like, device="cpu")
    assert step == 3 and all(_bits(got[k]) == _bits(_full(k, v)) for k, v in values.items())
    shutil.copytree(src / "sharded", tmp_path / "partial")
    shutil.rmtree(tmp_path / "partial" / "host-3")
    with pytest.raises(RuntimeError, match="uncovered"):
        CheckpointManager(str(tmp_path / "partial")).restore(like, device="cpu")
