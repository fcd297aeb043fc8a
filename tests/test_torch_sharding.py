"""The port's sharding rules (``repro_torch.sharding.rules``) and meshes
(``repro_torch.launch.mesh``) against the reference's, on the CPU.

The reference runs in a subprocess with 512 forced XLA host devices, so
that its meshes are real ``jax.make_mesh`` meshes; the port runs in another
under a fake process group of 512 ranks
(``torch.testing._internal.distributed.fake_pg``), where its meshes are real
``DeviceMesh``es over which nothing runs.  Each side prints, for every arch,
layout and mesh, the padded config and every spec; the specs must be equal
leaf by leaf.  A port leaf under ``layers``/``enc_layers``/``dec_layers`` is
one layer of the reference's stacked leaf, so its spec is the reference's
without the leading None.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs import ARCHS
from repro_torch.convert import STACKED
from repro_torch.models.config import ArchConfig
from repro_torch.sharding import rules

ROOT = Path(__file__).resolve().parents[1]
# (shape, axes): the mini dry-run's mesh and both production meshes
MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]

REF = """
import dataclasses, json
import jax
from repro.configs import ARCHS, SHAPES
from repro.data.pipeline import batch_struct
from repro.sharding import rules
from repro.train.step import abstract_cache, abstract_params

MESHES = {meshes!r}
out = {{}}
for shape, axes in MESHES:
    n = 1
    for s in shape:
        n *= s
    mesh = jax.make_mesh(shape, axes, devices=jax.devices()[:n])
    for name, cfg0 in ARCHS.items():
        for layout in rules.LAYOUTS:
            cfg = rules.pad_config_for_mesh(cfg0, mesh, layout)
            leaves = lambda tree: {{
                "/".join(str(getattr(k, "key", k)) for k in path): list(spec)
                for path, spec in jax.tree_util.tree_flatten_with_path(
                    tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}}
            row = {{"cfg": dataclasses.asdict(cfg),
                   "params": leaves(rules.param_specs(cfg, mesh, abstract_params(cfg), layout))}}
            for sname, sh in SHAPES.items():
                row["batch/" + sname] = leaves(rules.batch_specs(cfg, mesh, batch_struct(cfg, sh.seq_len, sh.global_batch), layout))
                if sh.step == "decode":
                    row["cache/" + sname] = leaves(rules.cache_specs(cfg, mesh, abstract_cache(cfg, sh.global_batch, sh.seq_len), layout))
            out["|".join([str(tuple(shape)), name, layout])] = row
print(json.dumps(out))
"""

PORT = """
import dataclasses, json
import torch, torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.data.pipeline import batch_struct
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import rules
from repro_torch.train.step import abstract_cache, abstract_params

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
meshes = {{(2, 16, 16): make_production_mesh(multi_pod=True, device="cpu"),
           (16, 16): DeviceMesh("cpu", torch.arange(256).reshape(16, 16), mesh_dim_names=("data", "model")),
           (2, 4): DeviceMesh("cpu", torch.arange(8).reshape(2, 4), mesh_dim_names=("data", "model"))}}
shells = {{}}
out = {{}}
for shape, axes in {meshes!r}:
    mesh = meshes[tuple(shape)]
    assert tuple(mesh.mesh_dim_names) == tuple(axes) and tuple(mesh.shape) == tuple(shape)
    for name, cfg0 in ARCHS.items():
        for layout in rules.LAYOUTS:
            cfg = rules.pad_config_for_mesh(cfg0, mesh, layout)
            if cfg not in shells:
                shells[cfg] = abstract_params(cfg)
            walk = lambda t: {{k: walk(v) if isinstance(v, dict) else list(v) for k, v in t.items()}}
            row = {{"cfg": dataclasses.asdict(cfg), "params": walk(rules.param_specs(cfg, mesh, shells[cfg], layout)),
                   "shapes": {{n: list(p.shape) for n, p in shells[cfg].named_parameters()}}}}
            for sname, sh in SHAPES.items():
                row["batch/" + sname] = walk(rules.batch_specs(cfg, mesh, batch_struct(cfg, sh.seq_len, sh.global_batch), layout))
                if sh.step == "decode":
                    row["cache/" + sname] = walk(rules.cache_specs(cfg, mesh, abstract_cache(cfg, sh.global_batch, sh.seq_len), layout))
            out["|".join([str(tuple(shape)), name, layout])] = row
print(json.dumps(out))
"""


def _start(code: str, env: dict) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": str(ROOT / "src"), **env})


def _result(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def both():
    """(reference rows, port rows), from two subprocesses run side by side."""
    meshes = [(list(s), list(a)) for s, a in MESHES]
    ref = _start(REF.format(meshes=meshes), {"XLA_FLAGS": "--xla_force_host_platform_device_count=512",
                                             "JAX_PLATFORMS": "cpu"})
    port = _start(PORT.format(meshes=meshes), {})
    return _result(ref), _result(port)


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _as_ref(port_params: dict) -> dict:
    """The port's per-layer specs as the reference's stacked ones: one spec for all
    layers of a leaf (they must agree), with the leading None of the layer axis."""
    out: dict[str, list] = {}
    for name, spec in port_params.items():
        stack, _, rest = name.partition(".")
        i, _, leaf = rest.partition(".")
        if stack in STACKED and i.isdigit():
            key, spec = f"{stack}/{leaf.replace('.', '/')}", [None, *spec]
            assert out.setdefault(key, spec) == spec, (name, spec, out[key])
        else:
            out[name.replace(".", "/")] = spec
    return out


@pytest.mark.parametrize("mesh", [str(s) for s, _ in MESHES])
@pytest.mark.parametrize("layout", rules.LAYOUTS)
def test_specs_equal_reference(both, mesh, layout):
    """pad_config_for_mesh, and param_specs, batch_specs and cache_specs leaf by leaf, for every arch."""
    ref, port = both
    keys = [k for k in ref if k.startswith(mesh + "|") and k.endswith("|" + layout)]
    assert len(keys) == len(ARCHS) == 10
    for key in keys:
        r, p = ref[key], port[key]
        # the reference's fields equal; the port's own (the zamba2 family's) at their defaults
        assert {k: v for k, v in p["cfg"].items() if k in r["cfg"]} == r["cfg"], key
        own = {f.name: json.loads(json.dumps(f.default)) for f in dataclasses.fields(ArchConfig) if f.name not in r["cfg"]}
        assert {k: v for k, v in p["cfg"].items() if k not in r["cfg"]} == own, key
        assert _as_ref(p["params"]) == r["params"], key
        assert sorted(r) == sorted(set(p) - {"shapes"})
        for part in r:
            if part.startswith(("batch/", "cache/")):
                assert _flat(p[part]) == r[part], (key, part)


@pytest.mark.parametrize("mesh", [str(s) for s, _ in MESHES])
def test_param_specs_divisibility_all_archs(both, mesh):
    """tests/test_sharding_dryrun.py's check on the port: every sharded dim divides."""
    _, port = both
    sizes = dict(zip(*next((a, s) for s, a in MESHES if str(s) == mesh)))
    for name in ARCHS:
        for layout in rules.LAYOUTS:
            row = port[f"{mesh}|{name}|{layout}"]
            shapes = row["shapes"]  # abstract_params(cfg) of the padded config
            assert sorted(shapes) == sorted(row["params"])
            for leaf, spec in row["params"].items():
                assert len(spec) == len(shapes[leaf])
                for dim, part in zip(shapes[leaf], spec):
                    axes = part if isinstance(part, list) else [part] if part else []
                    size = 1
                    for a in axes:
                        size *= sizes[a]
                    assert dim % size == 0, (name, layout, leaf, shapes[leaf], spec)


class _Mesh:
    """What the rules read of a mesh: its dim names and sizes."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)


def test_placements_of_a_tuple_of_axes():
    mesh = _Mesh((2, 16, 16), ("pod", "data", "model"))
    assert rules.to_placements((("pod", "data"), "model"), mesh) == [Shard(0), Shard(0), Shard(1)]
    assert rules.to_placements((None, ("pod", "data", "model")), mesh) == [Shard(1)] * 3
    assert rules.to_placements(("model", None), mesh) == [Replicate(), Replicate(), Shard(0)]
    assert rules.to_placements((), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh's order"):
        rules.to_placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="named twice"):
        rules.to_placements(("model", "model"), mesh)
    sharding = rules.NamedSharding(_Mesh((2, 4), ("data", "model")), ("data", None, "model"))
    assert sharding.placements == [Shard(0), Shard(2)]


def test_rules_read_only_dim_names_and_sizes():
    """pad_config_for_mesh is dataclass arithmetic on the model axis size."""
    mesh = _Mesh((2, 16, 16), ("pod", "data", "model"))
    cfg = rules.pad_config_for_mesh(ARCHS["yi-34b"], mesh)
    assert (cfg.num_heads, cfg.orig_num_heads, cfg.vocab_pad_multiple) == (64, 56, 2048)
    assert rules.pad_config_for_mesh(ARCHS["yi-34b"], mesh, "pure-dp").num_heads == 56
    assert rules.data_axes(mesh) == ("pod", "data") and rules.data_axes(mesh, "dp-only") == ("pod", "data", "model")
    assert rules.model_axis_size(_Mesh((4,), ("data",))) == 1
