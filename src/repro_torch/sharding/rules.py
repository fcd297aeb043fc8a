"""Parameter/activation sharding rules for the (pod, data, model) mesh.

Strategy (baseline; the other layouts below are the alternatives):

* **TP** over ``model``: attention q-heads, FFN hidden, MoE expert-hidden,
  SSM inner dim, vocab.  KV heads and SSM B/C groups are **replicated** when
  they don't divide the axis (GQA kv replication — standard TP practice).
* **FSDP** over ``(pod, data)``: the non-TP dim of every large 2-D+ weight is
  sharded over the data axes (ZeRO-3 style).  Optimizer state inherits
  parameter shardings.
* **Head padding**: archs whose q-head count doesn't divide the model axis
  (yi-34b 56H, phi3 40H) are padded to the next multiple with exact-zero
  padded heads (``pad_config_for_mesh``); vocab is padded to a lane-aligned
  multiple of the model axis.
* **Decode caches**: KV caches shard batch over data and sequence over
  ``model``.  When batch is 1 (long_500k) the sequence axis takes all mesh
  axes.

The reference's rules, on the port's tensors.  A spec is the reference's
``PartitionSpec`` as a tuple, one entry per tensor dim: an axis name, a
tuple of axis names, or None, so it compares with ``tuple(PartitionSpec)``
directly.  :func:`to_placements` turns it into DTensor placements over a
``DeviceMesh`` whose dim names are the axes.  The port's layer leaves are
per layer (``layers.{i}.ssm.wz``), not stacked over the layers, so their
specs have no leading ``None``.  The rules read only the mesh's dim names
and sizes (``mesh_dim_names`` and ``shape``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.models.config import ArchConfig

# Layouts (the hillclimb knobs; default is the paper-faithful baseline):
#   baseline            — TP over 'model', FSDP over (pod, data)
#   dp-only             — no TP: 'model' joins the data axes (batch + FSDP
#                         shard over every axis).  Right for small models
#                         whose TP all-reduces dwarf their compute.
#   replicated-weights  — weights sharded over 'model' only (replicated over
#                         data axes).  Right for decode: kills the per-step
#                         FSDP re-gather at the cost of dp x weight memory.
LAYOUTS = ("baseline", "dp-only", "replicated-weights", "pure-dp")
# pure-dp: weights fully replicated, batch over every axis — the classic
# small-model answer (grad all-reduce is the only collective).


def mesh_axes(mesh) -> dict[str, int]:
    """The mesh's axis sizes by name, in mesh order (the reference's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh, layout: str = "baseline") -> tuple[str, ...]:
    names = mesh.mesh_dim_names
    axes = tuple(a for a in ("pod", "data") if a in names)
    if layout == "dp-only" and "model" in names:
        axes = (*axes, "model")
    if layout in ("replicated-weights", "pure-dp"):
        return ()  # weights see no data axes
    return axes


def model_axis_size(mesh, layout: str = "baseline") -> int:
    if layout in ("dp-only", "pure-dp"):
        return 1
    return mesh_axes(mesh).get("model", 1)


def pad_config_for_mesh(cfg: ArchConfig, mesh, layout: str = "baseline") -> ArchConfig:
    """Pad q heads / vocab so TP dims divide the model axis (exact math)."""
    tp = model_axis_size(mesh, layout)
    changes: dict[str, Any] = {"vocab_pad_multiple": 128 * tp}
    if cfg.num_heads and cfg.num_heads % tp:
        padded = -(-cfg.num_heads // tp) * tp
        changes["orig_num_heads"] = cfg.num_heads
        changes["num_heads"] = padded
    return dataclasses.replace(cfg, **changes)


def _axes_size(mesh, axis) -> int:
    sizes = mesh_axes(mesh)
    out = 1
    for a in axis if isinstance(axis, tuple) else (axis,):
        out *= sizes[a]
    return out


def _spec_for(name: str, shape: tuple[int, ...], cfg: ArchConfig, mesh, layout: str = "baseline") -> tuple:
    """The spec of one leaf of one layer (or of an unstacked leaf): the reference's
    ``_spec_for`` with ``stacked=False``."""
    da = data_axes(mesh, layout)
    DA = da if len(da) > 1 else (da[0] if da else None)
    tp = model_axis_size(mesh, layout)
    mdl = "model" if tp > 1 else None

    def div(dim: int, axis) -> Any:
        if axis is None:
            return None
        return axis if dim % _axes_size(mesh, axis) == 0 else None

    d = shape
    nd = len(d)
    if name in ("embed",):
        return (div(d[0], mdl), div(d[1], DA))
    if name == "unembed":
        return (div(d[0], DA), div(d[1], mdl))
    if name == "dec_pos":
        return (div(d[0], mdl), div(d[1], DA))
    if name == "wq":
        return (div(d[0], DA), div(d[1], mdl), None)
    if name in ("wk", "wv"):
        return (div(d[0], DA), div(d[1], mdl), None)
    if name == "wo":
        return (div(d[0], mdl), None, div(d[2], DA))
    if name in ("bq", "bk", "bv"):
        return (div(d[0], mdl), None)
    if name in ("gate", "up"):  # mlp (D,F) or moe (E,D,F)
        if nd == 2:
            return (div(d[0], DA), div(d[1], mdl))
        return (None, div(d[1], DA), div(d[2], mdl))
    if name == "down":          # mlp (F,D) or moe (E,F,D)
        if nd == 2:
            return (div(d[0], mdl), div(d[1], DA))
        return (None, div(d[1], mdl), div(d[2], DA))
    if name == "router":
        return (div(d[0], DA), None)
    if name in ("wi", "wo_mlp"):
        return (div(d[0], DA), div(d[1], mdl))
    if name in ("wz", "wx"):
        return (div(d[0], DA), div(d[1], mdl))
    if name in ("wb", "wc"):
        return (div(d[0], DA), None)
    if name == "wdt":
        return (div(d[0], DA), div(d[1], mdl))
    if name == "out_proj":
        return (div(d[0], mdl), div(d[1], DA))
    if name == "conv_x":
        return (None, div(d[1], mdl))
    if name in ("conv_b", "conv_c"):
        return (None, None)
    if name in ("a_log", "dt_bias", "d_skip"):
        return (div(d[0], mdl),)
    if name == "bi":            # gelu mlp hidden bias (F,)
        return (div(d[0], mdl),)
    return (None,) * nd         # norms, small biases: replicate


def _leaf_name(name: str, shape: tuple[int, ...]) -> str:
    """The name the rules key on: the last part of the port's dotted name, with a
    gelu-mlp ``wo`` (2-D) told from attention's ``wo`` (3-D), as the reference does."""
    leaf = name.rpartition(".")[2]
    return "wo_mlp" if leaf == "wo" and len(shape) == 2 else leaf


def param_specs(cfg: ArchConfig, mesh, params_shape, layout: str = "baseline") -> dict[str, tuple]:
    """Spec per parameter name of a (possibly meta) model module.

    A leaf under ``layers``/``enc_layers``/``dec_layers`` is one layer of the
    reference's stacked leaf (``convert.STACKED``): its spec is the
    reference's without the leading ``None``.
    """
    out = {}
    for name, p in params_shape.named_parameters():
        shape = tuple(p.shape)
        leaf = _leaf_name(name, shape)
        if leaf in ("scale", "bias", "bo", "conv_bx", "conv_bb", "conv_bc"):
            out[name] = (None,) * len(shape)
        else:
            out[name] = _spec_for(leaf, shape, cfg, mesh, layout)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh: the reference's ``jax.sharding.NamedSharding``."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> list:
        return to_placements(self.spec, self.mesh)


def to_placements(spec: tuple, mesh) -> list:
    """DTensor placements for ``spec`` on ``mesh``: ``Shard(d)`` on each mesh dim that
    spec entry ``d`` names, ``Replicate()`` on the others.  Mesh dims that split one
    tensor dim do so in mesh order, which is what a tuple of axes means in JAX; a
    tuple in any other order, or an axis named twice, is refused."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (() if entry is None else (entry,))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the mesh's order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} named twice")
            out[i] = Shard(d)
    return out


def param_shardings(cfg: ArchConfig, mesh, params_shape, layout: str = "baseline") -> dict[str, NamedSharding]:
    return to_shardings(mesh, param_specs(cfg, mesh, params_shape, layout))


# ------------------------------------------------------- local shard geometry
def model_dim(spec: tuple) -> int | None:
    """The tensor dim that ``spec`` splits over the ``"model"`` axis, or None."""
    for d, entry in enumerate(spec):
        if "model" in (entry if isinstance(entry, tuple) else (entry,)):
            return d
    return None


def tp_spec(name: str, spec: tuple) -> tuple:
    """The spec a tensor-parallel step computes leaf ``name`` in: its stored
    ``spec``, but a GELU MLP's ``wo`` (F, D), which the reference's rules store
    with D over ``"model"``, row-parallel: F over ``"model"``, so that the hidden
    columns a rank computes meet their own rows and one all-reduce closes the
    layer (an all-to-all of the weight a step, where a split D would gather the
    (B, S, F) activations each layer)."""
    if _leaf_name(name, (0,) * len(spec)) == "wo_mlp":
        return ("model", None)
    return spec


def model_shard(spec: tuple, shape: tuple[int, ...], mesh) -> tuple[int, int, int] | None:
    """``(dim, start, length)`` of this rank's model-axis shard of a leaf of global
    ``shape`` under ``spec`` (a ``"model"`` entry alone in its dim: the TP
    layouts' specs), or None where the spec keeps the leaf whole over ``"model"``."""
    d = model_dim(spec)
    if d is None:
        return None
    n = shape[d] // mesh_axes(mesh)["model"]
    return d, mesh.get_local_rank("model") * n, n


# ---------------------------------------------------------------- activations
def batch_specs(cfg: ArchConfig, mesh, batch_shape, layout: str = "baseline") -> dict[str, tuple]:
    da = data_axes(mesh, "dp-only" if layout in ("dp-only", "pure-dp") else "baseline")
    DA = da if len(da) > 1 else (da[0] if da else None)
    dsz = _axes_size(mesh, da) if da else 1

    def spec(leaf):
        b = leaf.shape[0]
        first = DA if b % max(dsz, 1) == 0 and dsz > 1 else None
        return (first, *([None] * (len(leaf.shape) - 1)))

    return {k: spec(v) for k, v in batch_shape.items()}


def cache_specs(cfg: ArchConfig, mesh, cache_shape, layout: str = "baseline") -> dict[str, Any]:
    """KV/SSM cache specs for decode (see module docstring)."""
    da = data_axes(mesh, "dp-only" if layout in ("dp-only", "pure-dp") else "baseline")
    DA = da if len(da) > 1 else (da[0] if da else None)
    dsz = _axes_size(mesh, da) if da else 1
    tp = model_axis_size(mesh)

    def spec(name, shp):
        if name in ("k", "v", "cross_k", "cross_v"):
            # (L_or_sites, B, S, K, hd)
            _, b, s, kh, hd = shp
            bspec = DA if dsz > 1 and b % dsz == 0 else None
            if bspec is None and dsz > 1 and s % (dsz * tp) == 0:
                sspec = (*da, "model") if tp > 1 else DA
            else:
                sspec = "model" if tp > 1 and s % tp == 0 else None
            return (None, bspec, sspec, None, None)
        if name == "state":  # (L, B, H, P, N)
            _, b, h, p, n = shp
            bspec = DA if dsz > 1 and b % dsz == 0 else None
            hspec = "model" if tp > 1 and h % tp == 0 else None
            return (None, bspec, hspec, None, None)
        if name == "conv":  # (L, B, W, C) — small, replicate beyond batch
            b = shp[1]
            bspec = DA if dsz > 1 and b % dsz == 0 else None
            return (None, bspec, None, None)
        return (None,) * len(shp)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else spec(k, tuple(v.shape)) for k, v in tree.items()}

    return walk(cache_shape)


def to_shardings(mesh, spec_tree) -> Any:
    if isinstance(spec_tree, dict):
        return {k: to_shardings(mesh, v) for k, v in spec_tree.items()}
    return NamedSharding(mesh, spec_tree)


def distribute(tree: Any, shardings: Any) -> Any:
    """Place each tensor of ``tree`` as a DTensor in its sharding (the reference's
    ``jax.device_put(tree, shardings)``), from rank 0's values.  Each rank keeps
    only its shard; on a mesh of one rank that shard may share the tensor's storage."""
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    s = shardings
    return distribute_tensor(tree.detach().to(s.mesh.device_type), s.mesh, s.placements)
