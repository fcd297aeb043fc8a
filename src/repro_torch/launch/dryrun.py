"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on fake tensors.

The reference lowers and compiles each cell's jitted step on 512 forced XLA
host devices.  Here a ``"fake"`` process group
(``torch.testing._internal.distributed.fake_pg``) of 256 or 512 ranks
stands for the cards: this process is rank 0, and every collective returns
at once, moving nothing.  For every cell this script:

    1. builds the production mesh (16x16 single-pod or 2x16x16 multi-pod)
       over that group (``make_production_mesh``),
    2. pads the arch config for the mesh (head/vocab divisibility),
    3. builds the port's sharded step (``make_train_step`` with AdamW,
       ``make_prefill_step`` or ``make_decode_step``) and places fake params,
       optimizer state, batch and cache as DTensors in the rules'
       placements (``rules.distribute``),
    4. runs the step once, under ``torch._subclasses.FakeTensorMode`` and a
       dispatch mode of this module that counts rank 0's FLOPs
       (``torch.utils.flop_counter``'s formulas), the bytes its ops read and
       write, every collective with its operand bytes and group size, and the
       peak of its live storages,
    5. records memory, the analytic roofline terms and the traced figures
       beside them into a JSON row (``launch/roofline.py``).

Fake tensors hold no data, so nothing is allocated on any device.  The step
is traced on fake tensors of the CPU device type, where the kernels' entry
points run their plain versions (``kernels/ssd_scan/ops.py``), as the
reference's dry-run lowers ``ssd_scan_ref``.  Never trace on ``cuda``: a
fake CUDA tensor would reach a kernel's ctypes launch with no storage
behind it.  Every figure is a count from a CPU trace, priced at the H100's
data-sheet peaks; none is a measurement on a card.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh both
    python -m repro_torch.launch.dryrun --all --mesh single --out src/repro_torch/results/dryrun_single.json
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor import DTensor, Shard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, SHAPES, applicable
from repro_torch.data.pipeline import batch_struct
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.train import step as step_lib

# the functional collectives the port's steps issue on the CPU device type, by
# their HLO names (DTensor redistributes Shard(i) -> Shard(j) there by an
# all-gather; the all-to-all is ``sharding/tp.py``'s, moving a GELU ``wo``
# between its stored and its compute split); any other collective fails the cell
_COLLECTIVES = {"all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
                "all_reduce": "all-reduce", "all_to_all_single": "all-to-all"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Census(TorchDispatchMode):
    """Counts what one rank's step does, op by op, on tensors of any kind.

    ``trace`` gathers FLOPs, bytes read and written by each op that is not a
    view (its tensor inputs and outputs), and each functional collective
    (``wait_tensor`` and ``_wrap_tensor_autograd`` aside: the functional ops'
    waits, and the wrapper they return on a real process group).  Memory is counted by storage: an output that
    aliases none of its op's inputs is a new allocation, live until its
    storage is freed (a weak reference's callback, as
    ``torch.distributed._tools.mem_tracker`` tracks storages, without its
    module hooks); ``peak`` is the most bytes live at once, counting from
    ``arguments``, the tensors the step is given."""

    def __init__(self, arguments: list[torch.Tensor] = ()):
        super().__init__()
        self.trace = roofline.Trace()
        self.live = self.peak = 0
        self._refs: dict[int, weakref.ref] = {}
        for t in arguments:
            self._track(t.untyped_storage())

    def _track(self, st) -> None:
        key = id(st)
        if key in self._refs:
            return
        n = st.nbytes()
        self._refs[key] = weakref.ref(st, functools.partial(self._freed, key, n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _freed(self, key: int, n: int, _ref) -> None:
        del self._refs[key]
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._overloadpacket not in flop_registry and func is not torch.ops.prim.device.default:
            # under inference_mode a composite op (matmul, einsum) arrives whole:
            # count the ops it is made of, as FlopCounterMode does
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        ins = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        packet = func._overloadpacket
        if packet in flop_registry:
            self.trace.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.namespace == "_c10d_functional" and packet.__name__ not in ("wait_tensor", "_wrap_tensor_autograd"):
            name = _COLLECTIVES.get(packet.__name__)
            if name is None:
                raise NotImplementedError(f"the census does not price {func}")
            group = next(a for a in reversed(args) if isinstance(a, str))
            self.trace.collectives.append(roofline.Collective(
                name, sum(map(_nbytes, ins)), sum(map(_nbytes, outs)), _resolve_process_group(group).size()))
        if outs and not func.is_view:
            self.trace.bytes_accessed += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        seen = {id(t.untyped_storage()) for t in ins}
        for o in outs:
            st = o.untyped_storage()
            if id(st) not in seen:
                self._track(st)
        return out


@dataclasses.dataclass
class Lowered:
    """One cell's sharded step and its fake inputs, ready to trace: ``step(*args)``
    under ``fake_mode``.  ``arguments`` are this rank's local tensors among the
    inputs, and ``argument_bytes`` their bytes with the rank's rows of the
    global batch."""

    step: Callable
    args: tuple
    fake_mode: Any
    arguments: list
    argument_bytes: int


def _fake(tree):
    """A fake tensor of the same shape and dtype for each leaf of ``tree`` (a meta
    module's parameters, or a dict of tensors), under the ambient fake mode."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    return {k: _fake(v) if isinstance(v, dict) else torch.empty(v.shape, dtype=v.dtype) for k, v in tree.items()}


def _locals(tree) -> list[torch.Tensor]:
    """This rank's tensors in ``tree``: each DTensor's local shard, each plain tensor."""
    return [t.to_local() if isinstance(t, DTensor) else t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _rows_bytes(cfg, mesh, batch: dict, layout: str) -> int:
    """The bytes of this rank's rows of ``batch`` under ``rules.batch_specs``."""
    total = 0
    for k, spec in rules.batch_specs(cfg, mesh, batch, layout).items():
        split = [mesh.size(i) for i, pl in enumerate(rules.to_placements(spec, mesh)) if isinstance(pl, Shard)]
        total += _nbytes(batch[k]) // math.prod(split)
    return total


def input_specs(cfg, shape_spec) -> dict:
    """The global batch as fake tensors (under the ambient fake mode); each rank
    takes its rows by ``rules.batch_specs`` inside the step."""
    return _fake(batch_struct(cfg, shape_spec.seq_len, shape_spec.global_batch))


def lower_cell(arch: str, shape: str, mesh, *, layout: str = "baseline", grad_dtype: str = "float32",
               remat: bool = True, zero1: bool = False):
    """Returns (lowered, cfg, spec) for one cell on `mesh`."""
    spec = SHAPES[shape]
    cfg = rules.pad_config_for_mesh(ARCHS[arch], mesh, layout)
    if not remat:
        cfg = dataclasses.replace(cfg, remat=False)
    fake_mode = torch._subclasses.FakeTensorMode()
    with fake_mode:
        batch = input_specs(cfg, spec)
        if spec.step == "train":
            step, params_shape, pspecs, opt_shape, ospecs = step_lib.make_train_step(
                cfg, mesh, adamw.AdamWConfig(), layout=layout, grad_dtype=grad_dtype)
            if zero1:
                # ZeRO-1: optimizer states sharded over the data axes even
                # when params are replicated (grad RS + param AG per step)
                zshard = rules.param_shardings(cfg, mesh, params_shape, "dp-only")
                ospecs = {"mu": zshard, "nu": zshard, "step": ospecs["step"]}
            params = rules.distribute(_fake(params_shape), pspecs)
            opt = rules.distribute(_fake(opt_shape), ospecs)
            args, held = (params, opt, batch), (params, opt)
        elif spec.step == "prefill":
            batch.pop("labels", None)
            step, params_shape, pspecs = step_lib.make_prefill_step(cfg, mesh, spec.seq_len, layout=layout)
            params = rules.distribute(_fake(params_shape), pspecs)
            args, held = (params, batch), (params,)
        else:  # decode
            step, params_shape, pspecs = step_lib.make_decode_step(cfg, mesh, layout=layout)
            cache_shape = step_lib.abstract_cache(cfg, spec.global_batch, spec.seq_len)
            cshard = rules.to_shardings(mesh, rules.cache_specs(cfg, mesh, cache_shape, layout))
            cache = _fake(cache_shape)
            # a constant the fake mode can read back: decode writes the cache's last slot
            cache["pos"] = torch.tensor(spec.seq_len - 1, dtype=torch.int32)
            cache = rules.distribute(cache, cshard)
            params = rules.distribute(_fake(params_shape), pspecs)
            batch = {"tokens": batch["tokens"][:, :1]}
            args, held = (params, cache, batch["tokens"]), (params, cache)
        arguments = _locals(held)
        argument_bytes = sum(_nbytes(t) for t in arguments) + _rows_bytes(cfg, mesh, batch, layout)
    return Lowered(step, args, fake_mode, arguments, argument_bytes), cfg, spec


def trace_cell(lowered: Lowered) -> tuple[roofline.Trace, dict]:
    """Runs ``lowered``'s step once under a ``Census``; returns its trace and the
    row's memory figures (bytes on rank 0)."""
    with lowered.fake_mode, Census(lowered.arguments) as census:
        out = lowered.step(*lowered.args)
        outs = {id(t.untyped_storage()): _nbytes(t) for t in _locals(out)}
    argument = lowered.argument_bytes
    peak = max(census.peak, argument)
    memory = {"argument_bytes": argument, "output_bytes": sum(outs.values()), "temp_bytes": peak - argument,
              "peak_bytes": peak}
    return census.trace, memory


def run_cell(arch: str, shape: str, mesh_kind: str, layout: str = "baseline", grad_dtype: str = "float32",
             remat: bool = True, zero1: bool = False) -> dict:
    """One cell's row, over the current process group (``fake_group``)."""
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device="cpu")
    row = {"arch": arch, "shape": shape, "mesh": mesh_kind, "devices": mesh.size(),
           "layout": layout, "grad_dtype": grad_dtype, "remat": remat, "zero1": zero1}
    if not applicable(arch, shape):
        row["status"] = "skipped"
        row["reason"] = "full-attention arch: long_500k inapplicable (DESIGN.md)"
        return row
    t0 = time.time()
    try:
        lowered, cfg, spec = lower_cell(arch, shape, mesh, layout=layout, grad_dtype=grad_dtype, remat=remat,
                                        zero1=zero1)
        t1 = time.time()
        trace, memory = trace_cell(lowered)
        t2 = time.time()
        rl = roofline.analyze(
            trace, cfg=cfg, spec=spec, mesh=mesh, layout=layout,
            grad_bytes=2 if grad_dtype == "bfloat16" else 4,
            model_flops=roofline.model_flops_for(cfg, spec),
        )
        row.update(
            status="ok",
            lower_s=round(t1 - t0, 2),
            trace_s=round(t2 - t1, 2),
            memory=memory,
            roofline=dataclasses.asdict(rl),
        )
    except Exception as e:  # a failure here is a sharding/memory bug
        row["status"] = "FAIL"
        row["error"] = f"{type(e).__name__}: {e}"
        row["traceback"] = traceback.format_exc()[-2000:]
    return row


def fake_group(world: int) -> None:
    """Make the default process group a ``"fake"`` one of ``world`` ranks, with this
    process as rank 0, unless it already is one."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--layout", choices=["baseline", "dp-only", "replicated-weights", "pure-dp"], default="baseline")
    ap.add_argument("--grad-dtype", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]] = []
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        archs = [args.arch] if args.arch else list(ARCHS)
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(a, s) for a in archs for s in shapes]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    rows = []
    for mk in meshes:  # one fake group per mesh kind
        fake_group(512 if mk == "multi" else 256)
        for arch, shape in cells:
            row = run_cell(arch, shape, mk, layout=args.layout, grad_dtype=args.grad_dtype, remat=not args.no_remat,
                           zero1=args.zero1)
            rows.append(row)
            rl = row.get("roofline", {})
            print(
                f"[{row['status']:7s}] {arch:20s} {shape:12s} {mk:6s} "
                f"trace={row.get('trace_s', '-'):>7}s "
                f"bottleneck={rl.get('bottleneck', '-'):10s} "
                f"terms(ms)=c{1e3*rl.get('compute_s', 0):.1f}/m{1e3*rl.get('memory_s', 0):.1f}/x{1e3*rl.get('collective_s', 0):.1f}",
                flush=True,
            )
            if row["status"] == "FAIL":
                print(row["error"], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
            keys = {(r["arch"], r["shape"], r["mesh"], r.get("layout", "baseline"), r.get("grad_dtype", "float32")) for r in rows}
            existing = [r for r in existing if (r["arch"], r["shape"], r["mesh"], r.get("layout", "baseline"), r.get("grad_dtype", "float32")) not in keys]
        with open(args.out, "w") as f:
            json.dump(existing + rows, f, indent=1)
        print(f"wrote {len(rows)} rows -> {args.out}")
    if any(r["status"] == "FAIL" for r in rows):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
