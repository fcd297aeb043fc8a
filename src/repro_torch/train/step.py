"""Train / prefill / decode step builders.

``make_train_fn`` returns ``train_step(params, opt_state, batch) -> (params,
opt_state, metrics)``, the reference's un-jitted step: ``params`` is the
model (an ``nn.Module`` from ``init_params``) and ``opt_state`` comes from
``repro_torch.optim.adamw.init``.  The step updates both in place and
returns the same objects, as the reference donates its buffers; ``metrics``
holds ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors on the params'
device, read back by no one inside the step.  Optional hooks: gradient
compression (``repro_torch.train.compress``, without error state, as the
reference, over the reference's tensors: each layer leaf stacked over the
layers) and microbatched gradient accumulation.

On the card the Mamba2 and flash-attention layers run their CUDA kernels
forward; their backward is the gradient of the plain version, recomputed
(``kernels/*/ops.py``).

``make_train_step`` is the sharded step over a ``DeviceMesh``: params and
AdamW state live between steps as DTensors in the placements of
``repro_torch.sharding.rules``, each rank holding only its shards.  It
takes ``make_train_fn``'s keywords: ``accum_steps`` slices microbatches
from the global batch before each rank takes its rows, and sums their
gradients before the one reduce-scatter; ``compress`` runs on the
reduce-scattered shards, per tensor of the reference's stacked tree, with
only per-tensor maxima (int8) or counts (top-k) on the wire.
``make_prefill_step`` and ``make_decode_step`` are the serving steps over
the same placements, with the cache in ``rules.cache_specs``'.  Each rank
runs the model on its rows of the batch (the data axes).  Where the model
axis is wider than 1 (``baseline``, ``replicated-weights``) the steps of every
family are tensor parallel over it (``sharding/tp.py``, ``model_group``): each
leaf is gathered over the data axes only, each rank keeps its model-axis shard
and computes only its heads, hidden and expert hidden columns and vocabulary
slice (a GELU MLP's ``wo``, stored split over its output dim, is moved to its
rows by an all-to-all, ``rules.tp_spec``).  The decode steps keep the K/V
cache (and whisper's cross K/V) in its placements, each rank attending over
its own shard of the sequence.  The abstract trees (``abstract_params``,
``abstract_opt_state``, ``abstract_cache``) are the same trees on the ``meta``
device.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.utils._pytree import tree_map

from repro_torch.convert import STACKED
from repro_torch.models import get_model
from repro_torch.models.config import ArchConfig
from repro_torch.models.encdec import MAX_DECODER_POS
from repro_torch.models.layers import Attention, kv_head_map, kv_map
from repro_torch.models.transformer import nll_sum
from repro_torch.obs import span
from repro_torch.optim import adamw
from repro_torch.sharding import rules, tp
from repro_torch.train.compress import dequantize_int8


def abstract_params(cfg: ArchConfig) -> nn.Module:
    """The model with every leaf on the ``meta`` device: shapes and dtypes, no storage."""
    return get_model(cfg).init_params(cfg, torch.Generator(), device="meta")


def abstract_opt_state(params_shape) -> dict:
    return adamw.init(params_shape)


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16) -> dict:
    return get_model(cfg).init_cache(cfg, batch, max_len, dtype, device="meta")


class _Apply(nn.Module):
    """``fn(model, *args)`` as a module's forward, so that ``torch.func.functional_call``
    can run ``fn`` with ``model``'s leaves swapped for others."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def _loss_and_grad(cfg: ArchConfig, model: nn.Module, loss, leaves: dict[str, torch.Tensor], batch):
    """(loss, {name: gradient}) of ``loss`` with ``model``'s parameters swapped for
    ``leaves``.  The gradient is taken inside the call: there the swapped leaves
    stay in place for the backward too, where ``remat`` recomputes each layer's
    forward."""

    def value_and_grad(model, batch, leaves):
        value = loss(cfg, model, batch)
        return value.detach(), torch.autograd.grad(value, leaves, materialize_grads=True)

    value, grads = torch.func.functional_call(_Apply(model, value_and_grad),
                                              {f"model.{n}": t for n, t in leaves.items()},
                                              (batch, list(leaves.values())))
    return value, dict(zip(leaves, grads))


def _layer_groups(names) -> dict[str, list[str]]:
    """The port's names grouped as the reference's tree holds them: each layer
    leaf's per-layer names (``layers.3.mlp.gate``) under its stacked name
    (``layers.mlp.gate``), in layer order; every other name alone under itself."""
    parts: dict[str, list[tuple[int, str]]] = {}
    for name in names:
        stack, _, rest = name.partition(".")
        i, _, leaf = rest.partition(".")
        if stack in STACKED and i.isdigit():
            parts.setdefault(f"{stack}.{leaf}", []).append((int(i), name))
        else:
            parts[name] = [(0, name)]
    return {k: [n for _, n in sorted(v)] for k, v in parts.items()}


def _stack_layers(grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The reference's tree stacks each layer leaf over the layers (``layers/mlp/gate``
    is (L, D, F)); group the port's per-layer grads the same way (``_layer_groups``),
    so that per-tensor compression sees the reference's tensors."""
    return {k: grads[k] if names == [k] else torch.stack([grads[n] for n in names])
            for k, names in _layer_groups(grads).items()}


def _unstack_layers(stacked: dict[str, torch.Tensor], names) -> dict[str, torch.Tensor]:
    """Undo ``_stack_layers``: the port's per-layer names, in ``names``' order."""
    out = {}
    for name in names:
        stack, _, rest = name.partition(".")
        i, _, leaf = rest.partition(".")
        out[name] = stacked[f"{stack}.{leaf}"][int(i)] if stack in STACKED and i.isdigit() else stacked[name]
    return out


def _refuse_served_only(cfg: ArchConfig, what: str) -> None:
    """The zamba2, granitemoehybrid and falcon_h1 families are served on one card: their training and
    sharded steps are not built."""
    if cfg.family in ("zamba2", "granitemoehybrid", "falcon_h1"):
        raise NotImplementedError(f"{what}: the {cfg.family} family runs unsharded through prefill, decode_step "
                                  "and forward only; its training and tensor-parallel steps are not built")


def make_train_fn(cfg: ArchConfig, ocfg: adamw.AdamWConfig | None = None, *, compress: str = "none",
                  accum_steps: int = 1, grad_dtype: str = "float32"):
    """The train-step function (not for the zamba2, granitemoehybrid or falcon_h1 family, ``_refuse_served_only``).

    ``grad_dtype='bfloat16'`` differentiates w.r.t. a bf16 copy of the params
    (mixed precision): gradients — and therefore the data-parallel reduction
    on the wire — are bf16, halving the gradient collective.  The fp32 master
    weights still receive the update (adamw casts grads to fp32 internally).
    """
    _refuse_served_only(cfg, "make_train_fn")
    ocfg = ocfg or adamw.AdamWConfig()
    m = get_model(cfg)

    def value_and_grad(params: nn.Module, batch):
        named = dict(params.named_parameters())
        loss = m.loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, list(named.values()), materialize_grads=True)
        return loss.detach(), dict(zip(named, grads))

    def train_step(params: nn.Module, opt_state: dict, batch: dict):
        with span("train.step"):
            if grad_dtype != "float32":
                dt = getattr(torch, grad_dtype)
                with span("train.loss_and_grad"):
                    cast = {n: p.detach().to(dt).requires_grad_() if p.dtype == torch.float32 else p
                            for n, p in params.named_parameters()}
                    loss, grads = _loss_and_grad(cfg, params, m.loss_fn, cast, batch)
                metrics = adamw.update(ocfg, grads, opt_state, params)
                metrics["loss"] = loss
                return params, opt_state, metrics
            with span("train.loss_and_grad"):
                if accum_steps > 1:
                    loss = torch.zeros((), dtype=torch.float32, device=opt_state["step"].device)
                    grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                             for n, p in params.named_parameters()}
                    for i in range(accum_steps):
                        mb = {k: x[i * (x.shape[0] // accum_steps):(i + 1) * (x.shape[0] // accum_steps)]
                              for k, x in batch.items()}
                        mloss, mgrads = value_and_grad(params, mb)
                        loss = loss + mloss
                        for n, g in mgrads.items():
                            grads[n] += g
                    loss = loss / accum_steps
                    grads = {n: g / accum_steps for n, g in grads.items()}
                else:
                    loss, grads = value_and_grad(params, batch)
            if compress != "none":
                from repro_torch.train.compress import compress_grads

                with span("train.compress"):
                    grads = _unstack_layers(compress_grads(_stack_layers(grads), method=compress), list(grads))
            metrics = adamw.update(ocfg, grads, opt_state, params)
            metrics["loss"] = loss
            return params, opt_state, metrics

    return train_step


def model_group(cfg: ArchConfig, mesh, layout: str) -> tp.Group | None:
    """This rank's model-axis group when the steps of ``cfg`` run tensor parallel
    on ``mesh`` under ``layout``, else None.  That needs the q heads, SSM
    heads, FFN and expert hidden, padded vocabulary and whisper's decoder
    positions and width to divide the axis (``rules.pad_config_for_mesh`` pads
    the q heads and the vocabulary; every registered arch divides 16); where one
    does not, the spec keeps its leaves whole over ``model`` and the step
    gathers every leaf."""
    size = rules.model_axis_size(mesh, layout)
    if size == 1:
        return None
    dims = [cfg.vocab_padded]
    if cfg.family in ("ssm", "hybrid"):
        dims.append(cfg.ssm_num_heads)
    if cfg.family in ("dense", "hybrid", "vlm"):
        dims += [cfg.num_heads, cfg.d_ff]
    if cfg.family == "moe":
        dims += [cfg.num_heads, cfg.expert_d_ff, cfg.expert_d_ff * cfg.num_shared_experts]
    if cfg.family == "encdec":  # wo's output dim too: the step moves its split from there (``rules.tp_spec``)
        dims += [cfg.num_heads, cfg.d_ff, cfg.d_model, MAX_DECODER_POS]
    if any(v % size for v in dims):
        return None
    return tp.Group(mesh.get_group("model"), mesh.get_local_rank("model"), size)


def _shell(cfg: ArchConfig, device_type: str, g: tp.Group | None = None) -> nn.Module:
    """The model's modules with meta leaves and real buffers (each attention's q-head ->
    kv-head map) on ``device_type``: what a sharded step fills with gathered leaves.
    Under TP each module that splits over the model axis gets the group, and each
    attention the map of this rank's q heads into the kv heads it reads."""
    shell = abstract_params(cfg)
    for mod in shell.modules():
        if isinstance(mod, Attention):
            mod.kvm = kv_map(cfg, g).to(device_type)
        if g is not None and hasattr(mod, "tp_group"):
            mod.tp_group = g
    return shell


class _Keep(dict):
    """Under TP, each leaf's placements gathered over the data axes only: ``Shard``
    on the model axis where its spec splits it there (``rules.model_dim``),
    ``Replicate`` elsewhere; and ``turn``, the leaves whose compute spec
    (``rules.tp_spec``) splits another dim over the model axis, as (stored dim,
    compute dim), which an all-to-all over ``group`` moves between."""

    def __init__(self, placements: dict[str, list], turn: dict[str, tuple[int, int]], group: tp.Group):
        super().__init__(placements)
        self.turn, self.group = turn, group


def _keep_model(mesh, pspecs: dict, g: tp.Group | None) -> _Keep | None:
    """``_Keep`` for ``pspecs`` under TP; None without TP: every leaf is gathered whole."""
    if g is None:
        return None
    dims = {n: rules.model_dim(s.spec) for n, s in pspecs.items()}
    turn = {n: (dims[n], d) for n, s in pspecs.items() if (d := rules.model_dim(rules.tp_spec(n, s.spec))) != dims[n]}
    return _Keep({n: [Shard(d) if a == "model" and d is not None else Replicate() for a in mesh.mesh_dim_names]
                  for n, d in dims.items()}, turn, g)


def _leaves(params: dict[str, DTensor], keep: _Keep | None) -> dict[str, torch.Tensor]:
    """Each param as this rank computes with it: whole (``full_tensor``) or, under TP,
    gathered over the data axes into ``keep``'s placements, the rank's model-axis
    shard, moved to its compute dim where ``keep.turn`` says."""
    with torch.no_grad():
        if keep is None:
            return {n: p.full_tensor() for n, p in params.items()}
        out = {n: p.redistribute(p.device_mesh, keep[n]).to_local().detach() for n, p in params.items()}
        for n, (stored, compute) in keep.turn.items():
            out[n] = tp.all_to_all(out[n], compute, stored, keep.group)
        return out


def _rows(cfg: ArchConfig, mesh, batch: dict[str, torch.Tensor], layout: str) -> tuple[dict, list]:
    """This rank's rows of the global ``batch`` (``rules.batch_specs``), and the
    placements of its ``tokens``."""
    bspecs = rules.batch_specs(cfg, mesh, batch, layout)
    rows = {k: distribute_tensor(v.to(mesh.device_type), mesh, rules.to_placements(bspecs[k], mesh),
                                 src_data_rank=None).to_local() for k, v in batch.items()}
    return rows, rules.to_placements(bspecs["tokens"], mesh)


def _cache_rows(mesh, cache: dict, tokens: list, g: tp.Group | None, kept: dict | None = None) -> dict:
    """The placements of each cache leaf held as this rank's batch rows: the batch
    (dim 1) split where the tokens' rows are, every other dim whole, but under TP
    the SSM state's heads (dim 2) split over the model axis, as the rank holds them.
    ``kept``, where given, holds placements by leaf name (the K/V leaves', and
    whisper's cross K/V's), kept as they are (a decode over their sequence shards)."""
    def rows(t, heads=False):
        return [Shard(2) if heads and a == "model" else Shard(1) if isinstance(pl, Shard) and t.ndim > 1
                else Replicate() for a, pl in zip(mesh.mesh_dim_names, tokens)]

    def leaf(n, t):
        return kept[n] if kept and n in kept else rows(t, g is not None and n == "state")

    return {k: {n: leaf(n, t) for n, t in v.items()} if isinstance(v, dict) else leaf(k, v) for k, v in cache.items()}


def _place_cache(cfg: ArchConfig, mesh, local: dict, held: dict, layout: str) -> dict:
    """This rank's cache, held in ``held``'s placements (``_cache_rows``), as DTensors
    in ``rules.cache_specs``' placements."""
    rows = tree_map(lambda t, pl: DTensor.from_local(t, mesh, pl, run_check=False), local, held)
    shardings = rules.to_shardings(mesh, rules.cache_specs(cfg, mesh, rows, layout))
    return tree_map(lambda t, s: t.redistribute(mesh, s.placements), rows, shardings)


def _seq_split(mesh, placements: list, local_len: int, kvm: torch.Tensor) -> tp.SeqSplit | None:
    """This rank's shard of a K/V cache whose sequence (dim 2) ``placements`` split
    over one or more mesh dims, which take it in mesh order (``rules.to_placements``),
    or None where the sequence is whole on the rank."""
    dims = [i for i, pl in enumerate(placements) if pl == Shard(2) and mesh.size(i) > 1]
    if not dims:
        return None
    index = 0
    for i in dims:
        index = index * mesh.size(i) + mesh.get_local_rank(i)
    groups = tuple(tp.Group(mesh.get_group(i), mesh.get_local_rank(i), mesh.size(i)) for i in dims)
    return tp.SeqSplit(index * local_len, groups, kvm)


def _gather(params: dict[str, DTensor], keep: dict[str, list] | None) -> dict[str, torch.Tensor]:
    """``_leaves`` keyed for ``functional_call`` of an ``_Apply``.  Each leaf is a
    leaf that requires grad, as a module's parameter is (not a view of the
    gather's buffer), so that the serving functions take the module's paths
    through ``matmul`` and give its results bitwise."""
    return {f"model.{n}": t.detach().requires_grad_() if t.is_floating_point() else t
            for n, t in _leaves(params, keep).items()}


def _reduce_squares(sq: list[torch.Tensor], grads: list[DTensor]) -> torch.Tensor:
    """Each leaf's sum of squares over its whole tensor, from each rank's shard: one
    all-reduce over the mesh dims that split the leaf, per placement pattern."""
    out = list(sq)
    groups: dict[tuple, list[int]] = {}
    for i, g in enumerate(grads):
        groups.setdefault(tuple(g.placements), []).append(i)
    for pattern, idx in groups.items():
        mesh = grads[idx[0]].device_mesh
        partial = [Partial() if isinstance(pl, Shard) else Replicate() for pl in pattern]
        summed = DTensor.from_local(torch.stack([sq[i] for i in idx]), mesh, partial).full_tensor()
        for j, i in enumerate(idx):
            out[i] = summed[j]
    return torch.stack(out)


def _compress_shards(method: str, grads: dict[str, DTensor], topk_frac: float = 0.01) -> dict[str, torch.Tensor]:
    """``compress_grads`` (without error state) of the reference's tensors, each
    layer leaf stacked over the layers (``_layer_groups``), computed on each rank's
    shards of ``grads``: this rank's shard of each compressed gradient, bitwise
    the whole tensor's compressed, cut as ``grads`` cuts it.  No rank gathers a
    tensor.  ``int8``: each tensor's max |g| is its shards' maxima all-reduced
    (MAX) over the mesh, then each rank rounds its own shard.  ``topk``: each
    tensor's k-th largest |g| (k of the whole stacked tensor) is found by
    bisection over the int32 bit patterns of |g|, which order as the
    non-negative floats do: 31 rounds, each one all-reduce (an axis) of a
    vector of counts, one a tensor, where only the first rank of each
    ``Replicate`` mesh dim counts, so that every element is counted once.
    Each element with |g| at or above it is kept, ties included."""
    mesh = next(iter(grads.values())).device_mesh
    axes = [tp.Group(mesh.get_group(i), mesh.get_local_rank(i), mesh.size(i)) for i in range(mesh.ndim)
            if mesh.size(i) > 1]

    def over_mesh(x: torch.Tensor, op: str) -> torch.Tensor:
        for g in axes:
            x = tp._all_reduce(x, g, op)
        return x

    groups = list(_layer_groups(grads).values())
    local = {n: g.to_local() for n, g in grads.items()}
    dev = next(iter(local.values())).device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out = {}
    if method == "int8":
        top = over_mesh(torch.stack([torch.stack([local[n].abs().max() if local[n].numel() else zero
                                                  for n in names]).max() for names in groups]), "max")
        for j, names in enumerate(groups):
            scale = top[j] / 127.0 + 1e-12  # quantize_int8's scale, of the whole tensor
            for n in names:
                out[n] = dequantize_int8(torch.clamp(torch.round(local[n] / scale), -127, 127).to(torch.int8), scale)
        return out
    if method != "topk":
        raise ValueError(method)
    k = torch.tensor([max(1, int(sum(grads[n].numel() for n in names) * topk_frac)) for names in groups],
                     dtype=torch.int64, device=dev)
    first = [all(mesh.get_local_rank(i) == 0 for i, pl in enumerate(grads[names[0]].placements)
                 if not isinstance(pl, Shard)) for names in groups]
    bits = [torch.cat([local[n].reshape(-1) for n in names]).abs().view(torch.int32) if own else None
            for names, own in zip(groups, first)]
    none = torch.zeros((), dtype=torch.int64, device=dev)
    lo = torch.zeros(len(groups), dtype=torch.int64, device=dev)  # at least k elements at or above lo
    hi = torch.full((len(groups),), 2**31, dtype=torch.int64, device=dev)  # fewer than k at or above hi
    for _ in range(31):
        mid = (lo + hi) // 2
        m32 = mid.to(torch.int32)
        above = over_mesh(torch.stack([none if b is None else (b >= m32[j]).sum() for j, b in enumerate(bits)]), "sum")
        lo, hi = torch.where(above >= k, mid, lo), torch.where(above >= k, hi, mid)
    del bits
    thresh = lo.to(torch.int32).view(torch.float32)
    for j, names in enumerate(groups):
        for n in names:
            out[n] = torch.where(local[n].abs() >= thresh[j], local[n], 0.0)
    return out


def make_train_step(cfg: ArchConfig, mesh, ocfg: adamw.AdamWConfig | None = None, *, layout: str = "baseline",
                    grad_dtype: str = "float32", compress: str = "none", accum_steps: int = 1):
    """The train step sharded over ``mesh``; returns ``(step, params_shape, pspecs,
    opt_shape, ospecs)`` as the reference does.

    ``params_shape`` is the meta model, ``pspecs`` its ``rules.param_shardings``
    under ``layout``, ``opt_shape`` the meta AdamW state and ``ospecs`` its
    shardings (``mu`` and ``nu`` as the params, ``step`` replicated).  The
    caller places params and state with ``rules.distribute``.  ``step(params,
    opt_state, batch)`` takes params (``{name: DTensor}``) and state in those
    placements and the global batch, updates both in place, and returns them
    with the metrics of ``make_train_fn`` with the same keywords on the whole
    batch.  Per step:

    - each param is all-gathered once (in ``grad_dtype``, cast before the
      gather): ``full_tensor`` without TP; under TP (``model_group``) over the
      data axes only, each rank keeping its model-axis shards, on which the
      model computes (``sharding/tp.py``): each split leaf's gradient is then
      that shard's, each replicated leaf's is whole on every rank of the group;
    - with ``accum_steps`` a > 1, microbatch i is rows [i (B // a), (i + 1)
      (B // a)) of the global batch, as ``make_train_fn`` slices it (rows past
      a (B // a) are dropped); each rank takes its rows of each microbatch
      (``rules.batch_specs``) and runs the model on them: a microbatch's loss
      is the rank's summed token loss over that microbatch's global token
      count, so the ranks' losses and gradients sum to the microbatch's (a
      MoE's load-balancing loss enters as the mean of the data ranks' own).
      The losses and the float32 gradients are summed over the microbatches
      and divided by a on the rank, so an accumulated step runs the
      collectives of a plain one;
    - the gradients are summed over the mesh dims that split the batch and
      scattered into the AdamW state's placements (``redistribute``: a
      reduce-scatter); with ``compress`` (``"int8"``, ``"topk"``) each rank
      then compresses its shards as ``compress_grads`` compresses the
      reference's stacked tensors (``_compress_shards``: only per-tensor
      maxima or counts cross the wire, no error state, as in
      ``make_train_fn``); the global grad norm is reduced from the
      (compressed) shards, and AdamW clips by it and updates each rank's
      shards in place.  The state may lie in other placements than the
      params (ZeRO-1: the ``dp-only`` specs, as the reference's dry-run sets
      them): the params' shards are then taken in the state's placements,
      updated, and gathered back into their own.

    A ``grad_dtype`` other than float32 neither accumulates nor compresses, as
    in the reference's ``make_train_fn``.
    """
    _refuse_served_only(cfg, "make_train_step")
    ocfg = ocfg or adamw.AdamWConfig()
    if grad_dtype != "float32":
        compress, accum_steps = "none", 1
    m = get_model(cfg)
    params_shape = abstract_params(cfg)
    pspecs = rules.param_shardings(cfg, mesh, params_shape, layout)
    opt_shape = abstract_opt_state(params_shape)
    ospecs = {"mu": pspecs, "nu": pspecs, "step": rules.NamedSharding(mesh, ())}
    group = model_group(cfg, mesh, layout)
    shell = _shell(cfg, mesh.device_type, group)
    keep = _keep_model(mesh, pspecs, group)
    dt = getattr(torch, grad_dtype)

    def step(params: dict[str, DTensor], opt_state: dict, batch: dict[str, torch.Tensor]):
        n = next(iter(batch.values())).shape[0] // accum_steps
        micro = [{k: x[i * n:(i + 1) * n] for k, x in batch.items()} for i in range(accum_steps)]
        full = _leaves({n: p.to(dt) if p.dtype == torch.float32 else p for n, p in params.items()}, keep)
        leaves = {n: t.requires_grad_() for n, t in full.items()}
        loss = grads = None
        for mb in micro:
            rows, tokens = _rows(cfg, mesh, mb, layout)
            split = [isinstance(pl, Shard) for pl in tokens]
            shards = math.prod(mesh.size(i) for i, s in enumerate(split) if s)
            count = (mb["labels"] >= 0).to(torch.float32).sum().to(mesh.device_type).clamp(min=1.0)

            def loss_of(cfg, model, local, count=count, shards=shards):
                logits, aux = m.forward(cfg, model, local)
                return nll_sum(logits, local["labels"], group)[0] / count + 0.01 * aux / shards

            mloss, mgrads = _loss_and_grad(cfg, shell, loss_of, leaves, rows)
            if grads is None:
                loss, grads = mloss, mgrads
            else:
                loss = loss + mloss
                grads = {n: grads[n] + g for n, g in mgrads.items()}
            del mgrads
        del full, leaves
        partial = [Partial() if s else Replicate() for s in split]

        def held(n):  # the placements of this rank's gradient of leaf n: partial over the batch's dims
            return partial if keep is None else [Partial() if s else pl for s, pl in zip(split, keep[n])]

        with torch.no_grad():
            if accum_steps > 1:
                loss = loss / accum_steps
                grads = {n: g / accum_steps for n, g in grads.items()}
            for n, (stored, compute) in ({} if keep is None else keep.turn).items():
                grads[n] = tp.all_to_all(grads[n], stored, compute, group)
            loss = DTensor.from_local(loss, mesh, partial).full_tensor()
            into = {n: opt_state["mu"][n].placements for n in params}
            sharded = {n: DTensor.from_local(grads.pop(n), mesh, held(n)).redistribute(mesh, into[n]) for n in params}
            if compress == "none":
                local = [g.to_local() for g in sharded.values()]
            else:
                squeezed = _compress_shards(compress, sharded)
                local = [squeezed[n] for n in params]
            gnorm = _reduce_squares([g.to(torch.float32).square().sum() for g in local],
                                    list(sharded.values())).sum().sqrt()
            state = {"mu": {n: t.to_local() for n, t in opt_state["mu"].items()},
                     "nu": {n: t.to_local() for n, t in opt_state["nu"].items()},
                     "step": opt_state["step"].to_local()}
            held = {n: p if p.placements == into[n] else p.redistribute(mesh, into[n]) for n, p in params.items()}
            metrics = adamw.update(ocfg, dict(zip(params, local)), state,
                                   {n: p.to_local() for n, p in held.items()}, grad_norm=gnorm)
            for n, p in params.items():
                if held[n] is not p:  # ZeRO-1: gather the updated shards back into the params' placements
                    p.to_local().copy_(held[n].redistribute(mesh, p.placements).to_local())
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step, params_shape, pspecs, opt_shape, ospecs


def make_prefill_fn(cfg: ArchConfig, max_len: int):
    m = get_model(cfg)

    def prefill_step(params, batch):
        return m.prefill(cfg, params, batch, max_len)

    return prefill_step


def make_decode_fn(cfg: ArchConfig):
    m = get_model(cfg)

    def serve_step(params, cache, tokens):
        logits, new_cache = m.decode_step(cfg, params, cache, tokens)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return next_tok, new_cache

    return serve_step


def make_prefill_step(cfg: ArchConfig, mesh, max_len: int, *, layout: str = "baseline"):
    """``make_prefill_fn`` sharded over ``mesh`` (the reference jits it with the
    params in their shardings and the cache out in ``rules.cache_specs``');
    returns ``(step, params_shape, pspecs)``.

    ``step(params, batch)`` takes params as DTensors in ``pspecs`` and the
    global batch.  Each rank gathers every param whole (``full_tensor``), or
    under TP (``model_group``) over the data axes only, keeping its model-axis
    shards, and prefills its rows of the batch (``rules.batch_specs``).  It
    returns the last-position logits (over the whole vocabulary) as a DTensor
    split like the tokens' rows, and the cache as DTensors in
    ``rules.cache_specs``' placements: under TP each rank's SSM state holds its
    heads, and K/V (and whisper's cross K/V) are gathered over the heads, then
    cut into the sequence shards the specs give (a vlm's sequence holds its
    patch prefix too)."""
    _refuse_served_only(cfg, "make_prefill_step")
    params_shape = abstract_params(cfg)
    pspecs = rules.param_shardings(cfg, mesh, params_shape, layout)
    group = model_group(cfg, mesh, layout)
    run = _Apply(_shell(cfg, mesh.device_type, group), make_prefill_fn(cfg, max_len))
    keep = _keep_model(mesh, pspecs, group)

    def step(params: dict[str, DTensor], batch: dict[str, torch.Tensor]):
        rows, tokens = _rows(cfg, mesh, batch, layout)
        full = _gather(params, keep)
        logits, cache = torch.func.functional_call(run, full, (rows,))
        del full
        return (DTensor.from_local(logits, mesh, tokens, run_check=False),
                _place_cache(cfg, mesh, cache, _cache_rows(mesh, cache, tokens, group), layout))

    return step, params_shape, pspecs


def make_decode_step(cfg: ArchConfig, mesh, *, layout: str = "baseline"):
    """``make_decode_fn`` sharded over ``mesh``; returns ``(step, params_shape,
    pspecs)``.

    ``step(params, cache, tokens)`` takes params as DTensors in ``pspecs``,
    the cache as DTensors in ``rules.cache_specs``' placements and the
    global (B, 1) tokens.  Each rank decodes its rows of the batch, and keeps
    its K/V leaves (and whisper's ``cross_k``/``cross_v``) as the specs place
    them, its batch rows and its shard of the sequence: where the sequence is
    split (over ``"model"``, or over the data axes too where the batch does
    not divide them), each attention attends over the rank's shard and the
    softmax statistics are combined over the axes that split it
    (``layers._attend_cache``; a cross-attention's split is the frames',
    which divide 2 and 4 but not 16 for whisper's 1500).  Under TP
    (``model_group``) the rank also keeps its model-axis shards of the params
    and its heads of the SSM state.  It returns the next tokens as a DTensor
    split like the tokens' rows, and the new cache in ``rules.cache_specs``'
    placements."""
    _refuse_served_only(cfg, "make_decode_step")
    params_shape = abstract_params(cfg)
    pspecs = rules.param_shardings(cfg, mesh, params_shape, layout)
    group = model_group(cfg, mesh, layout)
    shell = _shell(cfg, mesh.device_type, group)
    run = _Apply(shell, make_decode_fn(cfg))
    keep = _keep_model(mesh, pspecs, group)
    # each decoding attention and the cache leaf it reads (whisper's encoder runs in prefill only)
    attns = [(mod, "cross_k" if name.endswith("cross_attn") else "k") for name, mod in shell.named_modules()
             if isinstance(mod, Attention) and not name.startswith("enc_layers")]
    kvm = kv_head_map(cfg.num_heads, cfg.num_kv_heads, cfg.orig_num_heads).to(mesh.device_type) if attns else None

    def step(params: dict[str, DTensor], cache: dict, tokens: torch.Tensor):
        rows, placements = _rows(cfg, mesh, {"tokens": tokens}, layout)
        kept = {n: list(cache[n].placements) for n in ("k", "v", "cross_k", "cross_v") if n in cache}
        held = _cache_rows(mesh, cache, placements, group, kept)
        local = tree_map(lambda t, pl: t.redistribute(mesh, pl).to_local(), cache, held)
        for mod, leaf in attns:
            mod.seq_split = _seq_split(mesh, kept[leaf], local[leaf].shape[2], kvm)
        full = _gather(params, keep)
        next_tok, new_cache = torch.func.functional_call(run, full, (local, rows["tokens"]))
        del full, local
        return (DTensor.from_local(next_tok, mesh, placements, run_check=False),
                _place_cache(cfg, mesh, new_cache, held, layout))

    return step, params_shape, pspecs
