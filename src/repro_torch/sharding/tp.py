"""Tensor parallelism over the mesh's ``"model"`` axis: Megatron-style region ops.

A TP region is a stretch of the model that each rank of a model-axis group
computes on its own part of a weight (its q heads, FFN hidden columns, SSM
heads or vocabulary rows).  Activations enter it replicated and leave it
as partial sums.  Four ops mark the edges, each a ``torch.autograd.Function``
over the group:

- :func:`copy`: identity forward, all-reduce backward.  Every replicated
  tensor read inside a region goes through it: the activation entering the
  region, and each replicated leaf that the rank's own part reads
  (``wb``/``wc``, replicated ``wk``/``wv``, a norm scale the rank slices).
  Each rank's gradient of such a tensor is partial, and the all-reduce sums
  the parts exactly once.
- :func:`reduce`: all-reduce forward, identity backward: the row-parallel
  output (``wo``, ``down``, ``out_proj``), whose consumer is replicated.
- :func:`all_reduce`: all-reduce both ways: a sum over the group whose
  consumer is split again (the gated norm's sum of squares).
- :func:`gather`: all-gather forward, the rank's slice backward.

:func:`embed_lookup` and :func:`nll_sum` are the vocab-parallel embedding and
token loss (:func:`embed_rows`, the lookup before its sum, lets two row-split
tables share one reduction).  :func:`all_to_all` moves a leaf's model-axis
split from one dim to another, outside autograd (a row-parallel GELU ``wo``
stored split over its output dim).  :func:`softmax_combine` joins the partial softmaxes of a decode
that attends over a sequence-sharded K/V cache, one shard a rank.  Every
collective is a ``torch.distributed._functional_collectives`` op
(``_c10d_functional``), the namespace ``launch/dryrun.py``'s census prices
(but an all-gather of CUDA tensors over ``gloo``: see ``_all_gather``).
Each op takes the model axis's :class:`Group` explicitly; with ``None`` it is
the identity and issues nothing, so a step without TP runs the ops it ran before.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol


@dataclasses.dataclass(frozen=True)
class Group:
    """The model axis as one rank sees it: the process group, this rank's index in it, its size."""

    group: object
    rank: int
    size: int


def _all_reduce(x: torch.Tensor, g: Group, op: str = "sum") -> torch.Tensor:
    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), op, g.group))


def _all_gather(x: torch.Tensor, dim: int, g: Group) -> torch.Tensor:
    """The group's parts of ``x`` joined along ``dim`` in rank order (the op gathers
    along dim 0, the others are cut and joined after).  A ``gloo`` group takes
    CUDA tensors through c10d's in-place all-gather: its functional one ends the
    process on them (torch 2.11)."""
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(g.group) == "gloo":
        out = torch.empty((g.size * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=g.group)
    else:
        out = funcol.wait_tensor(torch.ops._c10d_functional.all_gather_into_tensor(x, g.size, g.group.group_name))
    return torch.cat(out.chunk(g.size), dim=dim) if dim % x.ndim else out


def _all_to_all(x: torch.Tensor, g: Group) -> torch.Tensor:
    """``x``'s dim 0 cut into ``g.size`` equal parts, part j sent to rank j; what
    each rank sent, joined along dim 0 in rank order.  A ``gloo`` group takes CUDA
    tensors through c10d's in-place op, as ``_all_gather`` does."""
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(g.group) == "gloo":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=g.group)
        return out
    parts = [x.shape[0] // g.size] * g.size
    return funcol.wait_tensor(torch.ops._c10d_functional.all_to_all_single(x, parts, parts, g.group.group_name))


def all_to_all(x: torch.Tensor, split_dim: int, cat_dim: int, g: Group) -> torch.Tensor:
    """A tensor split over the group along ``cat_dim`` (this rank holds part
    ``g.rank``), split along ``split_dim`` instead: the rank's part along
    ``split_dim`` of the whole.  Not differentiable: the steps move leaves and
    gradients with it."""
    out = _all_to_all(torch.stack(x.chunk(g.size, split_dim)), g)
    return torch.cat(out.unbind(0), dim=cat_dim)


def _mine(x: torch.Tensor, dim: int, g: Group) -> torch.Tensor:
    """This rank's part of ``x`` along ``dim``, split in rank order."""
    n = x.shape[dim] // g.size
    return x.narrow(dim, g.rank * n, n)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.g), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return _all_reduce(x, g)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _all_reduce(x, g)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.g), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.g = dim, g
        return _all_gather(x, dim, g)

    @staticmethod
    def backward(ctx, grad):
        return _mine(grad, ctx.dim, ctx.g), None, None


def copy(x: torch.Tensor, g: Group | None) -> torch.Tensor:
    return x if g is None else _Copy.apply(x, g)


def reduce(x: torch.Tensor, g: Group | None) -> torch.Tensor:
    return x if g is None else _Reduce.apply(x, g)


def all_reduce(x: torch.Tensor, g: Group | None) -> torch.Tensor:
    return x if g is None else _AllReduce.apply(x, g)


def gather(x: torch.Tensor, dim: int, g: Group | None) -> torch.Tensor:
    return x if g is None else _Gather.apply(x, dim, g)


def part(x: torch.Tensor, dim: int, g: Group) -> torch.Tensor:
    """This rank's part along ``dim`` of a replicated tensor read inside a region
    (through :func:`copy`, so that its gradient is summed over the group)."""
    return _mine(copy(x, g), dim, g)


def embed_rows(table: torch.Tensor, index: torch.Tensor, dtype: torch.dtype, g: Group) -> torch.Tensor:
    """This rank's part of the rows ``index`` of a table split by rows over the
    group, in ``dtype``: the rank holds rows [rank * V/tp, (rank + 1) * V/tp) and
    looks up the indices that fall there, zeros elsewhere.  Summed over the group
    (``reduce``) it is each index's row, exactly."""
    vl = table.shape[0]
    local = index.to(torch.int64) - g.rank * vl
    inside = (local >= 0) & (local < vl)
    rows = table[local.clamp(0, vl - 1)].to(dtype)
    return torch.where(inside[..., None], rows, torch.zeros((), dtype=dtype, device=rows.device))


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype, g: Group) -> torch.Tensor:
    """Rows of a vocab-parallel table, in ``dtype``: ``embed_rows`` summed over the group."""
    return reduce(embed_rows(table, tokens, dtype, g), g)


def nll_sum(logits: torch.Tensor, labels: torch.Tensor, g: Group) -> tuple[torch.Tensor, torch.Tensor]:
    """``models.transformer.nll_sum`` on vocab-parallel logits (this rank's V/tp
    columns): the max, the sum of exponentials and the gold logit are each
    reduced over the group, so every rank gets the whole loss and the gradient
    of its own columns."""
    lg = logits.to(torch.float32)
    vl = lg.shape[-1]
    top = _all_reduce(lg.detach().amax(dim=-1), g, "max")
    local = labels.clamp(min=0).to(torch.int64) - g.rank * vl
    inside = (local >= 0) & (local < vl)
    gold = torch.gather(lg, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
    sums = reduce(torch.stack([(lg - top[..., None]).exp().sum(dim=-1), torch.where(inside, gold, 0.0)]), g)
    logz = top + sums[0].log()
    mask = (labels >= 0).to(torch.float32)
    return ((logz - sums[1]) * mask).sum(), mask.sum()


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """A K/V cache whose sequence is split over mesh axes, as one rank holds it:
    ``offset`` is the global position of its first row, ``groups`` the axes that
    split the sequence in mesh order (``"model"`` and, where ``rules.cache_specs``
    puts them there, the data axes), and ``kvm`` every q head's kv head on the
    cache's device (``layers.kv_head_map``): the rank attends with all q heads."""

    offset: int
    groups: tuple
    kvm: torch.Tensor


def softmax_combine(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor, groups) -> torch.Tensor:
    """The attention output over a sequence split over ``groups``, from each rank's
    partial statistics over its own positions, all float32: the running max ``m``
    (B, H, 1), the sum of exponentials ``l`` (B, H, 1) and the unnormalised output
    ``o`` (B, 1, H, D).  The max is all-reduced over each group in turn, each
    rank's ``l`` and ``o`` rescaled by ``exp(m_r - m)``, and the sums all-reduced
    over each group in turn (one reduction after another over the axes equals one
    over their product).  A rank whose positions are all masked has ``m_r`` at
    -1e30, so its weight, and what it adds, is exactly 0."""
    top = m
    for g in groups:
        top = _all_reduce(top, g, "max")
    w = torch.exp(m - top).transpose(1, 2)[..., None]  # (B, 1, H, 1)
    both = torch.cat([o * w, l.transpose(1, 2)[..., None] * w], dim=-1)
    for g in groups:
        both = _all_reduce(both, g)
    return both[..., :-1] / both[..., -1:]
