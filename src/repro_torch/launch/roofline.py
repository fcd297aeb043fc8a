"""Roofline-term extraction for the dry-run cells.

Three terms per (arch, shape, mesh), all in seconds, at the published peaks
of one NVIDIA H100 SXM (https://www.nvidia.com/en-us/data-center/h100/,
dense rates, 700 W power limit):

    compute    = FLOPs_per_device / 989e12        (bf16 tensor cores)
    memory     = bytes_per_device / 3.35e12       (HBM3)
    collective = wire_bytes_per_device / 50e9     (NDR InfiniBand per GPU)

The collective term uses the slowest link a production mesh axis crosses.
Inside one 8-GPU node NVLink gives each GPU 900 GB/s (450 per direction),
but every axis of the (16, 16) and (2, 16, 16) meshes is 16 ranks wide or
spans pods, so its rings leave the node, over one 400 Gb/s NDR InfiniBand
link per GPU, as in a DGX H100: 50e9 bytes/s.  These are data-sheet figures,
not measurements.

Methodology note: the headline terms are **analytic** (formulas below,
standard roofline practice).  Beside them each row records what the port's
step really does, from ``repro_torch.launch.dryrun``'s trace of it on fake
tensors: its FLOPs, the bytes its ops read and write, and its collectives,
priced by the same ring formulas (the ``traced_*`` fields).

Analytic model (per device; D devices, dp = data-parallel, tp = model axis):

* FLOPs: matmul term ``m·N_active·T`` with m = 2 (inference fwd), 6 (train),
  8 (train+remat); attention ``a·2·B·H·S²·hd`` per causal layer (a = 1 fwd,
  3 train, 4 train+remat; x2 for non-causal); SSD chunk term
  ``2·B·S·H·(Lc·(N+P) + 2·N·P)``; decode attention ``4·B·H·S_cache·hd``/layer.
* HBM bytes: optimizer state streams (8 fp32 arrays r/w) for train; one bf16
  weight pass per fwd/bwd/remat; activation traffic ``k·L·(B/dp)·S·d·2`` with
  k = 16 train / 8 prefill; KV-cache read+slot-write for decode; SSD states.
* Collective wire bytes: dp-axis gradient reduce-scatter + FSDP all-gathers
  (train), tp-axis per-layer activation all-reduces (2/layer fwd, 6 with
  bwd+remat), ring factors (k-1)/k, all-reduce x2.

A ring reduce-scatter moves (k-1)/k of its *operand* (k times its result).
The reference prices it by its result (ROADMAP fault (g)); the port prices
the operand, in ``collective_bytes`` and in the traced census alike.
"""
from __future__ import annotations

import dataclasses
import math
import re

from repro_torch.sharding import rules

PEAK_FLOPS = 989e12      # bf16 dense / GPU
HBM_BW = 3.35e12         # bytes/s
LINK_BW = 50e9           # bytes/s per GPU, NDR InfiniBand between nodes

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
}

_COLL_RE = re.compile(
    r"=\s*(?:\([^)]*\)|(?P<single>\w+\[[^\]]*\]))?\s*"
    r"(?P<op>all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
)
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_GROUPS_ALT = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_OPERANDS_RE = re.compile(r"\(([^)]*)\)")


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _group_size(line: str) -> int:
    m = _GROUPS_ALT.search(line)
    if m:  # iota format [N,M]<=[...]: N groups of M
        return int(m.group(2))
    m = _GROUPS_RE.search(line)
    if m:
        return len([x for x in m.group(1).split(",") if x.strip() != ""])
    return 2


def wire_bytes(op: str, operand_bytes: float, result_bytes: float, k: int) -> float:
    """Per-device bytes a ring collective of ``k`` ranks puts on the wire."""
    if op == "all-reduce":
        return 2.0 * result_bytes * (k - 1) / k
    if op == "collective-permute":
        return float(result_bytes)
    if op == "reduce-scatter":
        return float(operand_bytes) * (k - 1) / k
    return float(result_bytes) * (k - 1) / k  # all-gather, all-to-all


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0
    by_op: dict = dataclasses.field(default_factory=dict)
    count: int = 0

    def add(self, op: str, wire: float) -> None:
        self.wire_bytes += wire
        self.by_op[op] = self.by_op.get(op, 0.0) + wire
        self.count += 1


def collective_bytes(hlo_text: str) -> CollectiveStats:
    """Per-device on-wire bytes parsed from a *partitioned* HLO module.

    A reduce-scatter is priced by its operand, the shapes in the parentheses
    after the op's name (the reference prices its result: fault (g)).
    """
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        line = line.strip()
        m = _COLL_RE.search(line)
        if not m or line.startswith("//"):
            continue
        op = m.group("op")
        head = line.split("=", 1)
        if len(head) < 2:
            continue
        result_text, _, rest = head[1].partition(op)
        nbytes = _shape_bytes(result_text)
        if nbytes == 0:
            continue
        operands = _OPERANDS_RE.search(rest)
        operand_bytes = _shape_bytes(operands.group(1)) if operands else 0
        k = max(2, _group_size(line))
        stats.add(op, wire_bytes(op, operand_bytes, nbytes, k))
    return stats


@dataclasses.dataclass
class Collective:
    """One collective of a traced step: its HLO name, operand and result bytes on
    this rank, and the number of ranks in its group."""

    op: str
    operand_bytes: int
    result_bytes: int
    group_size: int


@dataclasses.dataclass
class Trace:
    """What ``repro_torch.launch.dryrun`` counted over one step on one rank: FLOPs
    (``torch.utils.flop_counter``'s formulas), bytes read and written by the
    ops, and every collective."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collectives: list = dataclasses.field(default_factory=list)

    def collective_stats(self) -> CollectiveStats:
        stats = CollectiveStats()
        for c in self.collectives:
            stats.add(c.op, wire_bytes(c.op, c.operand_bytes, c.result_bytes, c.group_size))
        return stats


# --------------------------------------------------------------- analytic ---
def _sizes(mesh) -> dict[str, int]:
    """Axis sizes by name: a ``DeviceMesh``'s through ``rules.mesh_axes``, or a
    stand-in's whose ``shape`` is already that dict."""
    return dict(mesh.shape) if isinstance(mesh.shape, dict) else rules.mesh_axes(mesh)


def _axes(mesh, layout: str = "baseline") -> tuple[int, int]:
    sizes = _sizes(mesh)
    dp = 1
    for a in ("pod", "data"):
        dp *= sizes.get(a, 1)
    tp = sizes.get("model", 1)
    if layout in ("dp-only", "pure-dp"):
        return dp * tp, 1
    return dp, tp


def analytic_costs(cfg, spec, mesh, layout: str = "baseline", grad_bytes: int = 4) -> dict:
    """Per-device (flops, hbm_bytes, wire_bytes) from the formulas above."""
    dp, tp = _axes(mesh, layout)
    D = dp * tp
    B = spec.global_batch
    S = spec.seq_len
    d = cfg.d_model
    L = cfg.num_layers
    hd = cfg.resolved_head_dim
    H = max(cfg.num_heads, 1)
    n_act = cfg.active_param_count()
    n_tot = cfg.param_count()
    step = spec.step
    remat = cfg.remat and step == "train"

    # ---- attention / ssd structure per family
    causal_layers, noncausal_pairs = 0, []  # (layers, q_len, kv_len)
    ssd_layers = 0
    if cfg.family in ("dense", "moe", "vlm"):
        causal_layers = L
        s_eff = S + (cfg.num_patches if cfg.family == "vlm" else 0)
    elif cfg.family == "hybrid":
        causal_layers = L // max(cfg.attn_every, 1)
        ssd_layers = L
        s_eff = S
    elif cfg.family == "ssm":
        ssd_layers = L
        s_eff = S
    else:  # encdec
        causal_layers = L
        noncausal_pairs = [(cfg.encoder_layers, cfg.encoder_frames, cfg.encoder_frames),
                           (L, S, cfg.encoder_frames)]
        s_eff = S

    # ---- FLOPs
    if step == "train":
        m_mat, m_attn = (8, 4) if remat else (6, 3)
        T = B * S
    elif step == "prefill":
        m_mat, m_attn = 2, 1
        T = B * S
    else:
        m_mat, m_attn = 2, 1
        T = B  # one token per sequence

    flops = m_mat * n_act * T
    if step == "decode":
        flops += causal_layers * 4.0 * B * H * s_eff * hd * m_attn
        flops += ssd_layers * 3.0 * 2.0 * B * cfg.ssm_num_heads * cfg.ssm_head_dim * cfg.ssm_state
        for (nl, q, kv) in noncausal_pairs:
            flops += nl * 4.0 * B * H * kv * hd * m_attn  # cross-attn reads enc kv
    else:
        flops += causal_layers * 2.0 * B * H * float(s_eff) ** 2 * hd * m_attn
        for (nl, q, kv) in noncausal_pairs:
            flops += nl * 4.0 * B * H * q * kv * hd * m_attn
        if ssd_layers:
            Lc, N, P = cfg.ssm_chunk, cfg.ssm_state, cfg.ssm_head_dim
            Hs = cfg.ssm_num_heads
            flops += ssd_layers * m_attn * 2.0 * B * S * Hs * (Lc * (N + P) + 2 * N * P)
    flops_dev = flops / D

    # ---- HBM bytes
    if step == "train":
        opt_stream = 8.0 * n_tot * 4 / D            # p, g, mu, nu read+write
        weight_passes = (3 if remat else 2) * n_tot * 2 / tp
        act = 16.0 * L * (B / dp) * S * d * 2
        hbm = opt_stream + weight_passes + act
    elif step == "prefill":
        weight_passes = n_tot * 2 / tp
        act = 8.0 * L * (B / dp) * S * d * 2
        cache_w = 2.0 * causal_layers * (B / dp) * S * cfg.num_kv_heads * hd * 2 / max(tp // 1, 1)
        hbm = weight_passes + act + cache_w
    else:
        weight_passes = n_tot * 2 / tp
        cache_r = 2.0 * causal_layers * (B / dp) * s_eff * cfg.num_kv_heads * hd * 2 / tp
        ssd_state = ssd_layers * (B / dp) * cfg.ssm_num_heads * cfg.ssm_head_dim * cfg.ssm_state * 4 * 2
        act = 2.0 * L * (B / dp) * 1 * d * 2 * 8
        hbm = weight_passes + cache_r + ssd_state + act

    # ---- collective wire bytes
    rs = (dp - 1) / max(dp, 1)
    rt = (tp - 1) / max(tp, 1)
    replicated = layout in ("replicated-weights", "pure-dp")
    if step == "train":
        grad_rs = n_tot * grad_bytes / tp * rs              # dp reduce-scatter
        opt_ag = n_tot * 4 / tp * rs                        # param re-gather
        fsdp_ag = (3 if remat else 2) * n_tot * 2 / tp * rs # per-pass weight gathers
        if replicated:
            fsdp_ag = 0.0
            grad_rs = n_tot * grad_bytes * rs * 2 / tp      # full all-reduce instead
            opt_ag = 0.0
        tp_ar = (6 if remat else 4) * L * (B / dp) * S * d * 2 * 2 * rt
        wire = grad_rs + opt_ag + fsdp_ag + tp_ar
    elif step == "prefill":
        fsdp_ag = 0.0 if replicated else n_tot * 2 / tp * rs
        tp_ar = 2.0 * L * (B / dp) * S * d * 2 * 2 * rt
        wire = fsdp_ag + tp_ar
    else:
        # baseline finding: 2-D sharded weights are re-gathered EVERY decode
        # step; 'replicated-weights' removes this entirely
        fsdp_ag = 0.0 if replicated else n_tot * 2 / tp * rs
        tp_ar = 2.0 * L * (B / dp) * 1 * d * 2 * 2 * rt
        softmax_stats = causal_layers * (B / dp) * H * 4 * 2 * 2 * rt
        wire = fsdp_ag + tp_ar + softmax_stats

    return {"flops_dev": flops_dev, "hbm_dev": hbm, "wire_dev": wire}


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    wire_bytes_per_device: float
    collectives: dict
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float       # MODEL_FLOPS / (FLOPs * chips)
    traced_flops_per_device: float = 0.0
    traced_bytes_per_device: float = 0.0
    traced_wire_bytes_per_device: float = 0.0

    def dominant_seconds(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def analyze(trace: Trace, *, cfg, spec, mesh, model_flops: float, layout: str = "baseline",
            grad_bytes: int = 4) -> Roofline:
    """The analytic terms of one cell, with ``trace`` (one rank's traced step)
    recorded beside them: its collectives' wire bytes by op, and the
    ``traced_*`` fields."""
    coll = trace.collective_stats()
    a = analytic_costs(cfg, spec, mesh, layout, grad_bytes)
    compute_s = a["flops_dev"] / PEAK_FLOPS
    memory_s = a["hbm_dev"] / HBM_BW
    collective_s = a["wire_dev"] / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    num_devices = math.prod(_sizes(mesh).values())
    useful = model_flops / max(a["flops_dev"] * num_devices, 1.0)
    return Roofline(
        flops_per_device=a["flops_dev"],
        hbm_bytes_per_device=a["hbm_dev"],
        wire_bytes_per_device=a["wire_dev"],
        collectives=coll.by_op,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_ratio=useful,
        traced_flops_per_device=trace.flops,
        traced_bytes_per_device=trace.bytes_accessed,
        traced_wire_bytes_per_device=coll.wire_bytes,
    )


def model_flops_for(cfg, shape_spec) -> float:
    """MODEL_FLOPS: 6·N·D (train) or 2·N_active·D (inference), D = tokens."""
    n_active = cfg.active_param_count()
    tokens = shape_spec.global_batch * (1 if shape_spec.step == "decode" else shape_spec.seq_len)
    mult = 6 if shape_spec.step == "train" else 2
    return float(mult) * n_active * tokens
