"""decode_attention_roofline.serve (%): the least time of the profiled batch's decode attention
at the H100's HBM peak over the device time of the kernels whose names hold ``decode_attention``.

The least time counts the work whatever computes it: each of the batch's ``new_tokens - 1``
decode steps at position s + t reads, at every attention site, the cache's rows 0 .. s + t of K
and V over every kv head, and reads q and writes the output once over every q head, in the
compute dtype; (b, s) are the profiled batch's, the sites, heads and head size the
configuration's.  None where the trace holds no such kernel (a program without it)."""
import torch

from bench.harness.env import PEAK_HBM_BYTES


def read(run, cell):
    profiled = run.info.get("profiled")
    kernel_s = run.trace.kernel_time("decode_attention") if run.trace is not None else 0.0
    if not profiled or not kernel_s:
        return None
    arch = cell.arch
    sites = len(arch.get("hybrid_layer_ids", ()))
    b, s, steps = profiled["batch"], profiled["seq_len"], cell.mix["new_tokens"] - 1
    elem = torch.finfo(getattr(torch, arch["compute_dtype"])).bits // 8
    rows = steps * (s + 1) + steps * (steps - 1) // 2  # sum over t < steps of (s + t + 1)
    kv = rows * 2 * arch["num_kv_heads"] * arch["head_dim"] * elem
    qo = steps * arch["num_heads"] * arch["head_dim"] * elem * 2
    return 100.0 * sites * b * (kv + qo) / PEAK_HBM_BYTES / kernel_s
