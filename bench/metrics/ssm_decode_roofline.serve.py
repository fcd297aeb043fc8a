"""ssm_decode_roofline.serve (%): the least time of the profiled batch's Mamba2 decode-state
updates at the H100's HBM peak over the device time of the kernels whose names hold
``ssm_decode``.

The least time counts the work whatever computes it: in each of the batch's ``new_tokens - 1``
decode steps every Mamba2 layer reads its float32 state (b, H, P, N) once and writes it once,
reads x and writes y (b, H, P) once in the compute dtype, reads B and C (b, G, N) once a group in
the compute dtype, and reads dt (b, H) in float32.  b is the profiled batch's; the layers
(``num_layers``, less the attention layers ``hybrid_layer_ids`` of a granitemoehybrid), H
(``ssm_expand`` x ``d_model`` / ``ssm_head_dim``), P, N and G (``ssm_ngroups``, 1 where unset)
the configuration's.  None where the trace holds no such kernel (a program without it)."""
import torch

from bench.harness.env import PEAK_HBM_BYTES


def read(run, cell):
    profiled = run.info.get("profiled")
    kernel_s = run.trace.kernel_time("ssm_decode") if run.trace is not None else 0.0
    if not profiled or not kernel_s:
        return None
    arch = cell.arch
    layers = arch["num_layers"]
    if arch["family"] == "granitemoehybrid":
        layers -= len(arch.get("hybrid_layer_ids", ()))
    h = arch["ssm_expand"] * arch["d_model"] // arch["ssm_head_dim"]
    p, n, g = arch["ssm_head_dim"], arch["ssm_state"], arch.get("ssm_ngroups", 1)
    b, steps = profiled["batch"], cell.mix["new_tokens"] - 1
    elem = torch.finfo(getattr(torch, arch["compute_dtype"])).bits // 8
    nbytes = b * (2 * h * p * n * 4 + 2 * h * p * elem + 2 * g * n * elem + h * 4)
    return 100.0 * steps * layers * nbytes / PEAK_HBM_BYTES / kernel_s
