"""ssd_scan_roofline.prefill (%): the least time of the profiled prefill's ``ssd_scan``
calls at the H100's peaks (``trace.ssd_bound``) over the device time of the scan's kernels
(``ssd_cb_kernel`` ... ``ssd_chunk_out_kernel``) in the trace.  Each call's shape is the
profiled batch's (b, s) and the heads, head size, groups and state of the cell's
configuration, as its reference lays them out."""
import torch

from bench.harness.trace import ssd_bound


def read(run, cell):
    profiled = run.info.get("profiled")
    calls = (profiled or {}).get("kernels", {}).get("ssd_scan", {}).get("LAUNCHES", 0)
    kernel_s = run.trace.kernel_time("ssd_") if run.trace is not None else 0.0
    if not calls or not kernel_s:
        return None
    arch = cell.arch
    k = cell.reference().dims(arch)
    b, s = profiled["batch"], profiled["seq_len"]
    elem_bytes = torch.finfo(getattr(torch, arch["compute_dtype"])).bits // 8
    least, _ = ssd_bound(b, s, k["h"], k["p"], k["g"], k["n"], min(arch["ssm_chunk"], s), elem_bytes)
    return 100.0 * calls * least / kernel_s
