"""prefill_mfu (%): model operations of the window's prefills over their synchronised time
at the H100's bf16 peak.  Operations: 2 per applied weight per prompt token (the hybrid's
shared block at each site), the head on the last position only; no attention scores."""
from bench.harness.env import PEAK_BF16_FLOPS


def read(run, cell):
    seconds = run.spans.total("prefill")
    if not seconds or not run.info.get("prefill_flops"):
        return None
    return 100.0 * run.info["prefill_flops"] / (seconds * PEAK_BF16_FLOPS)
