"""train_step_mfu (%): 6 operations per applied weight per trained token, over the window's
synchronised step time at the H100's bf16 peak (no attention scores, no recompute)."""
from bench.harness.env import PEAK_BF16_FLOPS


def read(run, cell):
    seconds, steps = run.spans.total("step"), run.spans.count("step")
    if not seconds or not run.info.get("train_flops_per_step"):
        return None
    return 100.0 * run.info["train_flops_per_step"] * steps / (seconds * PEAK_BF16_FLOPS)
