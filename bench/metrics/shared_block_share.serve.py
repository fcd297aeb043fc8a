"""shared_block_share.serve (%): the device time launched inside the program's ``model.shared_block``
spans (zamba2's sites: the concat and norm, the block's attention, its MLP with the site's LoRA, the
site's linear) over the device's busy time, in the profiled batch: its prefill and its eager decode
steps.  None where the program records no such span (a family without sites, an older commit)."""


def read(run, cell):
    if run.trace is None or not run.trace.busy_s:
        return None
    seconds = run.trace.device_time_under("model.shared_block")
    if seconds is None:
        return None
    return 100.0 * seconds / run.trace.busy_s
