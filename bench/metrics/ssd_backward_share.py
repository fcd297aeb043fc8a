"""ssd_backward_share (%): the device time of the kernels launched under ``SSDScanBackward``
(the scan's plain recomputed backward, its children included) over the device's busy time,
in the profiled step."""

OP = "SSDScanBackward"


def read(run, cell):
    if run.trace is None or not run.trace.busy_s:
        return None
    seconds = run.trace.device_time_under(OP)
    if seconds is None:
        return None
    return 100.0 * seconds / run.trace.busy_s
