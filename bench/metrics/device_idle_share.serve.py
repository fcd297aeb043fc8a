"""device_idle_share.serve (%): 1 - the device's busy time (the union of kernel intervals)
over the wall time of the profiled batch.  The profiler slows the host: an upper bound."""


def read(run, cell):
    if run.trace is None or not run.trace.kernels or not run.trace.window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
