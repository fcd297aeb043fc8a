"""optimizer_share (%): the device time launched from the program's ``train.optimizer`` span
(``optim/adamw.py`` ``update``: the global norm, the clip and the foreach passes) over the
device's busy time, in the profiled step."""


def read(run, cell):
    if run.trace is None or not run.trace.busy_s:
        return None
    seconds = run.trace.device_time_under("train.optimizer")
    if seconds is None:
        return None
    return 100.0 * seconds / run.trace.busy_s
