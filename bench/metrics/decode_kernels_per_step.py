"""decode_kernels_per_step (kernels): the device operations (kernels, copies, sets) launched
from inside each of the program's ``model.decode_step`` spans, on the span's thread, in the
profiled batch: the median over its steps.  The profiler loses or misattributes a few device
records a batch (0 to 11 of ~190,000 in a ``chat`` batch), which would move a mean by a
fraction of a launch from run to run; the median step reads the program's count exactly."""
import statistics

from bench.harness import program_spans


def read(run, cell):
    if run.trace is None:
        return None
    steps = program_spans.ranges(run.trace, "model.decode_step")
    if not steps:
        return None
    return float(statistics.median(program_spans.launches_each(run.trace, steps)))
