"""decode_cache_copy_share (%): the device time launched from the program's ``model.new_cache``
spans that lie inside ``model.decode_step`` spans (the stack of every layer's new state, a K/V
cache's copy) over the device time launched from ``model.decode_step`` spans, in the profiled
batch.  The Mixer's own concatenation of its conv history lies outside ``model.new_cache``."""
from bench.harness import program_spans


def read(run, cell):
    if run.trace is None:
        return None
    steps = program_spans.ranges(run.trace, "model.decode_step")
    total = sum(program_spans.launched(run.trace, steps))
    if not total:
        return None
    copies = program_spans.ranges(run.trace, "model.new_cache", within=steps)
    return 100.0 * sum(program_spans.launched(run.trace, copies)) / total
