"""moe_share.prefill (%): the device time launched inside the program's ``model.moe`` spans (a
granitemoehybrid layer's router, its held experts and its shared expert) that lie inside
``model.prefill`` spans, over the device time launched inside those ``model.prefill`` spans, in
the profiled batch.  None where the trace holds neither (a family without the span, an older
commit)."""
from bench.harness import program_spans


def read(run, cell):
    if run.trace is None:
        return None
    prefills = program_spans.ranges(run.trace, "model.prefill")
    total = sum(program_spans.launched(run.trace, prefills))
    moe = program_spans.ranges(run.trace, "model.moe", within=prefills)
    if not total or not moe:
        return None
    return 100.0 * sum(program_spans.launched(run.trace, moe)) / total
