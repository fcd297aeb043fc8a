"""parallel_mixer_share.prefill (%): the device time launched inside the program's ``model.parallel_mixer``
spans (a falcon_h1 layer's shared norm, its Mamba2 Mixer and its attention side by side with their
multipliers, their sum and the residual add; not its MLP) that lie inside ``model.prefill`` spans, over
the device time launched inside those ``model.prefill`` spans, in the profiled batch.  None where the
trace holds neither (a family without the span, an older commit)."""
from bench.harness import program_spans


def read(run, cell):
    if run.trace is None:
        return None
    prefills = program_spans.ranges(run.trace, "model.prefill")
    total = sum(program_spans.launched(run.trace, prefills))
    mixers = program_spans.ranges(run.trace, "model.parallel_mixer", within=prefills)
    if not total or not mixers:
        return None
    return 100.0 * sum(program_spans.launched(run.trace, mixers)) / total
