"""decode_graph_share (%): the share of the profiled batch's decode steps that were replayed from a
captured CUDA graph: the program's ``model.decode_graph`` spans over those and its eager
``model.decode_step`` spans together.  A program that records no ``model.decode_graph`` span
reads None."""
from bench.harness import program_spans


def _count(run, name: str) -> int:
    return sum(len(spans) for spans in program_spans.ranges(run.trace, name).values())


def read(run, cell):
    if run.trace is None:
        return None
    graphs = _count(run, "model.decode_graph")
    if not graphs:
        return None
    return 100.0 * graphs / (graphs + _count(run, "model.decode_step"))
