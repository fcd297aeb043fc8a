"""decode_step_ms (ms): the mean synchronised ``decode_step`` (the engine's ``_decode``) over the window."""


def read(run, cell):
    n = run.spans.count("decode")
    return 1e3 * run.spans.total("decode") / n if n else None
