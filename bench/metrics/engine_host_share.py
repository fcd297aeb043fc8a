"""engine_host_share (%): the share of ``ServeEngine.run_batch``'s time spent outside the
engine's ``model.prefill`` and ``_decode`` calls, over the window's synchronised spans."""


def read(run, cell):
    total = run.spans.total("run_batch")
    if not total:
        return None
    return 100.0 * (total - run.spans.total("prefill") - run.spans.total("decode")) / total
