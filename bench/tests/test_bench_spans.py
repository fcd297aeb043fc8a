"""The readers of the program's own spans, on hand-built traces."""
import pytest

from bench.harness import cell as cellmod
from bench.harness.run_state import Run
from bench.harness.spans import Spans
from bench.harness.trace import Trace

MAIN, OTHER = 1, 2


def run_of(ops, launches, busy_s=2.0):
    trace = Trace(window_s=4.0, busy_s=busy_s, kernels=len(launches),
                  ops=sorted(ops, key=lambda r: (r[0], -r[1])), launches=launches)
    return Run(spans=Spans(sync=False, device_type="cpu"), trace=trace)


def read(metric, run):
    cell = cellmod.load("mamba2-780m.train-2k" if metric == "optimizer_share" else "mamba2-780m.chat")
    return cellmod.reader(metric)(run, cell)


def test_kernels_per_step_counts_each_steps_launches_on_its_thread():
    ops = [(0, 100, "model.decode_step", MAIN), (10, 20, "model.mamba2", MAIN),
           (200, 300, "model.decode_step", MAIN), (0, 400, "serve.run_batch", MAIN)]
    launches = [(11, MAIN, 0.1), (12, MAIN, 0.1), (50, MAIN, 0.1),          # step 1: 3, one under a child
                *[(210 + i, MAIN, 0.1) for i in range(5)],                    # step 2: 5
                (150, MAIN, 0.1), (50, OTHER, 0.1), (250, OTHER, 0.1)]       # between steps; another thread
    assert read("decode_kernels_per_step", run_of(ops, launches)) == 4.0


def test_kernels_per_step_is_the_median_step():
    # a launch record the profiler lost in one of three steps leaves the reading as it was
    ops = [(100 * k, 100 * k + 50, "model.decode_step", MAIN) for k in range(3)]
    launches = [(100 * k + i, MAIN, 0.1) for k in range(3) for i in range(5 if k != 1 else 4)]
    assert read("decode_kernels_per_step", run_of(ops, launches)) == 5.0


def test_cache_copy_share_counts_only_the_copies_inside_decode_steps():
    ops = [(0, 100, "model.prefill", MAIN), (80, 90, "model.new_cache", MAIN),
           (200, 300, "model.decode_step", MAIN), (280, 290, "model.new_cache", MAIN),
           (400, 500, "model.decode_step", MAIN), (480, 490, "model.new_cache", MAIN)]
    launches = [(85, MAIN, 1.0),                                   # the prefill's stack: not counted
                (210, MAIN, 0.3), (285, MAIN, 0.1),
                (410, MAIN, 0.3), (485, MAIN, 0.1), (486, OTHER, 5.0)]
    assert read("decode_cache_copy_share", run_of(ops, launches)) == pytest.approx(25.0)


def test_optimizer_share_is_over_the_busy_time():
    ops = [(0, 100, "train.step", MAIN), (0, 60, "train.loss_and_grad", MAIN),
           (60, 100, "train.optimizer", MAIN)]
    launches = [(10, OTHER, 1.5), (70, MAIN, 0.25), (90, MAIN, 0.25)]
    assert read("optimizer_share", run_of(ops, launches)) == pytest.approx(25.0)


@pytest.mark.parametrize("metric", ["decode_kernels_per_step", "decode_cache_copy_share", "optimizer_share"])
def test_a_trace_without_the_programs_spans_gives_nothing(metric):
    # a program that records no spans of its own: the benchmark's wrappers and kernels only
    ops = [(0, 100, "bench.decode", MAIN), (0, 100, "bench.step", MAIN), (10, 20, "aten::mm", MAIN)]
    assert read(metric, run_of(ops, [(10, MAIN, 0.5)])) is None
