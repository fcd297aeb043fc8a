"""The copied operation and byte counts, against shapes worked by hand."""
import json

from bench.harness import program
from bench.harness.env import BENCH
from bench.harness.trace import ssd_bound, ssd_bytes_flops
from bench.reference import mamba2_lm as ref


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())["arch"]


def test_ssd_counts_at_the_mamba2_serving_shape():
    # B=4, S=1024, H=48, P=64, G=1, N=128, L=256, bf16: x and y 2 B x 4*1024*48*64 each, B and C
    # 2 B x 4*1024*128 each, dt 4 B x 4*1024*48, A 4 B x 48, the state 4 B x 4*48*64*128
    nbytes, flops = ssd_bytes_flops(4, 1024, 48, 64, 1, 128, 256, 2)
    assert nbytes == 2 * (2 * 12_582_912 + 2 * 524_288) + 4 * (196_608 + 48 + 1_572_864)
    # per (batch, head, chunk): 2 (T N + T P + 2 L P N) with T = 256 * 257 / 2 = 32,896
    assert flops == 4 * 48 * 4 * 2 * (32_896 * 128 + 32_896 * 64 + 2 * 256 * 64 * 128)
    least, by = ssd_bound(4, 1024, 48, 64, 1, 128, 256, 2)
    assert by == "bytes" and abs(least - nbytes / 3.35e12) < 1e-15
    assert abs(least * 1e3 - 0.01776) < 5e-5  # chip_smoke.py's figure at this shape


def test_the_roofline_reader_takes_shapes_from_the_cell():
    from bench.harness import cell as cellmod
    from bench.harness.run_state import Run
    from bench.harness.spans import Spans
    from bench.harness.trace import Trace

    cell = cellmod.load("mamba2-780m.longprompt")
    read = cellmod.reader("ssd_scan_roofline.prefill")
    least, _ = ssd_bound(4, 1024, 48, 64, 1, 128, 256, 2)
    run = Run(spans=Spans(sync=False, device_type="cpu"), trace=Trace(window_s=1.0, busy_s=0.5,
                                                                    kernel_s={"ssd_cb_kernel": 48 * 4 * least}))
    run.info["profiled"] = {"batch": 4, "seq_len": 1024, "kernels": {"ssd_scan": {"LAUNCHES": 48, "BACKWARDS": 0}}}
    assert abs(read(run, cell) - 25.0) < 1e-9
    run.info["profiled"]["kernels"]["ssd_scan"]["LAUNCHES"] = 0
    assert read(run, cell) is None


def test_mamba2_780m_applies_780m_weights_a_token():
    arch = config("mamba2-780m")
    d, di, h, n, w = 1536, 3072, 48, 128, 4
    layer = (d + 2 * d * di + 2 * d * n + d * h + w * di + di + 2 * (w * n + n) + 3 * h + di + di * d)
    assert layer == 14_644_112
    # the tied embedding, 50288 rows (config.json's 50277 padded to a multiple of 16), once as the head
    assert arch["vocab_size"] == 50288
    assert program.applied_weights(ref, arch) == 48 * layer + 50288 * d + d == 780_161_280
