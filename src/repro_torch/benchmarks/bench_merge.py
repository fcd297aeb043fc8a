"""Paper Fig. 8: (top) merge level N-1 vs N-2 and the NoMerge ideal;
(bottom) sorted vs unsorted transient-log segments.  Workload M (all-medium),
growth factor 4 — the paper's stress setup for the transient log."""
from __future__ import annotations

from .common import open_engine, run_phase, scaled_config, tagged
from repro_torch.core.ycsb import Workload

KEYS = 25_000


def one(emit, name: str, *, merge_depth: int, sorted_segments: bool, mode: str = "parallax"):
    cfg = scaled_config(
        mode, growth_factor=4, dataset_keys=KEYS, avg_kv_bytes=128,
        merge_depth=merge_depth, sorted_segments=sorted_segments,
    )
    engine = open_engine(cfg)
    w = Workload("load_a", "M", num_keys=KEYS, num_ops=0)
    res = run_phase(f"fig8:{name}", name, engine, w.load_ops())
    emit(res.row())
    # space amplification: transient-log live bytes over dataset
    space = engine.space_bytes()
    dataset = KEYS * (24 + 104)
    emit(f"{tagged(f'fig8:{name}/space', engine)},0,"
         f"space_amp={space/dataset:.2f};medium_segments={len(engine.store.medium_log.segments)}")
    return res.amplification


def main(emit) -> None:
    amp_n1 = one(emit, "N-1_sorted", merge_depth=1, sorted_segments=True)
    amp_n2 = one(emit, "N-2_sorted", merge_depth=2, sorted_segments=True)
    amp_n1u = one(emit, "N-1_unsorted", merge_depth=1, sorted_segments=False)
    amp_n2u = one(emit, "N-2_unsorted", merge_depth=2, sorted_segments=False)
    amp_ideal = one(emit, "NoMerge_ideal", merge_depth=1, sorted_segments=True, mode="nomerge")
    amp_rocks = one(emit, "rocksdb_ref", merge_depth=1, sorted_segments=True, mode="rocksdb")
    # paper claims:
    assert amp_ideal < amp_n1 < amp_rocks, (amp_ideal, amp_n1, amp_rocks)
    # sorted segments cut amplification substantially at N-1 (paper: ~4x)
    assert amp_n1u / amp_n1 > 1.5, (amp_n1u, amp_n1)
    # merging at N-1 beats N-2 on I/O amplification (paper top row: 6.8 vs 9.6)
    assert amp_n1 < amp_n2, (amp_n1, amp_n2)
    # NOTE: the paper's *secondary* observation (unsorted prefers N-2) does
    # not reproduce at 3-4 levels — recorded, not asserted; see EXPERIMENTS.md
    emit(
        f"fig8/claims,0,sorted_gain_at_N1={amp_n1u/amp_n1:.2f}x;"
        f"N1_vs_N2={amp_n2/amp_n1:.2f}x;unsortedN2_vs_N1={amp_n2u/amp_n1u:.2f}x;"
        f"ideal={amp_ideal:.2f};rocksdb={amp_rocks:.2f}"
    )
