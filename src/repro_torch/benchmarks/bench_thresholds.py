"""Beyond-paper ablation: sweep the classification thresholds T_SM / T_ML.

The paper fixes T_SM=0.2, T_ML=0.02 and explicitly leaves "examining these
thresholds in more detail" to future work (§2.2).  This sweep runs Run A over
the MD mix for a grid of thresholds and reports amplification — validating
that the paper's chosen operating point sits on the flat bottom of the basin
(small deviations don't help), while collapsing either threshold (the MS/ML
degenerate corners) hurts."""
from __future__ import annotations

from .common import load_then_run

KEYS = 8_000


def main(emit) -> None:
    grid = [
        (0.2, 0.02),   # paper operating point
        (0.3, 0.02),
        (0.12, 0.02),
        (0.2, 0.05),
        (0.2, 0.008),
        (0.3, 0.05),
        (0.02, 0.02),  # degenerate: no medium class (MS corner)
        (0.2, 0.2),    # degenerate: no medium class (ML corner)
    ]
    results = {}
    for t_sm, t_ml in grid:
        _, run, _ = load_then_run(
            f"thresholds:tsm{t_sm}_tml{t_ml}", "parallax", "MD",
            num_keys=KEYS, num_ops=KEYS,
            cfg_kw={"t_sm": t_sm, "t_ml": t_ml},
        )
        results[(t_sm, t_ml)] = run.amplification
        emit(run.row())
    paper = results[(0.2, 0.02)]
    best = min(results.values())
    # the paper's point is within 15% of the best grid point, and both
    # degenerate corners are worse than the paper's choice
    assert paper <= best * 1.15, (paper, best, results)
    assert results[(0.02, 0.02)] > paper * 0.98, results
    assert results[(0.2, 0.2)] > paper * 0.98, results
    emit(
        f"thresholds/claims,0,paper_amp={paper:.2f};grid_best={best:.2f};"
        f"paper_within={paper/best:.3f}x_of_best"
    )
