"""Paper Fig. 2: the analytical model curves (pure math, validates Eq. 2-4)."""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import model as M


def main(emit, device: str = "cuda") -> None:
    t0 = time.time()
    # Fig 2(a): D/D' vs p for a production tree (l=4, f=8)
    ps = [0.001, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.4, 0.72, 1.0]
    ratios = [float(M.separation_benefit(4, 8, p, device=device)) for p in ps]
    for p, r in zip(ps, ratios):
        emit(f"fig2a/ratio_p={p},{(time.time()-t0)*1e6:.1f},DdivDp={r:.2f}")
    # threshold sanity: the paper's categories
    assert ratios[ps.index(0.01)] > 6.0     # large: order of magnitude
    assert ratios[ps.index(0.72)] < 2.0     # small: not worth a log
    # Fig 2(b): R(1), R(2) for f in 4..10
    for f in range(4, 11):
        r1 = M.capacity_ratio(5, f, 1)
        r2 = M.capacity_ratio(5, f, 2)
        emit(f"fig2b/R_f={f},{(time.time()-t0)*1e6:.1f},R1={r1:.4f};R2={r2:.4f}")
    # Eq.1 literal == Eq.2 closed form (model self-check)
    lit = M.amplification_inplace_sum(4, 8, 1024.0)
    clo = M.amplification_inplace(4, 8, 1024.0 * 8**4)
    emit(f"fig2/eq1_vs_eq2,{(time.time()-t0)*1e6:.1f},literal={lit:.0f};closed={clo:.0f};rel_err={abs(lit-clo)/clo:.2e}")
