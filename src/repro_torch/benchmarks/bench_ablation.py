"""Paper Fig. 7: is the medium category worth it?  Parallax vs Parallax-MS
(mediums treated as small: T_SM=T_ML=0.02) vs Parallax-ML (mediums treated as
large: T_SM=T_ML=0.2) on Run A for MD and LD mixes."""
from __future__ import annotations

from .common import load_then_run

VARIANTS = {
    "parallax": dict(t_sm=0.2, t_ml=0.02),
    "parallax-MS": dict(t_sm=0.02, t_ml=0.02),
    "parallax-ML": dict(t_sm=0.2, t_ml=0.2),
}
KEYS = 10_000


def main(emit) -> None:
    amp: dict[tuple[str, str], float] = {}
    for mix in ("MD", "LD"):
        for name, thr in VARIANTS.items():
            load, run, _ = load_then_run(
                f"fig7:{mix}", name, mix,
                num_keys=KEYS, num_ops=KEYS,
                cfg_kw={"dataset_keys": KEYS, **thr},
            )
            emit(run.row())
            amp[(mix, name)] = run.amplification
    # paper: the 3-category Parallax improves on both 2-category variants,
    # most visibly on MD
    assert amp[("MD", "parallax")] < amp[("MD", "parallax-MS")], amp
    assert amp[("MD", "parallax")] < amp[("MD", "parallax-ML")], amp
    ms = amp[("MD", "parallax-MS")] / amp[("MD", "parallax")]
    ml = amp[("MD", "parallax-ML")] / amp[("MD", "parallax")]
    emit(f"fig7/claims,0,MD_amp_gain_vs_MS={ms:.2f}x;vs_ML={ml:.2f}x")
