"""Analytical I/O-amplification model from the paper (Section 2).

Implements Equations 1-4 plus the level-capacity ratio R(i) used to bound the
transient-log space amplification (Section 3.3).  These are the quantitative
basis for the hybrid-placement thresholds ``T_SM``/``T_ML`` and are validated
against closed forms in tests and reproduced as paper Fig. 2 in
``benchmarks/bench_model.py``.

All functions are pure.  The closed forms take python scalars; the
vectorized ones (``separation_benefit``, ``SizePolicy.p_of`` and
``SizePolicy.classify``) take torch tensors and compute in float32, as the
JAX reference does without x64.  A tensor keeps its device; a python scalar
or numpy array goes to ``device``, which defaults to the card and raises
without one (pass ``device="cpu"`` to run on the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

# Paper Section 2.2 / Section 4: thresholds on p = key(prefix) / KV size.
T_ML = 0.02  # below this: "large" KV pairs   (log always; GC affordable)
T_SM = 0.20  # above this: "small" KV pairs   (in place; log not worth GC)


def _tensor(x, device) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is, anything else on ``device``."""
    if isinstance(x, torch.Tensor):
        return x
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available; pass device='cpu' to run on the CPU explicitly")
    return torch.as_tensor(np.asarray(x), device=dev)


def amplification_inplace_sum(levels: int, growth_factor: int, s0: float) -> float:
    """Equation 1 evaluated literally (the explicit per-level double sum).

    ``levels`` is ``l`` (the index of the last level; levels are L0..Ll), so
    there are ``l`` merge boundaries.  ``s0`` is the L0 (memory) size and the
    dataset is ``S_l = s0 * f**l``.  Returns total device traffic D.
    """
    f = growth_factor
    sl = s0 * f**levels
    total = 0.0
    for i in range(levels):  # sub-expression for level i -> i+1
        si = s0 * f**i
        merges = int(round(sl / si))
        read_write_upper = (1 if i == 0 else 2) * si * merges
        lower = 2 * sum(((j - 1) % f) * si for j in range(1, merges + 1))
        total += read_write_upper + lower
    return total


def amplification_inplace(levels: int, growth_factor: int, sl: float = 1.0) -> float:
    """Equation 2 closed form: D = S_l * (l - 1 + f*l)."""
    return sl * (levels - 1 + growth_factor * levels)


def amplification_separated(levels: int, growth_factor: int, p: float, sl: float = 1.0) -> float:
    """Equation 3 closed form: D' = K_l*(l-1+f*l) + S_l with K_l = p*S_l."""
    return p * sl * (levels - 1 + growth_factor * levels) + sl


def separation_benefit(levels: int, growth_factor: int, p, *, device="cuda"):
    """Equation 4: D/D' = (l-1+f*l) / (p*(l-1+f*l) + 1).

    ``p`` may be a scalar, an array or a tensor; returns a float32 tensor of
    the same shape.
    """
    a = levels - 1 + growth_factor * levels
    p = _tensor(p, device).to(torch.float32)
    # a tensor numerator: ``a / t`` would take the reciprocal first and round twice
    return torch.full_like(p, a) / (p * a + 1.0)


def capacity_ratio(num_levels: int, growth_factor: int, i: int) -> float:
    """R(i) = (1 - f^(N-i)) / (1 - f^N): fraction of total LSM capacity held by
    the first N-i levels (paper Section 3.3, Fig. 2b).  This bounds the space
    amplification of keeping medium KVs in the transient log until level N-i.
    """
    f = float(growth_factor)
    n = num_levels
    return (1.0 - f ** (n - i)) / (1.0 - f**n)


@dataclasses.dataclass(frozen=True)
class SizePolicy:
    """The paper's size classifier (Section 3.1).

    ``p`` is computed with the *index entry* size as numerator: Parallax stores
    a fixed prefix (12 B) + a log pointer in the index, so the classifier uses
    ``prefix_size`` rather than the full (variable) key, per Section 2.2.
    """

    t_sm: float = T_SM
    t_ml: float = T_ML
    prefix_size: int = 12
    pointer_size: int = 8

    def p_of(self, key_size, value_size, *, device="cuda"):
        """Ratio p for a KV pair, in float32; sizes may be scalars, arrays or tensors."""
        k = _tensor(key_size, device)
        kv = k + _tensor(value_size, device)
        return k.clamp(max=self.prefix_size).to(torch.float32) / kv.to(torch.float32)

    def classify(self, key_size, value_size, *, device="cuda"):
        """0 = small (in place), 1 = medium (transient log), 2 = large (log).

        Vectorized: accepts arrays or tensors, returns an int32 tensor of
        categories.  The thresholds are compared in float32, as in the
        reference.
        """
        p = self.p_of(key_size, value_size, device=device)
        t_sm = torch.tensor(self.t_sm, dtype=torch.float32, device=p.device)
        t_ml = torch.tensor(self.t_ml, dtype=torch.float32, device=p.device)
        cat = torch.where(p < t_ml, 2, 1)
        return torch.where(p > t_sm, 0, cat).to(torch.int32)

    def classify_scalar(self, key_size: int, value_size: int) -> int:
        # pure-python fast path (the store calls this per op; no tensor dispatch)
        p = min(key_size, self.prefix_size) / (key_size + value_size)
        if p > self.t_sm:
            return 0
        if p < self.t_ml:
            return 2
        return 1


def levels_for_dataset(dataset_bytes: float, l0_bytes: float, growth_factor: int) -> int:
    """Number of levels l such that S_l = l0 * f**l >= dataset (min 1)."""
    l = 1
    cap = l0_bytes * growth_factor
    while cap < dataset_bytes:
        l += 1
        cap *= growth_factor
    return l


def expected_benefit_table(levels: int, growth_factor: int, ps: Sequence[float]) -> np.ndarray:
    """Convenience for benchmarks: rows of (p, D/D')."""
    out = []
    for p in ps:
        out.append((p, float(separation_benefit(levels, growth_factor, p, device="cpu"))))
    return np.asarray(out)
