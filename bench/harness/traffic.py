"""The one traffic generator: it reads a mix's parameters (``bench/traffic/<mix>.json``)
and makes its prompts, lengths and token batches from the seed alone.

Serving mixes (``"kind": "serve"``) form a closed loop of uniform batches: each
batch has ``batch`` requests of one prompt length and ``new_tokens`` tokens each
(the engine decodes greedily).  The lengths come in cycles: the length
distribution (log-uniform between ``min`` and ``max``) at ``strata`` evenly
spaced quantiles from 0 to 1, so that both ends are served, each rounded down
to a multiple of ``round``.  Every seed serves the same cycle of lengths, in its
own order, with its own prompt tokens (uniform over the vocabulary), so that
seeds change the order and the content but not the amount of work.

Training mixes (``"kind": "train"``) give each step a new batch of ``batch`` rows
of ``seq_len + 1`` tokens (inputs and next-token labels), uniform over the
vocabulary, from the seed and the step's index.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def load(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    if mix.get("kind") not in ("serve", "train"):
        raise ValueError(f"{path}: kind must be 'serve' or 'train', got {mix.get('kind')!r}")
    return mix


def cycle_lengths(prompt: dict) -> list[int]:
    """The prompt lengths of one cycle, shortest first: ``min`` and ``max`` and the quantiles
    evenly spaced between them (``strata`` >= 2)."""
    lo, hi, k, r = prompt["min"], prompt["max"], prompt["strata"], prompt["round"]
    if k < 2:
        raise ValueError(f"strata must be at least 2 (both ends of the range), got {k}")
    out = []
    for i in range(k):
        q = i / (k - 1)
        length = lo * (hi / lo) ** q  # exact at both ends
        out.append(max(r, int(length) // r * r))
    return out


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, *stream]))


class ServeTraffic:
    """The batches of a serving mix for one seed: ``batch(i)`` is the i-th batch's prompt
    length and its prompts, (batch, length) int64 on the host."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix, self.vocab, self.seed = mix, vocab, seed
        self.lengths = cycle_lengths(mix["prompt"])
        self.size = mix["batch"]
        self.new_tokens = mix["new_tokens"]
        self.max_len = mix["max_len"]

    def length(self, i: int) -> int:
        cycle, pos = divmod(i, len(self.lengths))
        order = rng(self.seed, 1, cycle).permutation(len(self.lengths))
        return self.lengths[order[pos]]

    def batch(self, i: int) -> tuple[int, np.ndarray]:
        s = self.length(i)
        return s, rng(self.seed, 2, i).integers(0, self.vocab, (self.size, s), dtype=np.int64)

    def distinct_lengths(self) -> list[int]:
        return sorted(set(self.lengths))


class TrainTraffic:
    """``batch(step)``: (tokens, labels), each (batch, seq_len) int64 on the host; every row new."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix, self.vocab, self.seed = mix, vocab, seed
        self.size, self.seq_len = mix["batch"], mix["seq_len"]

    def batch(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        rows = rng(self.seed, 3, step).integers(0, self.vocab, (self.size, self.seq_len + 1), dtype=np.int64)
        return rows[:, :-1], rows[:, 1:]
