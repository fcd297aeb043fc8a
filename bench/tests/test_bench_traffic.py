"""The one traffic generator: every mix is made from the seed alone."""
import json

import numpy as np
import pytest

from bench.harness import traffic
from bench.harness.env import BENCH

MIXES = sorted(p.stem for p in (BENCH / "traffic").glob("*.json"))


@pytest.mark.parametrize("name", MIXES)
def test_mix_is_deterministic_from_the_seed(name):
    mix = traffic.load(BENCH / "traffic" / f"{name}.json")
    seed = 2**31 + 12345  # seeds may exceed 32 signed bits
    kind = traffic.ServeTraffic if mix["kind"] == "serve" else traffic.TrainTraffic
    a, b, c = (kind(mix, 1000, s) for s in (seed, seed, seed + 1))
    for i in range(6):
        x, y, z = a.batch(i), b.batch(i), c.batch(i)
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
        assert any(not np.array_equal(u, w) for u, w in zip(x, z) if isinstance(u, np.ndarray))


@pytest.mark.parametrize("name", [m for m in MIXES if json.loads((BENCH / "traffic" / f"{m}.json").read_text())["kind"] == "serve"])
def test_every_seed_serves_the_same_lengths_in_its_own_order(name):
    mix = traffic.load(BENCH / "traffic" / f"{name}.json")
    cycles = {}
    for seed in (1, 2, 3, 2**33):
        t = traffic.ServeTraffic(mix, 1000, seed)
        k = len(t.lengths)
        cycles[seed] = [sorted(t.length(c * k + j) for j in range(k)) for c in range(3)]
        s, prompts = t.batch(0)
        assert prompts.shape == (mix["batch"], s) and prompts.min() >= 0 and prompts.max() < 1000
        assert s % mix["prompt"]["round"] == 0 and mix["prompt"]["min"] <= s <= mix["prompt"]["max"]
        assert s + mix["new_tokens"] - 1 <= mix["max_len"]
    assert all(c == [sorted(traffic.cycle_lengths(mix["prompt"]))] * 3 for c in cycles.values())


def test_cycle_lengths_reach_both_ends_of_the_range():
    # log-uniform on [1024, 4096]: 1024 * 4 ** (i / 3), rounded down to 256
    assert traffic.cycle_lengths({"min": 1024, "max": 4096, "round": 256, "strata": 4}) == [1024, 1536, 2560, 4096]
    assert traffic.cycle_lengths({"min": 256, "max": 1024, "round": 256, "strata": 4}) == [256, 256, 512, 1024]
    with pytest.raises(ValueError):
        traffic.cycle_lengths({"min": 256, "max": 1024, "round": 256, "strata": 1})


def test_train_rows_all_differ():
    mix = traffic.load(BENCH / "traffic" / "train-2k.json")
    t = traffic.TrainTraffic(mix, 50288, 7)
    rows = np.concatenate([t.batch(k)[0] for k in range(4)])
    assert rows.shape == (4 * mix["batch"], mix["seq_len"])
    assert len({r.tobytes() for r in rows}) == len(rows)
    tokens, labels = t.batch(0)
    np.testing.assert_array_equal(tokens[:, 1:], labels[:, :-1])
