"""The traffic generator: waves depend on the seed and their index only."""

import json
from pathlib import Path

import numpy as np
import pytest

from traffic import Traffic

WORKLOADS = sorted((Path(__file__).resolve().parents[1] / "workloads").glob("*.json"))


@pytest.mark.parametrize("path", WORKLOADS, ids=lambda p: p.stem)
def test_same_seed_same_waves(path):
    t = Traffic.load(path)
    for i in (-1, 0, 7):
        a, b = t.wave(2**31 + 9, i, 1000), t.wave(2**31 + 9, i, 1000)
        assert len(a) == t.batch and all(np.array_equal(x, y) for x, y in zip(a, b))
        assert all(x.dtype == np.int32 and 0 <= x.min() and x.max() < 1000 for x in a)


@pytest.mark.parametrize("path", WORKLOADS, ids=lambda p: p.stem)
def test_every_wave_holds_the_same_lengths_in_a_seeded_order(path):
    """Wave i holds the same lengths for every seed, in an order the seed
    draws; the waves pad to lengths the law spreads, each a multiple of
    ``multiple`` within [min, max]; the warm-up wave holds the longest."""
    t = Traffic.load(path)
    orders = set()
    for i in range(4):
        want = sorted(t.lengths(i).tolist())
        for seed in (1, 2, 3):
            lens = [len(p) for p in t.wave(seed, i, 50)]
            assert sorted(lens) == want
            orders.add(tuple(lens))
    assert len(orders) > 4
    padded = {int(t.lengths(i).max()) for i in range(16)}
    assert len(padded) > 2 and padded <= set(t.padded_lengths())
    assert all(n % t.multiple == 0 and t.min_len <= n <= t.max_len for i in range(16) for n in t.lengths(i))
    warm = t.wave(5, -1, 50)
    assert [len(p) for p in warm] == [t.max_len] * t.batch
    # the warm-up wave's tokens are none of the window's
    assert not np.array_equal(warm[0][:8], t.wave(5, 0, 50)[0][:8])


def test_seeds_change_the_tokens():
    t = Traffic.load(WORKLOADS[0])
    a, b = t.wave(1, 0, 10**5), t.wave(2, 0, 10**5)
    assert not all(len(x) == len(y) and np.array_equal(x, y) for x, y in zip(a, b))


def test_lognormal_lengths_are_drawn_and_clipped(tmp_path):
    spec = {"batch": 64, "new_tokens": 4,
            "prompt": {"median": 100, "sigma": 1.0, "min": 50, "max": 200, "multiple": 1}}
    (tmp_path / "t.json").write_text(json.dumps(spec))
    t = Traffic.load(tmp_path / "t.json")
    lens = [len(p) for p in t.wave(3, 0, 10)]
    assert min(lens) == 50 and max(lens) == 200 and len(set(lens)) > 5
    spec["prompt"]["multiple"] = 25
    (tmp_path / "t.json").write_text(json.dumps(spec))
    t = Traffic.load(tmp_path / "t.json")
    assert all(n % 25 == 0 for n in t.lengths(0)) and t.lengths(0).max() == 200


def test_bad_traffic_is_refused(tmp_path):
    for prompt in ({"median": 1, "sigma": 1, "min": 2, "max": 1, "multiple": 1},
                   {"median": 100, "sigma": 1, "min": 50, "max": 200, "multiple": 128}):
        (tmp_path / "t.json").write_text(json.dumps({"batch": 8, "new_tokens": 4, "prompt": prompt}))
        with pytest.raises(ValueError):
            Traffic.load(tmp_path / "t.json")
