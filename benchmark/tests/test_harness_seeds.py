"""Every traffic generator makes the same requests from the same --seed,
other requests from another, and the same work from every seed."""

import numpy as np
import pytest
import torch

from harness_small import small_cell
from mcbench import seeds, tables

SEEDS = [0, 1, 2**31 - 1, 2**31 + 17, 2**40 + 3, -5]


def test_kernel_seeds_in_range_and_deterministic():
    for s in SEEDS:
        a = [seeds.kernel_seed(s, "request", i) for i in range(20)]
        assert a == [seeds.kernel_seed(s, "request", i) for i in range(20)]
        assert all(0 <= x < 2**31 for x in a) and len(set(a)) == 20
    assert seeds.kernel_seed(1, "request", 0) != seeds.kernel_seed(
        2, "request", 0)


def test_equity_queries_generator():
    _, _, _, _, mod = small_cell("equity_hu_queries")
    from harness_small import spec
    full = spec.traffic("aks_qq_1e6")
    # the README's AKs (spades) and QQ (hearts, diamonds), no board
    assert mod.matchups(full) == [([12, 11], [23, 36], [])]
    assert full["rollouts"] == 10**6
    for s in SEEDS:
        a = [mod.query_seed(s, i, 0) for i in range(20)]
        assert a == [mod.query_seed(s, i, 0) for i in range(20)]
        assert len(set(a)) == 20 and all(0 <= x < 2**31 for x in a)
        assert mod.query_seed(s, "warmup", 0) not in a
    assert mod.query_seed(5, 0, 0) != mod.query_seed(6, 0, 0)


def test_sweep_hands_and_seeds():
    _, _, _, _, mod = small_cell("equity_sweep169")
    hands = mod.canonical_hands()
    assert hands.shape == (169, 2)
    classes = set()
    for a, b in hands.tolist():
        hi, lo = max(a % 13, b % 13), min(a % 13, b % 13)
        suited = a // 13 == b // 13
        assert a != b
        classes.add((hi, lo, suited))
    assert len(classes) == 169


def test_table_samples():
    for s in SEEDS:
        a = tables.sample_tables(s, 1 << 20, 2048)
        np.testing.assert_array_equal(a, tables.sample_tables(s, 1 << 20,
                                                              2048))
        assert len(np.unique(a)) == 2048 and a.max() < 1 << 20
        first, last = tables.checked_requests(s, 100)
        assert 0 <= first < 8 and last == 99
        assert tables.checked_requests(s, 1) == [0]


@pytest.mark.parametrize("cell", ["std6_selfplay_random",
                                  "std6_league_es9_es8"])
def test_engine_reference_deterministic(cell):
    _, _, config, traffic, mod = small_cell(cell)
    d1 = mod.Driver(config, traffic, torch.device("cpu"), 2**33 + 1)
    d2 = mod.Driver(config, traffic, torch.device("cpu"), 2**33 + 1)
    d3 = mod.Driver(config, traffic, torch.device("cpu"), 2**33 + 2)
    r1, r2, r3 = (d.reference(0) for d in (d1, d2, d3))
    r1, r2, r3 = (r[0] if isinstance(r, tuple) else r for r in (r1, r2, r3))
    assert torch.equal(r1, r2) and not torch.equal(r1, r3)
