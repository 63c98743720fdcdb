"""The league driver makes ``selfplay_net_league``'s calls one by one, so
that the check has the final state: at a CPU size and for the same seed
it gives what the entry gives, meters and hands."""

import numpy as np
import pytest
import torch

from harness_small import small_cell
from mcbench import seeds


@pytest.mark.parametrize("key", [0, 5])
def test_league_driver_equals_the_entry(key):
    from montecarlo_tpu_torch.ops import cuda_net as cn
    _, _, config, traffic, mod = small_cell("std6_league_es9_es8")
    traffic = dict(traffic, slots=40)      # a last launch shorter than 16
    seed = 2**35 + 11
    d = mod.Driver(config, traffic, torch.device("cpu"), seed)
    state, hands, (reported, _) = d._run(key)
    bb, err, n = cn.seat_meters(state, d.cfg)
    want = cn.selfplay_net_league(
        seeds.kernel_seed(seed, "request", key), d.cfg, d.banks, d.stb,
        d.T, d.slots, int(traffic["net_seats"]),
        steps_per_launch=d.per_launch, device="cpu")
    np.testing.assert_array_equal(bb, want[0])
    np.testing.assert_array_equal(err, want[1])
    assert hands == reported == n == want[2] > 0
