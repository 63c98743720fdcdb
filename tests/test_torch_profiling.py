"""The port's profiling utilities (``montecarlo_tpu_torch/utils/
profiling.py``).

- ``device_trace`` writes a Chrome trace of the block (CPU activity on
  the CPU) holding the block's operators.
- ``ci_width_at_wallclock`` on the CPU at a budget under a second: K1's
  plain version over whole batches, each batch its own Philox stream
  (``seed + 1000 + i``), the warm call outside the budget; the equity is
  within 4 sigma of ``equity_exact`` and its CI95 width is that of the
  rollouts counted.
"""

import json
import math

import pytest
import torch

from montecarlo_tpu_torch.ops import cuda_equity
from montecarlo_tpu_torch.rollout import equity as teq
from montecarlo_tpu_torch.utils.profiling import (
    ci_width_at_wallclock,
    device_trace,
)

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

AKS = [teq.make_card(0, 14), teq.make_card(0, 13)]
QQ = [teq.make_card(1, 12), teq.make_card(2, 12)]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with device_trace(str(log_dir), device="cpu"):
        torch.ones(8, 8) @ torch.ones(8, 8)
    trace = json.loads((log_dir / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names


def test_ci_width_at_wallclock_on_the_cpu(monkeypatch):
    seeds = []
    counts = cuda_equity.equity_vs_hand_counts

    def recording(seed, *a, **k):
        seeds.append(seed)
        return counts(seed, *a, **k)

    monkeypatch.setattr(cuda_equity, "equity_vs_hand_counts", recording)
    batch = 1 << 14
    res, elapsed = ci_width_at_wallclock(3, AKS, QQ, 0.5, batch,
                                         device="cpu")
    assert 0.5 <= elapsed < 5
    assert seeds[0] == 3 and seeds[1:] == [1003 + i for i in
                                           range(len(seeds) - 1)]
    assert res.n == batch * (len(seeds) - 1) > 0
    assert res.wins + res.ties + res.losses == res.n
    exact = teq.equity_exact(AKS, QQ, device="cpu").equity
    assert abs(res.equity - exact) <= 4 * res.stderr
    lo, hi = res.ci95
    assert hi - lo == pytest.approx(2 * 1.96 * math.sqrt(
        res.equity * (1 - res.equity) / res.n))
