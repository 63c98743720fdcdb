"""Observability: profiler traces and the equity CI meter, the port of
``montecarlo_tpu/utils/profiling.py``.

The reference's only observability is bare ``println``s on the hot path
(``board.clj:99-107``, ``helpers.clj:42``). Here: ``torch.profiler``
traces (Chrome trace JSON, viewable in Perfetto) and the host-side meter
of BASELINE's second primary metric, the equity CI95 width at a fixed
wall clock, on K1 (``rollout/equity.equity_vs_hand``).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.ops.philox import MASK


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (``trace.json``): CPU activity, and CUDA activity when ``device`` is
    the card (the card when None; ``device="cpu"`` traces the host
    only)."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def ci_width_at_wallclock(seed: int, hero, villain, seconds: float,
                          batch_size: int = 1 << 26, device=None):
    """Run hand-vs-hand equity rollouts (K1 on the card, its plain version
    for ``device="cpu"``) for ~``seconds`` of wall clock and return
    ``(EquityResult, elapsed)``; the result's ci95 width is the BASELINE
    metric.

    One call warms outside the budget; batch ``i`` then draws Philox
    stream ``seed + 1000 + i`` (JAX folds ``1000 + i`` into its key), so
    batches never reuse a rollout."""
    from montecarlo_tpu_torch.ops.cuda_equity import equity_vs_hand_counts
    from montecarlo_tpu_torch.rollout.equity import EquityResult

    dev = resolve(device)
    counts, _ = equity_vs_hand_counts(seed, hero, villain, batch_size, (),
                                      dev)
    counts.tolist()  # the warm call, synced

    wins = ties = n = 0
    i = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        counts, _ = equity_vs_hand_counts((seed + 1000 + i) & MASK, hero,
                                          villain, batch_size, (), dev)
        w, t = counts.tolist()
        wins += w
        ties += t
        n += batch_size
        i += 1
    elapsed = time.perf_counter() - t0
    return EquityResult(wins=wins, ties=ties, losses=n - wins - ties,
                        n=n), elapsed
