"""Observability: profiler traces, the program's spans and the equity CI
meter, the port of ``montecarlo_tpu/utils/profiling.py``.

The reference's only observability is bare ``println``s on the hot path
(``board.clj:99-107``, ``helpers.clj:42``). Here: ``torch.profiler``
traces (Chrome trace JSON, viewable in Perfetto), the span recorder, and
the host-side meter of BASELINE's second primary metric, the equity CI95
width at a fixed wall clock, on K1 (``rollout/equity.equity_vs_hand``).

The span recorder. The wrappers mark their host phases with
``with span(name):`` (the first deal, ``pack_state``, each launch, the
answers' read-back; ``ops/cuda_engine.py``, ``cuda_net.py``,
``cuda_equity.py``). While a ``torch.profiler`` session runs in the
process, and only then, a span records ``(name, start_ns, end_ns,
parent)``: both times from ``time.time_ns``, the clock of
``torch.profiler``'s events, so a span and a device operation of one
trace compare directly; ``parent`` is the index of the enclosing span of
the same thread in the same list, -1 at the top; ``end_ns`` is -1 while
the span is open. ``spans()`` hands over what was recorded and starts a
new list, and ``device_trace`` starts one too, so a process that profiles
again and again holds at most what it has not read. Off, ``span`` returns
one shared no-op context: no clock reading, no allocation.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.ops.philox import MASK


_NO_SPAN = contextlib.nullcontext()
# torch.profiler's own flag, on while a session runs; a torch without it
# records no span
_HAS_FLAG = hasattr(_autograd_profiler, "_is_profiler_enabled")
_state = {"events": []}
_lock = threading.Lock()
_stacks = threading.local()


def is_recording() -> bool:
    """Whether ``span`` records: while a ``torch.profiler`` session
    runs."""
    return _HAS_FLAG and _autograd_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "events", "index")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_stacks, "open", None)
        if stack is None:
            stack = _stacks.open = []
        with _lock:
            self.events = events = _state["events"]
            self.index = len(events)
            # an enclosing span handed over by spans() is no parent here
            parent = stack[-1][1] if stack and stack[-1][0] is events \
                else -1
            events.append((self.name, time.time_ns(), -1, parent))
        stack.append((events, self.index))
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stacks.open.pop()
        name, start, _, parent = self.events[self.index]
        self.events[self.index] = (name, start, end, parent)
        return False


def span(name: str):
    """A context that records the block as the span ``name`` while a
    profiler runs (``is_recording``); otherwise one shared no-op."""
    return _Span(name) if is_recording() else _NO_SPAN


def spans() -> list:
    """The spans recorded since the last call, ``(name, start_ns, end_ns,
    parent)`` in the order they opened; recording goes on into a new
    list."""
    with _lock:
        got, _state["events"] = _state["events"], []
    return got


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (``trace.json``): CPU activity, and CUDA activity when ``device`` is
    the card (the card when None; ``device="cpu"`` traces the host
    only). The block's spans start a new list: ``spans()`` after it."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    spans()     # the session's spans start a new list
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
