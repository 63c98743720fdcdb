"""The traced run's reading of ``torch.profiler``.

The window runs inside ``torch.profiler.profile`` with the CUDA activity
alone: the card's kernels, copies and sets, and the CUDA runtime calls
that launched them, on the profiler's clock (nanoseconds of the wall
clock, ``time.time_ns``). The host's operator events are not recorded,
so the trace costs the host little. The drivers record spans of their
own (``Spans``) around their calls into the program. Only a summary is
kept; no Chrome trace is written.

From it: the seconds the device was busy (the union of its operations'
intervals inside the window), each kernel's summed seconds, and the idle
gaps between device operations, each named by the innermost host event
(a driver's span or a runtime call) open at the gap's middle.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import numpy as np



# Device operations' names (demangled signatures) are cut to this length
# in the breakdown.
NAME_CHARS = 160


class Spans:
    """Host spans of a traced window: ``with spans(name):`` records (name,
    start, end) in ``time.time_ns`` when ``on``, and nothing otherwise."""

    def __init__(self):
        self.on = False
        self.events = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.events.append((name, t0, time.time_ns()))


@dataclasses.dataclass
class Summary:
    window_s: float
    # device operations: names, and start / end in ns on the profiler's
    # clock, clipped to the window
    names: list
    starts: np.ndarray
    ends: np.ndarray
    # the host's events on the window's thread: name, start, end (ns)
    host: list
    t0: int
    t1: int

    def union_s(self, mask=None) -> float:
        """Seconds covered by the device operations selected by ``mask``
        (all of them when None)."""
        s, e = self.starts, self.ends
        if mask is not None:
            s, e = s[mask], e[mask]
        if not len(s):
            return 0.0
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        run_end = np.maximum.accumulate(e)
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > run_end[:-1]
        idx = np.flatnonzero(new)
        seg_end = np.append(run_end[idx[1:] - 1], run_end[-1])
        return float((seg_end - s[idx]).sum()) * 1e-9

    def matching(self, pattern: str) -> np.ndarray:
        return np.array([pattern in n for n in self.names], bool)

    def kernel_s(self, pattern: str) -> float:
        """Summed seconds of the device operations whose name holds
        ``pattern``."""
        m = self.matching(pattern)
        return float((self.ends[m] - self.starts[m]).sum()) * 1e-9

    def top_ops(self, k: int = 10) -> list:
        """[[name, seconds], ...]: the device operations that took most
        time, summed by name."""
        sums: dict = {}
        for n, s, e in zip(self.names, self.starts, self.ends):
            sums[n] = sums.get(n, 0) + int(e - s)
        top = sorted(sums.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:NAME_CHARS], v * 1e-9] for n, v in top]

    def idle_gaps(self, k: int = 10) -> list:
        """[[host event, seconds], ...]: the device's idle time in the
        window, summed by the innermost host event open at each gap's
        middle ("host" where none is), the largest ``k``."""
        order = np.argsort(self.starts, kind="stable")
        s, e = self.starts[order], self.ends[order]
        run_end = np.maximum.accumulate(e) if len(e) else e
        bounds = [(self.t0, int(s[0]) if len(s) else self.t1)]
        for i in range(1, len(s)):
            if s[i] > run_end[i - 1]:
                bounds.append((int(run_end[i - 1]), int(s[i])))
        if len(s):
            bounds.append((int(run_end[-1]), self.t1))
        gaps = sorted((a, b) for a, b in bounds if b > a)
        host = sorted(self.host, key=lambda h: (h[1], -h[2]))
        sums: dict = {}
        stack, j = [], 0
        for a, b in gaps:
            mid = (a + b) // 2
            while j < len(host) and host[j][1] <= mid:
                while stack and stack[-1][2] <= host[j][1]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and stack[-1][2] <= mid:
                stack.pop()
            name = stack[-1][0] if stack else "host"
            sums[name] = sums.get(name, 0) + (b - a)
        top = sorted(sums.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v * 1e-9] for n, v in top]


@contextlib.contextmanager
def traced(enabled: bool, spans: Spans):
    """Profile the body's CUDA activity when ``enabled``, with ``spans``
    on; yields a holder whose ``summary`` is set on exit, its window the
    body's start and end."""
    holder = dataclasses.make_dataclass("Holder", [("summary", object)])(None)
    if not enabled:
        yield holder
        return
    import torch
    import torch.profiler as tp
    spans.on = True
    # without a card (the tests) the profiler records the host alone
    activity = (tp.ProfilerActivity.CUDA if torch.cuda.is_available()
                else tp.ProfilerActivity.CPU)
    with tp.profile(activities=[activity]) as prof:
        t0 = time.time_ns()
        yield holder
        t1 = time.time_ns()
    spans.on = False
    t_read = time.perf_counter()
    holder.summary = summarize(prof.profiler.kineto_results.events(),
                               spans.events, t0, t1)
    print(f"trace: {len(holder.summary.names)} device operations, read in "
          f"{time.perf_counter() - t_read:.3f} s", file=sys.stderr)


def summarize(events, spans, t0: int, t1: int) -> Summary:
    """The ``Summary`` of kineto events (``kineto_results.events()``) and
    host spans in the window [t0, t1] (ns)."""
    from torch.autograd import DeviceType
    names, starts, ends = [], [], []
    host = [sp for sp in spans if sp[2] > t0 and sp[1] < t1]
    for e in events:
        s, d = int(e.start_ns()), int(e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or d <= 0:
                continue
            a, b = max(s, t0), min(s + d, t1)
            if b > a:
                names.append(e.name())
                starts.append(a)
                ends.append(b)
        elif s + d > t0 and s < t1:
            host.append((e.name(), s, s + d))
    return Summary((t1 - t0) * 1e-9, names, np.array(starts, np.int64),
                   np.array(ends, np.int64), host, t0, t1)
