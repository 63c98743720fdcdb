"""The program's own spans in a traced window, and the arithmetic of the
readers that split the card's idle time by them.

The port marks its wrappers' host phases with spans
(``montecarlo_tpu_torch.utils.profiling.span``: ``first_deal``,
``pack_state``, ``launch.<key>``, ``meters.read``, ...) and records them
while a ``torch.profiler`` session runs, so the traced window records them
with no change to ``trace.traced``; their times are ``time.time_ns``, the
profiler's clock. ``spans(summary)`` takes them from the program once a
summary (``profiling.spans()`` hands them over), clipped to its window,
keeps them as ``summary.program`` and appends them to ``summary.host``:
the breakdown's idle gaps, which ``core`` reads after the metrics, then
name a program span wherever it is the innermost host event. So the
breakdown names them in a cell that reports a reader of this module, and
every traced cell does; a reader of ``summary.host`` would see them only
after such a reader (none of the others reads it). A program without the
recorder gives no spans, and every reader here returns None.
"""

from __future__ import annotations

import numpy as np

# The CUDA runtime calls that enqueue work on the card.
ENQUEUE = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaMemcpyAsync",
           "cudaMemsetAsync")


def _recorded() -> list:
    """The program's recorded spans, or [] without the recorder."""
    try:
        from montecarlo_tpu_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    return read() if read is not None else []


def spans(summary) -> list:
    """[(name, start, end)] (ns) of the program's spans in the window of
    ``summary``, clipped to it; read once, then kept on the summary."""
    kept = getattr(summary, "program", None)
    if kept is not None:
        return kept
    kept = []
    for name, start, end, _ in _recorded():
        a, b = max(start, summary.t0), min(end, summary.t1)
        if end >= 0 and b > a:
            kept.append((name, a, b))
    summary.program = kept
    summary.host.extend(kept)
    return kept


def merged(starts, ends):
    """(starts, ends): the sorted, disjoint intervals of the union."""
    s, e = np.asarray(starts, np.int64), np.asarray(ends, np.int64)
    if not len(s):
        return s, e
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(run_end[idx[1:] - 1], run_end[-1])


def idle(summary):
    """(starts, ends): the window's intervals with no device operation."""
    s, e = merged(summary.starts, summary.ends)
    return (np.concatenate([[summary.t0], e]),
            np.concatenate([s, [summary.t1]]))


def covered_ns(a, b, x) -> np.ndarray:
    """For sorted, disjoint intervals [a, b): the length of their union
    up to each point of ``x``."""
    x = np.asarray(x, np.int64)
    before = np.concatenate([[0], np.cumsum(b - a)])
    k = np.searchsorted(a, x, side="right") - 1
    j = np.maximum(k, 0)
    inside = np.clip(x - a[j], 0, b[j] - a[j])
    return np.where(k >= 0, before[j] + inside, 0)


def of_names(summary, names):
    """(starts, ends): the union of the program spans named ``names``, or
    None where the program recorded no span in the window."""
    found = spans(summary)
    if not found:
        return None
    chosen = [(a, b) for n, a, b in found if n in names]
    return merged([a for a, _ in chosen], [b for _, b in chosen])


def idle_pct(summary, names):
    """100 x the window's idle card time inside the program spans named
    ``names`` over the window; None without device operations or program
    spans."""
    if summary is None or summary.window_s <= 0 or not len(summary.names):
        return None
    under = of_names(summary, names)
    if under is None:
        return None
    ia, ib = idle(summary)
    ns = covered_ns(ia, ib, under[1]) - covered_ns(ia, ib, under[0])
    return 100.0 * float(ns.sum()) * 1e-9 / summary.window_s


def enqueues_per_request(summary, names, requests: int):
    """The runtime calls of ``ENQUEUE`` that start inside the program
    spans named ``names``, over ``requests``; None without device
    operations, program spans or requests."""
    if summary is None or not len(summary.names) or requests < 1:
        return None
    under = of_names(summary, names)
    if under is None:
        return None
    a, b = under
    if not len(a):
        return 0.0
    x = np.array([h[1] for h in summary.host if h[0] in ENQUEUE], np.int64)
    k = np.searchsorted(a, x, side="right") - 1
    inside = (k >= 0) & (x < b[np.maximum(k, 0)])
    return float(np.count_nonzero(inside)) / requests
