"""The port's profiling utilities (``montecarlo_tpu_torch/utils/
profiling.py``).

- ``device_trace`` writes a Chrome trace of the block (CPU activity on
  the CPU) holding the block's operators.
- The span recorder: on while a ``torch.profiler`` session runs, off by
  default and again after it, also when the block raises; off, ``span``
  is one shared no-op; on ``torch.profiler``'s clock; ``spans()`` hands
  the spans over, so sessions in a row do not pile them up; one stack of
  open spans a thread; the wrappers' spans (first deal, ``pack_state``,
  launches, read-backs) nest as named, and their outputs are bit-equal
  with recording on and off.
- ``ci_width_at_wallclock`` on the CPU at a budget under a second: K1's
  plain version over whole batches, each batch its own Philox stream
  (``seed + 1000 + i``), the warm call outside the budget; the equity is
  within 4 sigma of ``equity_exact`` and its CI95 width is that of the
  rollouts counted.
"""

import contextlib
import json
import math
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_equity
from montecarlo_tpu_torch.ops import cuda_net as cn
from montecarlo_tpu_torch.rollout import equity as teq
from montecarlo_tpu_torch.utils import profiling
from montecarlo_tpu_torch.utils.profiling import (
    ci_width_at_wallclock,
    device_trace,
)

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

AKS = [teq.make_card(0, 14), teq.make_card(0, 13)]
QQ = [teq.make_card(1, 12), teq.make_card(2, 12)]
STD6 = TableConfig(num_seats=6, rules="standard")
T = 1024


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



def _profiled():
    """A ``torch.profiler`` session with CPU activity, after handing over
    what earlier tests left."""
    profiling.spans()
    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("raises", [False, True])
def test_recording_is_off_outside_its_block(raises):
    assert not profiling.is_recording()
    with pytest.raises(RuntimeError) if raises else contextlib.nullcontext():
        with _profiled():
            assert profiling.is_recording()
            with profiling.span("a"):
                if raises:
                    raise RuntimeError("inside")
    assert not profiling.is_recording()
    (name, start, end, parent), = profiling.spans()
    assert (name, parent) == ("a", -1) and 0 < start <= end
    assert profiling.spans() == []


def test_span_off_is_one_shared_noop():
    profiling.spans()
    a, b = profiling.span("a"), profiling.span("b")
    assert a is b
    with a, b:
        torch.ones(4).sum()
    assert profiling.spans() == []


def test_spans_share_the_profilers_clock():
    """Under ``torch.profiler`` (CPU activity) a torch op run inside a
    span has its kineto start and end inside the span's interval."""
    with _profiled() as prof:
        assert profiling.is_recording()
        with profiling.span("outer"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert not profiling.is_recording()
    (name, start, end, parent), = profiling.spans()
    assert (name, parent) == ("outer", -1)
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert start <= e.start_ns() <= e.start_ns() + e.duration_ns() <= end


def test_span_stacks_are_per_thread():
    """Threads that nest spans at once each get their own parents; no span
    is lost and every span closes inside its parent."""
    n_threads, n_spans = 8, 200

    def work(k):
        for _ in range(n_spans):
            with profiling.span(f"t{k}"):
                with profiling.span(f"t{k}.inner"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiled():
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = profiling.spans()
    assert len(got) == 2 * n_threads * n_spans
    for name, start, end, parent in got:
        assert 0 < start <= end
        if name.endswith(".inner"):
            p = got[parent]
            assert p[0] == name[:-len(".inner")]
            assert p[1] <= start <= end <= p[2]
        else:
            assert parent == -1


@pytest.mark.parametrize("second", ["profile", "device_trace"])
def test_profiler_sessions_do_not_pile_up_spans(tmp_path, second):
    """Two sessions in a row: ``spans()`` after the first hands its span
    over, so the second's reading holds its own alone; ``device_trace``
    starts a new list, also where nobody read the first session's."""
    with _profiled():
        with profiling.span("first"):
            pass
    if second == "profile":
        assert [n for n, *_ in profiling.spans()] == ["first"]
        session = profile(activities=[ProfilerActivity.CPU])
    else:
        session = device_trace(str(tmp_path), device="cpu")
    with session:
        with profiling.span("second"):
            pass
    assert [n for n, *_ in profiling.spans()] == ["second"]
    assert profiling.spans() == []


def test_a_span_open_across_a_handover_is_no_parent():
    """``spans()`` inside an open span hands it over open (end -1), and a
    span opened after it starts at the top of the new list; the handed
    over span still gets its end."""
    with _profiled():
        with profiling.span("outer"):
            got = profiling.spans()
            assert [(n, e, p) for n, _, e, p in got] == [("outer", -1, -1)]
            with profiling.span("inner"):
                pass
    (name, _, end, parent), = profiling.spans()
    assert (name, parent) == ("inner", -1) and end > 0
    assert got[0][2] >= got[0][1] > 0


FIRST = [("first_deal", None), ("first_deal.words", "first_deal"),
         ("first_deal.cards", "first_deal"), ("pack_state", None)]


def _meters_of_a_played_state():
    state = ce.run_perpetual_prng(7, cn.initial_packed_state(6, STD6, T,
                                                             "cpu"),
                                  6, 16, 5, 10, rules="standard")
    return lambda: cn.seat_meters(state, STD6)


# each call (made by a factory, so that its inputs are built before
# recording) and the spans it records: (name, the parent's name)
CALLS = {
    "initial_packed_state": (
        lambda: lambda: cn.initial_packed_state(3, STD6, T, "cpu"), FIRST),
    "seat_meters": (_meters_of_a_played_state,
                    [("meters.read", None), ("meters.stats", None)]),
    "selfplay_perpetual_kernel": (
        lambda: lambda: ce.selfplay_perpetual_kernel(4, STD6, T, 32, 16,
                                                     "cpu"),
        FIRST + [("launch.engine_prng_standard", None)] * 2
        + [("selfplay.read", None)]),
    "equity_sweep_kernel": (
        lambda: lambda: cuda_equity.equity_sweep_kernel(
            5, [[0, 13], [12, 38]], 64, "cpu"),
        [("sweep.masks", None), ("launch.sweep", None),
         ("sweep.read", None)]),
}


def _same(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if hasattr(a, "dtype"):
        return a.dtype == b.dtype and a.shape == b.shape and (a == b).all()
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("call", sorted(CALLS))
def test_wrapper_spans_nest_and_leave_outputs_bit_equal(call):
    make, expected = CALLS[call]
    fn = make()
    off = fn()
    with _profiled():
        on = fn()
    got = profiling.spans()
    assert [(n, None if p < 0 else got[p][0]) for n, _, _, p in got] == \
        expected
    for name, start, end, parent in got:
        assert start <= end
        if parent >= 0:
            assert got[parent][1] <= start <= end <= got[parent][2]
    assert _same(off, on)


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_first_state_spans(device):
    """The card's first state is one launch under one ``first_deal`` span a
    call, with no words, cards or ``pack_state`` inside; the CPU's is
    ``first_deal`` (its words and cards) and then ``pack_state``."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    ce.first_state(3, STD6, T, device)  # the card builds its library
    with _profiled():
        for _ in range(2):
            ce.first_state(3, STD6, T, device)
    spans = profiling.spans()
    got = [(n, None if p < 0 else spans[p][0]) for n, _, _, p in spans]
    assert got == 2 * (FIRST if device == "cpu" else [("first_deal", None)])
