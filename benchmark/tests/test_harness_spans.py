"""The readers of the program's spans (``mcbench/program.py``,
``metrics/first_state_idle_pct.py``, ``answer_idle_pct.py``,
``first_state_ops.py``, ``host_path_idle_pct.py``) against hand-worked
values on a synthetic summary, their silence without the program's
spans, the breakdown naming program spans, the existing readers reading
the same after them, and a traced run on the CPU with and without the
recorder."""

import types

import numpy as np
import pytest

from harness_small import run_small
from mcbench import spec, trace
from montecarlo_tpu_torch.utils import profiling

# Device operations in a window of [0, 1000] ns: busy [100, 350] and
# [500, 600], so idle [0, 100], [350, 500] and [600, 1000].
OPS = [("mc_k", 100, 300), ("copy", 250, 350), ("mc_k", 500, 600)]
# The program's spans as the recorder gives them: (name, start, end,
# parent); the first starts before the window and the last is open. The
# sweep's spans share the window so that one summary serves every reader.
RECORDED = [("first_deal", -50, -10, -1),
            ("first_deal", 50, 400, -1), ("first_deal.words", 60, 200, 1),
            ("sweep.masks", 80, 120, -1),
            ("pack_state", 400, 550, -1), ("sweep.read", 600, 650, -1),
            ("meters.read", 700, 800, -1), ("meters.stats", 800, 900, -1),
            ("launch.sweep", 920, 940, -1),
            ("launch.net_league_standard", 950, 1200, -1),
            ("meters.read", 990, -1, -1)]
# Runtime calls and a driver's span, as kineto and ``Spans`` give them.
HOST = [("req.first_state", 0, 560), ("cudaMemsetAsync", 40, 45),
        ("cudaLaunchKernel", 70, 75), ("cudaStreamSynchronize", 100, 110),
        ("cudaMemcpyAsync", 420, 430), ("cudaLaunchKernel", 560, 565),
        ("req.meters", 690, 910)]


def _summary():
    return trace.Summary(1e-6, [o[0] for o in OPS],
                         np.array([o[1] for o in OPS], np.int64),
                         np.array([o[2] for o in OPS], np.int64),
                         list(HOST), 0, 1000)


def _ctx(summary, requests=2):
    return types.SimpleNamespace(summary=summary,
                                 latencies_s=[0.1] * requests)


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(RECORDED))


@pytest.mark.parametrize("metric,value", [
    # [0, 100] is half inside first_deal, [350, 500] inside first_deal
    # then pack_state: 50 + 150 ns of 1000
    ("first_state_idle_pct.league", 20.0),
    ("first_state_idle_pct.random", 20.0),
    # [700, 900] of the idle [600, 1000]
    ("answer_idle_pct.league", 20.0),
    # the launch at 70 and the copy at 420 start inside; the set at 40 and
    # the launch at 560 outside; the synchronize enqueues nothing
    ("first_state_ops.random", 1.0),
    # [80, 100], [600, 650] and [920, 940]: 20 + 50 + 20 ns of 1000
    ("host_path_idle_pct.sweep", 9.0),
])
def test_readers_on_a_synthetic_summary(recorded, metric, value):
    assert spec.reader(metric).read(_ctx(_summary())) == \
        pytest.approx(value)


@pytest.mark.parametrize("metric", ["first_state_idle_pct.league",
                                    "answer_idle_pct.random",
                                    "first_state_ops.league",
                                    "host_path_idle_pct.sweep"])
@pytest.mark.parametrize("case", ["no_recorder", "nothing_recorded",
                                  "no_device_ops", "untraced"])
def test_readers_return_none(monkeypatch, metric, case):
    summary = _summary()
    if case == "no_recorder":
        monkeypatch.delattr(profiling, "spans")
    elif case == "nothing_recorded":
        monkeypatch.setattr(profiling, "spans", lambda: [])
    else:
        monkeypatch.setattr(profiling, "spans", lambda: list(RECORDED))
        if case == "no_device_ops":
            summary = trace.Summary(1e-6, [], np.zeros(0, np.int64),
                                    np.zeros(0, np.int64), list(HOST), 0,
                                    1000)
        else:
            summary = None
    assert spec.reader(metric).read(_ctx(summary)) is None


def test_idle_gaps_name_program_spans(recorded):
    s = _summary()
    before = dict(s.idle_gaps())
    assert set(before) == {"req.first_state", "cudaMemcpyAsync",
                           "req.meters"}
    spec.reader("answer_idle_pct.league").read(_ctx(s))
    spec.reader("first_state_ops.league").read(_ctx(s))
    after = dict(s.idle_gaps())
    # [0, 100] is named by the innermost span at its middle, first_deal;
    # [600, 1000] by meters.stats, opened at its middle; the copy keeps
    # [350, 500]; the spans went to the host events once
    assert after == pytest.approx({"first_deal": 100e-9,
                                   "cudaMemcpyAsync": 150e-9,
                                   "meters.stats": 400e-9})
    assert [n for n, _, _ in s.program] == [
        "first_deal", "first_deal.words", "sweep.masks", "pack_state",
        "sweep.read", "meters.read", "meters.stats", "launch.sweep",
        "launch.net_league_standard"]
    assert s.program[-1][1:] == (950, 1000)
    assert len(s.host) == len(HOST) + len(s.program)


@pytest.mark.parametrize("existing", ["device_idle_pct.sweep",
                                      "wrapper_device_pct.league"])
@pytest.mark.parametrize("span_reader", ["first_state_idle_pct.league",
                                         "answer_idle_pct.league",
                                         "first_state_ops.random",
                                         "host_path_idle_pct.sweep"])
def test_existing_readers_read_the_same_after_a_span_reader(
        recorded, existing, span_reader):
    """A span reader appends the program's spans to the summary's host
    events; a reader that was there reads the same after it as alone."""
    alone = _ctx(_summary())
    alone.main_kernel = "mc_k"
    value = spec.reader(existing).read(alone)
    after = _ctx(_summary())
    after.main_kernel = "mc_k"
    spec.reader(span_reader).read(after)
    assert after.summary.program
    assert spec.reader(existing).read(after) == value


def test_traced_cpu_run_records_the_window_alone():
    """On the CPU the profiler runs with CPU activity: the program records
    its spans in the window alone (the warm-up is not traced), and the
    readers, finding no device operation, report nothing."""
    profiling.spans()   # hand over what earlier tests left
    result, _ = run_small("std6_selfplay_random", trace=1)
    names = [n for n, _, _, _ in profiling.spans()]
    assert {"first_deal", "first_deal.words", "first_deal.cards",
            "pack_state", "launch.engine_prng_standard",
            "selfplay.read"} <= set(names)
    assert names.count("first_deal") == result["attempted"]
    assert not profiling.is_recording()
    assert not {"first_state_idle_pct.random", "answer_idle_pct.random",
                "first_state_ops.random"} & set(result["metrics"])
    assert profiling.spans() == []


def test_traced_line_without_the_recorder(monkeypatch):
    """A program older than the recorder (no ``spans``) gives the line's
    existing shape, the span metrics absent."""
    monkeypatch.delattr(profiling, "spans")
    result, _ = run_small("std6_selfplay_random", trace=1)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert result["correct"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert not any(m.startswith(("first_state", "answer_idle"))
                   for m in result["metrics"])
