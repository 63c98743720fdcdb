"""The roofline arithmetic against the repo's hand-worked bounds, and the
trace summary's interval arithmetic."""

import types

import numpy as np
import pytest

from mcbench import roofline, spec, trace


def test_k1_preflop_bound():
    # 2^30 preflop rollouts: 7.692 ms by operations, K1 22.674 ms
    least, by = roofline.least_seconds(0, (1 << 30) * roofline.rollout_ops(5))
    assert by == "operations"
    assert least * 1e3 == pytest.approx(7.692, abs=5e-4)
    assert 100 * least / 22.674e-3 == pytest.approx(33.92, abs=0.01)


def test_k2_sweep_bound():
    least, by = roofline.least_seconds(
        0, 169 * 10**7 * roofline.rollout_ops(7))
    assert by == "operations"
    assert least * 1e3 == pytest.approx(12.107, abs=5e-4)
    assert 100 * least / 35.320e-3 == pytest.approx(34.28, abs=0.01)


def test_k4_standard_bound():
    # 2^20 tables x 512 slots, standard rules: 0.075265 ns a table-step
    # at 7.42135e8 hands/s -> 2.9977e7 hands; bound 1.148 ms
    hands = round(7.42135e8 * 0.075265e-9 * (1 << 20) * 512)
    ops, f32 = roofline.engine_ops(hands, 1 << 20, [512], 6, 2)
    assert f32 == 0
    state_bytes = 2 * (1 << 20) * 160 * 4
    least, by = roofline.least_seconds(state_bytes, ops)
    assert by == "operations"
    assert least * 1e3 == pytest.approx(1.148, abs=1e-3)


def test_engine_words():
    assert roofline.engine_launch_words(6, 512, 2) == 32 * 49
    assert roofline.engine_launch_words(6, 256, 6) == 16 * 113
    assert roofline.engine_launch_words(6, 10, 2) == 10 * 19
    assert roofline.launches_of({"slots": 512, "slots_per_launch": 256}) \
        == [256, 256]


def test_share_none_without_kernel_time():
    assert roofline.share_pct("x", 0, 1e9, 0, 0.0) is None


def _summary(ops, host=(), t0=0, t1=100):
    names = [o[0] for o in ops]
    return trace.Summary((t1 - t0) * 1e-9, names,
                         np.array([o[1] for o in ops], np.int64),
                         np.array([o[2] for o in ops], np.int64),
                         list(host), t0, t1)


def test_summary_intervals():
    s = _summary([("mc_k", 10, 30), ("copy", 20, 40), ("mc_k", 60, 70)],
                 host=[("req.a", 0, 100), ("aten::x", 42, 58)])
    assert s.union_s() == pytest.approx(40e-9)
    assert s.kernel_s("mc_k") == pytest.approx(30e-9)
    assert s.union_s(~s.matching("mc_k")) == pytest.approx(20e-9)
    gaps = dict(s.idle_gaps())
    # [0,10) and [70,100) under req.a, [40,60) under aten::x
    assert gaps["req.a"] == pytest.approx(40e-9)
    assert gaps["aten::x"] == pytest.approx(20e-9)
    assert s.top_ops()[0][0] == "mc_k"


def test_device_readers():
    s = _summary([("mc_k", 10, 30), ("copy", 20, 40)])
    ctx = types.SimpleNamespace(summary=s, main_kernel="mc_k")
    assert spec.reader("device_idle_pct.random").read(ctx) == \
        pytest.approx(70.0)
    assert spec.reader("wrapper_device_pct.random").read(ctx) == \
        pytest.approx(20.0)
    ctx.summary = None
    assert spec.reader("device_idle_pct.sweep").read(ctx) is None


def test_k1_reader():
    s = _summary([("void mc_equity_kernel<5, false>", 0, 22_674_000)],
                 t1=30_000_000)
    ctx = types.SimpleNamespace(summary=s, totals={"rollouts_draw5": 1 << 30})
    assert spec.reader("k1_roofline").read(ctx) == pytest.approx(33.92,
                                                                 abs=0.01)
