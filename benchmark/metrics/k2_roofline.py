"""k2_roofline: K2's least time over its summed kernel time in the
traced window. Least time: each rollout's two Philox blocks (seven words:
the villain's holes and the board) and two hand keys at the integer
peak."""

from mcbench import roofline


def read(ctx):
    if ctx.summary is None or "rollouts" not in ctx.totals:
        return None
    ops = ctx.totals["rollouts"] * roofline.rollout_ops(7)
    return roofline.share_pct("k2_roofline", 0, ops, 0,
                              ctx.summary.kernel_s("mc_sweep_kernel"))
