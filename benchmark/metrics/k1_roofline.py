"""k1_roofline: K1's least time over its summed kernel time in the
traced window. Least time: each rollout's Philox blocks (5, 2 or 1 board
words) and two hand keys (``mcbench.roofline.OPS``) at the integer peak;
its bytes (a few counters) are nothing beside that."""

from mcbench import roofline


def read(ctx):
    if ctx.summary is None:
        return None
    ops = sum(ctx.totals.get(f"rollouts_draw{d}", 0)
              * roofline.rollout_ops(d) for d in (5, 2, 1))
    return roofline.share_pct("k1_roofline", 0, ops, 0,
                              ctx.summary.kernel_s("mc_equity_kernel"))
