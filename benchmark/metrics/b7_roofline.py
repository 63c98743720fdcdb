"""b7_roofline: B7's least time over its summed kernel time in the
traced window. Least time: the larger of its bytes (each launch reads and
writes every table's state and reads the banks' weights) at the memory
rate and its operations at the peaks: integer (a betting step and P hand
keys a hand, every table's Philox blocks for six words a slot and the
deals, the features of every net decision) and float32 (the MLP of every
net decision). No answer reports the decisions: their count is the plain
reference's decisions a hand over the tables it replayed, times the
window's hands."""

from mcbench import roofline
from mcref import table


def read(ctx):
    if ctx.summary is None or "decisions_per_hand" not in ctx.totals:
        return None
    c, t = ctx.config, ctx.totals
    P = c["seats"]
    launches = roofline.launches_of(ctx.traffic)
    n_launch = len(ctx.latencies_s) * len(launches)
    n_bytes = (2 * t["tables"] * table.layout(P, c["rules"])[1] * 4
               * len(launches)
               + n_launch * len(ctx.traffic["banks"]) * 6020 * 4)
    decisions = t["decisions_per_hand"] * t["hands"]
    ops, f32 = roofline.engine_ops(t["hands"], t["tables"], launches, P, 6,
                                   decisions)
    return roofline.share_pct("b7_roofline", n_bytes, ops, f32,
                              ctx.summary.kernel_s("mc_net_eval_kernel"))
