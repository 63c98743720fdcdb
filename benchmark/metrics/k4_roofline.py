"""k4_roofline: K4's least time over its summed kernel time in the
traced window. Least time: the larger of its bytes (each launch reads and
writes every table's packed state once) at the memory rate and its
operations (a betting step and P hand keys a completed hand, every
table's Philox blocks for two words a slot and the deals) at the integer
peak."""

from mcbench import roofline
from mcref import table


def read(ctx):
    if ctx.summary is None or "hands" not in ctx.totals:
        return None
    c = ctx.config
    P = c["seats"]
    launches = roofline.launches_of(ctx.traffic)
    n_bytes = 2 * ctx.totals["tables"] * table.layout(P, c["rules"])[1] \
        * 4 * len(launches)
    ops, _ = roofline.engine_ops(ctx.totals["hands"], ctx.totals["tables"],
                                 launches, P, 2)
    return roofline.share_pct("k4_roofline", n_bytes, ops, 0,
                              ctx.summary.kernel_s("mc_engine_prng_kernel"))
