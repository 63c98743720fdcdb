"""device_idle_pct: the share of the traced window in which the card runs
no kernel, copy or set (100 less the union of their intervals)."""


def read(ctx):
    s = ctx.summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.union_s() / s.window_s)
