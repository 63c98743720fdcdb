"""hands_per_s: every hand the window's answers report, over the window's
seconds (host clock)."""


def read(ctx):
    if "hands" not in ctx.totals:
        return None
    return ctx.totals["hands"] / ctx.window_s
