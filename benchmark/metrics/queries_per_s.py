"""queries_per_s: every query the window's answers hold, over the window's
seconds (host clock)."""


def read(ctx):
    if "queries" not in ctx.totals:
        return None
    return ctx.totals["queries"] / ctx.window_s
