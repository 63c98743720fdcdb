"""rollouts_per_s: every rollout of the window's answers, over the window's
seconds (host clock)."""


def read(ctx):
    if "rollouts" not in ctx.totals:
        return None
    return ctx.totals["rollouts"] / ctx.window_s
