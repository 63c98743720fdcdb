"""wrapper_device_pct: the share of the traced window in which the card
runs anything other than the cell's main kernel: the wrappers' first
deal, packing, state copies, weights upload, reductions and reads."""


def read(ctx):
    s = ctx.summary
    if s is None or s.window_s <= 0 or not len(s.names):
        return None
    return 100.0 * s.union_s(~s.matching(ctx.main_kernel)) / s.window_s
