"""request_p95_ms: the 95th percentile (numpy's, linear between ranks) of
every request's latency in the window, each from the call until its
answer is on the host (host clock)."""

import numpy as np


def read(ctx):
    if not ctx.latencies_s:
        return None
    return float(np.percentile(ctx.latencies_s, 95)) * 1e3
