"""latency_p95_ms (ms, host clock): the 95th percentile, over every chunk of
an open-loop window, of the time from the chunk's due time to its
magnitudes in the caller's hands."""

import numpy as np


def read(ctx):
    w = ctx.window
    return float(np.percentile(w.latencies_s, 95)) * 1e3 if w.kind == "open" else None
