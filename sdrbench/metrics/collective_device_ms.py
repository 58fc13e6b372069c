"""collective_device_ms (ms/chunk, device trace): device time a chunk of the
ops whose launching call lies inside the port's ``tpu_sdr.comm.<collective>``
spans (``core/comm.py``), tied to them by correlation id: NCCL's kernels on
its own stream, on rank 0 in a multi-rank cell."""

from sdrbench import spans
from sdrbench.metrics.collective_host_ms import COLLECTIVES


def read(ctx):
    if ctx.trace is None:
        return None
    ops = spans.ops_in(ctx.trace, COLLECTIVES)
    if ops is None:
        return None
    return sum(te - ts for chunk in ops for ts, te, _, _ in chunk) / 1e3 / len(ops)
