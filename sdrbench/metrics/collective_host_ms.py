"""collective_host_ms (ms/chunk, device trace): host time a chunk inside the
port's ``tpu_sdr.comm.<collective>`` spans (``core/comm.py``: the call of
each collective of the sharded dispatch, on rank 0 in a multi-rank cell).
The names are spelled out here; a program without these spans reads None."""

from sdrbench import spans

COLLECTIVES = tuple(f"tpu_sdr.comm.{name}" for name in (
    "all_gather", "reduce_scatter", "all_reduce", "all_to_all", "shift", "broadcast_from_last"))


def read(ctx):
    return spans.host_ms(ctx.trace, COLLECTIVES) if ctx.trace is not None else None
