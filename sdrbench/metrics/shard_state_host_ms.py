"""shard_state_host_ms (ms/chunk, device trace): host time a chunk inside
the port's ``tpu_sdr.shard.state`` spans (``shard/pipeline.py``: this
rank's channel rows of the global state cut and moved before the dispatch's
body, and the new state's rows all-gathered after it), on rank 0 in a
multi-rank cell."""

from sdrbench import spans

STATE = ("tpu_sdr.shard.state",)


def read(ctx):
    return spans.host_ms(ctx.trace, STATE) if ctx.trace is not None else None
