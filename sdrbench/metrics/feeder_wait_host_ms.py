"""feeder_wait_host_ms (ms/chunk, device trace): the consumer's host time a
chunk inside the port's ``tpu_sdr.feeder.get`` span (``runtime/feeder.py``):
taking the next staged chunk, any wait for one included, and making the
consumer's stream wait on its copy. The name is spelled out here; a program
without the span reads None."""

from sdrbench import spans

GET = ("tpu_sdr.feeder.get",)


def read(ctx):
    return spans.host_ms(ctx.trace, GET) if ctx.trace is not None else None
