"""frame_chain_ops_per_chunk (ops/chunk, device trace): device ops a chunk
whose launching runtime call lies inside the port's
``tpu_sdr.iir.frame_chain`` span (``kernels/biquad.py`` ``frame_chain``)."""

from sdrbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    ops = spans.ops_in(ctx.trace, spans.FRAME_CHAIN)
    return None if ops is None else sum(map(len, ops)) / len(ops)
