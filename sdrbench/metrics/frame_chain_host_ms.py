"""frame_chain_host_ms (ms/chunk, device trace): host time a chunk inside
the port's ``tpu_sdr.iir.frame_chain`` span (``kernels/biquad.py``
``frame_chain``: one ``alb_step`` a frame, then the stack of the frames'
entry states)."""

from sdrbench import spans


def read(ctx):
    return spans.host_ms(ctx.trace, spans.FRAME_CHAIN) if ctx.trace is not None else None
