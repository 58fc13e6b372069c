"""idle_share_in_frame_chain (%, device trace): the share of the traced
window that is a device idle gap overlapping the port's
``tpu_sdr.iir.frame_chain`` span (``kernels/biquad.py``), by exact
overlap."""

from sdrbench import spans


def read(ctx):
    return spans.idle_share_in(ctx.trace, spans.FRAME_CHAIN) if ctx.trace is not None else None
