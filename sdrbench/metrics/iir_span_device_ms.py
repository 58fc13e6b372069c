"""iir_span_device_ms (ms/chunk, device trace): device time a chunk of the
ops launched inside the port's three IIR spans (``kernels/biquad.py``:
``tpu_sdr.iir.products``, ``tpu_sdr.iir.frame_chain``,
``tpu_sdr.iir.emit``), the IIR measured where it launches its work: no
window multiply, entry-state fill or counter update, which
``iir_device_ms`` counts."""

from sdrbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    ops = spans.ops_in(ctx.trace, spans.IIR)
    if ops is None:
        return None
    return sum(te - ts for chunk in ops for ts, te, _, _ in chunk) / 1e3 / len(ops)
