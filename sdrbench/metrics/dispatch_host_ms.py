"""dispatch_host_ms (ms/chunk, device trace): host time a chunk inside the
port's ``tpu_sdr.dispatch`` span, the whole of a ``SpectrumPipeline.process``
or ``process_planes`` call (``runtime/stream.py``): conversion, checks,
choosing the form, every launch and the new state. Split by what it moves:
``.sat`` (``msps``), ``.dev`` (``msps.dev``)."""

from sdrbench import spans


def read(ctx):
    return spans.host_ms(ctx.trace, spans.DISPATCH) if ctx.trace is not None else None
