"""idle_share_in_dispatch (%, device trace): the share of the traced window
that is a device idle gap overlapping the port's ``tpu_sdr.dispatch`` span
(``runtime/stream.py``), by exact overlap. ``idle_share`` less this is the
idle time of the harness's own loop. Split by what it moves: ``.sat``
(``msps``), ``.dev`` (``msps.dev``)."""

from sdrbench import spans


def read(ctx):
    return spans.idle_share_in(ctx.trace, spans.DISPATCH) if ctx.trace is not None else None
