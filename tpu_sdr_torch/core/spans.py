"""Profiler spans of the port.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler runs (an operator's ``torch.profiler.profile``, the CLI's
``trace``, a traced benchmark run), so Kineto records it on the same clock
as the device's activity. Otherwise it is one shared null context, and
the call costs a module attribute read. Spans have no switch and no clock
of their own: they are on exactly when a profiler is.

The names in use: ``tpu_sdr.dispatch`` (``runtime/stream.py``),
``tpu_sdr.iir.products``, ``tpu_sdr.iir.frame_chain`` and
``tpu_sdr.iir.emit`` (``kernels/biquad.py``), and
``tpu_sdr.launch.<kernel>`` (``kernels/cuda/launch.py``).
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler runs, else a shared
    null context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
