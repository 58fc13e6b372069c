"""Profiler spans of the port.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler runs (an operator's ``torch.profiler.profile``, the CLI's
``trace``, a traced benchmark run), so Kineto records it on the same clock
as the device's activity. Otherwise it is one shared null context, and
the call costs a module attribute read. Spans have no switch and no clock
of their own: they are on exactly when a profiler is.

The names in use: ``tpu_sdr.dispatch`` (``runtime/stream.py``, and the
sharded dispatch of ``shard/pipeline.py``), ``tpu_sdr.shard.state``
(``shard/pipeline.py``: the state's channel rows cut for this rank, and
all-gathered again), ``tpu_sdr.iir.products``, ``tpu_sdr.iir.frame_chain``
and ``tpu_sdr.iir.emit`` (``kernels/biquad.py``),
``tpu_sdr.launch.<kernel>`` (``kernels/cuda/launch.py``),
``tpu_sdr.comm.<collective>`` (``core/comm.py``), and
``tpu_sdr.feeder.stage`` (on the feeder's producer thread: one chunk's read
and copy launch) and ``tpu_sdr.feeder.get`` (the consumer's ``get()``,
any wait included) (``runtime/feeder.py``).

A profiler records the ranges of the thread that started it; the feeder's
producer thread's ranges appear only under a profiler that records every
thread (``torch.profiler._ExperimentalConfig(profile_all_threads=True)``).
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
