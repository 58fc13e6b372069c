"""The profiler spans of the sharded dispatch and of the collectives on a
(channel 2, time 2) mesh of every rank of the group, run by
``tests/test_torch_spans.py``. Each case returns every rank's readings to
rank 0. Imports ``tpu_sdr_torch``, numpy and scipy only."""

from __future__ import annotations

import numpy as np
import scipy.signal as sps
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from tpu_sdr_torch import FilterMode, PipelineConfig
from tpu_sdr_torch.core import comm
from tpu_sdr_torch.shard.mesh import make_sdr_mesh
from tpu_sdr_torch.shard.pipeline import ShardedSpectrumPipeline

N = 16384
C = 4
DISPATCHES = 2


def ranges(prof, prefix="tpu_sdr."):
    """(name, start, end) of each profiled range whose name starts with
    ``prefix``, in order of start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith(prefix)), key=lambda r: r[1])


def every_rank(reading):
    """Every rank's ``reading``, in rank order, on every rank."""
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, reading)
    return got


def bank():
    return [sps.butter(6, 0.1 * (c + 1), output="sos") for c in range(C)]


def custom_dispatch():
    """``DISPATCHES`` CUSTOM dispatches of a 4-channel bank, two frames a
    chunk (one a time shard), profiled after one warm-up; the ranges and
    the collectives counted in them."""
    mesh = make_sdr_mesh(2, 2, devices="cpu")
    pipe = ShardedSpectrumPipeline(PipelineConfig(channels=C), mesh)
    pipe.upload_sos_bank(bank())
    x = np.random.default_rng(5).standard_normal((C, 2 * N)).astype(np.float32)
    _, st = pipe.process(x, pipe.initial_state(), FilterMode.CUSTOM)
    before = dict(mesh.stats)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(DISPATCHES):
            _, st = pipe.process(x, st, FilterMode.CUSTOM)
    return every_rank({"ranges": ranges(prof), "calls": mesh.stats["calls"] - before["calls"]})


def _collectives(mesh):
    """(name, call) for each helper of ``core/comm.py`` on the time axis."""
    x = torch.arange(8.0).reshape(2, 4) + dist.get_rank()
    ax = mesh.time
    return [
        ("all_gather", lambda: comm.all_gather(x, ax, 0)),
        ("reduce_scatter", lambda: comm.reduce_scatter(x, ax, 0)),
        ("all_reduce", lambda: comm.all_reduce(x, ax)),
        ("all_to_all", lambda: comm.all_to_all(x, ax, 1, 0)),
        ("shift", lambda: comm.shift(x, ax, 1)),
        ("broadcast_from_last", lambda: comm.broadcast_from_last(x, ax)),
    ]


def each_collective():
    """Each collective once under the profiler, then each once with no
    profiler and ``torch.profiler.record_function`` made to raise: the
    ranges and ``calls`` of each, and whether the unprofiled
    calls made a range."""
    mesh = make_sdr_mesh(2, 2, devices="cpu")
    readings = []
    for name, call in _collectives(mesh):
        before = dict(mesh.stats)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            call()
        readings.append({"name": name, "ranges": [r[0] for r in ranges(prof)],
                         "calls": mesh.stats["calls"] - before["calls"]})

    def refuse(*args, **kwargs):
        raise AssertionError("a record_function was made with no profiler on")

    made, before = None, mesh.stats["calls"]
    original, torch.profiler.record_function = torch.profiler.record_function, refuse
    try:
        for _, call in _collectives(mesh):
            call()
    except AssertionError as e:
        made = str(e)
    finally:
        torch.profiler.record_function = original
    return every_rank({"collectives": readings, "unprofiled_range": made,
                       "unprofiled_calls": mesh.stats["calls"] - before})


CASES = [custom_dispatch, each_collective]
