"""A short profiler window, and the reduction of its Chrome trace.

``parse`` is a frozen copy of the port's ``bench/trace.parse_trace``
attribution: a kernel, memcpy or memset carries the correlation id of the
runtime (or driver) call that enqueued it, and that call lies inside one
chunk's annotated host range, so each device op is charged to the chunk that
launched it, even where it runs after the range has closed. Beside it: the
traced window (the first chunk's range start to the later of the last
range's end and the last charged op's end), the union of device ops in it,
its idle gaps labelled by the innermost host event running at each, and the
per-chunk sums that the metric readers take.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import tempfile

CHUNK_RANGE = "sdrbench chunk"
WAIT_RANGE = "sdrbench wait for due time"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
NAME_CHARS = 110
TOP = 10


def union_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    gaps, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            gaps.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(a, b) for a, b in gaps if b > a]


class TraceView:
    """The ops of each traced chunk and the traced window, in microseconds.
    ``correlations[i][j]`` is the correlation id of chunk i's op j, and
    ``launches[i]`` maps the correlation id of every runtime or driver call
    that started in chunk i's range to its (start, name): an op's launching
    call is ``launches[i][correlations[i][j]]``, on whatever stream the op
    ran."""

    def __init__(self, chunks, window, busy_us, gaps, host_events, unattributed, correlations,
                 launches):
        self.chunks = chunks  # per chunk: [(ts, te, name, cat)]
        self.window = window  # (start, end)
        self.busy_us = busy_us
        self.gaps = gaps
        self.host_events = host_events  # [(ts, te, name)]
        self.unattributed = unattributed
        self.correlations = correlations  # per chunk: [correlation id], beside chunks
        self.launches = launches  # per chunk: {correlation id: (ts, name)}

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return self.busy_us / 1e6

    def ops_per_chunk(self) -> float | None:
        if not self.chunks:
            return None
        return sum(len(ops) for ops in self.chunks) / self.n_chunks

    def ms_per_chunk(self, keep) -> float | None:
        """Device ms a chunk of the ops ``keep(name, cat)`` accepts; None
        when no traced op is accepted."""
        hits = [te - ts for ops in self.chunks for ts, te, name, cat in ops if keep(name, cat)]
        if not hits:
            return None
        return sum(hits) / 1e3 / self.n_chunks

    def breakdown(self) -> dict:
        """The device ops that took most time over the traced chunks, and the
        idle gaps summed by the innermost host event running at each."""
        ops = collections.Counter()
        for chunk in self.chunks:
            for ts, te, name, _ in chunk:
                ops[name] += (te - ts) / 1e6
        idle = collections.Counter()
        for a, b in self.gaps:
            mid = (a + b) / 2
            inner = [(te - ts, name) for ts, te, name in self.host_events if ts <= mid <= te]
            idle[min(inner)[1] if inner else "no host event"] += (b - a) / 1e6
        return {"device_ops": [[n, s] for n, s in ops.most_common(TOP)],
                "idle_gaps": [[n, s] for n, s in idle.most_common(TOP)]}


def parse(path: str, chunk_range: str = CHUNK_RANGE) -> TraceView | None:
    """A Chrome trace of ``torch.profiler`` -> its ``TraceView``; None when it
    holds no device op or no chunk range (a CPU run traces the host only)."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = [e for e in spans if e.get("cat") in DEVICE_CATEGORIES]
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in spans
                    if e.get("cat") == "user_annotation" and e.get("name") == chunk_range)
    if not device or not ranges:
        return None

    def chunk_of(ts: float) -> int | None:
        for i, (a, b) in enumerate(ranges):
            if a <= ts <= b:
                return i
        return None

    launch_chunk = {}
    launches: list[dict] = [{} for _ in ranges]
    for e in spans:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in LAUNCH_CATEGORIES and corr is not None:
            i = launch_chunk[corr] = chunk_of(float(e["ts"]))
            if i is not None:
                launches[i][corr] = (float(e["ts"]), e["name"])
    chunks: list[list] = [[] for _ in ranges]
    correlations: list[list] = [[] for _ in ranges]
    unattributed = 0
    for e in device:
        corr = e.get("args", {}).get("correlation")
        i = launch_chunk.get(corr)
        if i is None:
            unattributed += 1
            continue
        ts = float(e["ts"])
        chunks[i].append((ts, ts + float(e["dur"]), e["name"][:NAME_CHARS], e["cat"]))
        correlations[i].append(corr)
    lo = ranges[0][0]
    hi = max([ranges[-1][1]] + [te for ops in chunks for _, te, _, _ in ops])
    intervals = [(max(float(e["ts"]), lo), min(float(e["ts"]) + float(e["dur"]), hi))
                 for e in device]
    intervals = [(a, b) for a, b in intervals if b > a]
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][:NAME_CHARS])
            for e in spans if e.get("cat") in HOST_CATEGORIES]
    return TraceView(chunks, (lo, hi), union_us(intervals), _gaps(intervals, lo, hi), host,
                     unattributed, correlations, launches)


def capture(warm, stretch) -> TraceView | None:
    """Profile ``stretch()`` on the card after ``warm()`` has run under the
    profiler unrecorded (traced from its first step, the profiler loses
    kernels). The trace goes to a directory under TMPDIR, removed after
    parsing."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    tmp = tempfile.mkdtemp(prefix="sdrbench_trace_")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for step in (warm, stretch):
                step()
                torch.cuda.synchronize()
                prof.step()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return parse(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
