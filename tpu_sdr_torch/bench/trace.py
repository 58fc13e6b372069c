"""Device-trace capture and op-level attribution from ``torch.profiler``.

The counterpart of ``tpu_sdr.bench.trace``: ``capture_op_table(step)`` runs
a warmed callable a few times under the profiler and returns, for one
steady-state call: its span, the device's idle time inside it and the
device ops ranked by total time. ``parse_trace`` reads the Chrome trace that
``torch.profiler.profile.export_chrome_trace`` writes; it is plain Python,
so it runs (and is tested) without a card.

Each device op is charged to the step that launched it: a kernel, memcpy or
memset carries the correlation id of the runtime (or driver) call that
enqueued it, and that call lies inside the step's annotated host range. A
kernel that starts after its step's host range has ended is still that
step's, and a step of one kernel counts one.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import tempfile

# The annotated host range each profiled call runs in.
STEP_RANGE = "tpu_sdr_torch step"
# Chrome-trace categories of work on the device, and of the host calls that
# enqueue it.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
# Op names are kept to their first 110 characters (a kernel's signature
# follows its name), as in the reference's table.
NAME_CHARS = 110


def _union_us(intervals: list[tuple[float, float]]) -> float:
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


def parse_trace(path: str, step_name: str = STEP_RANGE) -> dict:
    """A Chrome trace of ``torch.profiler`` -> the op attribution of its
    last ``step_name`` range.

    Returns {"device_trace": False, "reason": ...} when the trace holds no
    device op or no step range (a CPU run traces the host only). Otherwise
    the reference's keys for the last step (``dispatch_ms`` is the step's
    span, from its host range's start to the later of that range's end and
    its last device op's end; ``device_idle_ms`` is that span less the
    union of its device ops, so overlapping ops never make it negative)
    and: ``device_busy_ms`` (the union), ``op_counts`` (the last step's ops
    by name), ``ops_all_steps`` ({name: [ms, count]} over every step) and
    ``unattributed`` (device ops whose launch lies in no step). Op names
    are cut to ``NAME_CHARS``."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = [e for e in spans if e.get("cat") in DEVICE_CATEGORIES]
    if not device:
        return {"device_trace": False, "reason": "no CUDA kernel, memcpy or memset events"}
    steps = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in spans if e.get("cat") == "user_annotation"
                   and e.get("name") == step_name)
    if not steps:
        return {"device_trace": False, "reason": f"no {step_name!r} range in the trace"}

    def step_of(ts: float) -> int | None:
        for i, (a, b) in enumerate(steps):
            if a <= ts <= b:
                return i
        return None

    launch_step = {}
    for e in spans:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in LAUNCH_CATEGORIES and corr is not None:
            launch_step[corr] = step_of(float(e["ts"]))
    per_step: list[list[tuple[float, float, str]]] = [[] for _ in steps]
    unattributed = 0
    for e in device:
        i = launch_step.get(e.get("args", {}).get("correlation"))
        if i is None:
            unattributed += 1
            continue
        ts = float(e["ts"])
        per_step[i].append((ts, ts + float(e["dur"]), e["name"][:NAME_CHARS]))
    ops_all: dict[str, list] = {}
    for ops in per_step:
        for a, b, name in ops:
            acc = ops_all.setdefault(name, [0.0, 0])
            acc[0] += (b - a) / 1e3
            acc[1] += 1
    (s0, s1), last = steps[-1], per_step[-1]
    end = max([s1] + [b for _, b, _ in last])
    busy_us = _union_us([(a, b) for a, b, _ in last])
    tot: collections.Counter = collections.Counter()
    for a, b, name in last:
        tot[name] += b - a
    return {
        "device_trace": True,
        "module": step_name,
        "executions": len(steps),
        "dispatch_ms": (end - s0) / 1e3,
        "n_ops": len(last),
        "op_sum_ms": sum(b - a for a, b, _ in last) / 1e3,
        "device_idle_ms": (end - s0 - busy_us) / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "top_ops_ms": [[n, round(d / 1e3, 4)] for n, d in tot.most_common(30)],
        "op_counts": dict(collections.Counter(name for _, _, name in last)),
        "ops_all_steps": ops_all,
        "unattributed": unattributed,
    }


def capture_op_table(step, reps: int = 10, logdir: str | None = None) -> dict:
    """Profile ``step()`` (already warmed; each call should dispatch the
    work under study on a carried state) and return the op attribution of
    its last call (``parse_trace``).

    One more call runs first under the profiler as its warm-up, and is not
    recorded: traced from its first step, the profiler lost kernels. Then
    ``reps`` calls run, each in its own ``STEP_RANGE`` range and followed by
    a synchronize. ``logdir``: a directory to keep the trace in (a fresh
    subdirectory of it; its contents are never touched); by default a
    temporary one, removed after parsing."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix="capture_", dir=logdir)
    else:
        tmp = tempfile.mkdtemp(prefix="tpu_sdr_torch_trace_")
    try:
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=reps, repeat=1)) as prof:
            for _ in range(1 + reps):
                with record_function(STEP_RANGE):
                    step()
                if cuda:
                    torch.cuda.synchronize()
                prof.step()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return parse_trace(path)
    finally:
        if logdir is None:
            shutil.rmtree(tmp, ignore_errors=True)
