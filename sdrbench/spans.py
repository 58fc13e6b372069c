"""The port's profiler spans in a traced stretch.

While a profiler runs, the port opens ``tpu_sdr.*`` ranges (its
``core/spans.py``). Kineto records them as host ``user_annotation`` events
on the clock of the device's activity, so ``trace.TraceView.host_events``
holds them beside the chunk ranges, the runtime calls and the idle gaps.
The names are spelled out here, not imported: the harness imports nothing
of the program to read it, and a span the program renames reads None.

A span counts for a chunk when it starts inside that chunk's range. A
device op is tied to the call that launched it by its correlation id, so an
op on another stream (NCCL's, in a multi-rank run) pairs as well as one on
the current stream. A chunk in which a launching call (``LAUNCHES``) has no
op, because the profiler lost it, is left out of the op readers rather than
read short; the other chunks still read.
"""

from __future__ import annotations

from sdrbench import trace as tracing

DISPATCH = ("tpu_sdr.dispatch",)
FRAME_CHAIN = ("tpu_sdr.iir.frame_chain",)
IIR = ("tpu_sdr.iir.products", "tpu_sdr.iir.frame_chain", "tpu_sdr.iir.emit")
# CUDA API calls (the `cuda*` and `cu*` names) that each put one op on the device.
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")


def _merged(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def by_chunk(view, keep) -> list[list[tuple[float, float]]]:
    """Per chunk, the (start, end) of each host event whose name ``keep``
    accepts and that starts inside the chunk's range."""
    ranges = sorted((a, b) for a, b, name in view.host_events if name == tracing.CHUNK_RANGE)
    out: list[list] = [[] for _ in ranges]
    for a, b, name in view.host_events:
        if keep(name):
            for i, (lo, hi) in enumerate(ranges):
                if lo <= a <= hi:
                    out[i].append((a, b))
                    break
    return out


def _spans(view, names):
    """Per chunk, the spans of ``names``; None when the stretch has none."""
    spans = by_chunk(view, lambda name: name in names)
    return spans if any(spans) else None


def host_ms(view, names) -> float | None:
    """Host ms a chunk inside the spans of ``names``."""
    spans = _spans(view, names)
    if spans is None:
        return None
    return sum(b - a for chunk in spans for a, b in chunk) / 1e3 / len(spans)


def launched(view) -> list[list[tuple[float, tuple]] | None]:
    """Per chunk, (start of the launching call, op) for each of its device
    ops, in the order of the calls; None for a chunk in which a launching
    call has no op."""
    pairs = []
    for ops, corrs, calls in zip(view.chunks, view.correlations, view.launches):
        seen = set(corrs)
        if any(name.startswith(LAUNCHES) and c not in seen for c, (_, name) in calls.items()):
            pairs.append(None)
            continue
        pairs.append(sorted((calls[c][0], op) for c, op in zip(corrs, ops)))
    return pairs


def ops_in(view, names) -> list[list[tuple]] | None:
    """Per chunk whose every launching call has its op, the device ops whose
    launching call lies inside a span of ``names``; None when the stretch
    has no such span or no such chunk."""
    spans = _spans(view, names)
    if spans is None:
        return None
    ops = [[op for at, op in chunk if any(a <= at <= b for a, b in inside)]
           for chunk, inside in zip(launched(view), spans) if chunk is not None]
    return ops or None


def idle_share_in(view, names) -> float | None:
    """% of the traced window that is a device idle gap overlapping a span
    of ``names``, by the exact length of each overlap."""
    spans = _spans(view, names)
    if spans is None:
        return None
    spans = _merged(ab for chunk in spans for ab in chunk)
    overlap = sum(max(0.0, min(b, d) - max(a, c)) for a, b in view.gaps for c, d in spans)
    return 100.0 * overlap / (view.window[1] - view.window[0])
