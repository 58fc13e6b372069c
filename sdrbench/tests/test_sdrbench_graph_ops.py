"""The reader of the ops that CUDA graph launches put on the device
(``metrics/graph_ops_per_chunk.py``): on a synthetic trace of a dispatch
that replays its IIR from three graph launches, and on the recorded
fixtures, which hold no graph launch."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from sdrbench import spec
from sdrbench import trace as tracing

FIXTURES = Path(__file__).parent / "fixtures"


def _read(name, view):
    return spec.load_module("metrics", name).read(SimpleNamespace(window=None, trace=view, cell=None))


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _replayed(chunks=2, graph_call="cudaGraphLaunch"):
    """Chunks of 100 us: a dispatch (5-90) with a window multiply launched
    at 8, the products' graph launch at 12 (4 ops), the frame chain's at 40
    (2 ops), the emit's at 65 (3 ops), each in its span, then the spectrum
    kernel launched at 80. Ops run 3 us, from 50 on."""
    events, corr = [], 0
    for k in range(chunks):
        t0 = 1000.0 * k
        events += [_x("user_annotation", tracing.CHUNK_RANGE, t0, 100.0),
                   _x("user_annotation", "tpu_sdr.dispatch", t0 + 5, 85.0),
                   _x("user_annotation", "tpu_sdr.iir.products", t0 + 10, 20.0),
                   _x("user_annotation", "tpu_sdr.iir.frame_chain", t0 + 35, 25.0),
                   _x("user_annotation", "tpu_sdr.iir.emit", t0 + 62, 8.0)]
        at_op = t0 + 50
        for at, call, ops in ((8, "cudaLaunchKernel", 1), (12, graph_call, 4), (40, graph_call, 2),
                              (65, graph_call, 3), (80, "cuLaunchKernel", 1)):
            corr += 1
            events.append(_x("cuda_runtime", call, t0 + at, 1.0, corr))
            for i in range(ops):
                events.append(_x("kernel", f"op{corr}.{i}", at_op, 3.0, corr))
                at_op += 3.0
    return {"traceEvents": events}


def _parse(tmp_path, trace):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    return tracing.parse(str(path))


@pytest.mark.parametrize("call", ["cudaGraphLaunch", "cudaGraphLaunch_v10000", "cuGraphLaunch"])
def test_graph_ops_are_the_ops_of_graph_launches(tmp_path, call):
    view = _parse(tmp_path, _replayed(graph_call=call))
    assert view.n_chunks == 2 and view.unattributed == 0
    assert _read("graph_ops_per_chunk", view) == 9.0
    assert _read("device_ops_per_chunk", view) == 11.0
    # the chain's graph launch holds the state kernel's two ops
    assert _read("frame_chain_ops_per_chunk", view) == 2.0


def test_a_dispatch_without_graphs_reads_zero(tmp_path):
    view = _parse(tmp_path, _replayed(graph_call="cudaLaunchKernel"))
    assert _read("graph_ops_per_chunk", view) == 0.0
    assert _read("device_ops_per_chunk", view) == 11.0


@pytest.mark.parametrize("fixture", ["trace_bank64_bypass_3chunks.json",
                                     "trace_bank64_custom_spans_3chunks.json"])
def test_the_recorded_fixtures_read_zero(fixture):
    assert _read("graph_ops_per_chunk", tracing.parse(str(FIXTURES / fixture))) == 0.0


def test_an_untraced_run_reads_none():
    assert _read("graph_ops_per_chunk", None) is None
