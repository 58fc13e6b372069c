"""The readers of the port's own spans (``sdrbench/spans.py`` and the
metrics that use it) on synthetic traces, on a recorded trace without
program spans, and on one recorded with them on an H100."""

import json
import math
from pathlib import Path
from types import SimpleNamespace

import pytest

from sdrbench import spans, spec
from sdrbench import trace as tracing

FIXTURES = Path(__file__).parent / "fixtures"
BYPASS = FIXTURES / "trace_bank64_bypass_3chunks.json"
CUSTOM = FIXTURES / "trace_bank64_custom_spans_3chunks.json"
READERS = ("dispatch_host_ms", "frame_chain_host_ms", "frame_chain_ops_per_chunk",
           "iir_span_device_ms", "idle_share_in_dispatch", "idle_share_in_frame_chain")


def _read(name, view):
    return spec.load_module("metrics", name).read(SimpleNamespace(window=None, trace=view, cell=None))


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _synthetic(drop_op=False):
    """Two chunks, each 100 us: a dispatch (5-90) holding the products
    (10-30: two launches), the frame chain (35-60: three) and the emit
    (62-70: one), then a spectrum launch (80) in a launch span; each op
    runs 4 us, from 50 on, 2 us apart. ``drop_op``: the profiler lost
    the second chunk's last op."""
    events, corr = [], 0
    for k in range(2):
        t0 = 1000.0 * k
        events += [_x("user_annotation", tracing.CHUNK_RANGE, t0, 100.0),
                   _x("user_annotation", "tpu_sdr.dispatch", t0 + 5, 85.0),
                   _x("user_annotation", "tpu_sdr.iir.products", t0 + 10, 20.0),
                   _x("user_annotation", "tpu_sdr.iir.frame_chain", t0 + 35, 25.0),
                   _x("user_annotation", "tpu_sdr.iir.emit", t0 + 62, 8.0),
                   _x("user_annotation", "tpu_sdr.launch.spectrum_bypass", t0 + 79, 3.0),
                   _x("cuda_runtime", "cudaEventRecordWithFlags", t0 + 95, 1.0)]
        for i, at in enumerate((12, 20, 40, 45, 50, 65, 80)):
            corr += 1
            name = "cuLaunchKernel" if i == 0 else "cudaLaunchKernel"
            events.append(_x("cuda_runtime", name, t0 + at, 1.0, corr))
            if not (drop_op and k == 1 and i == 6):
                events.append(_x("kernel", f"k{i}", t0 + 50 + 6 * i, 4.0, corr))
    return {"traceEvents": events}


def _parse(tmp_path, trace):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    return tracing.parse(str(path))


def test_the_readers_on_a_synthetic_trace(tmp_path):
    view = _parse(tmp_path, _synthetic())
    assert view.n_chunks == 2 and view.unattributed == 0
    assert _read("dispatch_host_ms", view) == pytest.approx(0.085)
    assert _read("frame_chain_host_ms", view) == pytest.approx(0.025)
    assert _read("frame_chain_ops_per_chunk", view) == 3.0
    # products 2, chain 3, emit 1: six ops of 4 us a chunk
    assert _read("iir_span_device_ms", view) == pytest.approx(0.024)
    # the device runs 50-90 of each chunk (ops of 4 us every 6): idle 0-50
    # and the 2 us between ops, of a window 0-1100 (the last chunk's end)
    window = 1100.0
    in_dispatch = 2 * ((50 - 5) + 6 * 2)
    assert _read("idle_share_in_dispatch", view) == pytest.approx(100 * in_dispatch / window)
    # the chain (35-60) overlaps the gaps 35-50 and 54-56
    assert _read("idle_share_in_frame_chain", view) == pytest.approx(100 * 2 * 17 / window)


def test_the_ops_pair_with_their_launches_by_order(tmp_path):
    view = _parse(tmp_path, _synthetic())
    pairs = spans.launched(view)
    assert [[op[2] for _, op in chunk] for chunk in pairs] == [[f"k{i}" for i in range(7)]] * 2
    assert [at for at, _ in pairs[1]] == [1012.0, 1020.0, 1040.0, 1045.0, 1050.0, 1065.0, 1080.0]


def test_a_lost_op_reads_none_for_the_op_readers_only(tmp_path):
    view = _parse(tmp_path, _synthetic(drop_op=True))
    assert spans.launched(view) is None
    assert _read("frame_chain_ops_per_chunk", view) is None
    assert _read("iir_span_device_ms", view) is None
    assert _read("dispatch_host_ms", view) == pytest.approx(0.085)


def test_the_order_of_the_idle_shares_and_host_times(tmp_path):
    view = _parse(tmp_path, _synthetic())
    idle = 100.0 * (1.0 - view.busy_s / view.window_s)
    assert _read("idle_share_in_frame_chain", view) <= _read("idle_share_in_dispatch", view) <= idle
    assert _read("frame_chain_host_ms", view) <= _read("dispatch_host_ms", view)


@pytest.mark.parametrize("name", READERS)
def test_a_trace_without_program_spans_reads_none(name):
    """The bypass fixture was recorded before the port had spans."""
    assert _read(name, tracing.parse(str(BYPASS))) is None


@pytest.mark.parametrize("name", READERS)
def test_an_untraced_run_reads_none(name):
    assert _read(name, None) is None


def test_a_span_that_starts_outside_every_chunk_is_not_counted(tmp_path):
    trace = _synthetic()
    trace["traceEvents"].append(_x("user_annotation", "tpu_sdr.dispatch", 500.0, 50.0))
    view = _parse(tmp_path, trace)
    assert _read("dispatch_host_ms", view) == pytest.approx(0.085)


# ------------------------------------------ the recorded trace with program spans


@pytest.fixture(scope="module")
def custom():
    return tracing.parse(str(CUSTOM))


def test_recorded_spans_read_in_order(custom):
    """Three chunks of ``bank64.custom.sat`` traced on an H100 with the
    port's spans: the ordering the metrics promise."""
    r = {name: _read(name, custom) for name in READERS}
    assert all(v is not None for v in r.values())
    idle = _read("idle_share", custom)
    assert r["frame_chain_host_ms"] <= r["dispatch_host_ms"]
    assert r["idle_share_in_frame_chain"] <= r["idle_share_in_dispatch"] <= idle
    assert r["iir_span_device_ms"] <= _read("iir_device_ms", custom)
    # 16 frames of three alb_step ops, then the stack
    assert r["frame_chain_ops_per_chunk"] == 49.0


def test_recorded_pairing_by_order_is_the_correlation_ids(custom):
    """On the recorded trace, the op paired with each launching call by
    order is the op that carries that call's correlation id."""
    with open(CUSTOM) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") in tracing.LAUNCH_CATEGORIES and "correlation" in e.get("args", {})}
    by_op = {(float(e["ts"]), e["name"][:tracing.NAME_CHARS]): launch_ts[e["args"]["correlation"]]
             for e in events if e.get("cat") in tracing.DEVICE_CATEGORIES}
    pairs = spans.launched(custom)
    assert pairs is not None and sum(map(len, pairs)) == sum(map(len, custom.chunks))
    for chunk in pairs:
        for at, (ts, _, name, _) in chunk:
            assert math.isclose(by_op[(ts, name)], at)
