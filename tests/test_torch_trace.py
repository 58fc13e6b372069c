"""``bench.trace.parse_trace`` on small synthetic Chrome traces, laid out as
``torch.profiler.profile.export_chrome_trace`` writes them (on an H100 the
port's kernels appear as category "kernel" events carrying the correlation
id of their "cuda_runtime" launch), and ``capture_op_table`` on the CPU."""

import json

import pytest

from tpu_sdr_torch.bench.trace import STEP_RANGE, capture_op_table, parse_trace


def _range(ts, dur, name=STEP_RANGE):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "pid": 1,
            "tid": 1, "args": {}}


def _launch(ts, corr, dur=5.0, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": ts, "dur": dur, "pid": 1,
            "tid": 1, "args": {"correlation": corr}}


def _op(ts, dur, corr, name="k", cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


def _parse(tmp_path, events, wrap=True):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events} if wrap else events))
    return parse_trace(str(path))


def test_one_kernel_step_counts_one(tmp_path):
    # the device-side copy of the range (gpu_user_annotation) is no op
    t = _parse(tmp_path, [_range(100.0, 50.0), _launch(110.0, 7), _op(120.0, 60.0, 7, "q15_fft_kernel"),
                          {"ph": "X", "cat": "gpu_user_annotation", "name": STEP_RANGE, "ts": 120.0,
                           "dur": 60.0, "args": {}}])
    assert t["device_trace"] and t["module"] == STEP_RANGE and t["executions"] == 1
    assert t["n_ops"] == 1 and t["op_counts"] == {"q15_fft_kernel": 1}
    assert t["op_sum_ms"] == pytest.approx(0.060) and t["device_busy_ms"] == pytest.approx(0.060)
    assert t["dispatch_ms"] == pytest.approx(0.080)  # 100 .. 180 us
    assert t["device_idle_ms"] == pytest.approx(0.020)
    assert t["top_ops_ms"] == [["q15_fft_kernel", 0.06]] and t["unattributed"] == 0


def test_kernel_after_the_host_range_is_its_steps(tmp_path):
    """The launch lies in step 0's range; its kernel runs after step 0's
    range ends and after step 1's begins: it is step 0's, by correlation."""
    t = _parse(tmp_path, [_range(0.0, 20.0), _launch(5.0, 1), _op(300.0, 10.0, 1, "late"),
                          _range(250.0, 40.0), _launch(255.0, 2), _op(320.0, 10.0, 2, "mine")])
    assert t["executions"] == 2
    assert t["op_counts"] == {"mine": 1}
    assert t["ops_all_steps"] == {"late": [pytest.approx(0.010), 1], "mine": [pytest.approx(0.010), 1]}
    assert t["dispatch_ms"] == pytest.approx(0.080)  # 250 .. 330 us


def test_overlapping_kernels_never_give_negative_idle(tmp_path):
    t = _parse(tmp_path, [_range(100.0, 10.0), _launch(101.0, 1), _launch(102.0, 2),
                          _launch(103.0, 3), _op(120.0, 40.0, 1, "a"), _op(130.0, 20.0, 2, "b"),
                          _op(150.0, 30.0, 3, "a")])
    assert t["n_ops"] == 3 and t["op_counts"] == {"a": 2, "b": 1}
    assert t["op_sum_ms"] == pytest.approx(0.090)
    assert t["device_busy_ms"] == pytest.approx(0.060)  # 120 .. 180 us
    assert t["dispatch_ms"] == pytest.approx(0.080)
    assert t["device_idle_ms"] == pytest.approx(0.020) and t["device_idle_ms"] >= 0
    assert t["top_ops_ms"][0] == ["a", 0.07]


def test_reps_take_the_last_step(tmp_path):
    events = []
    for k in range(3):
        t0 = 1000.0 * k
        events += [_range(t0, 50.0), _launch(t0 + 1, 10 * k)]
        events += [_op(t0 + 10, 5.0 * (k + 1), 10 * k, "k")]
        events += [_launch(t0 + 2, 10 * k + 1), _op(t0 + 30, 1.0, 10 * k + 1, "m", "gpu_memcpy")]
    events.append(_op(5000.0, 3.0, 999, "stray"))  # its launch is in no step
    t = _parse(tmp_path, events, wrap=False)
    assert t["executions"] == 3 and t["n_ops"] == 2
    assert t["op_counts"] == {"k": 1, "m": 1}
    assert t["op_sum_ms"] == pytest.approx(0.016)  # the third step: 15 + 1 us
    assert t["ops_all_steps"]["k"] == [pytest.approx(0.030), 3]
    assert t["ops_all_steps"]["m"][1] == 3
    assert t["unattributed"] == 1


def test_driver_launches_and_long_names(tmp_path):
    name = "void (anonymous namespace)::spectrum_bypass_kernel<" + "x" * 200 + ">"
    t = _parse(tmp_path, [_range(0.0, 10.0), _launch(1.0, 5, cat="cuda_driver"),
                          _op(2.0, 3.0, 5, name)])
    assert list(t["op_counts"]) == [name[:110]] and t["top_ops_ms"][0][0] == name[:110]


@pytest.mark.parametrize("events, reason", [
    ([_range(0.0, 10.0), _launch(1.0, 1)], "no CUDA kernel"),
    ([_launch(1.0, 1), _op(2.0, 3.0, 1)], "range in the trace"),
])
def test_no_device_trace(tmp_path, events, reason):
    t = _parse(tmp_path, events)
    assert t["device_trace"] is False and reason in t["reason"]


def test_capture_op_table_on_the_cpu_has_no_device_trace(tmp_path):
    import torch

    x = torch.arange(4096, dtype=torch.float32)
    calls = []
    t = capture_op_table(lambda: calls.append(float(x.sum())), reps=3, logdir=str(tmp_path))
    assert t == {"device_trace": False, "reason": "no CUDA kernel, memcpy or memset events"}
    assert len(calls) == 4  # the profiler's warm-up call, then reps
    (capture,) = tmp_path.iterdir()  # kept in a fresh subdirectory
    trace = json.loads((capture / "trace.json").read_text())
    ranges = [e for e in trace["traceEvents"] if e.get("name") == STEP_RANGE]
    assert len(ranges) == 3
