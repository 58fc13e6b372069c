"""The frozen arithmetic: correlation-id charging on a recorded Chrome trace,
the roofline counts of rows 1 and 5, and the check that no harness module
loads JAX or the JAX package."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from sdrbench import roofline, spec
from sdrbench import trace as tracing

FIXTURE = Path(__file__).parent / "fixtures" / "trace_bank64_bypass_3chunks.json"


def test_recorded_trace_charges_each_op_to_its_chunk():
    """Three chunks of ``bank64.bypass.sat`` traced on an H100: five device
    ops a chunk (the spectrum kernel, the entry-state fill and the counters'
    updates), none outside a chunk."""
    view = tracing.parse(str(FIXTURE))
    assert view.n_chunks == 3
    assert [len(ops) for ops in view.chunks] == [5, 5, 5]
    assert view.unattributed == 0
    assert view.ops_per_chunk() == 5.0
    spectrum = view.ms_per_chunk(lambda name, cat: "spectrum_bypass_kernel" in name)
    assert 0.05 < spectrum < 0.2
    assert 0 < view.busy_s < view.window_s


def test_trace_window_and_idle_gaps_add_up():
    view = tracing.parse(str(FIXTURE))
    gaps = sum(b - a for a, b in view.gaps) / 1e6
    assert math.isclose(view.busy_s + gaps, view.window_s, rel_tol=1e-9)
    bd = view.breakdown()
    assert len(bd["device_ops"]) <= tracing.TOP and len(bd["idle_gaps"]) <= tracing.TOP
    assert bd["device_ops"][0][0].startswith("void (anonymous namespace)::spectrum_bypass_kernel")
    assert math.isclose(sum(s for _, s in bd["idle_gaps"]), gaps, rel_tol=1e-9)


def _trace(events):
    return {"traceEvents": events}


def test_an_op_runs_after_its_range_and_still_counts_for_it(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": tracing.CHUNK_RANGE, "ts": 0, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2, "dur": 1,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "user_annotation", "name": tracing.CHUNK_RANGE, "ts": 20, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 21, "dur": 1,
         "args": {"correlation": 8}},
        # chunk 0's kernel runs inside chunk 1's range
        {"ph": "X", "cat": "kernel", "name": "k0", "ts": 22, "dur": 5, "args": {"correlation": 7}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)", "ts": 28,
         "dur": 4, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "stray", "ts": 40, "dur": 1, "args": {"correlation": 99}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps(_trace(events)))
    view = tracing.parse(str(path))
    assert [[op[2] for op in ops] for ops in view.chunks] == [["k0"], ["Memcpy DtoH (Device -> Pageable)"]]
    assert view.unattributed == 1
    assert view.window == (0.0, 32.0)
    assert view.busy_us == 9.0
    assert view.ms_per_chunk(lambda n, c: c == "gpu_memcpy") == 4e-3 / 2


def test_a_host_only_trace_reads_as_no_trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(_trace([
        {"ph": "X", "cat": "user_annotation", "name": tracing.CHUNK_RANGE, "ts": 0, "dur": 10}])))
    assert tracing.parse(str(path)) is None


def test_union_of_overlapping_intervals():
    assert tracing.union_us([(0, 4), (2, 6), (8, 9), (8.5, 8.7)]) == 7.0


def test_spectrum_bounds_count_shapes_at_published_peaks():
    n = 16384
    b, f = roofline.spectrum_real(1024, n)
    assert b == 8 * 1024 * n and f == 2.5 * n * 14 * 1024
    # bytes bound it: 134.2 MB at 3.35 TB/s
    assert math.isclose(roofline.bound_s(b, f), b / 3.35e12)
    b, f = roofline.spectrum_complex(4096, n)
    assert b == 12 * 4096 * n and f == 5 * n * 14 * 4096
    assert math.isclose(roofline.bound_s(b, f) * 1e3, 0.24038, rel_tol=1e-4)


def test_no_harness_module_loads_jax_or_the_jax_package():
    """Load every harness module, entry and metric reader, and run every cell
    once at a tiny size on the CPU, in a fresh process; then no module of
    sys.modules may have the top-level name jax, jaxlib, flax or tpu_sdr."""
    script = """
import json, sys, time
from sdrbench import spec, run, calibrate
from sdrbench.tests import tiny
bench = tiny.benchmark()
for kind in ("entries", "metrics"):
    for path in sorted((spec.HERE / kind).glob("*.py")):
        spec.load_module(kind, path.stem)
for w in bench["workloads"]:
    run.run_cell(tiny.shrink(spec.find_cell(bench, w["name"])), 5, 0.2, False, device="cpu",
                 t_start=time.time())
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""
    env = dict(os.environ, PYTHONPATH=str(spec.ROOT))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", script], cwd=spec.ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "tpu_sdr_torch" in names and "sdrbench" in names
    assert not names & {"jax", "jaxlib", "flax", "tpu_sdr"}


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla", "flax", "tpu_sdr.kernels"])
def test_the_run_refuses_forbidden_modules(monkeypatch, name):
    from sdrbench import run

    monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == [name.split(".")[0]]


def test_the_port_shares_a_prefix_with_the_jax_package_but_is_allowed(monkeypatch):
    from sdrbench import run

    for m in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "tpu_sdr_torch_extra", object())
    assert run.forbidden_modules() == []
