"""The pod cell, ``pod_bank.custom.x4``: its configuration against
``BENCHMARK.json`` and ``bank64``, and the cell cut to 8 channels x 4 frames
a chunk over four Gloo ranks on the CPU (``sdrbench/tests/pod.py``) through
``entries/sharded.py``: correct under the cell's limits against the float64
reference, and equal to the single-device pipeline bit for bit. The readers
of the spans that the cell adds, on a synthetic trace and on a trace of a
program without those spans. On a machine with four cards, the cell at its
own size over NCCL equals one card.
"""

import json
import pickle
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from sdrbench import inputs, spec
from sdrbench import trace as tracing
from sdrbench.tests import pod

# Four ranks import torch, join, run a 1 s window and are checked in about
# 30 s here.
LIMIT_S = 240.0
SEED = 2**31 + 25


def _pod(out, *args, limit=LIMIT_S):
    return subprocess.run([sys.executable, "-m", "sdrbench.tests.pod", "--out", str(out), *args],
                          cwd=spec.ROOT, capture_output=True, text=True, timeout=limit)


def _result(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_pod_configuration_agrees_with_benchmark_json():
    """Its ``mesh`` spans the cell's chips, its ``reduced`` is the entry's
    (the hosts alone), and it keeps bank64's widths, designs, guarantees
    and tier."""
    bench = spec.load_benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == "pod_bank")
    cell = pod.cell(full=True)
    cfg = cell.config
    assert cfg["mesh"] == {"channel": 2, "time": 2}
    assert cfg["mesh"]["channel"] * cfg["mesh"]["time"] == cell.chips == 4
    assert cfg["reduced"] == entry["reduced"] == ["hosts"] and cfg["hosts"] == 1
    bank64 = spec.find_cell(bench, "bank64.custom.sat").config
    for key in ("input", "fft_size", "hop", "window", "sample_rate_hz", "n_sections", "iir_order",
                "tier", "designs"):
        assert cfg[key] == bank64[key], key
    assert bank64["guarantees"].items() <= cfg["guarantees"].items()
    assert cfg["channels"] == 2 * bank64["channels"]
    t = cell.traffic
    assert (t["entry"], t["mode"], t["loop"], t["in_flight"]) == ("sharded.pod", "CUSTOM", "closed", 2)
    assert cell.samples_per_chunk == 128 * 512 * 16384
    assert t["check"] == {"chunks": 3, "channels": 16}
    assert cell.limits == {"mag_err": 2e-5, "mag_err_ch": 5e-4, "state_err": 4e-3, "frames_err": 0}


# ------------------------------------------------------------ the readers

POD_READERS = ("collective_host_ms", "collective_device_ms", "shard_state_host_ms")


def _read(name, view):
    return spec.load_module("metrics", name).read(SimpleNamespace(window=None, trace=view, cell=None))


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _sharded(tmp_path):
    """Two chunks of 200 us, each a sharded dispatch (5-190): the state's
    rows cut (10-14), the frame chain (20-60) holding the time axis's
    all-gather (30-40, one NCCL launch at 32), and the state gathered
    (150-180) with the channel axis's all-gather in it (155-170, its
    launch at 160). Each NCCL kernel runs 6 us from 100 and 120, another
    op 4 us from 50."""
    events, corr = [], 0
    for k in range(2):
        t0 = 1000.0 * k
        events += [_x("user_annotation", tracing.CHUNK_RANGE, t0, 200.0),
                   _x("user_annotation", "tpu_sdr.dispatch", t0 + 5, 185.0),
                   _x("user_annotation", "tpu_sdr.shard.state", t0 + 10, 4.0),
                   _x("user_annotation", "tpu_sdr.iir.frame_chain", t0 + 20, 40.0),
                   _x("user_annotation", "tpu_sdr.comm.all_gather", t0 + 30, 10.0),
                   _x("user_annotation", "tpu_sdr.shard.state", t0 + 150, 30.0),
                   _x("user_annotation", "tpu_sdr.comm.all_gather", t0 + 155, 15.0)]
        for at, run, name in ((25, 50, "k"), (32, 100, "ncclDevKernel_AllGather_RING_LL"),
                              (160, 120, "ncclDevKernel_AllGather_RING_LL")):
            corr += 1
            events.append(_x("cuda_runtime", "cudaLaunchKernelExC" if at != 25 else
                             "cudaLaunchKernel", t0 + at, 1.0, corr))
            events.append(_x("kernel", name, t0 + run, 6.0 if name != "k" else 4.0, corr))
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tracing.parse(str(path))


def test_the_pod_readers_on_a_synthetic_trace(tmp_path):
    view = _sharded(tmp_path)
    assert view.n_chunks == 2
    assert _read("collective_host_ms", view) == pytest.approx(0.025)
    assert _read("collective_device_ms", view) == pytest.approx(0.012)
    assert _read("shard_state_host_ms", view) == pytest.approx(0.034)
    assert _read("dispatch_host_ms.x4", view) == pytest.approx(0.185)


def test_the_pod_readers_read_none_without_their_spans():
    """A program without the sharded dispatch's spans (the single-card cell's
    recorded trace) and an untraced run read None."""
    fixture = Path(__file__).parent / "fixtures" / "trace_bank64_custom_spans_3chunks.json"
    view = tracing.parse(str(fixture))
    for name in POD_READERS:
        assert _read(name, view) is None and _read(name, None) is None


# ------------------------------------------------------------ four Gloo ranks


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    out = tmp_path_factory.mktemp("pod")
    proc = _pod(out, "--seed", str(SEED), "--keep")
    with open(out / "outputs.pkl", "rb") as f:
        compared = pickle.load(f)
    return proc, compared


def test_the_pod_cell_cut_small_over_four_gloo_ranks_is_correct_under_its_limits(sound):
    proc, _ = sound
    result = _result(proc)
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert result["device"]["count"] == 4 and result["attempted"] >= 2
    limits = pod.cell().limits
    assert {k: v["limit"] for k, v in result["checks"].items()} == limits
    assert all(v["value"] <= v["limit"] for v in result["checks"].values())


def _equal_to_one_device(cell: spec.Cell, compared: dict, device: str, seed: int):
    """The single-device entry (``entries/pipeline.py``) on the same seed's
    designs and ring, chunk after chunk to the window's last: the compared
    chunks' magnitudes, the carried state and the frame counter equal what
    the ranks handed the comparison, bit for bit."""
    cfg, traffic = cell.config, dict(cell.traffic, entry="pipeline")
    ring = inputs.make_ring(cfg, traffic, seed, device)
    _, channels = inputs.check_sample(traffic, cfg["channels"], seed)
    entry = spec.load_module("entries", "pipeline").build(
        cfg, traffic, inputs.make_designs(cfg, seed), device)
    assert max(compared["outputs"]) == compared["last"]
    for k in range(compared["last"] + 1):
        out = entry.dispatch(ring[k % ring.shape[0]])
        if k in compared["outputs"]:
            np.testing.assert_array_equal(compared["outputs"][k], entry.to_host(out, channels))
    np.testing.assert_array_equal(compared["state"], entry.iir_state(channels))
    assert compared["frames_counted"] == entry.frames_counted()


def test_its_gathered_outputs_and_state_equal_one_device_bit_for_bit(sound):
    _equal_to_one_device(pod.cell(), sound[1], "cpu", SEED)


@pytest.fixture
def four_cards():
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")


@pytest.mark.cuda
def test_the_pod_cell_over_nccl_equals_one_card(four_cards, tmp_path):
    """The cell at its own size (128 channels x 512 frames a chunk, 64 x 256
    a card) over NCCL on four cards, a 1 s window: correct under its limits,
    and its 16 compared channels' gathered magnitudes and state equal one
    card's ``SpectrumPipeline`` on the same global chunks, bit for bit."""
    proc = _pod(tmp_path, "--full", "--device", "cuda", "--seed", str(SEED), "--keep", limit=600)
    result = _result(proc)
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert result["device"]["count"] == 4 and result["device"]["platform"] == "gpu"
    with open(tmp_path / "outputs.pkl", "rb") as f:
        _equal_to_one_device(pod.cell(full=True), pickle.load(f), "cuda", SEED)


def test_the_pod_entry_alone_in_one_process_runs_the_sharded_entry_on_a_one_process_mesh():
    """Without ranks (every cell in one process, as the harness's module
    check runs them) the pod's entry is ``entries/sharded.py``'s on a 1 x 1
    mesh, and its dispatch equals the single-device entry's bit for bit."""
    c = pod.cell()
    cfg, traffic = c.config, c.traffic
    designs = inputs.make_designs(cfg, SEED)
    ring = inputs.make_ring(cfg, traffic, SEED, "cpu")
    entry = spec.load_module("entries", traffic["entry"]).build(cfg, traffic, designs, "cpu")
    assert type(entry).__module__ == "sdrbench.entries.sharded"
    assert entry.pipe.mesh.shape == {"channel": 1, "time": 1}
    assert cfg["mesh"] == {"channel": 2, "time": 2}
    one = spec.load_module("entries", "pipeline").build(cfg, dict(traffic, entry="pipeline"),
                                                        designs, "cpu")
    channels = list(range(cfg["channels"]))
    for k in range(2):
        np.testing.assert_array_equal(entry.to_host(entry.dispatch(ring[k]), channels),
                                      one.to_host(one.dispatch(ring[k]), channels))
    np.testing.assert_array_equal(entry.iir_state(channels), one.iir_state(channels))
