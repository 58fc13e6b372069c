"""The host-fed cell without a card: its configuration against ``bank64``'s,
the ``feeder`` entry at a tiny size on the CPU against the ``pipeline``
entry on the same chunks, and the readers of the host feed layer on
synthetic traces whose copies are launched from the feeder's producer
thread."""

import json
import time
from types import SimpleNamespace

import pytest

from sdrbench import inputs, run, spec
from sdrbench import trace as tracing
from sdrbench.tests import tiny

CELL = "bank64.custom.hostfed"
SEED = 2**31 + 907


def _cell_full():
    return spec.find_cell(spec.load_benchmark(), CELL)


def _cell():
    return tiny.shrink(_cell_full())


def _entries(cell):
    designs = inputs.make_designs(cell.config, SEED)
    ring = inputs.make_ring(cell.config, cell.traffic, SEED, "cpu")
    fed = spec.load_module("entries", "feeder").build(cell.config, cell.traffic, designs, "cpu")
    traffic = dict(cell.traffic, entry="pipeline")
    direct = spec.load_module("entries", "pipeline").build(cell.config, traffic, designs, "cpu")
    return ring, fed, direct


def _same(fed, direct, ring, order):
    r = ring.shape[0]
    for k in order:
        a, b = fed.dispatch(ring[k % r]), direct.dispatch(ring[k % r])
        assert a.equal(b), k
    channels = list(range(ring.shape[1]))
    assert (fed.iir_state(channels) == direct.iir_state(channels)).all()
    assert fed.frames_counted() == direct.frames_counted()


def test_the_hostfed_configuration_is_bank64_fed_from_the_host():
    """Its own entry and file, with another source, and every number, design
    and guarantee of ``bank64`` under the same key, nothing reduced; it adds
    the feed and the guarantees of the link."""
    bench = spec.load_benchmark()
    entries = {c["name"]: c for c in bench["configs"]}
    mine, bank = entries["bank64_hostfed"], entries["bank64"]
    assert mine["file"] != bank["file"] and mine["source"] != bank["source"]
    cfg, bank64 = _cell_full().config, spec.find_cell(bench, "bank64.custom.sat").config
    assert cfg["reduced"] == mine["reduced"] == []
    for key, value in bank64.items():
        if key not in ("name", "source", "deployment", "assumed", "guarantees"):
            assert cfg[key] == value, key
    assert bank64["guarantees"].items() <= cfg["guarantees"].items()
    assert {"every_chunk_crosses_the_link", "delivery"} <= set(cfg["guarantees"])
    assert cfg["feed"]["sample_format"].startswith("float32")


def test_the_feeder_entry_refuses_a_run_whose_chunks_took_a_host_copy():
    cell = _cell()
    ring, fed, _ = _entries(cell)
    try:
        for k in range(3):
            fed.dispatch(ring[k])
        assert fed.frames_counted() == 3 * cell.traffic["frames_per_chunk"]
        fed.feeder.stats["host_copies"] += 1
        with pytest.raises(RuntimeError, match="pinned path was not taken"):
            fed.frames_counted()
    finally:
        fed.feeder.stop()


def test_the_feeder_entry_hands_the_harness_its_ring_slots():
    """The harness's order: a warm-up of 7 chunks, a reset, the trace's
    warm-up of 2 and its stretch from slot 0 again with no reset, a reset,
    the window. The fed stream equals the device-fed one throughout."""
    cell = _cell()
    ring, fed, direct = _entries(cell)
    try:
        _same(fed, direct, ring, range(7))
        assert fed.source.slots[0].data_ptr() != ring[0].data_ptr()
        fed.reset(), direct.reset()
        _same(fed, direct, ring, [0, 1] + list(range(5)))
        fed.reset(), direct.reset()
        _same(fed, direct, ring, range(8))
        assert fed.feeder.stats["host_copies"] == 0
        # the ring of 3 is at slot 2 now: any other slot but a restart at 0 is refused
        with pytest.raises(RuntimeError, match="names ring slot 1"):
            fed.dispatch(ring[1])
    finally:
        fed.feeder.stop()


def test_the_cell_runs_at_a_tiny_size_on_the_cpu(capfd):
    result, lines = run.run_cell(_cell(), SEED, 0.3, False, device="cpu", t_start=time.time())
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"msps", "setup_s"}
    err = capfd.readouterr().err
    line = next(x for x in err.splitlines() if "feeder since the reset" in x)
    assert f"{result['attempted']} chunks handed over" in line and "host_copies 0" in line


# ---------------------------------------------------------------- readers

CHUNK_US = 1300.0  # a 67 MB chunk's copy at ~52 GB/s
PINNED = "Memcpy HtoD (Pinned -> Device)"


def _x(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    """Three chunks 1000 us apart on the consumer's thread (tid 1), each a
    range of 0-200 holding a ``get`` (10-40 us long) and a kernel launch.
    The producer (tid 2) launches one copy a chunk: at 100 (inside chunk
    0's range), at 600 (between ranges: not in the view) and at 2100
    (inside chunk 2's). Beside them chunk 1's consumer launches a small
    pinned copy and a pageable one, which are not chunks."""
    events, corr = [], 100
    for k, get_us in enumerate((10.0, 25.0, 40.0)):
        t0 = 1000.0 * k
        events += [_x("user_annotation", tracing.CHUNK_RANGE, t0, 200.0),
                   _x("user_annotation", "tpu_sdr.feeder.get", t0 + 5, get_us),
                   _x("cuda_runtime", "cudaLaunchKernel", t0 + 60, 2.0, corr),
                   _x("kernel", "k", t0 + 300, 50.0, corr)]
        corr += 1
    for at, us in ((100.0, CHUNK_US), (600.0, CHUNK_US + 100), (2100.0, CHUNK_US + 20)):
        events += [_x("cuda_runtime", "cudaMemcpyAsync", at, 3.0, corr, tid=2),
                   _x("gpu_memcpy", PINNED, at + 50, us, corr)]
        corr += 1
    for name, us in ((PINNED, 3.0), ("Memcpy HtoD (Pageable -> Device)", 2.0)):
        events += [_x("cuda_runtime", "cudaMemcpyAsync", 1070.0, 3.0, corr),
                   _x("gpu_memcpy", name, 1100.0, us, corr)]
        corr += 1
    return {"traceEvents": events}


def _view(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(_trace()))
    return tracing.parse(str(path))


def _read(name, view):
    cell = spec.find_cell(spec.load_benchmark(), CELL)
    ctx = SimpleNamespace(window=None, trace=view, cell=cell)
    return spec.load_module("metrics", name).read(ctx)


def test_the_host_feed_readers_take_the_producers_copies(tmp_path):
    view = _view(tmp_path)
    # the copy launched between ranges is not in the view; the two that
    # are are each one chunk's crossing, and the small copies are left out
    ms = (CHUNK_US + CHUNK_US + 20) / 2 / 1e3
    assert _read("h2d_device_ms", view) == pytest.approx(ms)
    peak = 32e9 * 16 * 128 / 130 / 8
    share = 100 * 64 * 16 * 16384 * 4 / (ms / 1e3) / peak
    assert _read("h2d_link_share", view) == pytest.approx(share)
    assert 0 < _read("h2d_link_share", view) <= 100
    assert _read("feeder_wait_host_ms", view) == pytest.approx((10 + 25 + 40) / 3 / 1e3)


def test_the_host_feed_readers_read_none_without_the_feeder(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        _x("user_annotation", tracing.CHUNK_RANGE, 0, 100.0),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 2.0, 1),
        _x("kernel", "k", 20, 5.0, 1)]}))
    view = tracing.parse(str(path))
    for name in ("h2d_device_ms", "h2d_link_share", "feeder_wait_host_ms"):
        assert _read(name, view) is None and _read(name, None) is None
