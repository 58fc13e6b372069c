"""The harness's own arithmetic and its lookups by name, without a card."""

import json
import math
import re
import statistics
from types import SimpleNamespace

import numpy as np
import pytest

from sdrbench import inputs, loops, spec
from sdrbench.tests import tiny


class FakeClock:
    """A clock that moves when the code under test sleeps or works, and by
    a tenth of a microsecond each time it is read (so a spin ends)."""

    TICK = 1e-7

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += self.TICK
        return self.t

    def sleep(self, s):
        self.t += s


def _read(name, window=None, trace=None, cell=None):
    return spec.load_module("metrics", name).read(SimpleNamespace(window=window, trace=trace, cell=cell))


def test_open_loop_times_each_chunk_from_its_due_time():
    """A stall in chunk 1 (25 ms against a 10 ms period) delays chunks 2
    and 3; their latency counts the wait, and the generator's lateness
    shows it."""
    clock = FakeClock()
    work = {0: 0.002, 1: 0.025, 2: 0.002, 3: 0.002, 4: 0.002}

    def dispatch(k):
        clock.t += work[k]
        return k

    w = loops.open_loop(dispatch, 0.05, period_s=0.01, samples_per_chunk=7, clock=clock,
                        sleep=clock.sleep)
    assert w.chunks == 5 and w.samples == 35
    np.testing.assert_allclose(w.lateness_s, [0, 0, 0.015, 0.007, 0], atol=1e-5)
    np.testing.assert_allclose(w.latencies_s, [0.002, 0.025, 0.017, 0.009, 0.002], atol=1e-5)


def test_latency_p95_is_over_every_chunk_of_the_window():
    lat = [0.001] * 95 + [0.010] * 5
    w = loops.Window("open", 0.0, 1.0, 100, 1, latencies_s=lat)
    assert math.isclose(_read("latency_p95_ms", w), float(np.percentile(lat, 95)) * 1e3)
    assert _read("msps", w) is None


def test_closed_loop_counts_every_sample_over_the_whole_window():
    """Chunks of 1e6 samples, 4 ms of device work each, 2 in flight, sent
    for 20 ms: every chunk sent counts, and the window lasts until the
    last one finishes."""
    clock = FakeClock()
    device = {"free": clock.t}

    class Mark:
        def __init__(self):
            device["free"] = max(device["free"], clock.t) + 0.004
            self.done = device["free"]

        def wait(self):
            clock.t = max(clock.t, self.done)

    def dispatch(k):
        clock.t += 0.0005  # host time a dispatch
        return k

    w = loops.closed_loop(dispatch, 0.02, in_flight=2, samples_per_chunk=10**6, mark=Mark,
                          clock=clock)
    assert w.kind == "closed"
    assert w.chunks == 6
    assert math.isclose(w.seconds, 0.0245, rel_tol=1e-3)
    assert math.isclose(_read("msps", w), w.samples / w.seconds / 1e6)
    assert w.samples == 6e6
    assert _read("latency_p95_ms", w) is None


def test_closed_loop_keeps_at_most_in_flight_chunks_unfinished():
    clock = FakeClock()
    open_marks = []

    class Mark:
        def __init__(self):
            open_marks.append(self)
            assert len(open_marks) <= 2

        def wait(self):
            open_marks.remove(self)

    loops.closed_loop(lambda k: clock.sleep(0.001), 0.05, in_flight=2, samples_per_chunk=1,
                      mark=Mark, clock=clock)
    assert not open_marks


def test_closed_loop_counts_the_time_it_waits_on_the_device():
    """Each mark is reached 3 ms after it is set and a dispatch takes 1 ms
    of the host: with 2 in flight the loop waits about 1 ms a chunk."""
    clock = FakeClock()

    class Mark:
        def __init__(self):
            self.due = clock.t + 0.003

        def wait(self):
            clock.t = max(clock.t, self.due)

    w = loops.closed_loop(lambda k: clock.sleep(0.001), 1.0, in_flight=2, samples_per_chunk=1,
                          mark=Mark, clock=clock)
    assert 0.4 < w.wait_s / w.seconds < 0.6


def test_keeper_takes_the_chunks_at_the_fractions_and_the_last():
    clock = FakeClock()
    w = loops.closed_loop(lambda k: clock.sleep(0.01) or f"out{k}", 1.0, in_flight=1,
                          samples_per_chunk=1, fractions=[0.245, 0.248, 0.5], clock=clock)
    assert sorted(w.kept) == [25, 50, w.chunks - 1]
    assert w.kept[25] == "out25"


def test_wait_until_sleeps_then_spins_to_the_due_time():
    clock = FakeClock()
    spins = []

    def ticking():
        spins.append(1)
        clock.t += 1e-5
        return clock.t

    due = clock.t + 0.5
    loops.wait_until(due, ticking, clock.sleep)
    assert due <= clock.t < due + 2e-5 and len(spins) < 200


def test_setup_and_idle_share_readers():
    w = loops.Window("closed", 0.0, 1.0, 1, 1, setup_s=12.5)
    assert _read("setup_s", w) == 12.5
    trace = SimpleNamespace(busy_s=0.25, window_s=1.0)
    assert _read("idle_share", trace=trace) == 75.0
    for name in ("idle_share", "idle_share.dev", "iir_device_ms", "spectrum_bypass_roofline",
                 "spectrum_complex_roofline", "d2h_copy_ms.rt", "device_ops_per_chunk.sat",
                 "device_ops_per_chunk.dev", "device_ops_per_chunk.rt"):
        assert _read(name, w, None) is None


def _kernel_trace(kernel, ms):
    return SimpleNamespace(ms_per_chunk=lambda keep: ms if keep(f"void {kernel}<float, float>(", "kernel") else None)


def test_rooflines_count_the_chunk_shape_and_their_own_kernel():
    bench = spec.load_benchmark()
    iq = spec.find_cell(bench, "wideband_iq.bypass.sat")
    real = spec.find_cell(bench, "bank64.custom.sat")
    # 4096 complex frames: 805 MB at 3.35 TB/s is 0.2404 ms
    assert math.isclose(_read("spectrum_complex_roofline", trace=_kernel_trace("spectrum_complex_kernel", 0.5),
                              cell=iq), 100 * 0.24038 / 0.5, rel_tol=1e-4)
    # 1024 real frames: 134.2 MB is 0.04006 ms
    assert math.isclose(_read("spectrum_bypass_roofline", trace=_kernel_trace("spectrum_bypass_kernel", 0.08),
                              cell=real), 100 * 0.040065 / 0.08, rel_tol=1e-4)
    assert _read("spectrum_bypass_roofline", trace=_kernel_trace("spectrum_complex_kernel", 0.5), cell=real) is None


# ------------------------------------------------------------ names


def test_every_cell_finds_its_files_by_name():
    bench = tiny.benchmark()
    for w in bench["workloads"]:
        cell = spec.find_cell(bench, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert "mag_err" in cell.limits
        spec.load_module("entries", cell.traffic["entry"]).build
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.load_module("metrics", m["name"]).read)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_an_unknown_name_is_refused():
    bench = spec.load_benchmark()
    with pytest.raises(KeyError):
        spec.find_cell(bench, "no.such.cell")
    with pytest.raises(FileNotFoundError):
        spec.load_module("metrics", "no_such_metric")


def test_a_split_metric_shares_the_reader_of_its_quantity():
    """``idle_share.dev`` has no file of its own and reads through
    ``idle_share.py``; a name with a file of its own keeps it."""
    trace = SimpleNamespace(busy_s=0.5, window_s=2.0)
    assert _read("idle_share.dev", trace=trace) == _read("idle_share", trace=trace) == 75.0
    assert spec.load_module("metrics", "idle_share.dev").__file__.endswith("idle_share.py")
    assert spec.load_module("metrics", "device_ops_per_chunk.rt").__file__.endswith("device_ops_per_chunk.py")
    with pytest.raises(FileNotFoundError):
        spec.load_module("metrics", "no_such_metric.dev")


def test_a_metric_without_workloads_goes_to_every_cell_that_reports_what_it_moves():
    bench = spec.load_benchmark()
    bench["per_layer"].append({"name": "extra", "moves": "msps.dev"})
    assert [m["name"] for m in spec.find_cell(bench, "wideband_iq.bypass.sat").per_layer][-1] == "extra"
    assert "extra" not in [m["name"] for m in spec.find_cell(bench, "bank64.custom.sat").per_layer]


# ------------------------------------------------------------ the seed


def test_the_same_seed_gives_the_same_inputs_and_any_whole_number_is_a_seed():
    torch = pytest.importorskip("torch")
    cell = spec.find_cell(spec.load_benchmark(), "bank64.custom.sat")
    big = 2**31 + 12345
    a = inputs.make_designs(cell.config, big)
    np.testing.assert_array_equal(a, inputs.make_designs(cell.config, big))
    assert a.shape == (64, 6, 6)
    assert not np.array_equal(a, inputs.make_designs(cell.config, big + 1))
    inputs.make_designs(cell.config, -3)
    cell.config["channels"] = 2
    cell.traffic["frames_per_chunk"] = 1
    cell.traffic["ring_chunks"] = 2
    r1 = inputs.make_ring(cell.config, cell.traffic, big, "cpu")
    assert r1.shape == (2, 2, 16384) and r1.dtype == torch.float32
    assert torch.equal(r1, inputs.make_ring(cell.config, cell.traffic, big, "cpu"))
    assert not torch.equal(r1[0], r1[1])


def test_each_seed_gets_the_same_mix_of_designs_in_another_order():
    cell = spec.find_cell(spec.load_benchmark(), "bank64.custom.sat")
    import scipy.signal as sps

    def kinds(seed):
        out = []
        for sos in inputs.make_designs(cell.config, seed):
            z, p, k = sps.sos2zpk(sos)
            dc, ny = np.abs(np.polyval(np.poly(z), [1, -1]) / np.polyval(np.poly(p), [1, -1]) * k)
            out.append("lowpass" if dc > 0.5 else "highpass" if ny > 0.5 else "bandpass")
        return out

    a, b = kinds(1), kinds(2)
    assert sorted(a) == sorted(b) and a != b
    assert statistics.multimode(a) and sorted(set(a)) == ["bandpass", "highpass", "lowpass"]


# ------------------------------------------------------------ BENCHMARK.json's format

def _check_chips(workloads: list[dict], config_of):
    """Each cell on 1 or 4 chips, and on 4 only within the cap: a quarter of
    the cells, rounded down, or one. A configuration's optional ``mesh``
    (``config_of(name)["mesh"]``) spans exactly each of its cells' chips."""
    for w in workloads:
        assert w["chips"] in (1, 4)
        mesh = config_of(w["config"]).get("mesh")
        if mesh is not None:
            assert set(mesh) == {"channel", "time"} and mesh["channel"] * mesh["time"] == w["chips"]
    assert sum(w["chips"] == 4 for w in workloads) <= max(1, len(workloads) // 4)


@pytest.mark.parametrize("chips, mesh, ok", [
    ([1, 1, 1, 4], {"channel": 2, "time": 2}, True),
    ([1, 4], {"channel": 4, "time": 1}, True),
    ([1, 1, 4, 4], {"channel": 2, "time": 2}, False),
    ([1, 1, 1, 4], {"channel": 2, "time": 1}, False),
    ([1, 1, 1, 2], {"channel": 2, "time": 1}, False),
    ([1, 1, 1, 4], None, True),
])
def test_four_chips_within_the_cap_and_a_mesh_that_spans_them(chips, mesh, ok):
    """The rules that the format test holds BENCHMARK.json to, on made-up
    cells: the last cell's configuration carries ``mesh``."""
    cells = [{"name": f"c{i}", "config": "m" if i == len(chips) - 1 else "s", "chips": n}
             for i, n in enumerate(chips)]
    config_of = lambda name: {"mesh": mesh} if name == "m" and mesh else {}
    if ok:
        _check_chips(cells, config_of)
    else:
        with pytest.raises(AssertionError):
            _check_chips(cells, config_of)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keeps_to_its_format():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert bench["paths"] == ["sdrbench"] and 1 <= bench["run_seconds"] <= 51
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("sdrbench/") and NAME.match(c["name"])
        assert any(w["config"] == c["name"] for w in cells.values())
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert json.loads((spec.ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    pairs = set()
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(cells)
    _check_chips(bench["workloads"],
                 lambda name: json.loads((spec.ROOT / configs[name]["file"]).read_text()))
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(cells) if "workloads" in m else True
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter",
                                                     "host_clock")
        for w in m["workloads"]:
            assert "workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"]
        if "_roofline" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], set()).add(m["name"])
    # a full check of 24 cells (2 + 14 runs a cell, each the window plus a
    # minute, 3 minutes a cell to build, 20 minutes spare) fits in 12 hours
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_a_multi_rank_cells_roofline_counts_rank_0s_block():
    """Only rank 0 traces, so its kernel's time is for its block: a quarter
    of the kept-out cell's chunk, which is bank64.custom.sat's chunk."""
    one = spec.find_cell(spec.load_benchmark(), "bank64.custom.sat")
    trace = _kernel_trace("spectrum_bypass_kernel", 0.08)
    assert _read("spectrum_bypass_roofline", trace=trace, cell=tiny.sharded()) == \
        _read("spectrum_bypass_roofline", trace=trace, cell=one)
