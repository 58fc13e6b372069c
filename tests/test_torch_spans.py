"""The port's profiler spans (``tpu_sdr_torch.core.spans``): none is made
while no profiler runs; under ``torch.profiler`` each dispatch of
``SpectrumPipeline`` opens ``tpu_sdr.dispatch`` once, a CUSTOM bank's IIR
opens its three spans once inside it, and a kernel launch opens
``tpu_sdr.launch.<kernel>``. The sharded dispatch opens
``tpu_sdr.dispatch`` the same way, and ``tpu_sdr.shard.state`` around its
state's cut and gather, on a 1 x 1 mesh and on a 2 x 2 mesh of four Gloo
ranks (``tests/shard_cases_spans.py``); each collective opens
``tpu_sdr.comm.<name>`` and is counted."""

import contextlib

import numpy as np
import pytest
import scipy.signal as sps
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_sdr_torch import FilterMode, PipelineConfig, SpectrumPipeline
from tpu_sdr_torch.core import comm, spans
from tpu_sdr_torch.kernels import biquad
from tpu_sdr_torch.kernels.cuda import launch
from tpu_sdr_torch.shard.mesh import MeshAxis, make_sdr_mesh
from tpu_sdr_torch.shard.pipeline import ShardedSpectrumPipeline

import shard_cases_spans as cases
from torch_shard_harness import run_group

torch.set_num_threads(1)

N = 16384
IIR = ("tpu_sdr.iir.products", "tpu_sdr.iir.frame_chain", "tpu_sdr.iir.emit")


def _ranges(prof, prefix="tpu_sdr."):
    """(name, start, end) of each profiled range whose name starts with
    ``prefix``, in order of start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith(prefix)), key=lambda r: r[1])


@pytest.fixture
def no_record_function(monkeypatch):
    """Make any construction of a profiler range fail the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("a record_function was made with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_with_no_profiler_a_span_is_the_shared_null_context(no_record_function):
    a, b = spans.span("tpu_sdr.dispatch"), spans.span("tpu_sdr.iir.emit")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a, b:  # reentrant: spans nest
        pass


def test_under_the_profiler_a_span_is_a_named_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("tpu_sdr.test"):
            torch.ones(8).sum()
    assert [r[0] for r in _ranges(prof)] == ["tpu_sdr.test"]
    assert spans.span("tpu_sdr.test") is spans.span("other")  # off again


def test_a_dispatch_with_no_profiler_makes_no_range(no_record_function):
    pipe = SpectrumPipeline(PipelineConfig(channels=2), device="cpu")
    pipe.upload_sos_bank([sps.butter(6, 0.2, output="sos")] * 2)
    x = np.random.default_rng(1).standard_normal((2, N)).astype(np.float32)
    out, _ = pipe.process(x, pipe.initial_state(), FilterMode.CUSTOM)
    assert out["magnitude"].shape == (2, 1, N)


def _bank_custom(pipe, rng):
    pipe.upload_sos_bank([sps.butter(6, 0.2, output="sos"),
                          sps.butter(6, [0.1, 0.3], btype="bandpass", output="sos")])
    x = rng.standard_normal((2, 2 * N)).astype(np.float32)
    return lambda st: pipe.process(x, st, FilterMode.CUSTOM), pipe.initial_state()


def _real_bypass(pipe, rng):
    x = rng.standard_normal((2, 2 * N)).astype(np.float32)
    return lambda st: pipe.process(x, st, FilterMode.BYPASS), pipe.initial_state()


def _planes_bypass(pipe, rng):
    xs = rng.standard_normal((2, 2, N)).astype(np.float32)
    return lambda st: pipe.process_planes(xs, st, FilterMode.BYPASS), pipe.initial_state((2,))


@pytest.mark.parametrize("make, iir", [(_bank_custom, True), (_real_bypass, False),
                                       (_planes_bypass, False)])
def test_each_span_opens_once_a_dispatch_and_the_iir_nests_in_it(make, iir):
    pipe = SpectrumPipeline(PipelineConfig(channels=2), device="cpu")
    step, st = make(pipe, np.random.default_rng(2))
    step(st)  # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            _, st = step(st)
    got = _ranges(prof)
    names = [r[0] for r in got]
    want = ("tpu_sdr.dispatch",) + (IIR if iir else ())
    assert sorted(names) == sorted(want * 2)
    dispatches = [r for r in got if r[0] == "tpu_sdr.dispatch"]
    for name, a, b in got:
        if name in IIR:
            assert sum(lo <= a and b <= hi for _, lo, hi in dispatches) == 1
    if iir:  # in the dispatch's order: products, chain, emit
        assert [n for n in names if n in IIR] == list(IIR) * 2


def test_the_time_sharded_frame_chain_is_one_span():
    """``time_axis`` gathers the summaries inside the same span, and the
    loop opens none of its own (one span a chain, never one a frame)."""
    op = type("Op", (), {"ALB": torch.eye(4)})()
    axis = MeshAxis("time", 1, 0, (0,))
    w = torch.randn(3, 5, 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        starts, z = biquad.frame_chain(op, torch.zeros(3, 4), w, axis)
    assert [r[0] for r in _ranges(prof)] == ["tpu_sdr.iir.frame_chain"]
    ref_starts, ref_z = biquad.frame_chain(op, torch.zeros(3, 4), w)
    assert torch.equal(starts, ref_starts) and torch.equal(z, ref_z)


class _FakeLib:
    def __init__(self):
        self.calls = []

    def tpu_sdr_spectrum_bypass(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_launch(monkeypatch):
    """``launch.launch`` over a stand-in library, stream and device, so
    its Python runs on the CPU."""
    lib = _FakeLib()
    monkeypatch.setattr(launch, "_kernel_lib", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 77})())
    launch.reset_counts()
    yield lib
    launch.reset_counts()


def test_the_launch_spans_are_named_once_for_every_kernel():
    assert tuple(launch.SPANS) == launch.KERNELS
    assert all(launch.SPANS[k] == "tpu_sdr.launch." + k for k in launch.KERNELS)


def test_a_launch_opens_its_span_under_the_profiler(fake_launch):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        launch.launch("spectrum_bypass", "cuda:0", 1, 2)
    assert [r[0] for r in _ranges(prof)] == ["tpu_sdr.launch.spectrum_bypass"]
    assert fake_launch.calls == [(1, 2, 77)]
    assert launch.counts["kernel"]["spectrum_bypass"] == 1


def test_a_launch_with_no_profiler_makes_no_range(fake_launch, no_record_function):
    launch.launch("spectrum_bypass", "cuda:0", 3)
    assert fake_launch.calls == [(3, 77)] and launch.counts["kernel"]["spectrum_bypass"] == 1


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_a_collective_is_counted_and_keeps_no_timer(backend):
    """``comm`` counts each call in the axis's ``stats`` and times none."""
    axis = MeshAxis("time", 2, 0, (0, 1), group=object(), backend=backend)
    t = torch.arange(6.0).reshape(2, 3)
    seen = []
    out = comm._run(axis, "all_gather", t, lambda x: seen.append(x) or x * 2)
    assert torch.equal(out, t * 2) and len(seen) == 1
    assert axis.stats == {"calls": 1}


def test_the_collective_spans_are_named_once_for_every_collective():
    assert tuple(comm.SPANS) == comm.COLLECTIVES
    assert all(comm.SPANS[k] == "tpu_sdr.comm." + k for k in comm.COLLECTIVES)
    assert all(callable(getattr(comm, k)) for k in comm.COLLECTIVES)


@pytest.mark.parametrize("name", comm.COLLECTIVES)
def test_a_collective_opens_its_span_under_the_profiler(name):
    axis = MeshAxis("time", 2, 0, (0, 1), group=object(), backend="gloo")
    t = torch.ones(3, 5, dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        comm._run(axis, name, t, lambda x: x)
    assert [r[0] for r in _ranges(prof)] == ["tpu_sdr.comm." + name]
    assert axis.stats == {"calls": 1}


def test_a_collective_with_no_profiler_makes_no_range(no_record_function):
    axis = MeshAxis("time", 2, 0, (0, 1), group=object(), backend="gloo")
    comm._run(axis, "shift", torch.ones(4), lambda x: x)
    assert axis.stats == {"calls": 1}


# ------------------------------------------------------------ the sharded dispatch


def _inside(r, outer) -> int:
    """How many of the ranges ``outer`` hold range ``r``."""
    return sum(lo <= r[1] and r[2] <= hi for _, lo, hi in outer)


def _check_sharded_dispatch(got, calls: int, dispatches: int):
    """``got``: one rank's profiled ranges over ``dispatches`` CUSTOM
    dispatches, ``calls`` the collectives counted in them. Each dispatch
    opens ``tpu_sdr.dispatch`` once, no other dispatch around it; the IIR's
    three spans, the two state spans and one span a collective lie inside
    one dispatch each."""
    names = [r[0] for r in got]
    dispatch = [r for r in got if r[0] == "tpu_sdr.dispatch"]
    assert len(dispatch) == dispatches
    assert all(_inside(r, dispatch) == 1 for r in dispatch)  # itself only: none nests
    for name in IIR:
        assert names.count(name) == dispatches
    assert names.count("tpu_sdr.shard.state") == 2 * dispatches
    comms = [r for r in got if r[0].startswith("tpu_sdr.comm.")]
    assert len(comms) == calls
    for r in got:
        if r[0] != "tpu_sdr.dispatch":
            assert _inside(r, dispatch) == 1, r[0]
    assert [n for n in names if n in IIR] == list(IIR) * dispatches


def test_a_sharded_dispatch_on_a_1x1_mesh_opens_dispatch_once_and_the_state_span_twice():
    mesh = make_sdr_mesh(devices="cpu")
    pipe = ShardedSpectrumPipeline(PipelineConfig(channels=cases.C), mesh)
    pipe.upload_sos_bank(cases.bank())
    x = np.random.default_rng(5).standard_normal((cases.C, 2 * N)).astype(np.float32)
    _, st = pipe.process(x, pipe.initial_state(), FilterMode.CUSTOM)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(cases.DISPATCHES):
            _, st = pipe.process(x, st, FilterMode.CUSTOM)
    _check_sharded_dispatch(_ranges(prof), 0, cases.DISPATCHES)
    assert mesh.stats == {"calls": 0}


def test_a_sharded_dispatch_with_no_profiler_makes_no_range(no_record_function):
    pipe = ShardedSpectrumPipeline(PipelineConfig(channels=cases.C), make_sdr_mesh(devices="cpu"))
    pipe.upload_sos_bank(cases.bank())
    x = np.zeros((cases.C, 2 * N), np.float32)
    out, _ = pipe.process(x, pipe.initial_state(), FilterMode.CUSTOM)
    assert out["magnitude"].shape == (cases.C, 2, N)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return run_group(tmp_path_factory.mktemp("shard_spans"), "shard_cases_spans", 4)


def _result(group, name):
    results, errors = group
    if name not in results:
        pytest.fail(f"case {name} did not finish in the rank group:\n{errors}")
    return results[name]


def test_a_sharded_dispatch_over_four_gloo_ranks_opens_each_span_where_it_belongs(group):
    """On every rank of a (channel 2, time 2) mesh: the time axis gathers
    the frames' end states inside the frame chain's span, the channel axis
    gathers the state inside ``tpu_sdr.shard.state``, and each collective
    opens one ``tpu_sdr.comm.all_gather`` there."""
    readings = _result(group, "custom_dispatch")
    assert len(readings) == 4
    for r in readings:
        assert r["calls"] >= 2 * cases.DISPATCHES
        _check_sharded_dispatch(r["ranges"], r["calls"], cases.DISPATCHES)
        comms = [x for x in r["ranges"] if x[0].startswith("tpu_sdr.comm.")]
        assert {x[0] for x in comms} == {"tpu_sdr.comm.all_gather"}
        state = [x for x in r["ranges"] if x[0] == "tpu_sdr.shard.state"]
        chain = [x for x in r["ranges"] if x[0] == "tpu_sdr.iir.frame_chain"]
        assert all(_inside(x, state) + _inside(x, chain) == 1 for x in comms)
        assert any(_inside(x, state) for x in comms) and any(_inside(x, chain) for x in comms)


def test_each_collective_over_four_gloo_ranks_opens_one_span_and_is_counted_once(group):
    readings = _result(group, "each_collective")
    assert len(readings) == 4
    for r in readings:
        assert [c["name"] for c in r["collectives"]] == list(comm.COLLECTIVES)
        for c in r["collectives"]:
            assert c["ranges"] == ["tpu_sdr.comm." + c["name"]]
            assert c["calls"] == 1
        assert r["unprofiled_range"] is None and r["unprofiled_calls"] == len(comm.COLLECTIVES)
