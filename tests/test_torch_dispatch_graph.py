"""The filtered dispatch's CUDA graphs (``runtime/dispatch_graphs.py``) on
the CPU: which dispatches take them, their cache's keys, invalidation and
eviction, and the counts, with a stand-in for the capture. The CPU is
dressed as the card: the forcing, state and emit kernels' paths on (their
plain versions), the current stream a number the test sets, and a capture
whose graphs run their steps again on replay. A dispatch captures two
graphs, the state step's and the emit step's: the forcing pass runs
eagerly into their static inputs. ``tests/test_torch_cuda.py`` holds the real
graphs to the eager dispatch bit for bit on the card."""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from tpu_sdr_torch import FilterMode, PipelineConfig, SpectrumPipeline
from tpu_sdr_torch.kernels import biquad
from tpu_sdr_torch.kernels.cuda import launch
from tpu_sdr_torch.runtime import dispatch_graphs, stream
from tpu_sdr_torch.shard.mesh import MeshAxis, make_sdr_mesh
from tpu_sdr_torch.shard.pipeline import ShardedSpectrumPipeline

torch.set_num_threads(1)

N = 16384
SOS = sps.butter(12, 0.25, output="sos")
BANK = [sps.butter(12, 0.1 * (c + 1), output="sos") for c in range(2)]
NONE = {"captures": 0, "replays": 0, "eager": 0, "evictions": 0}


class _Standin:
    """A captured graph's stand-in: a replay runs the step again. Its
    launches are not counted, as a graph's replay makes none from Python."""

    def __init__(self, step):
        self.step = step

    def replay(self):
        with launch.captured():
            self.step()


@pytest.fixture
def card(monkeypatch):
    """The CPU as the card; yields the current stream's holder."""
    current = {"stream": 7}
    captured = []

    def capture(steps, device):
        captured.append(len(steps))
        for step in steps:
            step()
        return [_Standin(step) for step in steps]

    monkeypatch.setattr(biquad, "takes_state_kernel", lambda op: True)
    monkeypatch.setattr(dispatch_graphs, "_stream_id", lambda device: current["stream"])
    monkeypatch.setattr(dispatch_graphs, "_capture", capture)
    launch.reset_counts()
    yield current
    assert all(n == 2 for n in captured)
    launch.reset_counts()


def _chunk(seed: int, channels: int = 2, frames: int = 2, iq: bool = False) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((channels, frames * N)).astype(np.float32)
    if iq:
        x = x + 1j * rng.standard_normal((channels, frames * N)).astype(np.float32)
    return torch.as_tensor(x)


def _run(pipe, chunks, mode, state=None, **kw):
    """Dispatch ``chunks`` in turn on a carried state: (outputs, state)."""
    state = pipe.initial_state() if state is None else state
    outs = []
    for x in chunks:
        out, state = pipe.process(x, state, mode, **kw)
        outs.append(out)
    return outs, state


def _eager(pipe, chunks, mode, state=None):
    """The same dispatches through ``process_stream`` without graphs."""
    state = pipe.initial_state() if state is None else state
    outs = []
    for x in chunks:
        out, state = stream.process_stream(
            x, state, pipe.bank_fixed, pipe.bank_custom, pipe.hann_w, pipe.plan,
            mode_index=stream._MODE_TO_INDEX[mode], cfg=pipe.cfg)
        outs.append(out)
    return outs, state


def _pipe(kind: str, **cfg) -> SpectrumPipeline:
    pipe = SpectrumPipeline(PipelineConfig(channels=2, **cfg), device="cpu")
    if kind == "custom":
        pipe.upload_sos(SOS)
    elif kind == "bank":
        pipe.upload_sos_bank(BANK)
    return pipe


# (pipeline kind, its config, mode): every hybrid FIXED or CUSTOM dispatch
ENGAGED = {
    "fixed": ("fixed", {}, FilterMode.FIXED),
    "custom": ("custom", {}, FilterMode.CUSTOM),
    "bank": ("bank", {}, FilterMode.CUSTOM),
    "bank-fused-config": ("bank", {"fused_two_pass": True}, FilterMode.CUSTOM),
    "bf16-io": ("custom", {"dtype": "bf16", "bf16_io": True}, FilterMode.CUSTOM),
}


@pytest.mark.parametrize("case", list(ENGAGED))
def test_hybrid_dispatch_replays_and_equals_eager(card, case):
    """The first dispatch of a key runs eagerly, the second captures, the
    rest replay; every output and the carried state equal the dispatches
    without graphs bit for bit, and earlier outputs stay as they were."""
    kind, cfg, mode = ENGAGED[case]
    pipe = _pipe(kind, **cfg)
    chunks = [_chunk(seed) for seed in range(5)]
    outs, state = _run(pipe, chunks, mode)
    assert launch.graph_counts == {**NONE, "eager": 1, "captures": 1, "replays": 3}
    kept = [out["magnitude"].clone() for out in outs]
    refs, ref_state = _eager(pipe, chunks, mode)
    for out, ref, copy in zip(outs, refs, kept):
        assert torch.equal(out["magnitude"], ref["magnitude"])
        assert torch.equal(out["magnitude"], copy)
    assert torch.equal(state.sos_state, ref_state.sos_state)
    assert int(state.frame_count) == 10


def _not_engaged(case: str):
    """One of the dispatches the graphs never take, run over 3 chunks."""
    if case == "bypass":
        _run(_pipe("fixed"), [_chunk(s) for s in range(3)], FilterMode.BYPASS)
    elif case == "hop":
        _run(_pipe("fixed", hop=N // 2), [_chunk(s) for s in range(3)], FilterMode.FIXED)
    elif case == "fused":
        _run(_pipe("custom", fused_two_pass=True), [_chunk(s) for s in range(3)],
             FilterMode.CUSTOM)
    elif case == "complex":
        pipe = _pipe("custom")
        _run(pipe, [_chunk(s, iq=True) for s in range(3)], FilterMode.CUSTOM,
             state=pipe.initial_state(batch_shape=(2,)))
    elif case in ("power", "all"):
        _run(_pipe("custom"), [_chunk(s) for s in range(3)], FilterMode.CUSTOM, outputs=case)
    elif case == "time_axis":
        pipe = _pipe("custom")
        axis = MeshAxis("time", 1, 0, (0,))
        state = pipe.initial_state()
        for s in range(3):
            _, state = stream.process_stream(
                _chunk(s), state, pipe.bank_fixed, pipe.bank_custom, pipe.hann_w, pipe.plan,
                mode_index=2, cfg=pipe.cfg, time_axis=axis, graphs=pipe._graphs)
    elif case == "sharded":
        pipe = ShardedSpectrumPipeline(PipelineConfig(channels=2), make_sdr_mesh(devices="cpu"))
        pipe.upload_sos_bank(BANK)
        _run(pipe, [_chunk(s) for s in range(3)], FilterMode.CUSTOM)


@pytest.mark.parametrize("case", ["bypass", "hop", "fused", "complex", "power", "all",
                                  "time_axis", "sharded"])
def test_other_dispatches_never_take_the_graphs(card, case):
    _not_engaged(case)
    assert launch.graph_counts == NONE


def test_the_cpu_never_takes_the_graphs():
    """Undressed, the CPU's filtered dispatches run eagerly and count
    nothing."""
    launch.reset_counts()
    _run(_pipe("bank"), [_chunk(s) for s in range(3)], FilterMode.CUSTOM)
    assert launch.graph_counts == NONE
    assert launch.counts["plain"]["spectrum_bypass"] == 3


def test_a_replay_counts_the_launches_of_an_eager_dispatch(card):
    pipe = _pipe("bank")
    per_dispatch = []
    state = pipe.initial_state()
    for seed in range(4):
        before = {k: dict(v) for k, v in launch.counts.items()}
        _, state = pipe.process(_chunk(seed), state, FilterMode.CUSTOM)
        per_dispatch.append({(kind, name): n - before[kind][name]
                             for kind, names in launch.counts.items()
                             for name, n in names.items() if n != before[kind][name]})
    assert per_dispatch[0] == {("plain", "iir_force"): 1, ("plain", "iir_state"): 2,
                               ("plain", "iir_emit"): 1, ("plain", "spectrum_bypass"): 1}
    assert all(d == per_dispatch[0] for d in per_dispatch)


def test_the_key_is_stream_mode_shape_and_bank(card):
    pipe = _pipe("custom")
    state = pipe.initial_state()
    for frames in (2, 3, 2, 3):
        _, state = pipe.process(_chunk(frames, frames=frames), state, FilterMode.CUSTOM)
    assert launch.graph_counts == {**NONE, "eager": 2, "captures": 2}
    _run(pipe, [_chunk(1)], FilterMode.FIXED)
    card["stream"] = 8
    _run(pipe, [_chunk(1)], FilterMode.CUSTOM)
    assert launch.graph_counts == {**NONE, "eager": 4, "captures": 2}
    # another bank's operator through the same graphs: a key of its own
    other = pipe._build_bank(SOS)
    _, state = stream.process_stream(
        _chunk(1), pipe.initial_state(), pipe.bank_fixed, other, pipe.hann_w, pipe.plan,
        mode_index=2, cfg=pipe.cfg, graphs=pipe._graphs)
    assert launch.graph_counts == {**NONE, "eager": 5, "captures": 2, "evictions": 1}
    assert len(pipe._graphs._keys) == dispatch_graphs.CAPACITY


@pytest.mark.parametrize("upload", ["sos", "sos_bank"])
def test_an_upload_drops_the_graphs_and_takes_effect_on_the_next_chunk(card, upload):
    pipe = _pipe("bank")
    chunks = [_chunk(seed) for seed in range(5)]
    _, state = _run(pipe, chunks[:3], FilterMode.CUSTOM)
    assert launch.graph_counts["replays"] == 1
    new = [sps.butter(8, 0.05 * (c + 2), output="sos") for c in range(2)]
    ref = _pipe("fixed")
    for p in (pipe, ref):
        if upload == "sos":
            p.upload_sos(new[0])
        else:
            p.upload_sos_bank(new)
    assert not pipe._graphs._keys
    outs, _ = _run(pipe, chunks[3:], FilterMode.CUSTOM, state=state)
    assert launch.graph_counts == {**NONE, "eager": 2, "captures": 2, "replays": 1}
    refs, _ = _eager(ref, chunks[3:], FilterMode.CUSTOM, state=state)
    for out, want in zip(outs, refs):
        assert torch.equal(out["magnitude"], want["magnitude"])


def test_the_least_recently_used_key_is_evicted(card):
    pipe = _pipe("custom")
    state = pipe.initial_state()
    shapes = range(1, dispatch_graphs.CAPACITY + 2)
    for frames in shapes:
        _, state = pipe.process(_chunk(frames, frames=frames), state, FilterMode.CUSTOM)
    assert launch.graph_counts == {**NONE, "eager": len(shapes), "evictions": 1}
    assert len(pipe._graphs._keys) == dispatch_graphs.CAPACITY
    # the first shape was dropped: it warms up again, evicting the second
    _, state = pipe.process(_chunk(1, frames=1), state, FilterMode.CUSTOM)
    assert launch.graph_counts["eager"] == len(shapes) + 1
    assert launch.graph_counts["evictions"] == 2
    # the last shape is still held: it captures
    _, state = pipe.process(_chunk(9, frames=shapes[-1]), state, FilterMode.CUSTOM)
    assert launch.graph_counts["captures"] == 1
