"""The port's control plane against the JAX package: the command decoder
and its busy shield, the filter designer's wire format, and the
``SpectrumAnalyzer`` facade (wire protocol, checkpoints, the stream-kind
latch, a JAX checkpoint resumed in the port). Analyzers run with
``device="cpu"``; inputs are seeded NumPy arrays given to both packages."""

import json

import numpy as np
import pytest
import scipy.signal as sps
import torch

from tpu_sdr.control import SpectrumAnalyzer as JSpectrumAnalyzer
from tpu_sdr.control import commands as jcommands
from tpu_sdr.control import designer as jdesigner
from tpu_sdr.control import golden as jgolden
from tpu_sdr.core.config import FilterMode as JFilterMode
from tpu_sdr.core.config import PipelineConfig as JPipelineConfig
from tpu_sdr_torch import (
    Command,
    CommandDecoder,
    CommMode,
    FilterMode,
    PipelineConfig,
    SpectrumAnalyzer,
    convert,
    design_iir_filter,
    sos_to_wire_bytes,
    wire_bytes_to_sos,
)
from tpu_sdr_torch.control.commands import encode_coefficient_upload, encode_start_sequence

torch.set_num_threads(1)

N = 16384
# Port vs JAX magnitudes: the f32 tier (the reference's bf16-split
# products, ~98 dB class) and bf16 stores (~50 dB).
PARITY_FLOOR_DB = {"f32": 90.0, "bf16": 45.0}


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.sum((ref - np.asarray(got, np.float64)) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(ref**2) / err)


def analyzer(channels=1, **kw):
    return SpectrumAnalyzer(PipelineConfig(channels=channels, **kw), device="cpu")


def tone(freq=100e3, n=N):
    return jgolden.synth_tone(freq, n).astype(np.float32)[None, :]


# ---------------------------------------------------------------- commands


def test_decoder_commands():
    d = CommandDecoder()
    evs = d.feed(bytes([0x55, 0xB1, 0xEF, 0x42]))
    assert [(e.kind, e.command) for e in evs] == [
        ("command", Command.START), ("command", Command.MODE_BYPASS),
        ("command", Command.COMM_ETH), ("ignored", None),
    ]


def test_decoder_coefficient_shield():
    """During the 12 coefficient bytes, command bytes are data."""
    d = CommandDecoder()
    payload = bytes([0x55, 0xFF, 0xB1, 0x00, 0xA1, 0xEF, 1, 2, 3, 4, 5, 6])
    evs = d.feed(bytes([0xF1]) + payload + bytes([0x55]))
    assert len(evs) == 2 and evs[0].kind == "coefficients"
    assert evs[0].coefficients == payload and evs[1].command == Command.START
    assert not d.busy


def test_decoder_partial_coefficient_stream():
    d = CommandDecoder()
    assert d.feed(bytes([0xF1, 1, 2, 3])) == [] and d.busy
    evs = d.feed(bytes(range(9)))
    assert evs[0].coefficients == bytes([1, 2, 3] + list(range(9)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decoder_matches_jax_on_random_bytes(seed):
    data = bytes(np.random.default_rng(seed).integers(0, 256, 4000, dtype=np.uint8))
    ours, ref = CommandDecoder(), jcommands.CommandDecoder()
    for chunk in (data[:1234], data[1234:]):
        a, b = ours.feed(chunk), ref.feed(chunk)
        assert [(e.kind, e.raw, e.coefficients, e.command and int(e.command)) for e in a] == \
               [(e.kind, e.raw, e.coefficients, e.command and int(e.command)) for e in b]
        assert ours.busy == ref.busy
    assert encode_start_sequence() == jcommands.encode_start_sequence()


# ---------------------------------------------------------------- designer


@pytest.mark.parametrize(
    "kind,btype,order,cutoff",
    [("butterworth", "lowpass", 4, 100e3), ("chebyshev1", "highpass", 2, 200e3),
     ("elliptic", "lowpass", 4, 150e3), ("bessel", "bandpass", 2, (100e3, 300e3)),
     ("chebyshev2", "bandstop", 2, (200e3, 260e3))],
)
def test_designer_wire_bytes_equal_jax(kind, btype, order, cutoff):
    ours = design_iir_filter(kind, btype, order, 1e6, cutoff)
    ref = jdesigner.design_iir_filter(kind, btype, order, 1e6, cutoff)
    np.testing.assert_array_equal(ours.sos, ref.sos)
    wire = ours.to_wire_bytes()
    assert wire == ref.to_wire_bytes() and len(wire) == 12
    np.testing.assert_array_equal(wire_bytes_to_sos(wire), jdesigner.wire_bytes_to_sos(wire))
    np.testing.assert_array_equal(ours.quantized_response()[1], ref.quantized_response()[1])


def test_wire_roundtrip_pads_and_rejects():
    design = design_iir_filter("butterworth", "lowpass", 4, 1e6, 100e3)
    sos_back = wire_bytes_to_sos(design.to_wire_bytes())
    clipped = np.abs(design.sos * 64) > 127
    assert np.max(np.abs(sos_back - design.sos)[~clipped]) <= 0.5 / 64 + 1e-12
    assert np.allclose(wire_bytes_to_sos(sos_to_wire_bytes(
        design_iir_filter("butterworth", "lowpass", 2, 1e6, 100e3).sos))[1], [1, 0, 0, 1, 0, 0])
    with pytest.raises(ValueError, match="wire format"):
        sos_to_wire_bytes(design_iir_filter("elliptic", "lowpass", 8, 1e6, 100e3).sos)


def test_designer_validation():
    with pytest.raises(ValueError, match="cutoff"):
        design_iir_filter("butterworth", "lowpass", 4, 1e6, 600e3)
    with pytest.raises(ValueError, match="band edges"):
        design_iir_filter("butterworth", "bandpass", 4, 1e6, (300e3, 100e3))
    with pytest.raises(ValueError, match="unknown filter kind"):
        design_iir_filter("brickwall", "lowpass", 4, 1e6, 100e3)
    with pytest.raises(ValueError, match="two cutoff"):
        design_iir_filter(btype="bandpass", cutoff_hz=100e3)
    with pytest.raises(ValueError, match="single cutoff"):
        design_iir_filter(btype="lowpass", cutoff_hz=(1e3, 2e3))


# ---------------------------------------------------------------- the facade


def test_analyzer_wire_protocol_end_to_end():
    sa = analyzer()
    x = tone()
    assert sa.process(x) is None  # before START: samples ignored
    sa.handle_bytes(bytes([Command.MODE_BYPASS, Command.START]))
    out = sa.process(x)
    assert sa.stats.frames_produced == 1 and abs(sa.stats.last_peak_bin - 1638) <= 1
    assert out["magnitude"].dtype == np.float32
    design = design_iir_filter("butterworth", "lowpass", 4, 1e6, 50e3)
    sa.handle_bytes(encode_coefficient_upload(design.to_wire_bytes()))
    sa.handle_bytes(bytes([Command.MODE_CUSTOM]))
    out2 = sa.process(x)
    assert out2["magnitude"][0, 0, 1638] < 0.1 * out["magnitude"][0, 0, 1638]
    assert sa.stats.coefficient_uploads == 1
    sa.handle_bytes(bytes([Command.RESET]))
    assert not sa.running and sa.filter_mode == FilterMode.BYPASS
    assert not sa.state.sos_state.any() and sa.custom_sos is not None


def test_analyzer_comm_mode_and_spectrum_hook():
    frames = []
    sa = SpectrumAnalyzer(PipelineConfig(channels=1), device="cpu",
                          on_spectrum=lambda mag, idx: frames.append((idx, mag.shape)))
    sa.handle_bytes(bytes([Command.COMM_UART, Command.START, Command.DATA_REQ]))
    assert sa.comm_mode == CommMode.UART and sa.uart_streaming
    sa.process(np.random.default_rng(0).standard_normal((1, 2 * N)).astype(np.float32))
    assert frames == [(0, (N,)), (1, (N,))]


def test_analyzer_takes_a_tensor_and_reads_only_its_shape():
    sa = analyzer()
    sa.start()
    x = torch.as_tensor(tone(n=2 * N))
    out = sa.process(x)
    assert out["magnitude"].shape == (1, 2, N) and sa.stats.samples_consumed == 2 * N


def test_analyzer_checkpoint_resume_bitwise():
    sa = analyzer()
    sa.handle_bytes(bytes([Command.START, Command.MODE_CUSTOM]))
    sa.upload_filter(sps.butter(8, 0.2, output="sos"))
    rng = np.random.default_rng(2)
    x1, x2 = rng.standard_normal((2, 1, N)).astype(np.float32)
    sa.process(x1)
    ckpt = json.loads(json.dumps({**sa.checkpoint(), "state": None}))
    ckpt["state"] = sa.checkpoint()["state"]
    out_direct = sa.process(x2)
    sb = analyzer()
    sb.restore(ckpt)
    assert np.array_equal(out_direct["magnitude"], sb.process(x2)["magnitude"])
    assert int(sb.state.frame_count) == int(sa.state.frame_count) == 2


def test_rejected_upload_does_not_abort_wire_buffer():
    sa = analyzer()
    bad12 = bytes([64, 0, 0, 64, 127, 127, 64, 0, 0, 64, 0, 0])
    sa.handle_bytes(bytes([0xF1]) + bad12 + bytes([0x55]))
    assert sa.running and sa.stats.uploads_rejected == 1
    assert "unstable" in (sa.last_upload_error or "") and sa.custom_sos is None


def test_bank_checkpoint_roundtrip():
    C = 2
    sa = analyzer(C)
    sa.start()
    sa.upload_filter_bank([sps.butter(8, 0.15, output="sos"), sps.butter(8, 0.45, output="sos")])
    sa.set_filter_mode(FilterMode.CUSTOM)
    x = np.random.default_rng(0).standard_normal((C, N)).astype(np.float32)
    sa.process(x)
    ck = sa.checkpoint()
    assert ck["custom_is_bank"]
    sb = analyzer(C)
    sb.restore(ck)
    assert sb.custom_sos.ndim == 3 and sb.stats.frames_produced == sa.stats.frames_produced
    assert np.array_equal(sa.process(x)["magnitude"], sb.process(x)["magnitude"])


def test_checkpoint_roundtrips_uart_streaming():
    sa = analyzer()
    sa.handle_bytes(bytes([Command.COMM_UART, Command.START, Command.DATA_REQ]))
    sb = analyzer()
    sb.restore(sa.checkpoint())
    assert sb.uart_streaming and sb.comm_mode == sa.comm_mode and sb.running


def test_failed_first_chunk_does_not_poison_stream_kind():
    sa = analyzer()
    sa.start()
    with pytest.raises(ValueError, match="multiple of"):
        sa.process(np.zeros(100, np.float32))
    out = sa.process(np.zeros(N, np.complex64))
    assert out is not None and sa._complex_stream is True
    with pytest.raises(ValueError, match="real and complex"):
        sa.process(np.zeros(N, np.float32))


def test_checkpoint_preserves_undetermined_stream_kind():
    sa = analyzer()
    sa.start()
    sb = analyzer()
    sb.restore(sa.checkpoint())
    assert sb._complex_stream is None
    out = sb.process(np.zeros(N, np.complex64))
    assert out is not None and sb._complex_stream is True


def test_successful_upload_clears_stale_rejection():
    sa = analyzer()
    sa.handle_bytes(bytes([0xF1]) + bytes([64, 0, 0, 64, 127, 127]) * 2)
    assert sa.stats.uploads_rejected == 1 and sa.last_upload_error is not None
    sa.upload_filter(sps.butter(4, 0.2, output="sos"))
    assert sa.last_upload_error is None


def test_mesh_and_missing_gpu_raise(monkeypatch):
    # mesh= on a 1 x 1 mesh (no process group) runs the sharded engine:
    # bit for bit the single-device analyzer; a device beside it is refused
    from tpu_sdr_torch.shard import ShardedSpectrumPipeline, make_sdr_mesh

    mesh = make_sdr_mesh(devices="cpu")
    sa = SpectrumAnalyzer(PipelineConfig(channels=2), mesh=mesh)
    assert isinstance(sa.pipe, ShardedSpectrumPipeline)
    x = np.random.default_rng(5).standard_normal((2, 2 * N)).astype(np.float32) + tone(250e3, 2 * N)
    got, ref = _wire_drive(sa, x), _wire_drive(analyzer(2), x)
    for a, b in zip(got, ref):
        assert np.array_equal(a["magnitude"], b["magnitude"])
    with pytest.raises(ValueError, match="mesh's devices"):
        SpectrumAnalyzer(PipelineConfig(), mesh=mesh, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpectrumAnalyzer(PipelineConfig())


# ---------------------------------------------------------------- against JAX


def _wire_drive(sa, x):
    """bytes -> bypass + start, a chunk; 0xF1 upload + CUSTOM, a chunk;
    an unstable upload (rejected); reset. Returns the two outputs."""
    sa.handle_bytes(bytes([Command.MODE_BYPASS, Command.START]))
    out1 = sa.process(x)
    # a notch at 250 kHz whose coefficients survive the wire's quantization
    d = design_iir_filter("butterworth", "bandstop", 2, 1e6, (230e3, 270e3))
    sa.handle_bytes(encode_coefficient_upload(d.to_wire_bytes()) + bytes([Command.MODE_CUSTOM]))
    out2 = sa.process(x)
    sa.handle_bytes(bytes([0xF1]) + bytes([64, 0, 0, 64, 127, 127]) * 2)
    sa.handle_bytes(bytes([Command.RESET]))
    return out1, out2


def test_wire_driven_run_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 2 * N)).astype(np.float32) + tone(250e3, 2 * N)
    ours = _wire_drive(analyzer(2), x)
    assert ours[1]["magnitude"][0, 1, 4096] < 1e-2 * ours[0]["magnitude"][0, 1, 4096]
    ref_sa = JSpectrumAnalyzer(JPipelineConfig(channels=2))
    ref = _wire_drive(ref_sa, x)
    for a, b in zip(ours, ref):
        assert a["magnitude"].shape == (2, 2, N)
        assert snr_db(np.asarray(b["magnitude"]), a["magnitude"]) >= PARITY_FLOOR_DB["f32"]
    sa = analyzer(2)
    _wire_drive(sa, x)
    for key in ("frames_produced", "samples_consumed", "commands_handled",
                "coefficient_uploads", "uploads_rejected", "resets", "last_peak_bin"):
        assert getattr(sa.stats, key) == getattr(ref_sa.stats, key), key
    np.testing.assert_array_equal(sa.custom_sos, ref_sa.custom_sos)


def test_bf16_io_host_edge_widens_to_float32():
    """bf16_io: the port hands back float32 magnitudes, each exactly a bf16
    value (widened on the host); the reference hands back bfloat16. The
    values agree with the reference's widened to the bf16 floor."""
    x = np.random.default_rng(6).standard_normal((1, N)).astype(np.float32)
    sa = analyzer(dtype="bf16", bf16_io=True)
    sa.start()
    mags = sa.process(x)["magnitude"]
    assert mags.dtype == np.float32
    assert np.array_equal(torch.as_tensor(mags).to(torch.bfloat16).float().numpy(), mags)
    ref_sa = JSpectrumAnalyzer(JPipelineConfig(channels=1, dtype="bf16", bf16_io=True))
    ref_sa.start()
    ref = np.asarray(ref_sa.process(x)["magnitude"])
    assert ref.dtype.name == "bfloat16"
    assert snr_db(ref.astype(np.float32), mags) >= PARITY_FLOOR_DB["bf16"]


@pytest.mark.parametrize("mode", ["BYPASS", "CUSTOM"])
def test_jax_checkpoint_resumes_in_the_port(mode):
    """A JAX analyzer's checkpoint, through convert.analyzer_checkpoint,
    restores into the port's: the command plane, coefficients and counters
    carry over; it continues within tolerance of JAX continuing, and (in
    BYPASS, whose carried history is raw samples) bit for bit like a port
    that ran the same chunks."""
    cfg = dict(channels=2, hop=8192)
    rng = np.random.default_rng(9)
    x1, x2 = rng.standard_normal((2, 2, 2 * N)).astype(np.float32)
    sos = sps.butter(8, 0.2, output="sos")
    ref = JSpectrumAnalyzer(JPipelineConfig(**cfg))
    own = analyzer(**cfg)
    for sa in (ref, own):
        sa.handle_bytes(bytes([Command.START, Command.COMM_UART, Command.DATA_REQ]))
        sa.upload_filter(sos)
        sa.set_filter_mode(FilterMode[mode])
        sa.process(x1)
    resumed = analyzer(**cfg)
    resumed.restore(convert.analyzer_checkpoint(ref.checkpoint()))
    assert resumed.filter_mode == FilterMode[mode] and resumed.uart_streaming
    assert resumed.comm_mode == CommMode.UART and resumed.running
    assert resumed.stats.frames_produced == ref.stats.frames_produced == 4
    np.testing.assert_array_equal(resumed.custom_sos, own.custom_sos)
    got = resumed.process(x2)["magnitude"]
    want = ref.process(x2)["magnitude"]
    mine = own.process(x2)["magnitude"]
    assert snr_db(np.asarray(want, np.float32), got) >= PARITY_FLOOR_DB["f32"]
    if mode == "BYPASS":
        assert np.array_equal(got, mine)
    else:
        assert snr_db(mine, got) >= PARITY_FLOOR_DB["f32"]
    assert resumed.stats.frames_produced == 8 and int(resumed.state.frame_count) == 8


def test_analyzer_checkpoint_conversion_checks_keys():
    with pytest.raises(KeyError, match="running"):
        convert.analyzer_checkpoint({"state": {}, "filter_mode": 0, "comm_mode": 0})
    sa = analyzer()
    sa.start()
    back = convert.analyzer_checkpoint(sa.checkpoint())
    assert back["state"]["sos_state"].shape == (1, 6, 2) and back["running"]
    assert JFilterMode(back["filter_mode"]) == JFilterMode.BYPASS
