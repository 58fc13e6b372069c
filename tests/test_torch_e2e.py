"""The full chain on the port (ROADMAP A19), against the JAX package.

``tests/test_e2e.py``'s chain with ``device="cpu"``: command bytes drive
``SpectrumAnalyzer``, its spectra leave as 64 x 1025-byte datagrams over a
loopback socket, ``UdpSpectrumReceiver`` reassembles and decodes them. The
decoded frames are held to the port analyzer's own magnitudes (within int16
quantisation) and to the JAX analyzer's on the same commands and input; a
checkpoint goes through files and back, the port's own and a JAX one.
"""

import json
import time

import numpy as np
import scipy.signal as sps

from tpu_sdr.control import SpectrumAnalyzer as JSpectrumAnalyzer
from tpu_sdr.core.config import PipelineConfig as JPipelineConfig
from tpu_sdr_torch import convert
from tpu_sdr_torch.control import SpectrumAnalyzer, design_iir_filter, golden
from tpu_sdr_torch.control.commands import Command, encode_coefficient_upload
from tpu_sdr_torch.core.config import PipelineConfig
from tpu_sdr_torch.transport.udp_stream import UdpSpectrumReceiver, UdpSpectrumSender

N = 16384
# The port's f32 magnitudes against the JAX package's on the same input
# (tests/test_torch_control.py's floor).
PARITY_FLOOR_DB = 90.0


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.sum((ref - np.asarray(got, np.float64)) ** 2)
    return float("inf") if err == 0 else 10 * np.log10(np.sum(ref**2) / err)


def _session(sa, x):
    """The wire-driven session of tests/test_e2e.py: bypass + start, then a
    designed 50 kHz low-pass uploaded by 0xF1 and CUSTOM. Returns the two
    calls' magnitudes."""
    sa.handle_bytes(bytes([Command.MODE_BYPASS, Command.START]))
    out_bypass = np.asarray(sa.process(x)["magnitude"], np.float32)
    d = design_iir_filter("butterworth", "lowpass", 4, 1e6, 50e3)
    sa.handle_bytes(encode_coefficient_upload(d.to_wire_bytes()))
    sa.handle_bytes(bytes([Command.MODE_CUSTOM]))
    out_custom = np.asarray(sa.process(x)["magnitude"], np.float32)
    return out_bypass, out_custom


def test_full_chain_commands_to_decoded_spectra():
    got = []
    rx = UdpSpectrumReceiver(port=0, bind_ip="127.0.0.1", fps_cap=1e9,
                             on_frame=lambda re, im, mag: got.append(mag.copy()))
    rx.start()
    tx = UdpSpectrumSender("127.0.0.1", rx.port)
    try:
        sa = SpectrumAnalyzer(PipelineConfig(channels=1), device="cpu",
                              on_spectrum=lambda mag, idx: tx.send_spectrum(
                                  mag, np.zeros_like(mag), scale=1.0))
        x = golden.synth_tone(100e3, N).astype(np.float32)[None, :]
        direct = _session(sa, x)
        deadline = time.time() + 10
        while len(got) < 2 and time.time() < deadline:
            time.sleep(0.02)
    finally:
        rx.stop()
        tx.close()
    assert len(got) == 2, f"got {len(got)} frames over UDP"
    # the wire carries int16 re/im; with imag = 0 the decoded magnitude is
    # |round(mag)|, within 0.5 of the direct value
    for frame, mags in zip(got, direct):
        assert np.abs(frame - np.abs(np.rint(mags[0, 0]))).max() <= 0.5
    assert got[1][1638] < 0.05 * got[0][1638]  # the filter acted over the wire
    assert rx.frames_received == 2
    # the JAX analyzer on the same commands and input: each decoded frame is
    # within 1 LSB of rint of the JAX magnitudes
    jax_mags = _session(JSpectrumAnalyzer(JPipelineConfig(channels=1)), x)
    for frame, mags in zip(got, jax_mags):
        assert np.abs(frame - np.abs(np.rint(mags[0, 0]))).max() <= 1.0


def _through_files(ckpt: dict, tmp_path) -> dict:
    """checkpoint() -> ckpt.npz + meta.json -> the dict restore() takes."""
    state = ckpt.pop("state")
    np.savez(tmp_path / "ckpt.npz", **{k: np.asarray(v) for k, v in state.items() if v is not None})
    (tmp_path / "meta.json").write_text(json.dumps(ckpt))
    meta = json.loads((tmp_path / "meta.json").read_text())
    loaded = dict(np.load(tmp_path / "ckpt.npz"))
    meta["state"] = {k: loaded.get(k) for k in ("sos_state", "window_phase", "frame_count", "history")}
    return meta


def _custom(sa):
    sa.handle_bytes(bytes([Command.START, Command.MODE_CUSTOM]))
    sa.upload_filter(sps.ellip(10, 0.5, 60, 0.3, output="sos"))
    return sa


def test_checkpoint_roundtrip_through_files(tmp_path):
    """Checkpoint/resume through an actual file (SURVEY.md §5.4)."""
    rng = np.random.default_rng(5)
    x1 = rng.standard_normal((1, N)).astype(np.float32)
    x2 = rng.standard_normal((1, N)).astype(np.float32)
    sa = _custom(SpectrumAnalyzer(PipelineConfig(channels=1), device="cpu"))
    sa.process(x1)
    sb = SpectrumAnalyzer(PipelineConfig(channels=1), device="cpu")
    sb.restore(_through_files(sa.checkpoint(), tmp_path))
    assert np.array_equal(sa.process(x2)["magnitude"], sb.process(x2)["magnitude"])
    assert int(sb.state.frame_count) == int(sa.state.frame_count)


def test_jax_checkpoint_file_resumes_in_the_port(tmp_path):
    """A JAX analyzer's checkpoint written to files resumes in the port
    (``convert.analyzer_checkpoint``) and continues within the f32 floor of
    the JAX analyzer continuing."""
    rng = np.random.default_rng(6)
    x1 = rng.standard_normal((1, 2 * N)).astype(np.float32)
    x2 = rng.standard_normal((1, 2 * N)).astype(np.float32)
    ref = _custom(JSpectrumAnalyzer(JPipelineConfig(channels=1)))
    ref.process(x1)
    ckpt = _through_files(ref.checkpoint(), tmp_path)
    port = SpectrumAnalyzer(PipelineConfig(channels=1), device="cpu")
    port.restore(convert.analyzer_checkpoint(ckpt))
    assert int(port.state.frame_count) == int(ref.state.frame_count) == 2
    want = np.asarray(ref.process(x2)["magnitude"], np.float32)
    got = port.process(x2)["magnitude"]
    assert snr_db(want, got) >= PARITY_FLOOR_DB
