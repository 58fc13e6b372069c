"""Overlapped (STFT) framing in the port: hop < fft_size with carried
history, against the golden STFT, its own chunking contract and the JAX
package (the same seeded NumPy inputs through both; JAX's kernels in
Pallas interpret mode)."""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from tpu_sdr.control import golden as jgolden
from tpu_sdr.core.config import FilterMode as JFilterMode
from tpu_sdr.core.config import PipelineConfig as JPipelineConfig
from tpu_sdr.runtime import SpectrumPipeline as JSpectrumPipeline
from tpu_sdr_torch import FilterMode, PipelineConfig, SpectrumAnalyzer, SpectrumPipeline
from tpu_sdr_torch import convert
from tpu_sdr_torch.control import golden
from tpu_sdr_torch.kernels.cuda import launch

torch.set_num_threads(1)

N = 16384
SOS = sps.butter(12, 0.3, output="sos")
# Port vs JAX on the same input: the default (f32) tier runs the
# reference's "high3" bf16-split products (~98 dB class), the port IEEE
# fp32 (as tests/test_torch_stream.py's PARITY_FLOOR_DB["f32"]).
PARITY_FLOOR_DB = 90.0


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.sum((ref - np.asarray(got, np.float64)) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(ref**2) / err)


@pytest.fixture(scope="module")
def pipe():
    p = SpectrumPipeline(PipelineConfig(hop=8192), device="cpu")
    p.upload_sos(SOS)
    return p


def test_hop_matches_golden_stft(pipe):
    x = np.random.default_rng(0).standard_normal(4 * N).astype(np.float32)
    out, st = pipe.process(x, pipe.initial_state(), FilterMode.CUSTOM)
    mag = out["magnitude"].numpy()[0]
    assert mag.shape == (8, N) and int(st.frame_count) == 8
    yf, _ = sps.sosfilt(SOS, x.astype(np.float64), zi=np.zeros((6, 2)))
    ext = np.concatenate([np.zeros(8192), yf])
    w = golden.hann_true(N)
    for k in (0, 3, 7):
        ref = np.abs(np.fft.fft(ext[k * 8192 : k * 8192 + N] * w))
        assert np.abs(mag[k] - ref).max() / ref.max() < 1e-5


@pytest.mark.parametrize("mode", ["CUSTOM", "BYPASS"])
@pytest.mark.parametrize("chunks", [2, 4])
def test_hop_chunked_bit_exact(pipe, chunks, mode):
    x = np.random.default_rng(1).standard_normal(4 * N).astype(np.float32)
    out_w, st_w = pipe.process(x, pipe.initial_state(), FilterMode[mode])
    st = pipe.initial_state()
    mags = []
    for c in np.split(x, chunks):
        o, st = pipe.process(c, st, FilterMode[mode])
        mags.append(o["magnitude"])
    assert torch.equal(torch.cat(mags, dim=1), out_w["magnitude"])
    assert torch.equal(st.history, st_w.history)
    assert torch.equal(st.sos_state, st_w.sos_state)


def test_hop_bypass_mode(pipe):
    x = jgolden.synth_tone(100e3, 2 * N).astype(np.float32)
    out, _ = pipe.process(x, pipe.initial_state(), FilterMode.BYPASS)
    mag = out["magnitude"].numpy()[0]
    assert mag.shape == (4, N)
    # steady-state frames (past the zero-history transient) show the tone
    assert abs(int(np.argmax(mag[3][: N // 2])) - 1638) <= 1


def test_hop_validation():
    with pytest.raises(ValueError, match="divide"):
        PipelineConfig(hop=10000)
    p = SpectrumPipeline(PipelineConfig(hop=8192), device="cpu")
    with pytest.raises(ValueError, match="multiple of"):
        p.process(np.zeros(8192, np.float32), p.initial_state())


def test_hop_nonstandard_iir_block_takes_the_plain_path():
    """hop + iir_block != 128: no kernel plan, the plain path gives
    correct spectra."""
    p = SpectrumPipeline(PipelineConfig(hop=8192, iir_block=64), device="cpu")
    sos = sps.butter(8, 0.25, output="sos")
    p.upload_sos(sos)
    assert p.bank_custom["pp"] is None
    x = jgolden.synth_tone(100e3, 2 * N).astype(np.float32)
    launch.reset_counts()
    out, _ = p.process(x, p.initial_state(), FilterMode.CUSTOM)
    mag = out["magnitude"].numpy()[0]
    assert mag.shape == (4, N) and np.isfinite(mag).all()
    assert not any(launch.counts["plain"].values())
    yf, _ = sps.sosfilt(sos, x.astype(np.float64), zi=np.zeros((4, 2)))
    ext = np.concatenate([np.zeros(8192), yf])
    ref = np.abs(np.fft.fft(ext[3 * 8192 : 3 * 8192 + N] * golden.hann_true(N)))
    assert np.abs(mag[3] - ref).max() / ref.max() < 1e-5


def test_hop_kernel_path_windows_raw_frames(pipe):
    """Magnitude output takes the spectrum kernel's plain version with the
    window inside it, once per dispatch."""
    launch.reset_counts()
    pipe.process(np.zeros(2 * N, np.float32), pipe.initial_state(), FilterMode.CUSTOM)
    assert launch.counts["plain"]["spectrum_bypass"] == 1
    assert sum(launch.counts["plain"].values()) == 1


@pytest.fixture(scope="module")
def jax_pairs():
    cache = {}

    def get(hop):
        if hop not in cache:
            jp = JSpectrumPipeline(JPipelineConfig(channels=2, hop=hop))
            p = SpectrumPipeline(PipelineConfig(channels=2, hop=hop), device="cpu")
            jp.upload_sos(SOS)
            p.upload_sos(SOS)
            cache[hop] = jp, p
        return cache[hop]

    return get


@pytest.mark.parametrize("mode", ["BYPASS", "FIXED", "CUSTOM"])
@pytest.mark.parametrize("hop", [8192, 4096])
def test_hop_matches_jax(jax_pairs, hop, mode):
    """Magnitude (the kernel path) and all outputs (the plain path), then a
    JAX hop state carried into the port by convert.state continues like
    JAX."""
    jp, p = jax_pairs(hop)
    rng = np.random.default_rng(hop)
    x1, x2 = rng.standard_normal((2, 2, 2 * N)).astype(np.float32)
    frames = 2 * N // hop
    for outputs in ("magnitude", "all"):
        jout, jst = jp.process(x1, jp.initial_state(), JFilterMode[mode], outputs)
        out, st = p.process(x1, p.initial_state(), FilterMode[mode], outputs)
        assert set(out) == set(jout)
        for key in out:
            ref = np.asarray(jout[key])
            assert out[key].shape == ref.shape == (2, frames, N), key
            if key != "phase":
                assert snr_db(ref, out[key].numpy()) >= PARITY_FLOOR_DB, (key, outputs)
        np.testing.assert_allclose(st.history.numpy(), np.asarray(jst.history), rtol=1e-5, atol=1e-5)
        assert int(st.frame_count) == int(jst.frame_count) == frames
        assert int(st.window_phase) == int(jst.window_phase) == 0
    carried = convert.state(jst.to_numpy(), device="cpu")
    assert carried.history.shape == (2, N - hop)
    jout2, _ = jp.process(x2, jst, JFilterMode[mode])
    out2, st2 = p.process(x2, carried, FilterMode[mode])
    assert snr_db(np.asarray(jout2["magnitude"]), out2["magnitude"].numpy()) >= PARITY_FLOOR_DB
    assert int(st2.frame_count) == 2 * frames


def test_hop_iq_input_takes_the_plain_complex_path():
    p = SpectrumPipeline(PipelineConfig(hop=8192), device="cpu")
    n = np.arange(2 * N)
    xc = np.exp(2j * np.pi * 1638 * n / N).astype(np.complex64)
    launch.reset_counts()
    out, st = p.process(xc, p.initial_state(batch_shape=(2,)), FilterMode.BYPASS)
    assert not any(launch.counts["plain"].values())
    mag = out["magnitude"].numpy()[0]
    assert mag.shape == (4, N) and st.history.shape == (2, 1, 8192)
    assert int(np.argmax(mag[3])) == 1638 and mag[3][N - 1638] < 1e-3 * mag[3][1638]


def test_analyzer_hop_frame_count():
    """frames_produced counts hop frames, not fft_size frames."""
    idxs = []
    sa = SpectrumAnalyzer(
        PipelineConfig(channels=1, hop=8192),
        on_spectrum=lambda mag, i: idxs.append(i),
        device="cpu",
    )
    sa.start()
    x = np.zeros((1, 2 * N), np.float32)
    sa.process(x)
    sa.process(x)
    assert sa.stats.frames_produced == 8
    assert idxs == list(range(8))


def test_hop_golden_helper_is_the_reference_window():
    assert np.array_equal(golden.hann_true(N), jgolden.hann_true(N))
