"""The float64 reference against SciPy and NumPy, and at tiny sizes against
the port's CPU path (its kernels' plain versions)."""

import numpy as np
import pytest
import scipy.signal as sps

from sdrbench import check, reference
from sdrbench.reference import chain

N = 16384


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def test_window_is_the_symmetric_hann():
    np.testing.assert_allclose(reference.hann(N), sps.windows.hann(N, sym=True), rtol=0, atol=1e-15)


def test_bypass_is_the_fft_of_each_windowed_frame(rng):
    x = rng.standard_normal(3 * N)
    got = reference.magnitudes_real(x, N)
    want = np.abs(np.fft.fft(x.reshape(3, N) * sps.windows.hann(N), axis=-1))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


def test_the_filter_runs_on_the_windowed_stream_with_its_state_carried(rng):
    sos = sps.butter(12, 0.2, output="sos")
    x = rng.standard_normal(3 * N)
    got = reference.magnitudes_real(x, N, sos)
    zi = np.zeros((6, 2))
    frames = []
    for f in range(3):
        y, zi = sps.sosfilt(sos, x[f * N:(f + 1) * N] * sps.windows.hann(N), zi=zi)
        frames.append(np.abs(np.fft.fft(y)))
    np.testing.assert_allclose(got, np.stack(frames), rtol=1e-10, atol=1e-9)


def test_complex_frames(rng):
    xr, xi = rng.standard_normal((2, 2 * N))
    got = reference.magnitudes_complex(xr, xi, N)
    want = np.abs(np.fft.fft((xr + 1j * xi).reshape(2, N) * sps.windows.hann(N), axis=-1))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


def test_tf32_keeps_ten_mantissa_bits_rounding_to_nearest_even():
    ulp = 2.0 ** -10
    x = np.array([1.0, 1.0 + ulp, 1.0 + ulp / 2, 1.0 + 3 * ulp / 2, 1.0 + ulp / 4, -3.0 - ulp / 4],
                 np.float32)
    np.testing.assert_array_equal(chain.to_tf32(x),
                                  np.array([1.0, 1.0 + ulp, 1.0, 1.0 + 2 * ulp, 1.0, -3.0], np.float32))


@pytest.mark.parametrize("precision", ["float64", "tf32"])
def test_precision_is_validated_and_tf32_departs_from_float64(rng, precision):
    x = rng.standard_normal(N)
    sos = sps.butter(12, 0.1, output="sos")
    ref = reference.magnitudes_real(x, N, sos)
    err = check.frame_errors(reference.magnitudes_real(x, N, sos, precision), ref, ref.max(axis=-1)).max()
    if precision == "float64":
        assert err == 0.0
    else:
        assert 1e-6 < err < 1e-1
    with pytest.raises(ValueError):
        reference.magnitudes_real(x, N, sos, "bfloat16")


@pytest.mark.parametrize("design", [
    sps.butter(12, 0.05, output="sos"),
    sps.butter(6, [0.1, 0.14], "bandpass", output="sos"),
    sps.butter(12, 0.8, "highpass", output="sos"),
])
def test_state_matrix_advances_the_state_as_sosfilt_does(rng, design):
    z = rng.standard_normal((6, 2))
    _, zf = sps.sosfilt(design, np.zeros(50), zi=z)
    got = np.linalg.matrix_power(chain.state_matrix(design), 50) @ z.reshape(-1)
    np.testing.assert_allclose(got, zf.reshape(-1), rtol=1e-9, atol=1e-12 * np.abs(zf).max())


def test_settle_frames_rebuilds_the_chunk_as_the_whole_stream(rng):
    sos = sps.butter(6, [0.02, 0.025], "bandpass", output="sos")
    settle = reference.settle_frames(sos, N)
    x = rng.standard_normal(6 * N)
    whole = reference.magnitudes_real(x, N, sos)[-1]
    rebuilt = reference.magnitudes_real(x[(5 - settle) * N:], N, sos)[-1]
    assert check.frame_errors(rebuilt, whole, whole.max()) < 1e-12
    with pytest.raises(ValueError):
        reference.settle_frames(sps.butter(2, 1e-6, output="sos"), 64, max_frames=4)


def test_stream_rebuilds_frames_from_the_ring():
    n, f = 4, 2
    ring = np.arange(3 * 2 * f * n, dtype=np.float32).reshape(3, 2, f * n)
    stream = check.Stream(ring, n, f)
    # chunk 4 is ring slot 1; its frames are stream frames 8 and 9
    np.testing.assert_array_equal(stream.frames(1, 8, 10), ring[1, 1])
    np.testing.assert_array_equal(stream.frames(0, 5, 7), np.concatenate([ring[2, 0, n:], ring[0, 0, :n]]))


# ------------------------------------------------------------ against the port, on the CPU

torch = pytest.importorskip("torch")

# The port computes in IEEE fp32; the reference in float64. On these designs
# the plain fp32 path reads under 1e-6 of a frame's peak; 1e-5 leaves room
# for the blocked IIR's rounding on other inputs.
PORT_LIMIT = 1e-5


def _port_pipeline(channels):
    from tpu_sdr_torch import PipelineConfig, SpectrumPipeline

    return SpectrumPipeline(PipelineConfig(channels=channels), device="cpu")


def test_port_bank_matches_the_reference_chunk_by_chunk(rng):
    from tpu_sdr_torch import FilterMode

    bank = np.stack([sps.butter(12, 0.1, output="sos"),
                     sps.butter(6, [0.2, 0.3], "bandpass", output="sos")])
    pipe = _port_pipeline(2)
    pipe.upload_sos_bank(bank)
    x = (0.3 * np.sin(0.3 * np.arange(3 * N)) + 0.01 * rng.standard_normal((2, 3 * N))).astype(np.float32)
    state = pipe.initial_state()
    got = []
    for k in range(3):  # three chunks of one frame, the state carried
        out, state = pipe.process(x[:, k * N:(k + 1) * N], state, FilterMode.CUSTOM)
        got.append(out["magnitude"].numpy())
    got = np.concatenate(got, axis=1)
    for c in range(2):
        ref = reference.magnitudes_real(x[c], N, bank[c])
        err = check.frame_errors(got[c], ref, ref.max(axis=-1)).max()
        assert err < PORT_LIMIT, (c, err)


def test_port_bypass_and_iq_planes_match_the_reference(rng):
    from tpu_sdr_torch import FilterMode

    pipe = _port_pipeline(2)
    x = rng.standard_normal((2, 2 * N)).astype(np.float32)
    out, _ = pipe.process(x, pipe.initial_state(), FilterMode.BYPASS)
    for c in range(2):
        ref = reference.magnitudes_real(x[c], N)
        assert check.frame_errors(out["magnitude"][c].numpy(), ref, ref.max(axis=-1)).max() < PORT_LIMIT
    planes = rng.standard_normal((2, 2, 2 * N)).astype(np.float32)
    out, _ = pipe.process_planes(planes, pipe.initial_state(batch_shape=(2,)), FilterMode.BYPASS)
    for c in range(2):
        ref = reference.magnitudes_complex(planes[0, c], planes[1, c], N)
        assert check.frame_errors(out["magnitude"][c].numpy(), ref, ref.max(axis=-1)).max() < PORT_LIMIT
