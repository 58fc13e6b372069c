"""The port's WelchPSD against the JAX package's and ``scipy.signal.welch``,
on the CPU, at 1e-5 of the peak. "median" runs at even and odd segment
counts: an even count averages the two middle periodograms."""

import numpy as np
import pytest
import scipy.signal as sps

from tpu_sdr.runtime.psd import WelchPSD as JWelchPSD
from tpu_sdr_torch.runtime import psd
from tpu_sdr_torch.runtime.psd import WelchPSD

FS = 1e6
REL = 1e-5  # of the peak


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _signal(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    return (0.7 * np.sin(2 * np.pi * 123e3 * t) + 0.05 * rng.standard_normal(n) + 0.3
            ).astype(np.float32)


# (kw, samples as a multiple of nperseg): nseg = 2 * mult - 1 at the default
# half overlap, or mult without overlap.
CASES = {
    "mean odd": (dict(), 8),
    "mean even": (dict(noverlap=0), 8),
    "median odd nseg": (dict(average="median"), 8),
    "median even nseg": (dict(average="median", noverlap=0), 6),
    "median even nseg overlap": (dict(average="median", noverlap=256), 5),
    "spectrum hamming": (dict(scaling="spectrum", window="hamming"), 6),
    "no detrend": (dict(detrend=False), 4),
    "nperseg 1000": (dict(nperseg=1000), 6),
}


@pytest.mark.parametrize("case", list(CASES))
def test_compute_matches_jax_and_scipy(case):
    kw, mult = CASES[case]
    kw = dict(kw)
    nperseg = kw.pop("nperseg", 1024)
    x = _signal(mult * nperseg, 1)
    port = WelchPSD(fs=FS, nperseg=nperseg, device="cpu", **kw)
    ref = JWelchPSD(fs=FS, nperseg=nperseg, **kw)
    nseg = port.segment_count(x.size)
    if case.startswith("median even"):
        assert nseg % 2 == 0
    got = port.compute(x).numpy()
    assert got.dtype == np.float32
    assert _rel(got, ref.compute(x)) < REL
    f_ref, p_ref = sps.welch(x.astype(np.float64), fs=FS, nperseg=nperseg, **kw)
    assert got.shape == p_ref.shape and _rel(got, p_ref) < REL
    assert np.allclose(port.frequencies(), f_ref)


def test_median_even_count_averages_the_middle_pair():
    import torch

    p = torch.tensor([[4.0, 1.0, 3.0, 2.0]]).T  # (4, 1)
    assert psd._median(p, 0).item() == 2.5  # torch.median would give 2.0
    assert psd._median(p[:3], 0).item() == 3.0
    assert psd._median_bias(7) == pytest.approx(sps._spectral_py._median_bias(7))


@pytest.mark.parametrize("average", ["mean", "median"])
def test_compute_iq_matches_jax_and_scipy(average):
    rng = np.random.default_rng(2)
    nperseg = 1024
    t = np.arange(8 * nperseg) / FS
    z = (np.exp(2j * np.pi * (-200e3) * t)
         + 0.1 * (rng.standard_normal(t.size) + 1j * rng.standard_normal(t.size))).astype(np.complex64)
    port = WelchPSD(fs=FS, nperseg=nperseg, average=average, noverlap=0, device="cpu")
    got = port.compute_iq(z.real.copy(), z.imag.copy()).numpy()
    ref = JWelchPSD(fs=FS, nperseg=nperseg, average=average, noverlap=0).compute_iq(
        z.real.copy(), z.imag.copy())
    assert _rel(got, ref) < REL
    _, p_ref = sps.welch(z.astype(np.complex128), fs=FS, nperseg=nperseg, average=average,
                         noverlap=0, return_onesided=False)
    assert got.shape == (nperseg,) and _rel(got, p_ref) < REL
    assert np.allclose(port.frequencies(onesided=False), np.fft.fftfreq(nperseg, 1 / FS))


def test_batched_rows_match_per_row():
    x = np.stack([_signal(4096, s) for s in (3, 4, 5)])
    port = WelchPSD(fs=FS, nperseg=512, device="cpu")
    whole = port.compute(x).numpy()
    assert whole.shape == (3, 257)
    for r in range(3):
        assert _rel(whole[r], port.compute(x[r]).numpy()) < REL


@pytest.mark.parametrize("iq", [False, True], ids=["real", "iq"])
def test_spectrogram_matches_jax_and_scipy(iq):
    nperseg, noverlap = 256, 128
    x = _signal(12 * nperseg, 6)
    xi = _signal(12 * nperseg, 7) if iq else None
    port = WelchPSD(fs=FS, nperseg=nperseg, noverlap=noverlap, device="cpu")
    ref = JWelchPSD(fs=FS, nperseg=nperseg, noverlap=noverlap)
    got = port.spectrogram(x, xi).numpy()
    assert _rel(got, ref.spectrogram(x, xi)) < REL
    sig = x.astype(np.float64) if xi is None else x + 1j * xi.astype(np.float64)
    f, t, sxx = sps.spectrogram(sig, fs=FS, window="hann", nperseg=nperseg, noverlap=noverlap,
                                detrend="constant", scaling="density", mode="psd",
                                return_onesided=not iq)
    assert got.shape == sxx.shape and _rel(got, sxx) < REL
    assert np.allclose(port.segment_times(x.size), t)
    assert np.array_equal(port.segment_times(x.size), ref.segment_times(x.size))


def test_validation_matches_the_reference():
    with pytest.raises(ValueError, match="noverlap"):
        WelchPSD(nperseg=64, noverlap=64, device="cpu")
    with pytest.raises(ValueError, match="scaling"):
        WelchPSD(scaling="power", device="cpu")
    with pytest.raises(ValueError, match="average"):
        WelchPSD(average="max", device="cpu")
    with pytest.raises(ValueError, match="detrend"):
        WelchPSD(detrend="linear", device="cpu")
    port = WelchPSD(nperseg=64, device="cpu")
    with pytest.raises(ValueError, match="compute_iq"):
        port.compute(np.zeros(256, np.complex64))
    with pytest.raises(ValueError, match="at least nperseg"):
        port.compute(np.zeros(32, np.float32))
    assert port.segment_count(1000) == JWelchPSD(nperseg=64).segment_count(1000)
