"""Golden CPU reference model (NumPy/SciPy): the oracle for the kernels.

A copy of ``tpu_sdr.control.golden``: the two windows, the RTL's Q15 window
ROM and multiply, the fixed filter's SOS cascade (which the spectrum
pipeline builds its constants from), and the oracles: ``sosfilt_golden``,
``rtl_biquad12_quirky``, ``sosfilt_q15_intended`` (the integer path's
oracle), ``fft_golden``, ``magnitude_golden``, ``golden_pipeline`` and
``synth_tone``. Everything here is NumPy, deliberately slow and simple.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sps

from tpu_sdr_torch.core import qformat as qf

N_DEFAULT = 16384


def hann_true(n: int = N_DEFAULT) -> np.ndarray:
    """The intended window: symmetric Hann, 0.5*(1-cos(2*pi*n/(N-1))).

    The reference generator uses ``scipy.signal.windows.hann(N)``
    (``scripts/hann_coeff.py:4``).
    """
    return sps.windows.hann(n, sym=True).astype(np.float64)


def hann_rtl_effective(n: int = N_DEFAULT) -> np.ndarray:
    """The window the RTL actually applies: 2*hann - 1 = -cos(2*pi*n/(N-1)).

    The ROM stores (hann - 0.5) * 2^16 but the multiplier treats it as a
    plain Q15 coefficient, so the effective gain is 2*(hann - 0.5).
    """
    return 2.0 * hann_true(n) - 1.0


def hann_q16_rom(n: int = N_DEFAULT) -> np.ndarray:
    """Bit-exact RTL Hann ROM: int16 = clip(round((hann - 0.5) * 65536)).

    Reference ``scripts/hann_coeff.py:4-5`` / ``src/hann.vhd:5-6``.
    """
    w = hann_true(n)
    q = np.floor((w - 0.5) * qf.Q16_SCALE + 0.5).astype(np.int64)
    return np.clip(q, qf.INT16_MIN, qf.INT16_MAX).astype(np.int16)


def rtl_window_q15(
    x_q15: np.ndarray,
    phase: int = 0,
    n: int = N_DEFAULT,
    misaligned: bool = False,
) -> np.ndarray:
    """Bit-exact RTL window path: ROM lookup + (x*w)>>15 half-LSB rounding.

    ``phase`` is the window address counter at the first sample (it wraps
    mod n). ``misaligned=True`` multiplies sample k by ROM[k-1], the RTL's
    coefficient/sample misalignment in steady streaming; the default is the
    intended alignment.
    """
    rom = hann_q16_rom(n)
    lag = 1 if misaligned else 0
    idx = (phase + np.arange(len(x_q15)) - lag) % n
    return qf.window_multiply_q15(np.asarray(x_q15, np.int16), rom[idx])


def fixed_filter_sos() -> np.ndarray:
    """The fixed filter bank's intended SOS cascade.

    Two Q7 coefficient sets (``imp/filter_pkg.vhd:54-68``), alternated
    across 6 sections:

      ALPHA: b = [14, 0, -14]/128,  a = [1,  21/128, 107/128]
      BETA : b = [15, 0, -15]/128,  a = [1, -21/128, 107/128]
    """
    alpha = np.array([14 / 128, 0.0, -14 / 128, 1.0, 21 / 128, 107 / 128])
    beta = np.array([15 / 128, 0.0, -15 / 128, 1.0, -21 / 128, 107 / 128])
    return np.stack([alpha, beta, alpha, beta, alpha, beta]).astype(np.float64)


def sosfilt_golden(sos: np.ndarray, x: np.ndarray, zi: np.ndarray | None = None):
    """SciPy sosfilt: the intended filter semantics (transposed DF-II).
    Returns (y, zf)."""
    sos = np.asarray(sos, dtype=np.float64)
    if zi is None:
        zi = np.zeros((sos.shape[0], 2), dtype=np.float64)
    y, zf = sps.sosfilt(sos, np.asarray(x, np.float64), zi=zi)
    return y, zf


def rtl_biquad12_quirky(coeffs_x64: np.ndarray, x_q15: np.ndarray) -> np.ndarray:
    """Simulation of the RTL custom filter datapath with its quirks.

    The RTL difference equation (``imp/filter_iir.vhd:83-87``) is

      y[n] = (B0*x[n-2] + B1*x[n-1] + B2*x[n] - A0*y[n-2] - A1*y[n-1]) >> 7

    with a truncating >> 7, A2 unused, and 6 sections sharing one
    12-coefficient file alternating set0/set1
    (``src/filter_iir12_cust.vhd:67-240``). With the RTL's per-sample state
    zeroing (``imp/filter_iir.vhd:130-151``) only the B2 tap survives:
    y[n] = (B2*x[n]) >> 7 per section.
    """
    c = np.asarray(coeffs_x64, dtype=np.int64)
    if c.shape != (12,):
        raise ValueError(f"need 12 coefficients; got shape {c.shape}")
    # wire order per set: [B0, B1, B2, A0, A1, A2] (fft_analyzer_gui.py:591-613)
    sets = [c[0:6], c[6:12]]
    y = np.asarray(x_q15, dtype=np.int64)
    for s in range(6):
        b = sets[s % 2]
        y = (b[2] * y) >> 7  # truncating shift, int64 arithmetic
        y = np.clip(y, qf.INT16_MIN, qf.INT16_MAX)
    return y.astype(np.int16)


def sosfilt_q15_intended(
    sos_x64: np.ndarray, x_q15: np.ndarray, zi: np.ndarray | None = None
):
    """Integer-path oracle: TDF-II SOS with x64 int coeffs, /64 rounding.

    int8 x64 coefficients, products accumulated in int64, each section
    output scaled back by >> 6 with round-half-away, saturated to int16.
    Returns (y_q15, zf) with zf int64 state (pre-shift accumulators).
    """
    sos = np.asarray(sos_x64, dtype=np.int64)
    if np.any(sos[:, 3] != qf.COEFF_SCALE):
        # The >>6 below IS the /a0 for a0 == 64; any other a0 would need a
        # per-section divide this fixed-point contract does not define.
        raise ValueError(
            "sosfilt_q15_intended is defined for normalized sections "
            f"(a0 == {qf.COEFF_SCALE}); got a0 = {sos[:, 3].tolist()}"
        )
    n_sections = sos.shape[0]
    x = np.asarray(x_q15, dtype=np.int64)
    if zi is None:
        zi = np.zeros((n_sections, 2), dtype=np.int64)
    z = np.array(zi, dtype=np.int64)
    y = np.empty_like(x)
    for n in range(len(x)):
        v = x[n]
        for s in range(n_sections):
            b0, b1, b2, a0, a1, a2 = sos[s]
            out = qf.rshift_round_half_away(b0 * v + z[s, 0], 6)
            out = int(np.clip(out, qf.INT16_MIN, qf.INT16_MAX))
            z[s, 0] = b1 * v - a1 * out + z[s, 1]
            z[s, 1] = b2 * v - a2 * out
            v = out
        y[n] = v
    return y.astype(np.int16), z


def fft_golden(x: np.ndarray) -> np.ndarray:
    """Forward complex DFT, float64: the spectral oracle."""
    return np.fft.fft(np.asarray(x, dtype=np.complex128))


def magnitude_golden(spec: np.ndarray) -> np.ndarray:
    """sqrt(re^2 + im^2) as the GUI computes it (fft_analyzer_gui.py:256-260)."""
    return np.sqrt(spec.real.astype(np.float64) ** 2 + spec.imag.astype(np.float64) ** 2)


def golden_pipeline(
    x: np.ndarray,
    sos: np.ndarray | None = None,
    zi: np.ndarray | None = None,
    window: str = "hann",
    n: int = N_DEFAULT,
):
    """Full intended-math chain on a stream: window -> IIR -> per-frame FFT.

    The window phase counter runs over the continuous stream (mod ``n``),
    filtering follows windowing, and each consecutive n-sample frame is
    transformed. Returns dict with 'windowed', 'filtered', 'spectra' (F, n)
    complex, 'magnitude' (F, n), and 'zf'.
    """
    x = np.asarray(x, dtype=np.float64)
    n_frames = len(x) // n
    x = x[: n_frames * n]
    if window == "hann":
        w = hann_true(n)
    elif window == "rtl":
        w = hann_rtl_effective(n)
    elif window in (None, "none", "rect"):
        w = np.ones(n)
    else:
        raise ValueError(f"unknown window {window!r}")
    xw = (x.reshape(n_frames, n) * w[None, :]).reshape(-1)
    if sos is not None:
        y, zf = sosfilt_golden(sos, xw, zi)
    else:
        y, zf = xw, zi
    frames = y.reshape(n_frames, n)
    spectra = np.fft.fft(frames, axis=-1)
    return {
        "windowed": xw,
        "filtered": y,
        "spectra": spectra,
        "magnitude": magnitude_golden(spectra),
        "zf": zf,
    }


def synth_tone(
    freq_hz: float = 100_000.0,
    n_samples: int = N_DEFAULT,
    fs: float = 1_000_000.0,
    amplitude: float = 0.5,
    noise: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """A synthetic tone at 1 MSPS (the BASELINE config-1 stimulus)."""
    t = np.arange(n_samples, dtype=np.float64) / fs
    x = amplitude * np.sin(2 * np.pi * freq_hz * t)
    if noise > 0:
        rng = np.random.default_rng(seed)
        x = x + noise * rng.standard_normal(n_samples)
    return x
