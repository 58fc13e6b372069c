"""Spectrum-analyzer measurement functions (capability extension).

A copy of ``tpu_sdr.runtime.measure`` (host NumPy code, no tensors): the
port imports nothing of ``tpu_sdr``.

The reference GUI reports only the single peak bin/magnitude
(``scripts/fft_analyzer_gui.py:415-455``); a production analyzer also
measures. Host-side NumPy on already-reduced spectra (these operate on
one PSD/magnitude row, not the sample stream — device work would be
waste):

- ``channel_power``: integrate a PSD over a band (W, given V^2/Hz in).
- ``occupied_bandwidth``: the band holding a fraction of total power
  with equal tails outside (the ITU-style 99% OBW measurement).
- ``peak_search``: top-k local maxima with quadratic (parabolic)
  sub-bin interpolation of frequency and level — the standard
  marker-table estimator.

All golden-tested against closed-form synthetic signals
(tests/test_measure.py).
"""

from __future__ import annotations

import numpy as np


def channel_power(
    pxx: np.ndarray, freqs: np.ndarray, f_lo: float, f_hi: float
) -> float:
    """Integrated power of a PSD (V^2/Hz) over [f_lo, f_hi] -> V^2.

    Rectangular integration over the bins whose centers fall in-band
    (each PSD bin already represents its bin-width's power density).
    """
    pxx = np.asarray(pxx, np.float64)
    freqs = np.asarray(freqs, np.float64)
    if pxx.shape != freqs.shape:
        raise ValueError(f"pxx {pxx.shape} vs freqs {freqs.shape}")
    if freqs.size < 2:
        raise ValueError("need at least 2 bins to infer the bin width")
    if f_hi <= f_lo:
        raise ValueError(f"need f_lo < f_hi; got [{f_lo}, {f_hi}]")
    df = float(np.median(np.diff(np.sort(freqs))))
    mask = (freqs >= f_lo) & (freqs <= f_hi)
    return float(pxx[mask].sum() * df)


def occupied_bandwidth(
    pxx: np.ndarray, freqs: np.ndarray, fraction: float = 0.99
) -> tuple[float, float, float]:
    """(f_lo, f_hi, obw): the smallest frequency span, with equal power
    tails outside, containing ``fraction`` of the total power.

    Frequencies must be sorted ascending (use fftshifted two-sided PSDs).
    """
    pxx = np.asarray(pxx, np.float64)
    freqs = np.asarray(freqs, np.float64)
    if pxx.shape != freqs.shape:
        raise ValueError(f"pxx {pxx.shape} vs freqs {freqs.shape}")
    if not 0.0 < fraction < 1.0:
        raise ValueError(f"fraction must be in (0, 1); got {fraction}")
    if np.any(np.diff(freqs) <= 0):
        raise ValueError("freqs must be sorted ascending (fftshift first)")
    c = np.cumsum(pxx)
    total = c[-1]
    if total <= 0:
        raise ValueError("no power in spectrum")
    tail = (1.0 - fraction) / 2.0
    lo = int(np.searchsorted(c, tail * total))
    hi = int(np.searchsorted(c, (1.0 - tail) * total))
    hi = min(hi, freqs.size - 1)
    return float(freqs[lo]), float(freqs[hi]), float(freqs[hi] - freqs[lo])


def _parabolic(ym1: float, y0: float, yp1: float) -> tuple[float, float]:
    """Vertex offset (in bins, in [-0.5, 0.5]) and value of the parabola
    through three equally spaced points."""
    denom = ym1 - 2.0 * y0 + yp1
    if denom == 0.0:
        return 0.0, y0
    d = 0.5 * (ym1 - yp1) / denom
    return d, y0 - 0.25 * (ym1 - yp1) * d


def refine_peak(
    spectrum: np.ndarray, i: int, db: bool = True
) -> tuple[float, float]:
    """(sub-bin offset, interpolated level) of the local maximum at bin i.

    Parabolic interpolation across the two neighbors, in dB when ``db``
    (the standard estimator for windowed-FFT tones). Edge bins return
    offset 0 and their own level."""
    y = np.asarray(spectrum, np.float64)
    if not 0 < i < y.size - 1:
        return 0.0, float(y[i])
    tri = y[i - 1 : i + 2]
    if db:
        tri = 20.0 * np.log10(np.maximum(tri, 1e-300))
    d, v = _parabolic(*tri)
    return float(d), float(10.0 ** (v / 20.0) if db else v)


def peak_search(
    spectrum: np.ndarray,
    freqs: np.ndarray,
    k: int = 5,
    min_separation_bins: int = 3,
    db: bool = True,
) -> list[dict]:
    """Top-k local maxima of a magnitude (or PSD) row, strongest first.

    Each peak is refined with quadratic interpolation (in dB when ``db``,
    the standard estimator for windowed-FFT tones) across its two
    neighbors: returns dicts {bin, freq_hz, level} where ``level`` is in
    the input's units (interpolated). Peaks closer than
    ``min_separation_bins`` to a stronger peak are suppressed.
    """
    y = np.asarray(spectrum, np.float64)
    freqs = np.asarray(freqs, np.float64)
    if y.ndim != 1 or y.shape != freqs.shape:
        raise ValueError(f"need matching 1-D arrays; {y.shape} vs {freqs.shape}")
    if k < 1 or min_separation_bins < 1:
        raise ValueError("k and min_separation_bins must be >= 1")
    n = y.size
    order = np.argsort(y)[::-1]
    taken: list[int] = []
    out = []
    df = float(np.median(np.diff(freqs))) if n > 1 else 0.0
    for idx in order:
        i = int(idx)
        # local-max test including the edges (an edge bin must still beat
        # its one neighbor — a sloped floor's low edge is NOT a peak)
        if (i > 0 and y[i] < y[i - 1]) or (i < n - 1 and y[i] < y[i + 1]):
            continue
        if any(abs(i - j) < min_separation_bins for j in taken):
            continue
        d, level = refine_peak(y, i, db=db)
        out.append(
            {
                "bin": i,
                "freq_hz": float(freqs[i] + d * df),
                "level": level,
            }
        )
        taken.append(i)
        if len(out) == k:
            break
    return out


def frequency_offset(re, im, fs: float) -> float:
    """Carrier-frequency offset of a complex baseband (..., T) -> Hz.

    The single-lag (Kay / Luise-Reggiannini L=1) phase-increment
    estimator: fhat = fs/(2*pi) * angle(sum_n z[n]*conj(z[n-1])) —
    exact for a noiseless tone, unbiased for tones in AWGN, range
    +/- fs/2. Feed it a DDC/Receiver baseband and ``retune(center +
    fhat)`` closes the AFC loop. Host-side NumPy (a measurement, not a
    hot kernel), averaged over any leading batch dims.
    """
    z = np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)
    if z.shape[-1] < 2:
        raise ValueError("need at least 2 samples")
    acc = np.sum(z[..., 1:] * np.conj(z[..., :-1]))
    return float(np.angle(acc) * fs / (2.0 * np.pi))
