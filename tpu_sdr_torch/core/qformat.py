"""Fixed-point (Q-format) helpers: the numeric contract of the reference.

A copy of ``tpu_sdr.core.qformat`` (NumPy only), which the port keeps as its
own: the window ROM, the window multiply and the coefficient wire format.

The reference datapath is 16-bit Q15 samples with 8-bit (x64, nominally Q7)
filter coefficients (SURVEY.md §2.6). These helpers implement the exact
rounding/scaling rules so the "rtl-faithful" integer path can be tested
bit-for-bit against a NumPy model, while the default f32 path only needs to
stay inside the quantization SNR envelope.

Contract (with reference citations):
- window coefficients: int16 = round((hann(n) - 0.5) * 2^16), clipped
  (``scripts/hann_coeff.py:4-5``);
- window multiply: (x * w) >> 15 with half-LSB rounding — the RTL computes
  ``product(31:15) + product(14)`` (``src/hann8192.vhd:36-39``);
- filter coefficients: int8 = clip(round(c * 64)) with no a0 normalization
  (``scripts/fft_analyzer_gui.py:159-179``); the *intended* engine scale is
  /64 (designer preview semantics), while the RTL truncates products >> 7
  (= /128, ``imp/filter_iir.vhd:83-87``) — a documented divergence;
- FFT: scaled fixed-point with truncation in the reference IP (default 1/N
  schedule — the RTL never writes the config channel); the integer path
  models it per-stage in ``tpu_sdr/kernels/fft_q15.py`` (schedule-faithful
  truncating shifts, Q15 twiddles), yielding the int16 wire words.
"""

from __future__ import annotations

import numpy as np

Q15_SCALE = 1 << 15
Q16_SCALE = 1 << 16
COEFF_SCALE = 64  # designer quantization step (fft_analyzer_gui.py:168)


def xfft_wire_scale(n: int = 16384) -> float:
    """float-spectrum -> wire-int16 scale implied by the xfft default
    scaling schedule: wire = (1/N)*FFT(x_q15) = (2^15/N)*FFT(x_float) for
    Q15-normalized float samples — 2.0 at the reference's N = 16384.
    Single source of truth; the per-stage integer model lives in
    ``tpu_sdr/kernels/fft_q15.py``."""
    return Q15_SCALE / float(n)

INT16_MIN, INT16_MAX = -(1 << 15), (1 << 15) - 1
INT8_MIN, INT8_MAX = -128, 127


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """Round-half-away-from-zero (floor(x+0.5) would round negative ties UP,
    disagreeing with ``rshift_round_half_away`` by 1 LSB on ties)."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def to_q15(x, clip: bool = True):
    """float in [-1, 1) -> int16 Q15 with round-half-away-from-zero."""
    x = np.asarray(x, dtype=np.float64)
    q = _round_half_away(x * Q15_SCALE).astype(np.int64)
    if clip:
        q = np.clip(q, INT16_MIN, INT16_MAX)
    return q.astype(np.int16)


def from_q15(q):
    return np.asarray(q, dtype=np.float64) / Q15_SCALE


def adc12_to_q16(raw12):
    """12-bit unsigned XADC code (in result bits [15:4]) -> signed 16-bit.

    The reference sign-extends the 16-bit DRP word arithmetically >> 4
    (``imp/dsp_system_top.vhd:435``); a raw 12-bit code c placed in [15:4]
    therefore maps to the signed value of (c << 4) >> 4.
    """
    raw12 = np.asarray(raw12, dtype=np.int64) & 0xFFF
    word = (raw12 << 4).astype(np.int16)  # wraps => sign bit from bit 15
    return (word >> 4).astype(np.int16)


def window_multiply_q15(x_q15, w_q16):
    """RTL window multiply: 16x16 -> 32, take [31:15] + half-LSB rounding bit.

    Reference ``src/hann8192.vhd:36-39``: sample_out <= product(31 downto 15)
    + product(14). Note the slice keeps 17 bits then assigns to 16 — the RTL
    relies on the product magnitude never filling bit 31; we reproduce the
    arithmetic value with int64 then wrap to int16.
    """
    p = np.asarray(x_q15, dtype=np.int64) * np.asarray(w_q16, dtype=np.int64)
    out = (p >> 15) + ((p >> 14) & 1)
    return out.astype(np.int16)


def quantize_coeff_x64(c):
    """Designer coefficient quantization: clip(round(c*64)) to int8.

    Reference ``scripts/fft_analyzer_gui.py:168-175``. No a0 normalization is
    performed by the reference; our designer normalizes SOS by a0 *before*
    quantization (scipy emits a0=1 sections anyway) so behavior is identical
    for designed filters.
    """
    c = np.asarray(c, dtype=np.float64)
    # np.round = round-half-even, matching the reference's np.round exactly
    # (a floor(x+0.5) half-up would differ on .5 ties)
    q = np.round(c * COEFF_SCALE).astype(np.int64)
    return np.clip(q, INT8_MIN, INT8_MAX).astype(np.int8)


def dequantize_coeff_x64(q):
    """Engine-side dequantization: /64 (the *intended* designer semantics).

    The RTL instead divides biquad products by 128 (``imp/filter_iir.vhd:87``:
    slice (22 downto 7)), halving every tap — quirks register item (d).
    """
    return np.asarray(q, dtype=np.float64) / COEFF_SCALE


def rshift_round_half_away(x, n: int):
    """Arithmetic >> n with round-half-away-from-zero, elementwise int64."""
    x = np.asarray(x, dtype=np.int64)
    bias = (1 << (n - 1)) if n > 0 else 0
    return np.where(x >= 0, (x + bias) >> n, -((-x + bias) >> n))


def rshift_trunc(x, n: int):
    """Arithmetic >> n with truncation toward -inf (what VHDL slicing does)."""
    return np.asarray(x, dtype=np.int64) >> n


def q15_snr_db(ref, test) -> float:
    """SNR of `test` against `ref` in dB (both float arrays)."""
    ref = np.asarray(ref, dtype=np.float64)
    err = np.asarray(test, dtype=np.float64) - ref
    p_sig = float(np.mean(ref**2))
    p_err = float(np.mean(err**2))
    if p_err == 0.0:
        return float("inf")
    return 10.0 * np.log10(max(p_sig, 1e-300) / p_err)
