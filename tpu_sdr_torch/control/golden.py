"""Host-side (NumPy) window and fixed-filter definitions.

A copy of the parts of ``tpu_sdr.control.golden`` that the spectrum pipeline
needs to build its constants: the two windows, the RTL's Q15 window ROM and
multiply, and the fixed filter's SOS cascade. Everything here is NumPy.
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
