"""Host-side (NumPy) window and fixed-filter definitions.

A copy of the parts of ``tpu_sdr.control.golden`` that the spectrum pipeline
needs to build its constants: the two windows and the fixed filter's SOS
cascade. Everything here is float64 NumPy.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sps

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
