"""Window coefficients (the counterpart of ``tpu_sdr.kernels.window``).

The window is a device-resident coefficient vector; the spectrum kernel
multiplies by it as it loads a frame (BYPASS), and the filtered modes
multiply by it before the IIR.
"""

from __future__ import annotations

import torch

from tpu_sdr_torch.control import golden


def hann_coefficients(
    n: int, rtl_faithful: bool = False, *, device="cuda", dtype=torch.float32
) -> torch.Tensor:
    """Window coefficients (n,) on ``device``.

    ``rtl_faithful=True`` reproduces the RTL's effective -cos window; the
    default is the true Hann window. The float64 host values are rounded
    once to ``dtype``.
    """
    w = golden.hann_rtl_effective(n) if rtl_faithful else golden.hann_true(n)
    return torch.as_tensor(w, dtype=dtype, device=device)

