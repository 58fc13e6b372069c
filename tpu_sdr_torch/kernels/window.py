"""Window coefficients (the counterpart of ``tpu_sdr.kernels.window``).

The window is a device-resident coefficient vector; the spectrum kernel
multiplies by it as it loads a frame (BYPASS), and the filtered modes
multiply by it before the IIR. ``window_q15`` is the RTL's bit-exact Q15
window multiply on int16 tensors.
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


def hann_q16_rom(n: int, *, device) -> torch.Tensor:
    """The bit-exact int16 ROM contents (``src/hann.vhd:5-6``) on the
    caller's ``device`` (no default: the Q15 pipeline builds its ROM on its
    own device)."""
    return torch.as_tensor(golden.hann_q16_rom(n), device=device)


def apply_window(frames: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """frames (..., N) * w (N,): the whole window 'kernel'."""
    return frames * w


def window_q15(frames_q15: torch.Tensor, rom_q16: torch.Tensor) -> torch.Tensor:
    """Bit-exact RTL window multiply: (x*w)>>15 + the half-LSB bit.

    Reference ``src/hann8192.vhd:36-39``. int16 x int16 -> int32 products;
    the result wraps to int16 like the RTL slice assignment.
    """
    p = frames_q15.to(torch.int32) * rom_q16.to(torch.int32)
    return ((p >> 15) + ((p >> 14) & 1)).to(torch.int16)
