"""Filter-bank construction (the counterpart of ``tpu_sdr.runtime.banks``):
SOS validation, padding and operator building for coefficient uploads."""

from __future__ import annotations

import numpy as np
import torch

from tpu_sdr_torch.core.config import PipelineConfig
from tpu_sdr_torch.kernels import biquad
from tpu_sdr_torch.kernels.cuda import iir_fft


def validate_stable(sos: np.ndarray, label: str = "SOS"):
    """Reject sections with poles on/outside the unit circle - the blocked
    operator raises A to the 128th power, which overflows for unstable poles.
    """
    for i, sec in enumerate(np.atleast_2d(sos)):
        if sec[3] == 0.0:
            # np.roots would strip the leading zero and silently pass a
            # section whose a0 normalization divides by zero downstream
            raise ValueError(
                f"{label} section {i} has a0 == 0; refusing upload"
            )
        poles = np.roots(sec[3:6])
        if np.any(np.abs(poles) >= 1.0):
            raise ValueError(
                f"{label} section {i} is unstable (|pole| = "
                f"{np.max(np.abs(poles)):.4f} >= 1); refusing upload"
            )


def prepare_sos(sos, n_sections: int) -> np.ndarray:
    """Pad to the engine's section count and validate stability."""
    sos = biquad.pad_sos(sos, n_sections)
    validate_stable(sos)
    return sos


def build_bank(
    cfg: PipelineConfig, hann_w: torch.Tensor, fft_plan: dict, sos
) -> dict:
    """Build one {op, pp} filter bank on the device of ``hann_w``.

    ``pp`` (the kernel plan) is built exactly when
    ``cfg.pallas_geometry_ok()``, the gate the dispatch shares.
    """
    fb = cfg.fft_size // cfg.iir_block
    op = biquad.precompute_composite(
        sos, cfg.iir_block, fb, device=hann_w.device
    )
    pp = None
    if cfg.pallas_geometry_ok():
        pp = iir_fft.build_plan(sos, hann_w, fft_plan, cfg.iir_block, fb)
    return {"op": op, "pp": pp}
