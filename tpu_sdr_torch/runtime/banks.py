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


def prepare_bank(sos_bank, channels: int, n_sections: int) -> np.ndarray:
    """Normalize a per-channel bank: (C, S, 6) array or list of designs
    (orders may differ; each padded per channel), stability-validated.
    """
    if isinstance(sos_bank, (list, tuple)):
        bank_list = [np.atleast_2d(np.asarray(s, np.float64)) for s in sos_bank]
    else:
        arr = np.asarray(sos_bank, np.float64)
        if arr.ndim == 2:
            # one (S, 6) design -> a 1-channel bank (np.atleast_3d would
            # append the axis and mangle the rows)
            arr = arr[None]
        bank_list = [arr[c] for c in range(arr.shape[0])]
    if len(bank_list) != channels:
        raise ValueError(
            f"bank has {len(bank_list)} channel filters; config has "
            f"{channels} channels"
        )
    padded = []
    for c, sos in enumerate(bank_list):
        sos = biquad.pad_sos(sos, n_sections)
        validate_stable(sos, label=f"channel {c}")
        padded.append(sos)
    return np.stack(padded)


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


def build_channel_bank_op(
    cfg: PipelineConfig, sos_bank_padded: np.ndarray, device
) -> biquad.BlockedSOSComposite:
    """Per-channel composite operator stack from a prepared (C, S, 6) bank,
    built on ``device``."""
    return biquad.precompute_composite_bank(
        sos_bank_padded, cfg.iir_block, cfg.fft_size // cfg.iir_block, device=device
    )
