"""Blind IQ imbalance correction (image rejection); the counterpart of
``tpu_sdr.kernels.iqcorr``.

The received stream z = alpha*s + beta*conj(s) of a proper signal s
(E[s^2] = 0) is corrected by the one-tap

    w[n] = z[n] - c * conj(z[n]),   c = E[z^2] / (2 * E[|z|^2])

with the moments taken per 128-sample block, smoothed across blocks by a
leak-rate EMA (the affine chain ``kernels/demod._chain_blocks``, a Python
loop over the blocks: two launches a block on the card; the three moments
walk it together as one stacked chain), block k corrected with the
estimate as of block k-1. The block moments are fixed-order sums
(``ddc.fixed_sum``), so chunked == one-shot bit for bit at block
granularity.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sdr_torch.kernels.ddc import f32, fixed_sum, resolve_device
from tpu_sdr_torch.kernels.demod import _chain_blocks


def _iq_block_update(re, im, m2re0, m2im0, p0, lam: float, block: int):
    """Per-block moment EMAs. Returns (c_re, c_im per block (..., G), the
    PREVIOUS block's estimate ratio; the m2/p finals)."""
    lead = re.shape[:-1]
    G = re.shape[-1] // block
    rb = re.reshape(*lead, G, block)
    ib = im.reshape(*lead, G, block)
    inv = f32(1.0 / block)
    moments = torch.stack([fixed_sum(rb * rb - ib * ib) * inv,  # E[z^2] re
                           fixed_sum(2.0 * rb * ib) * inv,  # E[z^2] im
                           fixed_sum(rb * rb + ib * ib) * inv])  # E[|z|^2]
    # EMA across blocks: m[k] = lam*m[k-1] + (1-lam)*moment[k]; prev are
    # the EMAs BEFORE each block (the causal estimate).
    a = torch.full_like(moments, f32(lam))
    fin, prev = _chain_blocks(a, f32(1.0 - lam) * moments, torch.stack([m2re0, m2im0, p0]))
    denom = torch.clamp_min(2.0 * prev[2], 1e-12)
    return prev[0] / denom, prev[1] / denom, fin[0], fin[1], fin[2]


def _iq_apply(re, im, c_re, c_im, block: int):
    """w = z - c*conj(z), with per-block c (..., G) broadcast over L."""
    lead = re.shape[:-1]
    G = re.shape[-1] // block
    rb = re.reshape(*lead, G, block)
    ib = im.reshape(*lead, G, block)
    cr = c_re[..., None]
    ci = c_im[..., None]
    wre = rb - (cr * rb + ci * ib)
    wim = ib - (ci * rb - cr * ib)
    return wre.reshape(*lead, G * block), wim.reshape(*lead, G * block)


class IQCorrectorState:
    """EMA moments: E[z^2] (re/im) and E[|z|^2], each (...,)."""

    def __init__(self, m2re, m2im, power, offset: int = 0):
        self.m2re = m2re
        self.m2im = m2im
        self.power = power
        self.offset = int(offset)

    def to_numpy(self) -> dict:
        as_np = lambda t: t.detach().cpu().numpy()
        return {
            "m2re": as_np(self.m2re), "m2im": as_np(self.m2im),
            "power": as_np(self.power), "offset": np.int64(self.offset),
        }

    @classmethod
    def from_numpy(cls, d: dict, *, device="cuda") -> "IQCorrectorState":
        as_t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        return cls(as_t(d["m2re"]), as_t(d["m2im"]), as_t(d["power"]), int(d["offset"]))

    def estimate(self):
        """The current corrector tap c = E[z^2]/(2 E[|z|^2]) (host values,
        ~= beta/conj(alpha)): a Python complex for an unbatched state, a
        complex ndarray per batch element otherwise."""
        st = self.to_numpy()
        p = np.maximum(2.0 * np.asarray(st["power"], np.float64), 1e-12)
        c = (np.asarray(st["m2re"], np.float64) / p
             + 1j * np.asarray(st["m2im"], np.float64) / p)
        return complex(c) if c.ndim == 0 else c


class IQCorrector:
    """Streaming blind IQ imbalance corrector on complex planes.

    ``leak`` is the per-block EMA retention (time constant ~
    block/(1-leak) samples). Chunk lengths must be multiples of
    ``block``; chunked == one-shot bitwise. ``device`` None means CUDA."""

    def __init__(self, leak: float = 0.99, block: int = 128, device=None):
        if not (0.0 <= leak < 1.0):
            raise ValueError(f"leak must be in [0, 1); got {leak}")
        self.device = resolve_device(device, "IQCorrector")
        self.leak = float(leak)
        self.block = int(block)

    def initial_state(self, batch_shape: tuple = ()) -> IQCorrectorState:
        z = torch.zeros(tuple(batch_shape), dtype=torch.float32, device=self.device)
        return IQCorrectorState(z, z, z, 0)

    def process(self, re, im, state: IQCorrectorState):
        re = torch.as_tensor(re, dtype=torch.float32, device=self.device)
        im = torch.as_tensor(im, dtype=torch.float32, device=self.device)
        t = re.shape[-1]
        if t % self.block:
            raise ValueError(
                f"chunk length {t} not a multiple of block={self.block}")
        if tuple(state.power.shape) != tuple(re.shape[:-1]):
            raise ValueError(
                f"state shape {tuple(state.power.shape)} != {tuple(re.shape[:-1])}")
        c_re, c_im, fr, fi, fp = _iq_block_update(
            re, im, state.m2re, state.m2im, state.power, self.leak, self.block)
        wre, wim = _iq_apply(re, im, c_re, c_im, self.block)
        return wre, wim, IQCorrectorState(fr, fi, fp, state.offset + t)


def apply_imbalance(z: np.ndarray, gain_db: float, phase_deg: float):
    """Test helper: impair a complex stream with I/Q gain (dB) and phase
    skew (deg): I' = g*I, Q' = Q*cos(phi) + I*sin(phi); host NumPy."""
    g = 10.0 ** (gain_db / 20.0)
    phi = np.deg2rad(phase_deg)
    i = g * z.real
    q = z.imag * np.cos(phi) + z.real * np.sin(phi)
    return i + 1j * q
