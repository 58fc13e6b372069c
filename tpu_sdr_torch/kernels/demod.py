"""Demodulators: FM quadrature discriminator, AM envelope, SSB product
detector, a block-scan AGC and a carrier-power squelch.

The counterpart of ``tpu_sdr.kernels.demod``.

- The FM discriminator is ``f[n] = angle(z[n] * conj(z[n-1])) * fs / 2pi``
  with one complex sample of carried state. Its atan2 is ``atan2_ieee``:
  ``torch.atan`` on the octant-reduced ratio with the signs restored from
  the IEEE sign bits. ``torch.atan2``'s CPU kernel computes the elements of
  a vector body and of a scalar tail with different code, so the same
  sample rounds differently at different positions of a chunk; ``atan`` and
  the reduction do not (tested).
- Every recurrence (de-emphasis pole, DC blocker, AGC loop, squelch EMA) is
  a first-order affine recurrence ``y[n] = a[n]*y[n-1] + b[n]`` solved by
  one blocked prefix solver: a Hillis-Steele composition inside fixed
  128-sample blocks plus a sequential chain across blocks (``_chain_blocks``,
  a Python loop over the blocks: two small launches a block on a GPU).
  Chunked == one-shot BITWISE for any block-multiple chunking.
- The SSB product detector reuses the DDC's exact NCO for the BFO.

``FMDemodulator(use_pallas=True)`` runs the fused FM kernel
(``kernels/cuda/affine_scan.fm_demod_pallas``) instead.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as nnf

from tpu_sdr_torch.kernels.ddc import (
    _nco_cos_sin,
    _principal_alias_hz,
    _tuning_word,
    _u32,
    f32,
    fixed_sum,
    resolve_device,
)

_PI = f32(np.pi)
_HALF_PI = f32(np.pi / 2)


# ---------------------------------------------------------------- filters


def deemphasis_sos(fs: float, tau: float = 75e-6) -> np.ndarray:
    """FM de-emphasis: one-pole lowpass with time constant tau (75 us US /
    50 us EU), impulse-invariant pole, unit DC gain, in SOS form. The engine
    runs y[n] = (1-a)*x[n] + a*y[n-1] through the affine solver."""
    a = float(np.exp(-1.0 / (fs * tau)))
    return np.array([[1.0 - a, 0.0, 0.0, 1.0, -a, 0.0]])


def dc_block_sos(r: float = 0.995) -> np.ndarray:
    """DC blocker y[n] = x[n] - x[n-1] + r*y[n-1] (pole at r)."""
    return np.array([[1.0, -1.0, 0.0, 1.0, -float(r), 0.0]])


# ------------------------------------------------- blocked affine solver


def _inblock_prefix(a: torch.Tensor, b: torch.Tensor, block: int):
    """Inclusive Hillis-Steele prefix of affine maps inside fixed-size
    blocks: a, b (..., T) -> (A, B) of shape (..., G, L) with
    y_k(in block) = A[..., k] * y_in + B[..., k]. The tree is always over
    exactly L elements, so the op order does not depend on how many blocks
    a dispatch carries."""
    lead = a.shape[:-1]
    L = block
    G = a.shape[-1] // L
    A = a.reshape(*lead, G, L)
    B = b.reshape(*lead, G, L)
    d = 1
    while d < L:
        A_e = nnf.pad(A[..., :-d], (d, 0), value=1.0)
        B_e = nnf.pad(B[..., :-d], (d, 0))
        A, B = A * A_e, A * B_e + B
        d *= 2
    return A, B


def _chain_blocks(A_last: torch.Tensor, B_last: torch.Tensor, y0: torch.Tensor):
    """Sequential chain over block-final affines (the canonical state
    order): A_last, B_last (..., G); y0 (...,). Returns (y_final (...,),
    y_ins (..., G)), y_ins[..., g] the state entering block g."""
    y = y0
    y_ins = []
    for g in range(A_last.shape[-1]):
        y_ins.append(y)
        y = A_last[..., g] * y + B_last[..., g]
    return y, torch.stack(y_ins, dim=-1)


def _affine_prefix_raw(a, b, y0, block: int):
    """Solve y[n] = a[n]*y[n-1] + b[n] (inclusive), y[-1] = y0.

    a, b: (..., T) with T % block == 0; y0: (...,). Returns (y (..., T),
    y_final (...,)). The op order, and every rounding, is the same for any
    block-multiple chunking of the stream."""
    lead = a.shape[:-1]
    A, B = _inblock_prefix(a, b, block)
    y_final, y_ins = _chain_blocks(A[..., -1], B[..., -1], y0)
    y = A * y_ins[..., None] + B
    return y.reshape(*lead, a.shape[-1]), y_final


# --------------------------------------------------------- FM discriminator


def atan2_ieee(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2 as ``torch.atan`` of the octant-reduced ratio min/max, with
    the octant and the signs restored: atan2(+-0, -0) = +-pi and
    atan2(+-0, +0) = +-0, as IEEE (and the reference's arctan2) give."""
    ax, ay = x.abs(), y.abs()
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    a = torch.atan(lo / torch.where(hi > 0, hi, 1.0))
    a = torch.where(ay > ax, _HALF_PI - a, a)
    a = torch.where(torch.signbit(x), _PI - a, a)
    return torch.where(torch.signbit(y), -a, a)


def _fm_disc_raw(re, im, prev_re, prev_im, fs: float):
    """Instantaneous frequency (Hz) of z = re + j*im, one sample of history
    carried in prev_* (..., 1)."""
    re1 = torch.cat([prev_re, re[..., :-1]], dim=-1)
    im1 = torch.cat([prev_im, im[..., :-1]], dim=-1)
    dot = re * re1 + im * im1
    cross = im * re1 - re * im1
    return atan2_ieee(cross, dot) * f32(fs / (2.0 * np.pi))


def fm_discriminate(re, im, prev_re, prev_im, fs: float):
    """Functional form: (..., T) planes -> instantaneous Hz (..., T)."""
    return _fm_disc_raw(re, im, prev_re, prev_im, fs)


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# ------------------------------------------------------------------- AGC


class AGCState:
    def __init__(self, gain, offset: int = 0):
        self.gain = gain
        self.offset = int(offset)

    def to_numpy(self) -> dict:
        return {"gain": self.gain.detach().cpu().numpy(), "offset": np.int64(self.offset)}

    @classmethod
    def from_numpy(cls, d: dict, *, device="cuda") -> "AGCState":
        return cls(torch.tensor(np.asarray(d["gain"], np.float32), device=device),
                   int(d["offset"]))


def _agc_solve(mag, g0, mu: float, ref: float, block: int):
    """Gain solve for y[n] = g[n-1]*x[n] under the linear loop
    g[n] = g[n-1]*(1 - mu*mag[n]) + mu*ref, the loop factor floored at 0
    (a spike with mag > 1/mu snaps the gain to mu*ref instead of flipping
    its sign). Returns (g inclusive, g_final)."""
    a = torch.clamp_min(1.0 - mag * f32(mu), 0.0)
    b = torch.full_like(mag, f32(mu * ref))
    return _affine_prefix_raw(a, b, g0, block)


class AGC:
    """Streaming automatic gain control toward envelope ``ref``.

    ``mu`` is the loop gain per sample (time constant ~ 1/(mu*ref)
    samples). Chunk lengths must be multiples of ``block``."""

    def __init__(self, mu: float = 1e-3, ref: float = 1.0, block: int = 128,
                 g_init: float = 1.0, device=None):
        if not (0.0 < mu < 1.0):
            raise ValueError(f"mu must be in (0, 1); got {mu}")
        self.device = resolve_device(device, "AGC")
        self.mu = float(mu)
        self.ref = float(ref)
        self.block = int(block)
        self.g_init = float(g_init)

    def initial_state(self, batch_shape: tuple = ()) -> AGCState:
        return AGCState(torch.full(tuple(batch_shape), self.g_init,
                                   dtype=torch.float32, device=self.device), 0)

    def _check(self, x, state: AGCState):
        t = x.shape[-1]
        if t % self.block:
            raise ValueError(f"chunk length {t} not a multiple of block={self.block}")
        if tuple(state.gain.shape) != tuple(x.shape[:-1]):
            raise ValueError(
                f"state shape {tuple(state.gain.shape)} != {tuple(x.shape[:-1])}")

    def process_real(self, x, state: AGCState):
        x = _as_f32(x, self.device)
        self._check(x, state)
        g, g_final = _agc_solve(x.abs(), state.gain, self.mu, self.ref, self.block)
        g_prev = torch.cat([state.gain[..., None], g[..., :-1]], dim=-1)
        return g_prev * x, AGCState(g_final, state.offset + x.shape[-1])

    def process(self, re, im, state: AGCState):
        """Complex planes: one gain track drives both planes."""
        re, im = _as_f32(re, self.device), _as_f32(im, self.device)
        self._check(re, state)
        mag = torch.sqrt(re * re + im * im)
        g, g_final = _agc_solve(mag, state.gain, self.mu, self.ref, self.block)
        g_prev = torch.cat([state.gain[..., None], g[..., :-1]], dim=-1)
        return g_prev * re, g_prev * im, AGCState(g_final, state.offset + re.shape[-1])


# ----------------------------------------------------------------- squelch


class SquelchState:
    def __init__(self, power, offset: int = 0):
        self.power = power
        self.offset = int(offset)

    def to_numpy(self) -> dict:
        return {"power": self.power.detach().cpu().numpy(), "offset": np.int64(self.offset)}

    @classmethod
    def from_numpy(cls, d: dict, *, device="cuda") -> "SquelchState":
        return cls(torch.tensor(np.asarray(d["power"], np.float32), device=device),
                   int(d["offset"]))


def _squelch_forward(re, im, p0, lam: float, thresh: float, block: int):
    """Per-block baseband power EMA -> open/closed gate. Block k is gated on
    the EMA as of block k-1 (causal)."""
    lead = re.shape[:-1]
    G = re.shape[-1] // block
    rb = re.reshape(*lead, G, block)
    ib = im.reshape(*lead, G, block)
    pw = fixed_sum(rb * rb + ib * ib) * f32(1.0 / block)
    a = torch.full_like(pw, f32(lam))
    p_final, p_prev = _chain_blocks(a, pw * f32(1.0 - lam), p0)
    gate = (p_prev > f32(thresh)).to(torch.float32)
    return gate, p_final


class Squelch:
    """Carrier-power squelch: mutes audio while the baseband power EMA sits
    below ``threshold`` (linear mean|z|^2; use ``10**(dB/10)``). ``gates``
    returns a per-sample 0/1 mask aligned to the input. Chunked == one-shot
    bitwise at block granularity."""

    def __init__(self, threshold: float, leak: float = 0.99, block: int = 128,
                 device=None):
        if threshold <= 0:
            raise ValueError(f"threshold must be > 0; got {threshold}")
        if not (0.0 <= leak < 1.0):
            raise ValueError(f"leak must be in [0, 1); got {leak}")
        self.device = resolve_device(device, "Squelch")
        self.threshold = float(threshold)
        self.leak = float(leak)
        self.block = int(block)

    def initial_state(self, batch_shape: tuple = ()) -> SquelchState:
        return SquelchState(torch.zeros(tuple(batch_shape), dtype=torch.float32,
                                        device=self.device), 0)

    def gates(self, re, im, state: SquelchState):
        re, im = _as_f32(re, self.device), _as_f32(im, self.device)
        t = re.shape[-1]
        if t % self.block:
            raise ValueError(f"chunk length {t} not a multiple of block={self.block}")
        if tuple(state.power.shape) != tuple(re.shape[:-1]):
            raise ValueError(
                f"state shape {tuple(state.power.shape)} != {tuple(re.shape[:-1])}")
        gate, p_final = _squelch_forward(re, im, state.power, self.leak,
                                         self.threshold, self.block)
        per_sample = torch.repeat_interleave(gate, self.block, dim=-1)
        return per_sample, SquelchState(p_final, state.offset + t)


# ------------------------------------------------------------ demodulators


def _fm_forward(re, im, prev_re, prev_im, filt, fs: float, dev: float, pole,
                block: int):
    """FM forward: discriminator, /deviation, optional de-emphasis."""
    audio = _fm_disc_raw(re, im, prev_re, prev_im, fs) * f32(1.0 / dev)
    if pole is not None:
        a = f32(pole)
        b = audio * f32(np.float32(1.0) - np.float32(pole))
        audio, filt = _affine_prefix_raw(torch.full_like(audio, a), b, filt, block)
    return audio, re[..., -1:].clone(), im[..., -1:].clone(), filt


def _am_forward(re, im, prev_re, prev_im, filt, pole: float, block: int):
    env = torch.sqrt(re * re + im * im)
    prev_env = torch.sqrt(prev_re * prev_re + prev_im * prev_im)
    env1 = torch.cat([prev_env, env[..., :-1]], dim=-1)
    audio, filt = _affine_prefix_raw(torch.full_like(env, f32(pole)), env - env1,
                                     filt, block)
    return audio, re[..., -1:].clone(), im[..., -1:].clone(), filt


class DemodState:
    """prev complex sample (planes (..., 1)) + filter state (...,) +
    absolute sample offset (host int, drives the SSB BFO phase)."""

    def __init__(self, prev_re, prev_im, filt, offset: int = 0):
        self.prev_re = prev_re
        self.prev_im = prev_im
        self.filt = filt
        self.offset = int(offset)

    def to_numpy(self) -> dict:
        as_np = lambda t: t.detach().cpu().numpy()
        return {
            "prev_re": as_np(self.prev_re),
            "prev_im": as_np(self.prev_im),
            "filt": as_np(self.filt),
            "offset": np.int64(self.offset),
        }

    @classmethod
    def from_numpy(cls, d: dict, *, device="cuda") -> "DemodState":
        as_t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        return cls(as_t(d["prev_re"]), as_t(d["prev_im"]), as_t(d["filt"]),
                   int(d["offset"]))


def _zero_demod_state(batch_shape, device) -> DemodState:
    b = tuple(batch_shape)
    z1 = torch.zeros(b + (1,), dtype=torch.float32, device=device)
    return DemodState(z1, z1, torch.zeros(b, dtype=torch.float32, device=device), 0)


class FMDemodulator:
    """FM: quadrature discriminator -> /deviation -> de-emphasis.

    Input: complex baseband planes at ``fs`` (a DDC output). Output: audio
    at the same rate, ~[-1, 1] for full deviation. ``deemphasis_tau=None``
    disables the de-emphasis pole.

    ``use_pallas=True`` (the reference's name for its fused kernel) runs
    ``kernels/cuda/affine_scan.fm_demod_pallas``: one CUDA kernel launch per
    call on a GPU, its plain version on the CPU. Its bits differ slightly
    from this class's default path (a polynomial atan2 against
    ``atan2_ieee``, a roll-and-mask tree against pad shifts) but are
    invariant to chunking, so chunked == one-shot holds within either path.
    Requires block == 128."""

    def __init__(self, fs: float, deviation_hz: float = 75e3,
                 deemphasis_tau: float | None = 75e-6, block: int = 128,
                 use_pallas: bool = False, device=None):
        self.device = resolve_device(device, "FMDemodulator")
        self.fs = float(fs)
        self.deviation_hz = float(deviation_hz)
        self.tau = deemphasis_tau
        self.block = int(block)
        self._pole = (None if deemphasis_tau is None
                      else float(np.exp(-1.0 / (self.fs * deemphasis_tau))))
        if use_pallas and self.block != 128:
            raise ValueError("use_pallas requires block=128")
        self.use_pallas = bool(use_pallas)

    def initial_state(self, batch_shape: tuple = ()) -> DemodState:
        return _zero_demod_state(batch_shape, self.device)

    def _process_pallas(self, re, im, state: DemodState):
        from tpu_sdr_torch.kernels.cuda.affine_scan import fm_demod_pallas

        lead = re.shape[:-1]
        t = re.shape[-1]
        c = int(np.prod(lead, dtype=np.int64)) if lead else 1
        n_blocks = t // 128
        # The reference's tile width (<= 64 blocks dividing the chunk); the
        # kernel's result does not depend on it.
        rows = next(r for r in range(min(64, n_blocks), 0, -1) if n_blocks % r == 0)
        audio, pr, pi, filt = fm_demod_pallas(
            re.reshape(c, t), im.reshape(c, t),
            state.prev_re.reshape(c, 1), state.prev_im.reshape(c, 1),
            state.filt.reshape(c),
            fs=self.fs, dev=self.deviation_hz, pole=self._pole, rows_per_tile=rows)
        return (audio.reshape(*lead, t),
                DemodState(pr.reshape(*lead, 1), pi.reshape(*lead, 1),
                           filt.reshape(lead), state.offset + t))

    def process(self, re, im, state: DemodState):
        re, im = _as_f32(re, self.device), _as_f32(im, self.device)
        t = re.shape[-1]
        if t % self.block:
            raise ValueError(f"chunk length {t} not a multiple of block={self.block}")
        if self.use_pallas:
            return self._process_pallas(re, im, state)
        audio, pr, pi, filt = _fm_forward(
            re, im, state.prev_re, state.prev_im, state.filt,
            fs=self.fs, dev=self.deviation_hz, pole=self._pole, block=self.block)
        return audio, DemodState(pr, pi, filt, state.offset + t)


class AMDemodulator:
    """AM: envelope |z| -> DC block. Output ~carrier-amplitude-scaled; add an
    ``AGC`` stage for constant loudness."""

    def __init__(self, fs: float, dc_pole: float = 0.995, block: int = 128,
                 device=None):
        self.device = resolve_device(device, "AMDemodulator")
        self.fs = float(fs)
        self.block = int(block)
        self.dc_pole = float(dc_pole)

    def initial_state(self, batch_shape: tuple = ()) -> DemodState:
        return _zero_demod_state(batch_shape, self.device)

    def process(self, re, im, state: DemodState):
        re, im = _as_f32(re, self.device), _as_f32(im, self.device)
        t = re.shape[-1]
        if t % self.block:
            raise ValueError(f"chunk length {t} not a multiple of block={self.block}")
        audio, pr, pi, filt = _am_forward(
            re, im, state.prev_re, state.prev_im, state.filt,
            pole=self.dc_pole, block=self.block)
        return audio, DemodState(pr, pi, filt, state.offset + t)


class SSBDemodulator:
    """SSB product detector: audio = Re{z * exp(-j*2*pi*bfo*n/fs)}.

    Sideband selection is done by the preceding DDC (filter method);
    ``bfo_hz`` re-inserts the carrier offset (signed). The BFO rides the
    exact 32-bit NCO, so chunked == one-shot bitwise at any chunking."""

    def __init__(self, fs: float, bfo_hz: float = 0.0, device=None):
        self.device = resolve_device(device, "SSBDemodulator")
        self.fs = float(fs)
        self.retune(bfo_hz)

    def retune(self, bfo_hz: float):
        self.bfo_hz = float(bfo_hz)
        self._word = _tuning_word(self.fs, self.bfo_hz)

    @property
    def realized_bfo_hz(self) -> float:
        return _principal_alias_hz(self.fs, self._word)

    def initial_state(self, batch_shape: tuple = ()) -> DemodState:
        return _zero_demod_state(batch_shape, self.device)

    def process(self, re, im, state: DemodState):
        re, im = _as_f32(re, self.device), _as_f32(im, self.device)
        t = re.shape[-1]
        c, s = _nco_cos_sin(_u32(state.offset * self._word, self.device),
                            _u32(self._word, self.device), t)
        audio = re * c + im * s  # Re{z * (c - j*s)}
        return audio, DemodState(re[..., -1:].clone(), im[..., -1:].clone(),
                                 state.filt, state.offset + t)
