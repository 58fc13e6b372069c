"""FM stereo (MPX) decoder: pilot-locked L/R recovery, filter-free.

The counterpart of ``tpu_sdr.kernels.stereo``. The multiplex

    m(t) = (L+R)/2  +  cos(2*theta_p(t)) * (L-R)/2  +  a_p*cos(theta_p(t))

carries a 19 kHz pilot at theta_p and the L-R DSB subcarrier locked to
twice its phase. The decoder recovers the 38 kHz carrier from the pilot and
matrixes L = sum+diff, R = sum-diff:

- pilot extraction is a per-128-sample-block correlator against the exact
  32-bit NCO (``kernels/ddc``), Hann-weighted; its sum over the block is
  ``ddc.fixed_sum``, so it does not depend on the chunk's shape;
- phase/frequency tracking is two complex EMAs over blocks (four real
  chains, run as one ``demod._chain_blocks`` over a stacked axis), with
  the EMA's lag divided back out using the measured rotation;
- strictly causal: block g uses the EMAs as of block g-1;
- carrier doubling is algebraic (U^2/|U|^2) and the 38 kHz NCO uses the
  doubled tuning word, exact mod 2^32.

A silent pilot gates the block to mono: L == R == m.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sdr_torch.kernels.ddc import (
    _nco_cos_sin,
    _principal_alias_hz,
    _tuning_word,
    _u32,
    f32,
    fixed_sum,
    resolve_device,
)
from tpu_sdr_torch.kernels.demod import _affine_prefix_raw, _chain_blocks

PILOT_HZ = 19_000.0


def _hann_corr_win(block: int, device) -> torch.Tensor:
    """The normalized periodic-Hann correlator window (see _block_phasor)."""
    n_b = np.arange(block)
    w_np = 0.5 - 0.5 * np.cos(2.0 * np.pi * n_b / block)
    return torch.tensor((2.0 * w_np / w_np.sum()).astype(np.float32), device=device)


def _track_pilot(prev_ar, prev_ai, prev_br, prev_bi, *, lam: float,
                 thresh: float, w_max: float):
    """Per-block pilot tracking from the EMA states as of block g-1:
    rotation clamp, EMA de-lag, one-block advance, squaring, gate. Returns
    (d2r, d2i, gate, p2): the unit doubled phasor, the stereo gate and
    |pilot|^2 per block."""
    lam_f = f32(lam)
    one_m = f32(1.0 - lam)
    # unit per-block rotation phasor w (pilot frequency error vs the NCO),
    # clamped to the plausible drift range
    bmag = torch.sqrt(prev_br * prev_br + prev_bi * prev_bi)
    safe_b = bmag > f32(1e-12)
    safe_mag = torch.clamp_min(bmag, f32(1e-12))
    wr_raw = torch.where(safe_b, prev_br / safe_mag, 1.0)
    wi_raw = torch.where(safe_b, prev_bi / safe_mag, 0.0)
    s_max = f32(np.sin(w_max))
    wi = torch.clamp(torch.where(wr_raw > 0, wi_raw, torch.sign(wi_raw)), -s_max, s_max)
    wr = torch.sqrt(torch.clamp_min(1.0 - wi * wi, 0.0))
    # de-lag the A-EMA: divide by C = (1-lam)/(1-lam*conj(w)), then advance
    # one block (the EMA is causal: it ends at block g-1)
    dr = (1.0 - wr * lam_f) / one_m
    di = (wi * lam_f) / one_m
    ur = prev_ar * dr - prev_ai * di
    ui = prev_ar * di + prev_ai * dr
    ur, ui = ur * wr - ui * wi, ur * wi + ui * wr  # advance by w

    p2 = ur * ur + ui * ui  # |pilot|^2 estimate per block
    gate = (p2 > f32(thresh * thresh)).to(torch.float32)
    # unit doubled phasor e^{j2phi} = U^2 / |U|^2
    inv = 1.0 / torch.clamp_min(p2, f32(1e-12))
    d2r = (ur * ur - ui * ui) * inv
    d2i = (2.0 * ur * ui) * inv
    return d2r, d2i, gate, p2


def _block_phasor(m, c19, s19, win, block: int):
    """Per-block pilot correlator: (..., T) -> (A_re, A_im) (..., G), a
    Hann-weighted sum over each block (its -65 dB sidelobes keep audio and
    DSB content out of the rotation estimate)."""
    lead = m.shape[:-1]
    g = m.shape[-1] // block
    rb = (m * c19).reshape(*lead, g, block)
    ib = (m * (-s19)).reshape(*lead, g, block)
    return fixed_sum(rb * win), fixed_sum(ib * win)


def _stereo_forward(m, a_re0, a_im0, b_re0, b_im0, last_re0, last_im0, filt0,
                    phase19: int, k19: int, *, lam: float, thresh: float,
                    sub_gain: float, pole, block: int, w_max: float):
    """One chunk of MPX -> stacked (L, R) planes (..., 2, T) + state finals."""
    lead = m.shape[:-1]
    t = m.shape[-1]
    g = t // block
    dev = m.device
    c19, s19 = _nco_cos_sin(_u32(phase19, dev), _u32(k19, dev), t)
    # doubled word/phase: exact mod-2^32 arithmetic keeps the 38 kHz carrier
    # phase-locked to the pilot NCO for any stream offset
    c38, s38 = _nco_cos_sin(_u32(phase19 * 2, dev), _u32(k19 * 2, dev), t)

    win = _hann_corr_win(block, dev)
    ar, ai = _block_phasor(m, c19, s19, win, block)  # (..., G)

    # rotation products B_g = A_g * conj(A_{g-1}); A_{-1} carried
    pr = torch.cat([last_re0[..., None], ar[..., :-1]], dim=-1)
    pi = torch.cat([last_im0[..., None], ai[..., :-1]], dim=-1)
    br = ar * pr + ai * pi
    bi = ai * pr - ar * pi

    # The four EMAs share the pole lam: one chain over a stacked axis.
    one_m = f32(1.0 - lam)
    forcing = torch.stack([ar, ai, br, bi]) * one_m
    fins, prevs = _chain_blocks(torch.full_like(forcing, f32(lam)), forcing,
                                torch.stack([a_re0, a_im0, b_re0, b_im0]))
    d2r, d2i, gate, p2 = _track_pilot(*prevs, lam=lam, thresh=thresh, w_max=w_max)

    # cos(2theta + 2phi) per sample, the per-block phasor broadcast over L
    c38b = c38.reshape(*([1] * len(lead)), g, block)
    s38b = s38.reshape(*([1] * len(lead)), g, block)
    carrier = c38b * d2r[..., None] - s38b * d2i[..., None]
    mb = m.reshape(*lead, g, block)
    diff = (2.0 * f32(sub_gain)) * mb * carrier * gate[..., None]
    left = (mb + diff).reshape(*lead, t)
    right = (mb - diff).reshape(*lead, t)
    lr = torch.stack([left, right], dim=len(lead))  # (..., 2, T)

    if pole is not None:
        a = f32(pole)
        b = lr * f32(np.float32(1.0) - np.float32(pole))
        lr, filt = _affine_prefix_raw(torch.full_like(lr, a), b, filt0, block)
    else:
        filt = filt0
    return (lr, *fins, ar[..., -1], ai[..., -1], filt, p2[..., -1])


class StereoDecoderState:
    """Carried state: pilot-phasor EMA (a), rotation EMA (b), the last raw
    block phasor, per-channel de-emphasis state (..., 2), the absolute
    sample offset driving the NCO, and the |pilot|^2 estimate at chunk end
    (a device tensor, fetched lazily by ``pilot_level``)."""

    def __init__(self, a_re, a_im, b_re, b_im, last_re, last_im, filt,
                 offset: int = 0, pilot_pow=0.0):
        self.a_re, self.a_im = a_re, a_im
        self.b_re, self.b_im = b_re, b_im
        self.last_re, self.last_im = last_re, last_im
        self.filt = filt
        self.offset = int(offset)
        self.pilot_pow = pilot_pow

    _LEAVES = ("a_re", "a_im", "b_re", "b_im", "last_re", "last_im", "filt")

    def to_numpy(self) -> dict:
        d = {k: getattr(self, k).detach().cpu().numpy() for k in self._LEAVES}
        d["offset"] = np.int64(self.offset)
        p = self.pilot_pow
        p = p.detach().cpu().numpy() if torch.is_tensor(p) else p
        d["pilot_pow"] = np.asarray(p, np.float64)
        return d

    @classmethod
    def from_numpy(cls, d: dict, *, device="cuda") -> "StereoDecoderState":
        as_t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        return cls(*(as_t(d[k]) for k in cls._LEAVES), int(d["offset"]),
                   np.asarray(d.get("pilot_pow", 0.0), np.float64))

    def pilot_level(self):
        """Estimated pilot amplitude (same units as the MPX input): a float
        for an unbatched stream, a per-station array otherwise."""
        p = self.pilot_pow
        p = p.detach().cpu().numpy() if torch.is_tensor(p) else p
        lvl = np.sqrt(np.maximum(np.asarray(p, np.float64), 0.0))
        return float(lvl) if lvl.ndim == 0 else lvl


class StereoDecoder:
    """Streaming FM stereo MPX decoder.

    Input: the demodulated MPX (deviation-normalized discriminator output)
    at ``fs`` >= ~106 kHz. Output: stacked (L, R) planes (..., 2, T) at the
    same rate. Chunk lengths must be multiples of ``block``; chunked ==
    one-shot bitwise.

    ``leak``: per-block EMA retention of the pilot tracker.
    ``pilot_threshold``: pilot amplitude below which the decoder gates to
    mono. ``deemphasis_tau``: per-channel de-emphasis (None = off).
    ``subcarrier_gain``: L-R gain trim for upstream droop at 38 kHz.
    """

    def __init__(self, fs: float, leak: float = 0.995,
                 pilot_threshold: float = 0.02,
                 deemphasis_tau: float | None = None,
                 subcarrier_gain: float = 1.0, block: int = 128,
                 max_pilot_offset_hz: float = 4.0, device=None):
        if fs < 106_000.0:  # 2 * (38 kHz subcarrier + 15 kHz sideband)
            raise ValueError(f"fs={fs} too low for the 38 kHz subcarrier + 15 kHz audio")
        if not (0.0 <= leak < 1.0):
            raise ValueError(f"leak must be in [0, 1); got {leak}")
        self.device = resolve_device(device, "StereoDecoder")
        self.fs = float(fs)
        self.leak = float(leak)
        self.pilot_threshold = float(pilot_threshold)
        self.tau = deemphasis_tau
        self.subcarrier_gain = float(subcarrier_gain)
        self.block = int(block)
        self._pole = (None if deemphasis_tau is None
                      else float(np.exp(-1.0 / (self.fs * deemphasis_tau))))
        self._word = _tuning_word(self.fs, PILOT_HZ)
        # max tracked pilot drift, as rotation per block (rad)
        self._w_max = float(2.0 * np.pi * max_pilot_offset_hz * self.block / self.fs)

    @property
    def realized_pilot_hz(self) -> float:
        return _principal_alias_hz(self.fs, self._word)

    def initial_state(self, batch_shape: tuple = ()) -> StereoDecoderState:
        b = tuple(batch_shape)
        z = torch.zeros(b, dtype=torch.float32, device=self.device)
        return StereoDecoderState(
            z, z, z, z, z, z,
            torch.zeros(b + (2,), dtype=torch.float32, device=self.device), 0)

    def process(self, m, state: StereoDecoderState):
        """MPX (..., T) -> ((..., 2, T) L/R, new state)."""
        m = torch.as_tensor(m, dtype=torch.float32, device=self.device)
        t = m.shape[-1]
        if t % self.block:
            raise ValueError(f"chunk length {t} not a multiple of block={self.block}")
        if tuple(state.a_re.shape) != tuple(m.shape[:-1]):
            raise ValueError(
                f"state shape {tuple(state.a_re.shape)} != {tuple(m.shape[:-1])}")
        (lr, far, fai, fbr, fbi, lre, lim, filt, p2) = _stereo_forward(
            m, state.a_re, state.a_im, state.b_re, state.b_im,
            state.last_re, state.last_im, state.filt,
            (state.offset * self._word) % (1 << 32), self._word,
            lam=self.leak, thresh=self.pilot_threshold,
            sub_gain=self.subcarrier_gain, pole=self._pole, block=self.block,
            w_max=self._w_max)
        new = StereoDecoderState(far, fai, fbr, fbi, lre, lim, filt,
                                 state.offset + t, p2)
        return lr, new


def make_mpx(left: np.ndarray, right: np.ndarray, fs: float,
             pilot_amp: float = 0.09, pilot_hz: float = PILOT_HZ,
             pilot_phase: float = 0.0, audio_gain: float = 0.9) -> np.ndarray:
    """Host-side stereo multiplex generator (float64) for tests/demos:
    audio_gain*((L+R)/2 + cos(2*theta)*(L-R)/2) + pilot_amp*cos(theta)."""
    left = np.asarray(left, np.float64)
    right = np.asarray(right, np.float64)
    n = left.shape[-1]
    theta = 2.0 * np.pi * pilot_hz * np.arange(n) / fs + pilot_phase
    s = 0.5 * (left + right)
    d = 0.5 * (left - right)
    return audio_gain * (s + np.cos(2.0 * theta) * d) + pilot_amp * np.cos(theta)
