"""Streaming polyphase rational resampler (upsample L / downsample M).

The counterpart of ``tpu_sdr.kernels.resample``. With zero initial
conditions it computes ``scipy.signal.upfirdn(h, x, L, M)``:

    out[m] = sum_j h[(m*M mod L) + j*L] * x[floor(m*M/L) - j]

With L, M coprime and the chunk length T a multiple of M, a chunk produces
exactly O = T*L/M outputs and the phase pattern restarts every chunk.
Outputs are grouped into L phase classes; each class is P shifted
stride-M slices of the input (elementwise multiply-adds in a fixed j
order), interleaved back with one reshape. Carried state is the last P-1
input samples, so chunked processing is bit-identical to one-shot.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu_sdr_torch.kernels.ddc import resolve_device


def design_resample_fir(
    up: int, down: int, taps_per_phase: int = 8, window: str = "hamming"
) -> np.ndarray:
    """Anti-imaging/anti-alias lowpass for an L/M resampler: length
    taps_per_phase * L, cutoff min(1/L, 1/M) (normalized to Nyquist),
    passband gain L (the ``scipy.signal.resample_poly`` convention).
    float64."""
    import scipy.signal as sps

    g = math.gcd(int(up), int(down))
    up, down = int(up) // g, int(down) // g
    if up == 1 and down == 1:
        return np.ones(1)
    h = sps.firwin(taps_per_phase * up, 1.0 / max(up, down), window=window)
    return (up * h / h.sum()).astype(np.float64)


def _resample_forward(x, tail, h, up: int, down: int, p: int):
    """One chunk: x (..., T) with T % down == 0, tail (..., p-1) input
    history, h the (p*up,) float32 FIR as Python floats. Returns
    (out (..., T*up/down), new_tail)."""
    t = x.shape[-1]
    hist = p - 1
    cat = torch.cat([tail, x], dim=-1) if hist else x
    k_steps = t // down  # outputs per phase class
    classes = []
    for c in range(up):
        # output m = c + k*up taps x at floor(m*down/up) - j with FIR phase
        # (m*down) mod up
        phase = (c * down) % up
        off = (c * down) // up
        acc = None
        for j in range(p):
            start = hist + off - j
            seg = cat[..., start : start + (k_steps - 1) * down + 1 : down]
            term = seg * h[phase + j * up]
            acc = term if acc is None else acc + term
        classes.append(acc)
    # classes[c][..., k] is output index k*up + c -> (..., K, up) -> (..., O)
    out = torch.stack(classes, dim=-1).reshape(*x.shape[:-1], k_steps * up)
    new_tail = cat[..., cat.shape[-1] - hist :].clone() if hist else tail
    return out, new_tail


class ResamplerState:
    """Streaming state: input-sample tail (device) + absolute input offset
    (host integer)."""

    def __init__(self, tail, offset: int = 0):
        self.tail = tail
        self.offset = int(offset)

    def to_numpy(self) -> dict:
        return {"tail": self.tail.detach().cpu().numpy(), "offset": np.int64(self.offset)}

    @classmethod
    def from_numpy(cls, d: dict, *, device="cuda") -> "ResamplerState":
        return cls(torch.tensor(np.asarray(d["tail"], np.float32), device=device),
                   int(d["offset"]))


class Resampler:
    """Streaming rational L/M resampler (output rate = fs * L/M).

    ``fir=None`` designs a ``design_resample_fir`` lowpass (gain L). Common
    factors of (up, down) are reduced; chunk lengths must be multiples of
    the reduced M. Works on any leading batch shape (stack IQ as a leading
    (2, ...) plane axis)."""

    def __init__(
        self,
        up: int = 1,
        down: int = 1,
        fir: np.ndarray | None = None,
        taps_per_phase: int = 8,
        window: str = "hamming",
        device=None,
    ):
        if up < 1 or down < 1:
            raise ValueError(f"up/down must be >= 1; got {up}/{down}")
        self.device = resolve_device(device, "Resampler")
        g = math.gcd(int(up), int(down))
        self.up = int(up) // g
        self.down = int(down) // g
        if fir is None:
            fir = design_resample_fir(self.up, self.down, taps_per_phase, window)
        h = np.asarray(fir, np.float64).reshape(-1)
        if h.size % self.up:
            h = np.pad(h, (0, self.up - h.size % self.up))
        self.fir = h
        self.p = h.size // self.up  # taps per phase
        # The taps as fp32 values; each multiplies a whole slice as a scalar.
        self._h = [float(v) for v in h.astype(np.float32)]

    @property
    def history_len(self) -> int:
        return self.p - 1

    def rate_out(self, fs: float) -> float:
        return fs * self.up / self.down

    def out_len(self, t: int) -> int:
        if t % self.down:
            raise ValueError(f"chunk length {t} not a multiple of M={self.down}")
        return t * self.up // self.down

    def initial_state(self, batch_shape: tuple = ()) -> ResamplerState:
        z = torch.zeros(tuple(batch_shape) + (self.history_len,), dtype=torch.float32,
                        device=self.device)
        return ResamplerState(z, 0)

    def process(self, x, state: ResamplerState):
        """x (..., T), T % M == 0 -> (out (..., T*L/M), new state)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        t = x.shape[-1]
        self.out_len(t)  # validates T % M
        want = tuple(x.shape[:-1]) + (self.history_len,)
        if tuple(state.tail.shape) != want:
            raise ValueError(f"state shape {tuple(state.tail.shape)} != {want}")
        out, tail = _resample_forward(x, state.tail, self._h, self.up, self.down, self.p)
        return out, ResamplerState(tail, state.offset + t)
