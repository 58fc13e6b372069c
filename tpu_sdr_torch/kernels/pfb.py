"""Polyphase filter-bank (PFB) channelizer.

The counterpart of ``tpu_sdr.kernels.pfb``. For output step n over input x
at rate fs (weighted overlap-fold, the classic polyphase spectrometer):

    block_n = x[nM : nM + P·M]              (slides by M — critically sampled)
    folded_n[p] = sum_t  h[tM + p] * block_n[tM + p]     (p = 0..M-1)
    Y[n, k]   = sum_p  folded_n[p] * exp(-2j*pi*k*p / M)

Channel k is centered at k*fs/M (wrapping to negative frequencies for IQ
input) and decimated to fs/M. The branch filtering is P shifted elementwise
multiply-adds; the M-point DFT is a dense (steps, M) @ (M, M) product, run
through ``biquad._canonical_matmul`` in calls of a fixed row count so that a
step's bits do not depend on the chunk. Streaming state is the last (P-1)·M
input samples, so chunked processing is bit-identical to one-shot.

``use_pallas=True`` with m == 128 runs the fused fold + DFT kernel
(``kernels/cuda/pfb_kernel.pfb_fold_dft``); the real/IQ combine of its two
products stays outside it, as in the reference. Every dtype tier computes
in IEEE fp32 in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sdr_torch.kernels import biquad
from tpu_sdr_torch.kernels.cuda.pfb_kernel import PRODUCT_ROWS, fold_rows, pfb_fold_dft
from tpu_sdr_torch.kernels.ddc import resolve_device

DTYPES = ("f32", "f32max", "bf16")


def design_prototype(m: int, taps: int, window: str = "hamming") -> np.ndarray:
    """Lowpass prototype FIR, length taps*m, cutoff fs/(2M), unit DC gain
    (float64)."""
    import scipy.signal as sps

    n = taps * m
    h = sps.firwin(n, cutoff=1.0 / m, window=window, scale=False)
    return (h / h.sum()).astype(np.float64)


def dft_matrices(m: int) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) with W[p, k] = exp(-2j*pi*p*k/m) = cos[p,k] - 1j*sin[p,k],
    built in float64 and rounded once to float32."""
    pk = np.outer(np.arange(m), np.arange(m)) % m
    ang = 2.0 * np.pi * pk / m
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _fold(x: torch.Tensor, h2: torch.Tensor, taps: int, m: int) -> torch.Tensor:
    """(…, (steps+taps−1)·m) windowed fold -> (…, steps, m)."""
    return fold_rows(x.reshape(x.shape[:-1] + (-1, m)), h2, taps)


def _dft(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return biquad._canonical_matmul(a, w, PRODUCT_ROWS)


def _forward(cat, h2, cos, sin, taps: int, m: int, iq: bool,
             use_pallas: bool = False, kprec: str = "highest"):
    """Windowed fold + M-point DFT; returns (re, im, new_state)."""
    if use_pallas and m == 128:
        rows = cat.reshape(cat.shape[:-1] + (-1, m))
        lead = rows.shape[:-2]
        flat = rows.reshape((-1,) + rows.shape[-2:])
        a, b = pfb_fold_dft(
            flat, h2, cos, sin, taps, m, precision=kprec,
            neg_b=not iq,  # real input reads (A, -B) straight as (re, im)
        )
        a = a.reshape(lead + a.shape[-2:])
        b = b.reshape(lead + b.shape[-2:])
        if iq:
            re = a[0] + b[1]
            im = a[1] - b[0]
        else:
            re, im = a, b
    else:
        folded = _fold(cat, h2, taps, m)
        if iq:
            fr, fi = folded[0], folded[1]
            # (fr + j fi) @ (cos − j sin)
            re = _dft(fr, cos) + _dft(fi, sin)
            im = _dft(fi, cos) - _dft(fr, sin)
        else:
            re = _dft(folded, cos)
            im = -_dft(folded, sin)
    hist = (taps - 1) * m
    new_state = cat[..., cat.shape[-1] - hist :].clone()
    return re, im, new_state


class Channelizer:
    """Streaming M-channel critically-sampled PFB.

    Accepts real ``(…, T)`` arrays or pre-split IQ planes ``(2, …, T)`` via
    :meth:`process_planes`; ``T`` must be a multiple of ``m``. Returns
    ``{"re", "im"}`` (and ``"magnitude"`` when requested) of shape
    ``(…, T//m, m)`` plus the carried state. ``device`` None means CUDA.
    """

    def __init__(
        self,
        m: int = 128,
        taps: int = 8,
        window: str = "hamming",
        dtype: str = "f32",
        sample_rate: float = 1_000_000.0,
        use_pallas: bool = False,
        device=None,
    ):
        if m < 2 or taps < 1:
            raise ValueError(f"need m >= 2, taps >= 1; got m={m}, taps={taps}")
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {list(DTYPES)}")
        self.device = resolve_device(device, "Channelizer")
        self.m = m
        self.taps = taps
        self.window = window
        self.dtype = dtype
        self.sample_rate = sample_rate
        self.history_len = (taps - 1) * m
        self.prototype = design_prototype(m, taps, window)
        self._h2 = torch.tensor(self.prototype.reshape(taps, m).astype(np.float32),
                                device=self.device)
        cos, sin = dft_matrices(m)
        self._cos = torch.tensor(cos, device=self.device)
        self._sin = torch.tensor(sin, device=self.device)
        self.use_pallas = use_pallas
        # The reference kernel's precision keyword; the port computes in fp32.
        self._kprec = "default" if dtype == "bf16" else "highest"

    @property
    def channel_hz(self) -> float:
        """Subchannel spacing (and output rate): fs / M."""
        return self.sample_rate / self.m

    def initial_state(self, batch_shape: tuple = ()) -> torch.Tensor:
        """Zero history: the last (taps−1)·m input samples."""
        return torch.zeros(tuple(batch_shape) + (self.history_len,),
                           dtype=torch.float32, device=self.device)

    def _check(self, x, state):
        if x.shape[-1] % self.m:
            raise ValueError(f"input length {x.shape[-1]} not a multiple of m={self.m}")
        want = tuple(x.shape[:-1]) + (self.history_len,)
        if tuple(state.shape) != want:
            raise ValueError(f"state shape {tuple(state.shape)} != {want}")

    def _run(self, x, state, outputs: str, iq: bool):
        cat = torch.cat([state, x], dim=-1)
        re, im, new_state = _forward(
            cat, self._h2, self._cos, self._sin, self.taps, self.m, iq=iq,
            use_pallas=self.use_pallas, kprec=self._kprec,
        )
        return self._pack(re, im, outputs), new_state

    def process(self, x, state, outputs: str = "complex"):
        """Real-input channelization. Returns (dict, new_state)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        self._check(x, state)
        return self._run(x, state, outputs, iq=False)

    def process_planes(self, xs, state_planes, outputs: str = "complex"):
        """IQ-input channelization: ``xs`` is (2, …, T) re/im planes, state
        the matching (2, …, history) stack."""
        xs = torch.as_tensor(xs, dtype=torch.float32, device=self.device)
        self._check(xs[0], state_planes[0])
        return self._run(xs, state_planes, outputs, iq=True)

    @staticmethod
    def _pack(re, im, outputs: str) -> dict:
        if outputs not in ("complex", "magnitude", "all"):
            raise ValueError(f"unknown outputs {outputs!r}")
        out = {}
        if outputs in ("complex", "all"):
            out["re"], out["im"] = re, im
        if outputs in ("magnitude", "all"):
            out["magnitude"] = torch.sqrt(re * re + im * im)
        return out
