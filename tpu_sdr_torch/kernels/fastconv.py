"""Streaming fast convolution (overlap-save) FIR engine (the counterpart of
``tpu_sdr.kernels.fastconv``).

One long FIR at unit rate through overlap-save: each block of ``block``
output samples is one ``nfft``-point frame (``history = nfft - block``
samples of the previous input, then the block's own), transformed by the
four-step DFT of ``kernels/fft``'s plan, multiplied by the taps' spectrum
(a float64 DFT rounded once) and transformed back; the frame's last
``block`` samples are the output.

The block grid is absolute, so chunked processing equals one-shot bit for
bit at ``chunk_granularity`` = block. For that the DFT products here run at
one fixed call shape (``_fixed_dft``: every product a call of exactly
``CALL_ROWS`` rows, through ``biquad._canonical_matmul``), not through
``fft.fft_4step``, whose batched products hand the BLAS library a row
count that grows with the chunk: MKL and cuBLAS pick their kernels, and
with them the rounding, by the row count. Every product is IEEE fp32
(``torch.get_float32_matmul_precision() == "highest"``, checked before
each dispatch), at every ``dtype`` tier.

Output matches ``scipy.signal.lfilter(h, 1, x)`` (causal, zero initial
conditions) to FFT-roundtrip precision. Real taps filter real streams
(``process``) or IQ planes (``process_planes``, each plane); complex taps
take the planes path with the full complex multiply.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sdr_torch.kernels import fft
from tpu_sdr_torch.kernels.biquad import _canonical_matmul
from tpu_sdr_torch.kernels.ddc import resolve_device
from tpu_sdr_torch.runtime.stream import check_matmul_precision

# near-square four-step factorizations (n1, n2) of each DFT size
_NFFT_PLANS = {
    1024: (32, 32),
    2048: (64, 32),
    4096: (64, 64),
    8192: (128, 64),
    16384: (128, 128),
    32768: (256, 128),
    65536: (256, 256),
}

# Rows of every DFT product call (the last call of a dispatch zero-padded).
CALL_ROWS = 16384


def _auto_nfft(n_taps: int) -> int:
    """Smallest planned size with a valid-block fraction >= 3/4 (block =
    nfft - L + 1 >= 3L keeps redundant overlap work under ~33%)."""
    biggest = max(_NFFT_PLANS)
    for n in sorted(_NFFT_PLANS):
        if n - n_taps + 1 >= 3 * n_taps:
            return n
    if biggest - n_taps + 1 >= 1:
        return biggest
    raise ValueError(
        f"{n_taps} taps exceed the largest planned FFT ({biggest}); "
        f"cascade shorter sections instead")


def _cproducts(ar, ai, br, bi):
    """(ar + i ai) @ (br + i bi) as fixed-shape real products; ai None is a
    real left operand."""
    mm = lambda a, b: _canonical_matmul(a, b, CALL_ROWS)
    if ai is None:
        return mm(ar, br), mm(ar, bi)
    return mm(ar, br) - mm(ai, bi), mm(ar, bi) + mm(ai, br)


def _fixed_dft(xr: torch.Tensor, xi: torch.Tensor | None, plan: dict):
    """Forward DFT of frames (..., N), N = n1*n2, as ``fft.fft_4step``
    computes it (column DFTs, twiddle, row DFTs), with each product a row
    product of one fixed call shape."""
    n2, n1 = plan["w2r"].shape[0], plan["w1r"].shape[0]
    lead = xr.shape[:-1]
    # Step 1, column DFTs over n2, with n1 as the rows: (.., n1, n2) @ W2^T.
    tr = lambda v: v.reshape(*lead, n2, n1).transpose(-1, -2)
    yr, yi = _cproducts(tr(xr), None if xi is None else tr(xi),
                        plan["w2r"].T, plan["w2i"].T)  # (.., n1, k2)
    # Step 2, twiddle (transposed to (n1, k2)).
    twr, twi = plan["twr"].T, plan["twi"].T
    tr_, ti_ = yr * twr - yi * twi, yr * twi + yi * twr
    # Step 3, row DFTs over n1: (.., k2, n1) @ W1^T -> (.., k2, k1).
    zr, zi = _cproducts(tr_.transpose(-1, -2), ti_.transpose(-1, -2),
                        plan["w1r"].T, plan["w1i"].T)
    # Step 4, output index n2*k1 + k2.
    return (zr.transpose(-1, -2).reshape(*lead, n1 * n2),
            zi.transpose(-1, -2).reshape(*lead, n1 * n2))


def _fixed_idft(xr: torch.Tensor, xi: torch.Tensor, plan: dict):
    """Inverse DFT via conjugation, as ``fft.ifft_4step``."""
    n = xr.shape[-1]
    yr, yi = _fixed_dft(xr, -xi, plan)
    return yr / n, -yi / n


class FastFIRState:
    """Carried input tail: the ``history`` samples preceding the next
    chunk (per plane for IQ), plus the absolute sample offset."""

    def __init__(self, tail, offset: int = 0):
        self.tail = tail
        self.offset = int(offset)

    def to_numpy(self) -> dict:
        return {"tail": self.tail.detach().cpu().numpy(), "offset": np.int64(self.offset)}

    @classmethod
    def from_numpy(cls, d: dict, *, device="cuda") -> "FastFIRState":
        return cls(torch.tensor(np.asarray(d["tail"], np.float32), device=device),
                   int(d["offset"]))


def _fastfir_forward(xr, xi, tail_r, tail_i, hr, hi, plan, *, block: int,
                     history: int, cplx: bool):
    lead = xr.shape[:-1]
    t = xr.shape[-1]
    nfft = block + history
    buf_r = torch.cat([tail_r, xr], dim=-1)
    fr = buf_r.unfold(-1, nfft, block)  # (..., nb, nfft)
    if cplx:
        buf_i = torch.cat([tail_i, xi], dim=-1)
        Xr, Xi = _fixed_dft(fr, buf_i.unfold(-1, nfft, block), plan)
    else:
        Xr, Xi = _fixed_dft(fr, None, plan)
    Yr = Xr * hr - Xi * hi
    Yi = Xr * hi + Xi * hr
    yr, yi = _fixed_idft(Yr, Yi, plan)
    out_r = yr[..., history:].reshape(*lead, t)
    new_tail_r = buf_r[..., t:]
    if cplx:
        return out_r, yi[..., history:].reshape(*lead, t), new_tail_r, buf_i[..., t:]
    return out_r, new_tail_r


class FastFIR:
    """Streaming overlap-save FIR (``scipy.signal.lfilter(h, 1, x)``
    semantics, zero initial conditions).

    ``fir``: real or complex taps (up to 65536 - block + 1). ``nfft``: DFT
    size from {1024, ..., 65536}; the default is the smallest whose
    valid-block fraction is >= 3/4. ``block``: samples produced per DFT
    frame, at most ``nfft - len(fir) + 1`` (the default). ``dtype``: the
    reference's tier name (bf16 / f32 / f32max); the port computes every
    tier in IEEE fp32. ``device`` None means CUDA.

    Chunk lengths must be multiples of ``chunk_granularity``; chunked
    processing is bitwise identical to one-shot for any chunk mix.
    """

    def __init__(self, fir, nfft: int | None = None,
                 block: int | None = None, dtype: str = "f32max", device=None):
        if dtype not in ("bf16", "f32", "f32max"):
            raise ValueError(f"dtype must be bf16, f32 or f32max; got {dtype!r}")
        self.device = resolve_device(device, "FastFIR")
        h = np.asarray(fir).reshape(-1)
        if h.size < 2:
            raise ValueError(f"need at least 2 taps; got {h.size}")
        self.complex_taps = bool(np.iscomplexobj(h))
        h = h.astype(np.complex128 if self.complex_taps else np.float64)
        if nfft is None:
            nfft = _auto_nfft(h.size)
        if nfft not in _NFFT_PLANS:
            raise ValueError(
                f"nfft must be one of {sorted(_NFFT_PLANS)}; got {nfft}")
        max_block = nfft - h.size + 1
        if max_block < 1:
            raise ValueError(
                f"{h.size} taps do not fit an nfft={nfft} overlap-save "
                f"frame (need nfft >= taps)")
        if block is None:
            block = max_block
        if not 1 <= block <= max_block:
            raise ValueError(
                f"block must be in [1, {max_block}] for nfft={nfft} and "
                f"{h.size} taps; got {block}")
        self.fir = h
        self.dtype = dtype
        self.nfft = int(nfft)
        self.block = int(block)
        self.history = self.nfft - self.block
        n1, n2 = _NFFT_PLANS[self.nfft]
        self._plan = fft.plan_constants(n1, n2, device=self.device)
        H = np.fft.fft(h, self.nfft)
        self._hr = torch.as_tensor(np.float32(H.real), device=self.device)
        self._hi = torch.as_tensor(np.float32(H.imag), device=self.device)

    @property
    def chunk_granularity(self) -> int:
        return self.block

    def initial_state(self, batch_shape: tuple = (),
                      iq: bool | None = None) -> FastFIRState:
        """Zero history. ``iq=True`` (implied by complex taps) makes the
        tail (2, *batch_shape, history) for the planes path."""
        if iq is None:
            iq = self.complex_taps
        shape = tuple(batch_shape) + (self.history,)
        if iq:
            shape = (2,) + shape
        return FastFIRState(torch.zeros(shape, dtype=torch.float32, device=self.device), 0)

    def _check(self, shape, state: FastFIRState):
        t = shape[-1]
        if t % self.block:
            raise ValueError(
                f"chunk length {t} not a multiple of "
                f"chunk_granularity={self.block}")
        want = tuple(shape[:-1]) + (self.history,)
        if tuple(state.tail.shape) != want:
            raise ValueError(
                f"state shape {tuple(state.tail.shape)} != {want}")
        check_matmul_precision("highest")

    def process(self, x, state: FastFIRState):
        """Real stream (..., T) -> (filtered (..., T), new state). Real
        taps only: complex taps take ``process_planes``."""
        if self.complex_taps:
            raise ValueError(
                "complex taps produce IQ output; use process_planes")
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        self._check(x.shape, state)
        out, tail = _fastfir_forward(
            x, None, state.tail, None, self._hr, self._hi, self._plan,
            block=self.block, history=self.history, cplx=False)
        return out, FastFIRState(tail, state.offset + x.shape[-1])

    def process_planes(self, planes, state: FastFIRState):
        """IQ planes (2, ..., T) -> (planes (2, ..., T), new state). Real
        taps filter each plane independently; complex taps apply the full
        complex response."""
        planes = torch.as_tensor(planes, dtype=torch.float32, device=self.device)
        if planes.shape[0] != 2:
            raise ValueError(f"planes must be (2, ..., T); got "
                             f"{tuple(planes.shape)}")
        self._check(planes.shape, state)
        out_r, out_i, tail_r, tail_i = _fastfir_forward(
            planes[0], planes[1], state.tail[0], state.tail[1],
            self._hr, self._hi, self._plan,
            block=self.block, history=self.history, cplx=True)
        return (torch.stack([out_r, out_i]),
                FastFIRState(torch.stack([tail_r, tail_i]),
                             state.offset + planes.shape[-1]))
