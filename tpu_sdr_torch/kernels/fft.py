"""Four-step DFT on re/im planes (the counterpart of ``tpu_sdr.kernels.fft``).

N = n1*n2; per frame, with x[n], n = n1 + n1_size*n2, viewed as X[n2, n1]:

    1. column DFTs:  Y[k2, n1] = sum_n2  W_N2[k2, n2] * X[n2, n1]
    2. twiddle:      Y *= exp(-2*pi*i * n1 * k2 / N)
    3. row DFTs:     Z[k2, k1] = sum_n1  Y[k2, n1] * W_N1[k1, n1]
    4. output:       X_hat[n2_size*k1 + k2] = Z[k2, k1]

Steps 1 and 3 are dense matrix products (``torch.matmul`` in IEEE fp32 when
``torch.get_float32_matmul_precision()`` is "highest"). This is the plain
path for shapes the spectrum kernel does not take and for outputs other than
the magnitude; the kernel in ``kernels/cuda/iir_fft.py`` computes the same
factorization for the magnitude.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_sdr_torch.core import comm


@functools.lru_cache(maxsize=8)
def _dft_mat_np(n: int):
    k = np.arange(n)
    ang = -2.0 * np.pi * np.outer(k, k) / n
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=8)
def _twiddle_np(n1: int, n2: int):
    # tw[k2, n1] = exp(-2*pi*i*n1*k2/N)
    ang = -2.0 * np.pi * np.outer(np.arange(n2), np.arange(n1)) / (n1 * n2)
    return np.cos(ang), np.sin(ang)


def plan_constants(
    n1: int = 128, n2: int = 128, *, device="cuda", dtype=torch.float32
) -> dict:
    """FFT plan on ``device``: two DFT matrices + twiddle planes.

    Keys and values match ``tpu_sdr.kernels.fft.plan_constants``: the same
    float64 host math rounded once to ``dtype``.
    """
    w1r, w1i = _dft_mat_np(n1)
    w2r, w2i = _dft_mat_np(n2)
    twr, twi = _twiddle_np(n1, n2)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return {
        "w1r": as_t(w1r), "w1i": as_t(w1i),
        "w2r": as_t(w2r), "w2i": as_t(w2i),
        "twr": as_t(twr), "twi": as_t(twi),
    }


def _cmatmul(ar, ai, br, bi):
    """Complex matmul (ar + i*ai) @ (br + i*bi) via 4 real products."""
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def fft_4step(xr: torch.Tensor, xi: torch.Tensor | None, plan: dict):
    """Forward DFT of frames (..., N), N = n1*n2. Returns (re, im) (..., N).

    ``xi=None`` means real input (the reference feeds imag = 0); the first
    product pair then skips two of its four real products.
    """
    n2, n1 = plan["w2r"].shape[0], plan["w1r"].shape[0]
    lead = xr.shape[:-1]
    Xr = xr.reshape(*lead, n2, n1)
    # Step 1: column DFTs, contract over n2: (k2, n2) @ (..., n2, n1).
    if xi is None:
        Yr = plan["w2r"] @ Xr
        Yi = plan["w2i"] @ Xr
    else:
        Xi = xi.reshape(*lead, n2, n1)
        Yr, Yi = _cmatmul(plan["w2r"], plan["w2i"], Xr, Xi)
    # Step 2: twiddle.
    Tr = Yr * plan["twr"] - Yi * plan["twi"]
    Ti = Yr * plan["twi"] + Yi * plan["twr"]
    # Step 3: row DFTs, contract over n1: (..., k2, n1) @ (n1, k1).
    Zr, Zi = _cmatmul(Tr, Ti, plan["w1r"].T, plan["w1i"].T)
    # Step 4: output index k = n2*k1 + k2 -> transpose (k2, k1) -> (k1, k2).
    out_r = Zr.transpose(-1, -2).reshape(*lead, n1 * n2)
    out_i = Zi.transpose(-1, -2).reshape(*lead, n1 * n2)
    return out_r, out_i


def ifft_4step(xr: torch.Tensor, xi: torch.Tensor | None, plan: dict):
    """Inverse DFT via conjugation: ifft(x) = conj(fft(conj(x))) / N.

    ``xi=None`` means a real input, as in ``fft_4step``.
    """
    n = xr.shape[-1]
    yr, yi = fft_4step(xr, None if xi is None else -xi, plan)
    return yr / n, -yi / n


def fft_4step_sharded(xr_local: torch.Tensor, xi_local: torch.Tensor | None, plan: dict, axis):
    """One frame's FFT sharded ACROSS the ranks of ``axis`` (a
    ``shard.mesh.MeshAxis``): intra-FFT sharding for latency-critical
    single-stream operation.

    xr_local: (..., n2, n1/D), this rank's contiguous block of the n1
    columns. Step 1 (column DFTs) and the twiddle are local; the step-3
    contraction over n1 becomes partial products summed across the ranks
    by a reduce-scatter over k1, the four-step's transpose as a collective.
    Returns (re, im), each (..., (n1/D) * n2): this rank's k1-contiguous
    block of the natural-order spectrum (the blocks in rank order are the
    whole spectrum). Not bitwise equal to ``fft_4step``: the step-3 sums
    are split across ranks.
    """
    n1 = plan["w1r"].shape[0]
    n1l = xr_local.shape[-1]
    if n1 % n1l:
        raise ValueError(f"local shard width {n1l} must divide n1 = {n1}")
    lo = axis.index * n1l
    cols = slice(lo, lo + n1l)
    lead = xr_local.shape[:-2]
    # Step 1 (local): column DFTs over the whole n2, present on every rank.
    if xi_local is None:
        yr, yi = plan["w2r"] @ xr_local, plan["w2i"] @ xr_local
    else:
        yr, yi = _cmatmul(plan["w2r"], plan["w2i"], xr_local, xi_local)
    # Step 2 (local): the twiddle of the local columns.
    twr, twi = plan["twr"][:, cols], plan["twi"][:, cols]
    tr = yr * twr - yi * twi
    ti = yr * twi + yi * twr
    # Step 3: the partial contraction over the local n1 columns ...
    zr, zi = _cmatmul(tr, ti, plan["w1r"][:, cols].T, plan["w1i"][:, cols].T)
    # ... summed across the ranks and scattered over k1: (..., k1/D, k2).
    k1_dim = len(lead)
    zr = comm.reduce_scatter(zr.transpose(-1, -2), axis, k1_dim)
    zi = comm.reduce_scatter(zi.transpose(-1, -2), axis, k1_dim)
    # Natural order k = n2*k1 + k2: (k1_local, k2) flattened is this block.
    return zr.reshape(*lead, -1), zi.reshape(*lead, -1)


def fft_golden_check(xr, xi=None):
    """NumPy oracle with matching signature (host-side, tests only)."""
    x = np.asarray(xr, np.float64)
    if xi is not None:
        x = x + 1j * np.asarray(xi, np.float64)
    s = np.fft.fft(x, axis=-1)
    return s.real, s.imag
