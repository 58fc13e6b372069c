"""Fused FM demodulation (the counterpart of
``tpu_sdr.kernels.pallas.affine_scan``).

``fm_demod_pallas`` computes the quadrature discriminator, the deviation
scale and the one-pole de-emphasis of (C, T) re/im planes with the carried
state (previous complex sample, filter state) of each channel. On a CUDA
tensor it launches ``csrc/fm_demod.cu``; on a CPU tensor it runs
``fm_demod_plain``, the same arithmetic in PyTorch: the octant-reduced
polynomial atan2 with signs from the IEEE sign bits, the roll-and-mask
Hillis-Steele tree over 128-sample blocks and ``kernels.demod``'s
sequential block chain. The plain version is not ``kernels.demod``'s path
(a library atan and a pad-shift tree): the two agree to float rounding,
not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sdr_torch.kernels import demod
from tpu_sdr_torch.kernels.cuda import launch

L = 128  # the canonical affine block (matches kernels/demod)

# atan(r) ~= r * P(r^2) on [0, 1]: the reference's degree-17 odd polynomial
# (max |err| 1.3e-7 in f32 Horner), highest coefficient last; each value is
# rounded to fp32 once, from the same double the reference rounds.
_ATAN_C = tuple(float(np.float32(c)) for c in (
    9.999999055e-01, -3.333265785e-01, 1.998653749e-01, -1.416433338e-01,
    1.050731979e-01, -7.247950662e-02, 3.989956004e-02, -1.445869707e-02,
    2.468246625e-03,
))
_PI = float(np.float32(np.pi))
_HALF_PI = float(np.float32(np.pi / 2))


def _atan2_poly(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Octant-reduced atan2 from multiplies, adds and one division.

    IEEE signed zeros are kept: atan2(+-0, -0) = +-pi and atan2(+-0, +0) =
    +-0, which the discriminator's zero-state first sample hits."""
    ax, ay = x.abs(), y.abs()
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    r = lo / torch.where(hi > 0, hi, 1.0)
    r2 = r * r
    p = torch.full_like(r2, _ATAN_C[-1])
    for c in _ATAN_C[-2::-1]:
        p = p * r2 + c
    a = p * r
    a = torch.where(ay > ax, _HALF_PI - a, a)
    a = torch.where(torch.signbit(x), _PI - a, a)
    return torch.where(torch.signbit(y), -a, a)


def _scale(fs: float, dev: float, pole):
    """(fs / 2pi, 1 / dev, pole, 1 - pole), each an fp32 value as the
    reference rounds it (pole and 1 - pole are None without a pole)."""
    k_hz = float(np.float32(fs / (2.0 * np.pi)))
    k_dev = float(np.float32(1.0 / dev))
    if pole is None:
        return k_hz, k_dev, None, None
    a = np.float32(pole)
    return k_hz, k_dev, float(a), float(np.float32(1.0) - a)


def _discriminate(re, im, prev_re, prev_im, k_hz, k_dev):
    re1 = torch.cat([prev_re, re[:, :-1]], dim=-1)
    im1 = torch.cat([prev_im, im[:, :-1]], dim=-1)
    dot = re * re1 + im * im1
    cross = im * re1 - re * im1
    return _atan2_poly(cross, dot) * k_hz * k_dev


def _roll_tree(A: torch.Tensor, B: torch.Tensor):
    """Inclusive Hillis-Steele prefix over the last (128-lane) axis: each
    element combined with the one d before it, identity maps (A 1, B 0)
    before the block start."""
    lane = torch.arange(L, device=A.device)
    d = 1
    while d < L:
        keep = lane >= d
        A_e = torch.where(keep, torch.roll(A, d, dims=-1), 1.0)
        B_e = torch.where(keep, torch.roll(B, d, dims=-1), 0.0)
        A, B = A * A_e, A * B_e + B
        d *= 2
    return A, B


def fm_demod_plain(re, im, prev_re, prev_im, y0, *, fs: float, dev: float, pole):
    """The plain PyTorch version of ``fm_demod_pallas``: (C, T) planes,
    T a multiple of 128 -> (audio (C, T), prev_re (C, 1), prev_im (C, 1),
    filt (C,))."""
    k_hz, k_dev, a, oma = _scale(fs, dev, pole)
    audio = _discriminate(re, im, prev_re, prev_im, k_hz, k_dev)
    prev = (re[:, -1:].clone(), im[:, -1:].clone())
    if pole is None:
        return (audio, *prev, y0.clone())
    c, t = re.shape
    B = (audio * oma).reshape(c, t // L, L)
    A, B = _roll_tree(torch.full_like(B, a), B)
    y, y_in = demod._chain_blocks(A[..., -1], B[..., -1], y0)
    out = A * y_in[..., None] + B
    return (out.reshape(c, t), *prev, y)


def fm_demod_cuda(re, im, prev_re, prev_im, y0, *, fs: float, dev: float, pole):
    """Launch ``csrc/fm_demod.cu`` on (C, T) fp32 planes on a CUDA device.
    Raises if the kernel cannot be built or launched."""
    c, t = re.shape
    dev_ = re.device
    shapes = {"re": (re, (c, t)), "im": (im, (c, t)), "prev_re": (prev_re, (c, 1)),
              "prev_im": (prev_im, (c, 1)), "y0": (y0, (c,))}
    for name, (v, shape) in shapes.items():
        if v.device != dev_ or v.dtype != torch.float32 or tuple(v.shape) != shape:
            raise ValueError(
                f"{name} must be {shape} float32 on {dev_}, got "
                f"{tuple(v.shape)} {v.dtype} on {v.device}"
            )
    if dev_.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev_}")
    if t % L or c * (t // L) >= 2**31:
        raise ValueError(f"T must be a multiple of {L} and C*T/{L} < 2^31, got {(c, t)}")
    k_hz, k_dev, a, oma = _scale(fs, dev, pole)
    re, im = launch.aligned(re), launch.aligned(im)
    prev_re, prev_im, y0 = (v.contiguous() for v in (prev_re, prev_im, y0))
    f32 = dict(dtype=torch.float32, device=dev_)
    audio = torch.empty((c, t), **f32)
    pr_out = torch.empty((c, 1), **f32)
    pi_out = torch.empty((c, 1), **f32)
    filt = torch.empty((c,), **f32)
    blocks = t // L
    has_pole = pole is not None
    # the chain's scratch: each block's final map and its entry state, and
    # the launch's ticket counter, progress counts and map-tile flags (at
    # most one a block)
    ab = torch.empty((c * blocks * 2,), **f32) if has_pole else None
    y_in = torch.empty((c * blocks,), **f32) if has_pole else None
    sync = torch.empty((1 + c * (1 + blocks),), dtype=torch.int32, device=dev_) if has_pole else None
    ptr = lambda v: None if v is None else v.data_ptr()
    launch.launch(
        "fm_demod", dev_,
        re.data_ptr(), im.data_ptr(), prev_re.data_ptr(), prev_im.data_ptr(),
        y0.data_ptr(), audio.data_ptr(), pr_out.data_ptr(), pi_out.data_ptr(),
        filt.data_ptr(), ptr(ab), ptr(y_in), ptr(sync), c, blocks,
        k_hz, k_dev, a if has_pole else 0.0, oma if has_pole else 0.0, int(has_pole),
    )
    return audio, pr_out, pi_out, filt


def fm_demod_pallas(re, im, prev_re, prev_im, y0, *, fs: float, dev: float, pole,
                    rows_per_tile: int = 64, interpret: bool = False):
    """Fused FM forward: (C, T) planes -> (audio (C, T), prev_re (C, 1),
    prev_im (C, 1), filt (C,)). T must be a multiple of rows_per_tile*128,
    as in the reference, whose tile width it was; the result does not depend
    on it. ``pole`` None skips the de-emphasis (filt is y0). ``interpret``
    has no meaning for a CUDA kernel: the plain version runs exactly when re
    lies on the CPU, and ``interpret=True`` on a CUDA tensor raises."""
    c, t = re.shape
    w = rows_per_tile * L
    if t % w:
        raise ValueError(f"T={t} not a multiple of tile width {w}")
    if launch.on_cpu("fm_demod", re, interpret):
        return fm_demod_plain(re, im, prev_re, prev_im, y0, fs=fs, dev=dev, pole=pole)
    return fm_demod_cuda(re, im, prev_re, prev_im, y0, fs=fs, dev=dev, pole=pole)
