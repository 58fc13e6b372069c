"""Fused window + four-step FFT + magnitude with a given plan (the
counterpart of ``tpu_sdr.kernels.pallas.spectrum``).

``fft_mag_fused`` takes its window and all six plan planes as arguments and
computes with them as given. On a CUDA tensor it launches
``csrc/fft_mag_fused.cu`` (n1 = n2 = 128 only: the products on the tensor
cores, each fp32 operand split into three bf16 pieces, six piece products,
as the TPU's precision="highest"); on a CPU tensor it runs
``fft_mag_fused_plain`` (IEEE fp32), at any geometry.
"""

from __future__ import annotations

import torch

from tpu_sdr_torch.kernels import fft, magnitude
from tpu_sdr_torch.kernels.cuda import launch

PRECISIONS = ("highest", "high", "default")
PLAN_KEYS = ("w2r", "w2i", "twr", "twi", "w1r", "w1i")


def fft_mag_fused_plain(frames: torch.Tensor, win: torch.Tensor, plan: dict) -> torch.Tensor:
    """The plain PyTorch version: ``fft.fft_4step`` of frames * win with the
    given plan, then the magnitude; (F, N) float32, natural order."""
    fr, fi = fft.fft_4step(frames.float() * win.float(), None, plan)
    return magnitude.magnitude(fr, fi)


def fft_mag_fused_cuda(frames: torch.Tensor, win: torch.Tensor, plan: dict) -> torch.Tensor:
    """Launch ``fft_mag_fused.cu`` on frames (F, 16384) fp32 with win
    (16384,) and the six (128, 128) fp32 plan planes, all on one CUDA
    device. Raises if the kernel cannot be built or launched."""
    if frames.device.type != "cuda":
        raise ValueError(f"the kernel needs a CUDA tensor, got frames on {frames.device}")
    if frames.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32 frames, got {frames.dtype}")
    if frames.shape[0] >= 2**31:
        raise ValueError(f"too many frames for one launch: {frames.shape[0]}")
    consts = {"win": win, **{k: plan[k] for k in PLAN_KEYS}}
    for name, t in consts.items():
        if t.device != frames.device or t.dtype != torch.float32:
            raise ValueError(
                f"{name} is {t.dtype} on {t.device}; the kernel needs float32 "
                f"on {frames.device}"
            )
    consts = {k: launch.aligned(t) for k, t in consts.items()}
    x = launch.aligned(frames)
    out = torch.empty_like(x)
    launch.launch(
        "fft_mag_fused", x.device, x.data_ptr(),
        *(consts[k].data_ptr() for k in ("win", *PLAN_KEYS)),
        out.data_ptr(), x.shape[0],
    )
    return out


def fft_mag_fused(
    frames: torch.Tensor,
    win: torch.Tensor,
    plan: dict,
    n1: int = 128,
    n2: int = 128,
    interpret: bool = False,
    precision: str = "highest",
) -> torch.Tensor:
    """frames (F, N) float32, win (N,) -> magnitude (F, N), N = n1 * n2.

    Output index k = n2*k1 + k2 (natural order), identical to
    ``fft.fft_4step`` + ``magnitude`` with the same plan. ``plan`` holds
    w2r, w2i (n2, n2), twr, twi (n2, n1) and w1r, w1i (n1, n1); the kernel
    computes with exactly these planes. ``precision`` is validated and
    accepted; the kernel runs its six-pass split at every value, the plain
    version IEEE fp32; ``interpret`` as in
    ``iir_fft.spectrum_from_state``. The CUDA kernel takes n1 = n2 = 128
    only; another geometry on a CUDA tensor raises ValueError.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    n = n1 * n2
    if frames.dim() != 2 or frames.shape[1] != n:
        raise ValueError(f"frames must be (F, {n}) for n1={n1}, n2={n2}, got {tuple(frames.shape)}")
    if tuple(win.shape) != (n,):
        raise ValueError(f"win must be ({n},), got {tuple(win.shape)}")
    want = {"w2r": (n2, n2), "w2i": (n2, n2), "twr": (n2, n1), "twi": (n2, n1),
            "w1r": (n1, n1), "w1i": (n1, n1)}
    for k, shape in want.items():
        if tuple(plan[k].shape) != shape:
            raise ValueError(f"plan[{k!r}] must be {shape}, got {tuple(plan[k].shape)}")
    if launch.on_cpu("fft_mag_fused", frames, interpret):
        return fft_mag_fused_plain(frames, win, plan)
    if (n1, n2) != (128, 128):
        raise ValueError(
            f"the fft_mag_fused kernel takes n1 = n2 = 128, got n1={n1}, n2={n2}"
        )
    return fft_mag_fused_cuda(frames, win, plan)
