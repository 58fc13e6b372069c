"""The fused spectrum kernel and its plan (the counterpart of
``tpu_sdr.kernels.pallas.iir_fft``).

``build_plan`` builds every constant of the reference plan, so that later
kernels (the in-kernel IIR, the IQ kernel) and the weight converter can use
it. ``spectrum_from_state`` is implemented in its ``bypass=True`` form:
optional Hann window, the 16384-point four-step DFT and the magnitude, stored
in natural order. On a CUDA tensor it launches the hand-written kernel in
``tpu_sdr_torch/csrc/spectrum_bypass.cu``; on a CPU tensor it runs the plain
PyTorch version of the same function (``spectrum_bypass_plain``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as nnf

from tpu_sdr_torch.kernels import biquad, fft, magnitude
from tpu_sdr_torch.kernels.cuda import loader

LOG2B = 7  # B = 128 blocks per frame
MAX_GROUP = 8  # frames per group in the reference kernel's tiled planes
HALF_K2 = 72  # half-spectrum rows: k2 in [0, 64] padded to a multiple of 8

PRECISIONS = ("highest", "high3", "default")
OUT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Launches of the CUDA kernel ("kernel") and CPU calls of the plain version
# made by ``spectrum_from_state`` ("plain"). Read and reset by callers that
# check which path a run took.
counts = {"kernel": 0, "plain": 0}


@dataclasses.dataclass(frozen=True)
class PallasSOSPlan:
    """Device constants of the fused spectrum pipeline (host float64 math).

    The leaves and their shapes are those of the reference plan (class name
    kept so that a plan maps 1:1 between the packages): T (L, L) Toeplitz
    impulse response; PT (L, m) forcing; MT (m, L) state injection; AL1T
    (m, m) = AL^T; ALpowsT (LOG2B, m, m) = (AL^(2^k))^T; ALB (m, m) frame
    transition; U (G*B, G) frame-start scatter; V (G, G*B) frame-end gather;
    EYE (m, 128) lane projection; win (n2, n1) window; the DFT planes; the
    G-tiled twiddle planes (n2, G*n1); the half-spectrum rows.
    """

    T: torch.Tensor
    PT: torch.Tensor
    MT: torch.Tensor
    AL1T: torch.Tensor
    ALpowsT: torch.Tensor
    ALB: torch.Tensor
    U: torch.Tensor
    V: torch.Tensor
    EYE: torch.Tensor
    win: torch.Tensor
    w1r: torch.Tensor
    w1i: torch.Tensor
    w2r: torch.Tensor
    w2i: torch.Tensor
    twr: torch.Tensor
    twi: torch.Tensor
    w2r_h: torch.Tensor
    w2i_h: torch.Tensor
    twr_h: torch.Tensor
    twi_h: torch.Tensor

    @property
    def state_dim(self) -> int:
        return self.MT.shape[0]

    @functools.cached_property
    def fft_plan(self) -> dict:
        """The (n2, n1) FFT plan the spectrum uses, for the plain version."""
        n1 = self.w1r.shape[0]
        return {
            "w1r": self.w1r, "w1i": self.w1i,
            "w2r": self.w2r, "w2i": self.w2i,
            "twr": self.twr[:, :n1], "twi": self.twi[:, :n1],
        }

    @functools.cached_property
    def kernel_constants(self) -> tuple:
        """(tab (4, 128), twr (128, 128), twi (128, 128)) for the kernel.

        W128[k, n] = W128[1, (k*n) mod 128], so row 1 of each DFT plane is
        the whole table; it holds the values computed from the reduced
        angle, which differ from the plan's other rows by at most 1 ulp.
        """
        tab = torch.stack([self.w2r[1], self.w2i[1], self.w1r[1], self.w1i[1]])
        n1 = self.w1r.shape[0]
        return (
            tab.contiguous(),
            self.twr[:, :n1].contiguous(),
            self.twi[:, :n1].contiguous(),
        )


def build_plan(
    sos: np.ndarray,
    win: torch.Tensor,
    fft_plan: dict,
    block: int = 128,
    frame_blocks: int = 128,
    dtype=torch.float32,
) -> PallasSOSPlan:
    """Build the plan on the device that ``fft_plan`` lives on.

    Every leaf equals the reference ``build_plan`` leaf bitwise in float32:
    the same float64 host math rounded once, and placement (tile, slice,
    pad) done on the device.
    """
    if block != 128 or frame_blocks != 128:
        raise ValueError(
            f"the kernel plan requires block=frame_blocks=128, got "
            f"{block}x{frame_blocks}"
        )
    n1 = fft_plan["w1r"].shape[0]
    n2 = fft_plan["w2r"].shape[0]
    if n1 != 128 or n2 != 128:
        raise ValueError(
            f"the kernel plan requires the 128x128 four-step FFT, got "
            f"fft_n1={n1}, fft_n2={n2}"
        )
    device = fft_plan["w1r"].device
    T, M, P, alpows = biquad._composite_host_parts(sos, block, frame_blocks)
    m = M.shape[-1]
    B = frame_blocks
    G = MAX_GROUP
    AL = alpows[1]
    alpow = [alpows[2**j] for j in range(LOG2B)]
    ALB = alpows[B]

    # Frame-start scatter / frame-end gather for a group of G frames.
    U = np.zeros((G * B, G))
    V = np.zeros((G, G * B))
    for f in range(G):
        U[f * B, f] = 1.0
        V[f, f * B + B - 1] = 1.0

    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    twr = fft_plan["twr"].repeat(1, G).to(dtype)
    twi = fft_plan["twi"].repeat(1, G).to(dtype)

    def half_rows(a2d: torch.Tensor) -> torch.Tensor:
        # rows k2 in [0, n2/2] zero-padded to HALF_K2 rows
        keep = a2d[: n2 // 2 + 1]
        return nnf.pad(keep, (0, 0, 0, HALF_K2 - keep.shape[0])).to(dtype)

    return PallasSOSPlan(
        T=as_t(T),
        PT=as_t(P.T),
        MT=as_t(M.T),
        AL1T=as_t(AL.T),
        ALpowsT=as_t(np.stack([a.T for a in alpow])),
        ALB=as_t(ALB),
        U=as_t(U),
        V=as_t(V),
        EYE=as_t(np.eye(m, 128)),
        win=win.to(device=device, dtype=dtype).reshape(n2, n1),
        w1r=fft_plan["w1r"].to(dtype),
        w1i=fft_plan["w1i"].to(dtype),
        w2r=fft_plan["w2r"].to(dtype),
        w2i=fft_plan["w2i"].to(dtype),
        twr=twr,
        twi=twi,
        w2r_h=half_rows(fft_plan["w2r"]),
        w2i_h=half_rows(fft_plan["w2i"]),
        twr_h=half_rows(twr),
        twi_h=half_rows(twi),
    )


def spectrum_bypass_plain(
    x: torch.Tensor,
    plan: PallasSOSPlan,
    apply_window: bool = True,
    out_dtype: str = "float32",
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: x (F, N) -> |DFT| (F, N).

    Window (optional), ``fft.fft_4step``, magnitude, then one rounding to
    ``out_dtype``. Runs on any device; the wrapper takes it only for CPU
    tensors.
    """
    xf = x.float()
    if apply_window:
        xf = xf * plan.win.reshape(-1)
    fr, fi = fft.fft_4step(xf, None, plan.fft_plan)
    return magnitude.magnitude(fr, fi).to(OUT_DTYPES[out_dtype])


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = loader.load("spectrum_bypass")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tpu_sdr_spectrum_bypass.argtypes = [p, i, p, p, p, p, p, i, i, p]
    lib.tpu_sdr_spectrum_bypass.restype = i
    lib.tpu_sdr_cuda_error_string.argtypes = [i]
    lib.tpu_sdr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t if contiguous and 16-byte aligned, else a contiguous copy: the
    kernel loads frames and the window 16 bytes at a time, and a contiguous
    view can start at any element (``x1d[3:3 + n]``)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def spectrum_bypass_cuda(
    x: torch.Tensor,
    plan: PallasSOSPlan,
    apply_window: bool = True,
    out_dtype: str = "float32",
) -> torch.Tensor:
    """Launch the CUDA kernel on x (F, 16384) fp32/bf16 on a CUDA device.

    Raises if the kernel cannot be built or launched; never falls back.
    """
    n = plan.win.numel()
    if x.dim() != 2 or x.shape[1] != n:
        raise ValueError(f"x must be (F, {n}), got {tuple(x.shape)}")
    F = x.shape[0]
    if x.device.type != "cuda":
        raise ValueError(f"spectrum kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"spectrum kernel takes fp32 or bf16 input, got {x.dtype}")
    if F >= 2**31:
        raise ValueError(f"too many frames for one launch: {F}")
    tab, twr, twi = plan.kernel_constants
    win = _aligned(plan.win)
    for name, t in (("tab", tab), ("twr", twr), ("twi", twi), ("win", win)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(
                f"plan leaf {name} is {t.dtype} on {t.device}; the kernel "
                f"needs float32 on {x.device}"
            )
    x = _aligned(x)
    out = torch.empty((F, n), dtype=OUT_DTYPES[out_dtype], device=x.device)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tpu_sdr_spectrum_bypass(
            x.data_ptr(),
            int(x.dtype == torch.bfloat16),
            win.data_ptr() if apply_window else None,
            tab.data_ptr(),
            twr.data_ptr(),
            twi.data_ptr(),
            out.data_ptr(),
            int(out_dtype == "bfloat16"),
            F,
            stream,
        )
    if err != 0:
        msg = lib.tpu_sdr_cuda_error_string(err).decode()
        raise RuntimeError(f"spectrum kernel launch failed: CUDA error {err} ({msg})")
    counts["kernel"] += 1
    return out


def spectrum_from_state(
    x: torch.Tensor,
    z_starts: torch.Tensor,
    plan: PallasSOSPlan,
    interpret: bool = False,
    precision: str = "highest",
    bypass: bool = False,
    apply_window: bool = True,
    half_spectrum: bool = False,
    karatsuba: bool = False,
    out_dtype: str = "float32",
    flat_emit: bool = False,
    blocked_output: bool = False,
) -> torch.Tensor:
    """x (F, N) frames + per-frame entry states (F, m) -> magnitudes (F, N).

    The keywords are the reference's. Implemented: ``bypass=True`` (the
    entry states are then unused) with ``apply_window`` True/False,
    ``out_dtype`` "float32"/"bfloat16" (the fp32 result rounded once on
    store) and ``flat_emit`` True/False (natural-order (F, N) either way).
    ``precision`` ("highest" | "high3" | "default") and ``karatsuba`` are
    validated and accepted: the kernel computes in IEEE fp32 at every tier.
    ``interpret`` has no meaning for a CUDA kernel: the plain version runs
    exactly when x lies on the CPU, and ``interpret=True`` on a CUDA tensor
    raises.

    Not ported yet (NotImplementedError): ``bypass=False`` (ROADMAP queue A
    item 1, kernel row 2), ``half_spectrum`` and ``blocked_output`` (queue A
    item 6, kernel row 4).
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {tuple(OUT_DTYPES)}, got {out_dtype!r}")
    if not bypass:
        raise NotImplementedError(
            "spectrum_from_state(bypass=False), the in-kernel IIR: ROADMAP "
            "queue A item 1 (kernel row 2)"
        )
    if half_spectrum or blocked_output:
        raise NotImplementedError(
            "spectrum_from_state half_spectrum / blocked_output: ROADMAP "
            "queue A item 6 (kernel row 4)"
        )
    n2, n1 = plan.win.shape
    F = x.shape[0]
    if x.shape != (F, n1 * n2):
        raise ValueError(f"x must be (F, {n1 * n2}), got {tuple(x.shape)}")
    if tuple(z_starts.shape) != (F, plan.state_dim):
        raise ValueError(
            f"z_starts must be ({F}, {plan.state_dim}), got {tuple(z_starts.shape)}"
        )
    if x.device.type == "cpu":
        counts["plain"] += 1
        return spectrum_bypass_plain(x, plan, apply_window, out_dtype)
    if interpret:
        raise ValueError("interpret=True: a CUDA kernel has no interpret mode")
    return spectrum_bypass_cuda(x, plan, apply_window, out_dtype)
