"""The fused spectrum kernels and their plan (the counterpart of
``tpu_sdr.kernels.pallas.iir_fft``).

``build_plan`` builds every constant of the reference plan. Four kernels,
each a hand-written CUDA source in ``tpu_sdr_torch/csrc/``, and five
functions, each with a plain PyTorch version beside it:

- ``spectrum_from_state(bypass=True)``: optional Hann window, the
  16384-point four-step DFT and the magnitude, natural order
  (``spectrum_bypass.cu``; ``spectrum_bypass_plain``).
- ``spectrum_from_state(bypass=False)``: the same after the composite IIR,
  run inside the kernel from each frame's entry state (``spectrum_iir.cu``;
  ``spectrum_iir_plain``).
- ``iir_summaries``: each frame's zero-state IIR end state, which seeds the
  frame chain of the fused two-pass pipeline: the kernel takes it as one
  product with the plan's ``summary_matrix`` (``iir_summaries.cu``), the
  plain version as the block chain (``iir_summaries_plain``).
- ``spectrum_mag_complex``: the magnitude spectrum of IQ frames given as re
  and im planes (``spectrum_complex.cu``; ``spectrum_complex_plain``).
- ``spectrum_from_state(half_spectrum=True)``, either form: the DFT of rows
  k2 in [0, 64] only and the mirror |X[N - k]| = |X[k]| of a real frame,
  which is what the bypass and IIR kernels compute, so it launches them
  (``spectrum_half_cuda``; ``spectrum_half_plain``).

Each public function runs its plain version exactly when its input lies on
the CPU, and launches the kernel on a CUDA tensor; it never falls back.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as nnf

from tpu_sdr_torch.kernels import biquad, fft, magnitude
from tpu_sdr_torch.kernels.cuda import launch

LOG2B = 7  # B = 128 blocks per frame
MAX_GROUP = 8  # frames per group in the reference kernel's tiled planes
HALF_K2 = 72  # half-spectrum rows: k2 in [0, 64] padded to a multiple of 8

PRECISIONS = ("highest", "high3", "default")
OUT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# This module's kernels, by the name of their source (``csrc/<name>.cu``).
KERNELS = ("spectrum_bypass", "spectrum_iir", "iir_summaries", "spectrum_complex")

# Launches and plain calls of every kernel of the port (``launch.counts``).
counts = launch.counts
reset_counts = launch.reset_counts


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
        """(tab (4, 128), twr (128, 128), twi (128, 128)) for the kernels.

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

    @functools.cached_property
    def iir_constants(self) -> tuple:
        """(h (L,), PT (L, m), MT (m, L), AL1T (m, m)) for the IIR kernels.

        T is Toeplitz, T[i, k] = h[i - k] for i >= k and 0 above the
        diagonal, so its first column h is the whole matrix.
        """
        return (
            self.T[:, 0].contiguous(),
            self.PT.contiguous(),
            self.MT.contiguous(),
            self.AL1T.contiguous(),
        )

    @functools.cached_property
    def summary_matrix(self) -> torch.Tensor:
        """K_w (m, N) fp32, the map from a raw frame to its zero-state end
        state: ``iir_summaries(x) = x @ K_w.T`` in exact arithmetic.

        Block j of the frame reaches the end state through AL^(B-1-j) P, so
        K_w[:, L j + k] = (AL^(B-1-j) P)[:, k] * win[L j + k]. Computed in
        float64 on the plan's device from its own fp32 AL1T, PT and win (the
        same function on the same plan), and rounded once. Built on first
        use and cached with the plan.
        """
        AL = self.AL1T.double().T
        P = self.PT.double().T  # (m, L)
        powers = [P]  # AL^d P
        for _ in range(self.win.shape[0] - 1):
            powers.append(AL @ powers[-1])
        K = torch.stack(powers[::-1], dim=1).reshape(self.state_dim, -1)
        return (K * self.win.double().reshape(-1)).float().contiguous()


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


# ---------------------------------------------------------------- plain versions


def spectrum_bypass_plain(
    x: torch.Tensor,
    plan: PallasSOSPlan,
    apply_window: bool = True,
    out_dtype: str = "float32",
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: x (F, N) -> |DFT| (F, N).

    ``spectrum_complex_plain`` of a real input. Runs on any device; the
    wrapper takes it only for CPU tensors.
    """
    return spectrum_complex_plain(x, None, plan, apply_window, out_dtype)


def _blocks(x: torch.Tensor, plan: PallasSOSPlan, apply_window: bool) -> torch.Tensor:
    """x (F, N) -> the (optionally windowed) fp32 frames as (F, B, L) blocks."""
    n2, n1 = plan.win.shape
    xf = x.float()
    if apply_window:
        xf = xf * plan.win.reshape(-1)
    return xf.reshape(-1, n2, n1)


def _block_chain(plan: PallasSOSPlan, f: torch.Tensor, z: torch.Tensor):
    """The in-frame block chain: f (F, B, m) forcing, z (F, m) entry states
    -> (z_in (F, B, m), the state after the frame (F, m)).

    z_in[:, j] is the state entering block j; z <- AL z + f[:, j]. Each step
    is an elementwise multiply and a sum over m, like ``biquad.alb_step``,
    so a frame's bits do not depend on how many frames share the call.
    """
    AL = plan.AL1T.T
    z_in = []
    for j in range(f.shape[1]):
        z_in.append(z)
        z = (AL * z[:, None, :]).sum(dim=-1) + f[:, j]
    return torch.stack(z_in, dim=1), z


def _rows(plan: PallasSOSPlan) -> int:
    """Block rows per product call: ``biquad.CANONICAL_FRAMES`` frames."""
    return biquad.CANONICAL_FRAMES * plan.win.shape[0]


def iir_summaries_plain(x: torch.Tensor, plan: PallasSOSPlan) -> torch.Tensor:
    """The plain PyTorch version of ``iir_summaries``: x (F, N) -> (F, m).

    Window, forcing xw @ PT through ``biquad._canonical_matmul``, the block
    chain from rest; returns the state after each frame.
    """
    xw = _blocks(x, plan, apply_window=True)
    f = biquad._canonical_matmul(xw, plan.PT, _rows(plan))
    zero = torch.zeros((xw.shape[0], plan.state_dim), dtype=f.dtype, device=f.device)
    return _block_chain(plan, f, zero)[1]


def spectrum_iir_plain(
    x: torch.Tensor,
    z_starts: torch.Tensor,
    plan: PallasSOSPlan,
    apply_window: bool = True,
    out_dtype: str = "float32",
) -> torch.Tensor:
    """The plain PyTorch version of ``spectrum_from_state(bypass=False)``.

    Per frame from its entry state: y_zs = xw @ T^T, the forcing xw @ PT and
    the state product z_in @ MT through ``biquad._canonical_matmul``, the
    block chain of ``_block_chain``, y = y_zs + z_in @ MT; then
    ``spectrum_bypass_plain`` of y without a window.
    """
    return spectrum_bypass_plain(_iir_y(x, z_starts, plan, apply_window), plan, False, out_dtype)


def _iir_y(x, z_starts, plan: PallasSOSPlan, apply_window: bool) -> torch.Tensor:
    """The composite IIR of each frame from its entry state: (F, N) fp32."""
    xw = _blocks(x, plan, apply_window)
    rows = _rows(plan)
    y_zs = biquad._canonical_matmul(xw, plan.T.T, rows)
    f = biquad._canonical_matmul(xw, plan.PT, rows)
    z_in, _ = _block_chain(plan, f, z_starts.float())
    y = y_zs + biquad._canonical_matmul(z_in, plan.MT, rows)
    return y.reshape(x.shape[0], -1)


def spectrum_half_plain(
    x: torch.Tensor,
    z_starts: torch.Tensor | None,
    plan: PallasSOSPlan,
    apply_window: bool = True,
    out_dtype: str = "float32",
) -> torch.Tensor:
    """The plain PyTorch version of ``spectrum_from_state(half_spectrum=
    True)``: x (F, N) -> |DFT| (F, N), natural order.

    z_starts None is the bypass form (window only), else the IIR form of
    ``spectrum_iir_plain``. The four-step DFT runs on rows k2 in [0, n2/2]
    of the column DFT only; the magnitudes, rounded once to ``out_dtype``,
    fill out[k1, k2] for k2 <= n2/2 and are copied to the mirrored bins
    out[k1, k2] = out[n1 - 1 - k1, n2 - k2] for k2 > n2/2.
    """
    if z_starts is None:
        y = _blocks(x, plan, apply_window).reshape(x.shape[0], -1)
    else:
        y = _iir_y(x, z_starts, plan, apply_window)
    p = plan.fft_plan
    n2, n1 = plan.win.shape
    h = n2 // 2 + 1
    X = y.reshape(-1, n2, n1)
    Yr, Yi = p["w2r"][:h] @ X, p["w2i"][:h] @ X
    Tr = Yr * p["twr"][:h] - Yi * p["twi"][:h]
    Ti = Yr * p["twi"][:h] + Yi * p["twr"][:h]
    Zr, Zi = fft._cmatmul(Tr, Ti, p["w1r"].T, p["w1i"].T)  # (F, k2 < h, k1)
    top = magnitude.magnitude(Zr, Zi).to(OUT_DTYPES[out_dtype]).transpose(1, 2)
    mirror = top.flip(1)[:, :, 1 : h - 1].flip(2)  # out[n1-1-k1, n2-k2]
    return torch.cat([top, mirror], dim=2).reshape(x.shape[0], -1)


def spectrum_complex_plain(
    xr: torch.Tensor,
    xi: torch.Tensor | None,
    plan: PallasSOSPlan,
    apply_window: bool = True,
    out_dtype: str = "float32",
) -> torch.Tensor:
    """The plain PyTorch version of ``spectrum_mag_complex``: window both
    planes (optional), ``fft.fft_4step`` of xr + i*xi, magnitude, one
    rounding to ``out_dtype``. xi None is a real input."""
    planes = [None if t is None else t.float() for t in (xr, xi)]
    if apply_window:
        w = plan.win.reshape(-1)
        planes = [None if t is None else t * w for t in planes]
    fr, fi = fft.fft_4step(*planes, plan.fft_plan)
    return magnitude.magnitude(fr, fi).to(OUT_DTYPES[out_dtype])


# ---------------------------------------------------------------- CUDA launches


def _check_frames(what: str, x: torch.Tensor, plan: PallasSOSPlan, dtypes) -> int:
    """Validate a (F, N) CUDA input of a kernel; returns F."""
    n = plan.win.numel()
    if x.dim() != 2 or x.shape[1] != n:
        raise ValueError(f"{what} must be (F, {n}), got {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"the kernel needs a CUDA tensor, got {what} on {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"the kernel takes {what} as {dtypes}, got {x.dtype}")
    if x.shape[0] >= 2**31:
        raise ValueError(f"too many frames for one launch: {x.shape[0]}")
    return x.shape[0]


def _check_leaves(device: torch.device, **leaves):
    for name, t in leaves.items():
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(
                f"plan leaf {name} is {t.dtype} on {t.device}; the kernel "
                f"needs float32 on {device}"
            )


def _check_state_dim(plan: PallasSOSPlan):
    if plan.state_dim != 12:
        raise ValueError(f"the IIR kernels take m = 12 states, got {plan.state_dim}")


def _check_z_starts(z_starts: torch.Tensor, F: int, plan: PallasSOSPlan):
    if tuple(z_starts.shape) != (F, plan.state_dim) or z_starts.dtype != torch.float32:
        raise ValueError(
            f"z_starts must be ({F}, {plan.state_dim}) float32, got "
            f"{tuple(z_starts.shape)} {z_starts.dtype}"
        )


def spectrum_bypass_cuda(
    x: torch.Tensor,
    plan: PallasSOSPlan,
    apply_window: bool = True,
    out_dtype: str = "float32",
) -> torch.Tensor:
    """Launch ``spectrum_bypass.cu`` on x (F, 16384) fp32/bf16 on a CUDA
    device. Raises if the kernel cannot be built or launched."""
    F = _check_frames("x", x, plan, (torch.float32, torch.bfloat16))
    tab, twr, twi = plan.kernel_constants
    win = launch.aligned(plan.win)
    _check_leaves(x.device, tab=tab, twr=twr, twi=twi, win=win)
    x = launch.aligned(x)
    out = torch.empty((F, x.shape[1]), dtype=OUT_DTYPES[out_dtype], device=x.device)
    launch.launch(
        "spectrum_bypass", x.device,
        x.data_ptr(), int(x.dtype == torch.bfloat16),
        win.data_ptr() if apply_window else None,
        tab.data_ptr(), twr.data_ptr(), twi.data_ptr(),
        out.data_ptr(), int(out_dtype == "bfloat16"), F,
    )
    return out


def spectrum_iir_cuda(
    x: torch.Tensor,
    z_starts: torch.Tensor,
    plan: PallasSOSPlan,
    apply_window: bool = True,
    out_dtype: str = "float32",
) -> torch.Tensor:
    """Launch ``spectrum_iir.cu`` on x (F, 16384) fp32 and entry states
    z_starts (F, 12) fp32 on a CUDA device. Raises if the kernel cannot be
    built or launched."""
    F = _check_frames("x", x, plan, (torch.float32,))
    _check_state_dim(plan)
    _check_z_starts(z_starts, F, plan)
    tab, twr, twi = plan.kernel_constants
    h, pt, mt, al1t = plan.iir_constants
    win = launch.aligned(plan.win)
    zs = z_starts.contiguous()
    _check_leaves(
        x.device, tab=tab, twr=twr, twi=twi, win=win, h=h, PT=pt, MT=mt,
        AL1T=al1t, z_starts=zs,
    )
    x = launch.aligned(x)
    out = torch.empty((F, x.shape[1]), dtype=OUT_DTYPES[out_dtype], device=x.device)
    launch.launch(
        "spectrum_iir", x.device,
        x.data_ptr(), zs.data_ptr(), win.data_ptr() if apply_window else None,
        h.data_ptr(), pt.data_ptr(), mt.data_ptr(), al1t.data_ptr(),
        tab.data_ptr(), twr.data_ptr(), twi.data_ptr(),
        out.data_ptr(), int(out_dtype == "bfloat16"), F,
    )
    return out


def iir_summaries_cuda(x: torch.Tensor, plan: PallasSOSPlan) -> torch.Tensor:
    """Launch ``iir_summaries.cu`` on x (F, 16384) fp32 on a CUDA device:
    x @ plan.summary_matrix.T, each frame summed in the kernel's fixed order.
    Raises if the kernel cannot be built or launched."""
    F = _check_frames("x", x, plan, (torch.float32,))
    _check_state_dim(plan)
    kw = plan.summary_matrix
    _check_leaves(x.device, summary_matrix=kw)
    x = launch.aligned(x)
    out = torch.empty((F, plan.state_dim), dtype=torch.float32, device=x.device)
    launch.launch("iir_summaries", x.device, x.data_ptr(), kw.data_ptr(), out.data_ptr(), F)
    return out


def spectrum_complex_cuda(
    xr: torch.Tensor,
    xi: torch.Tensor,
    plan: PallasSOSPlan,
    apply_window: bool = True,
    out_dtype: str = "float32",
) -> torch.Tensor:
    """Launch ``spectrum_complex.cu`` on IQ planes xr, xi (F, 16384), both
    fp32 or both bf16, on a CUDA device. Raises if the kernel cannot be
    built or launched."""
    F = _check_frames("xr", xr, plan, (torch.float32, torch.bfloat16))
    if xi.shape != xr.shape or xi.dtype != xr.dtype or xi.device != xr.device:
        raise ValueError(
            f"xi must match xr: {tuple(xr.shape)} {xr.dtype} on {xr.device}, "
            f"got {tuple(xi.shape)} {xi.dtype} on {xi.device}"
        )
    tab, twr, twi = plan.kernel_constants
    win = launch.aligned(plan.win)
    _check_leaves(xr.device, tab=tab, twr=twr, twi=twi, win=win)
    xr, xi = launch.aligned(xr), launch.aligned(xi)
    out = torch.empty((F, xr.shape[1]), dtype=OUT_DTYPES[out_dtype], device=xr.device)
    launch.launch(
        "spectrum_complex", xr.device,
        xr.data_ptr(), xi.data_ptr(), int(xr.dtype == torch.bfloat16),
        win.data_ptr() if apply_window else None,
        tab.data_ptr(), twr.data_ptr(), twi.data_ptr(),
        out.data_ptr(), int(out_dtype == "bfloat16"), F,
    )
    return out


def spectrum_half_cuda(
    x: torch.Tensor,
    z_starts: torch.Tensor | None,
    plan: PallasSOSPlan,
    apply_window: bool = True,
    out_dtype: str = "float32",
) -> torch.Tensor:
    """The half spectrum of x (F, 16384) on a CUDA device: the bypass form
    (z_starts None; x fp32 or bf16) launches ``spectrum_bypass.cu``, the IIR
    form from the entry states z_starts (F, 12) fp32 (x fp32)
    ``spectrum_iir.cu``. Both kernels transform rows k2 in [0, 64] only and
    give each mirrored bin its partner's bits, which is this function, so
    half and full spectra are the same bits. Counts the launch under
    "spectrum_half" too. Raises if the kernel cannot be built or launched."""
    if z_starts is None:
        out = spectrum_bypass_cuda(x, plan, apply_window, out_dtype)
    else:
        out = spectrum_iir_cuda(x, z_starts, plan, apply_window, out_dtype)
    launch.count("kernel", "spectrum_half")
    return out


# ---------------------------------------------------------------- public functions


def _check_options(precision: str, out_dtype: str = "float32"):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {tuple(OUT_DTYPES)}, got {out_dtype!r}")


def _check_x(x: torch.Tensor, plan: PallasSOSPlan, name: str = "x") -> int:
    n2, n1 = plan.win.shape
    F = x.shape[0]
    if tuple(x.shape) != (F, n1 * n2):
        raise ValueError(f"{name} must be (F, {n1 * n2}), got {tuple(x.shape)}")
    return F


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

    The keywords are the reference's: ``bypass=True`` (window, DFT,
    magnitude; the entry states are then unused) or ``bypass=False`` (the
    composite IIR from each frame's entry state first; x must be fp32),
    each with ``apply_window`` True/False, ``out_dtype`` "float32"/
    "bfloat16" (the fp32 result rounded once on store), ``flat_emit``
    True/False (natural-order (F, N) either way), ``half_spectrum`` (the DFT
    of k2 in [0, 64] only, the other bins copied from their mirrors
    |X[N - k]| = |X[k]|; not with ``flat_emit``) and ``blocked_output``
    (the same bits as an (F, n1, n2) view; not with ``flat_emit``).
    ``precision`` ("highest" | "high3" | "default") and ``karatsuba`` are
    validated and accepted: the kernels compute in IEEE fp32 at every tier.
    ``interpret`` has no meaning for a CUDA kernel: the plain version runs
    exactly when x lies on the CPU, and ``interpret=True`` on a CUDA tensor
    raises.
    """
    _check_options(precision, out_dtype)
    if half_spectrum and flat_emit:
        raise ValueError("flat_emit is not supported with half_spectrum")
    if flat_emit and blocked_output:
        raise ValueError("flat_emit and blocked_output are exclusive")
    F = _check_x(x, plan)
    if tuple(z_starts.shape) != (F, plan.state_dim):
        raise ValueError(
            f"z_starts must be ({F}, {plan.state_dim}), got {tuple(z_starts.shape)}"
        )
    if half_spectrum:
        zs = None if bypass else z_starts
        if launch.on_cpu("spectrum_half", x, interpret):
            out = spectrum_half_plain(x, zs, plan, apply_window, out_dtype)
        else:
            out = spectrum_half_cuda(x, zs, plan, apply_window, out_dtype)
    elif bypass:
        if launch.on_cpu("spectrum_bypass", x, interpret):
            out = spectrum_bypass_plain(x, plan, apply_window, out_dtype)
        else:
            out = spectrum_bypass_cuda(x, plan, apply_window, out_dtype)
    elif launch.on_cpu("spectrum_iir", x, interpret):
        out = spectrum_iir_plain(x, z_starts, plan, apply_window, out_dtype)
    else:
        out = spectrum_iir_cuda(x, z_starts, plan, apply_window, out_dtype)
    if blocked_output:
        n2, n1 = plan.win.shape
        return out.view(F, n1, n2)
    return out


def iir_summaries(
    x: torch.Tensor,
    plan: PallasSOSPlan,
    interpret: bool = False,
    precision: str = "highest",
) -> torch.Tensor:
    """x (F, N) raw frames -> per-frame zero-state forcing summaries (F, m).

    ``precision`` is validated and accepted (IEEE fp32 at every tier);
    ``interpret`` as in ``spectrum_from_state``.
    """
    _check_options(precision)
    _check_x(x, plan)
    if launch.on_cpu("iir_summaries", x, interpret):
        return iir_summaries_plain(x, plan)
    return iir_summaries_cuda(x, plan)


def spectrum_mag_complex(
    xr: torch.Tensor,
    xi: torch.Tensor,
    plan: PallasSOSPlan,
    interpret: bool = False,
    precision: str = "highest",
    apply_window: bool = True,
    karatsuba: bool = False,
    out_dtype: str = "float32",
) -> torch.Tensor:
    """IQ frames xr/xi (F, N) -> magnitudes (F, N), natural order.

    ``precision`` and ``karatsuba`` are validated and accepted (IEEE fp32,
    four real products per complex one, at every tier); ``interpret`` as in
    ``spectrum_from_state``.
    """
    _check_options(precision, out_dtype)
    F = _check_x(xr, plan, "xr")
    if tuple(xi.shape) != (F, xr.shape[1]):
        raise ValueError(f"xi must be {tuple(xr.shape)}, got {tuple(xi.shape)}")
    if launch.on_cpu("spectrum_complex", xr, interpret):
        return spectrum_complex_plain(xr, xi, plan, apply_window, out_dtype)
    return spectrum_complex_cuda(xr, xi, plan, apply_window, out_dtype)
