"""12th-order IIR cascade as one blocked state-space system (composite form).

The counterpart of the composite part of ``tpu_sdr.kernels.biquad``. The
cascade of 6 transposed direct-form II sections is composed into one
m = 12 state linear system, z[n] = A z[n-1] + B x[n], y[n] = C z[n-1] + D x[n],
and evaluated per frame of B blocks x L samples:

  y_zs     = x @ T^T                 (L, L) Toeplitz product per block
  zhat     = f_flat @ W^T            (B*m, B*m) causal block-Toeplitz product
                                     per frame (the zero-state chain)
  z_end[j] = APow[j] z_start + zhat[j]
  y        = y_zs + z_in @ M^T

The heavy terms are dense constant matrix products (``torch.matmul``); the
only sequential work is the per-frame chain z_{f+1} = A^(B*L) z_f + zhat[B-1],
one 12-dim affine step per frame (``alb_step``). A per-channel bank
(``precompute_composite_bank``) holds the same leaves with a leading channel
axis; its products are batched over the channels
(``sosfilt_blocked_composite_bank``).

Chunked streaming at frame granularity is bit-identical to one-shot
processing within one device: each frame runs the same reductions whatever
the dispatch shape (``_canonical_matmul``), and the frame chain is an exact
elementwise multiply-and-sum.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as nnf


def sos_to_composite_statespace(sos: np.ndarray):
    """Compose the whole cascade into one m = 2S state linear system (host f64).

    Series interconnection of the per-section TDF-II systems: the composite
    state is the per-section states stacked section-major, so it reshapes
    1:1 to/from the scipy ``zi`` (S, 2) convention. Returns (A (m,m), B (m,),
    C (m,), D ()) float64.
    """
    sos = np.asarray(sos, np.float64)
    S = sos.shape[0]
    m = 2 * S
    A = np.zeros((m, m))
    Bv = np.zeros(m)
    R = np.zeros(m)  # y_{s-1} = R . z[n-1] + g * u[n]
    g = 1.0
    for s in range(S):
        b0, b1, b2, a0, a1, a2 = sos[s]
        b0, b1, b2, a1, a2 = b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0
        As = np.array([[-a1, 1.0], [-a2, 0.0]])
        Bs = np.array([b1 - a1 * b0, b2 - a2 * b0])
        Cs = np.array([1.0, 0.0])
        sl = slice(2 * s, 2 * s + 2)
        A[sl, :] = np.outer(Bs, R)
        A[sl, sl] += As
        Bv[sl] = Bs * g
        R_new = b0 * R
        R_new[sl] += Cs
        R, g = R_new, b0 * g
    return A, Bv, R, g


def _composite_host_parts(sos: np.ndarray, block: int, frame_blocks: int):
    """Host-side float64 math of the composite operator.

    Returns (T (L,L), M (L,m), P (m,L), alpows (B+1,m,m)) as float64 NumPy.
    alpows[k] = (A^L)^k fully determines the W block-Toeplitz operator, so
    only it is shipped to the device; W is expanded there.
    """
    A, Bv, C, D = sos_to_composite_statespace(sos)
    m = A.shape[0]
    L, B = block, frame_blocks

    # Sample-level powers A^0..A^L (for h, M, P and the block transition).
    pows = np.empty((L + 1, m, m))
    pows[0] = np.eye(m)
    for k in range(1, L + 1):
        pows[k] = A @ pows[k - 1]

    # Impulse response h[0] = D, h[n] = C A^(n-1) B.
    h = np.empty(L)
    h[0] = D
    h[1:] = np.einsum("i,kij,j->k", C, pows[: L - 1], Bv)
    n_idx = np.arange(L)[:, None]
    k_idx = np.arange(L)[None, :]
    delta = n_idx - k_idx
    T = np.where(delta >= 0, h[np.clip(delta, 0, L - 1)], 0.0)

    # M[n] = C A^n ; P[:, k] = A^(L-1-k) B.
    M = np.einsum("i,nij->nj", C, pows[:L])
    P = np.einsum("kij,j->ik", pows[L - 1 :: -1], Bv)

    # Block-level powers AL^0..AL^B of the per-block transition AL = A^L.
    AL = pows[L]
    alpows = np.empty((B + 1, m, m))
    alpows[0] = np.eye(m)
    for k in range(1, B + 1):
        alpows[k] = AL @ alpows[k - 1]
    return T, M, P, alpows


@dataclasses.dataclass(frozen=True)
class BlockedSOSComposite:
    """Device constants of the composite cascade.

    Leaves: T (L,L), M (L,m), P (m,L), APow (B,m,m), W (B*m,B*m), ALB (m,m);
    a per-channel bank has a leading channel axis C on each.
    """

    T: torch.Tensor
    M: torch.Tensor
    P: torch.Tensor
    APow: torch.Tensor
    W: torch.Tensor
    ALB: torch.Tensor

    @property
    def block(self) -> int:
        return self.T.shape[-1]

    @property
    def state_dim(self) -> int:
        return self.M.shape[-1]

    @property
    def frame_blocks(self) -> int:
        return self.APow.shape[-3]


def _expand_block_toeplitz(alpows: torch.Tensor) -> torch.Tensor:
    """W[j*m+a, i*m+b] = alpows[j-i][a,b] for i <= j, else 0.

    Pure placement of already-rounded alpows entries, so the result is
    bit-identical to building W on the host.
    """
    B = alpows.shape[0] - 1
    m = alpows.shape[-1]
    ar = torch.arange(B, device=alpows.device)
    dj = ar[:, None] - ar[None, :]
    Wb = torch.where(
        (dj >= 0)[:, :, None, None],
        alpows[dj.clamp(0, B)],
        torch.zeros((), dtype=alpows.dtype, device=alpows.device),
    )  # (B, B, m, m)
    return Wb.permute(0, 2, 1, 3).reshape(B * m, B * m)


def precompute_composite(
    sos: np.ndarray,
    block: int = 128,
    frame_blocks: int = 128,
    *,
    device="cuda",
    dtype=torch.float32,
) -> BlockedSOSComposite:
    """Build the composite blocked operator on ``device`` (host float64
    internals; the large W leaf is expanded on the device from alpows)."""
    T, M, P, alpows = _composite_host_parts(sos, block, frame_blocks)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    ap = as_t(alpows)  # (B+1, m, m)
    return BlockedSOSComposite(
        T=as_t(T),
        M=as_t(M),
        P=as_t(P),
        APow=ap[1:],
        W=_expand_block_toeplitz(ap),
        ALB=ap[-1],
    )


# Every product over the (channel, frame) axes runs in calls that hold
# exactly this many (channel, frame) pairs, the last call zero-padded.
# Sized to bench.py's dispatch (8 channels x 64 frames), which then makes
# one call per product; a smaller dispatch computes padded rows, whose
# device time stayed under its host time on an H100
# (scripts/torch_iir_call_shape.py, PERF.md).
CANONICAL_FRAMES = 512


def _canonical_matmul(a: torch.Tensor, bt: torch.Tensor, rows: int) -> torch.Tensor:
    """a (..., K) @ bt (K, N), in calls of exactly ``rows`` rows of a; or,
    for a per-channel bank, a (C, ..., K) @ bt (C, K, N), channel by
    channel in batched calls of exactly ``rows`` rows of each channel.

    A BLAS library picks its kernel, its split of K and its thread
    partition from the row count, so a row's bits can depend on how many
    rows share the call. Measured: with MKL on one thread, rows of a
    (M, 1536) @ (1536, 1536) product differ between M < 16 and M >= 16;
    with cuBLAS on an H100, one call per product gave chunked results that
    differed from one-shot at every shape tried (1 x 4, 2 x 8 and 8 x 64
    channels x frames, in 4 chunks). The reference guards only the single-frame
    case; with every call at one fixed shape, each frame's rows run the
    same reductions whatever the number of frames and channels in the
    dispatch, which is what chunked == one-shot needs.

    A dispatch that fits one call is one zero-padded product; a larger one
    writes each call straight into the result. Either way the result is a
    view of its first M rows, with no copy.
    """
    lead = a.shape[:-1]
    batch = bt.shape[:-2]  # () or (C,)
    a2 = a.reshape(*batch, -1, a.shape[-1])
    M = a2.shape[-2]
    if M % rows:
        a2 = nnf.pad(a2, (0, 0, 0, rows - M % rows))
    if a2.shape[-2] == rows:
        out = a2 @ bt
    else:
        out = a2.new_empty(*batch, a2.shape[-2], bt.shape[-1])
        for i in range(0, a2.shape[-2], rows):
            torch.matmul(a2[..., i : i + rows, :], bt, out=out[..., i : i + rows, :])
    return out[..., :M, :].reshape(*lead, bt.shape[-1])


def _composite_frame_terms(op: BlockedSOSComposite, v, frames: int = CANONICAL_FRAMES):
    """Per-frame parallel work: v (..., F, B, L) windowed input blocks ->
    (y_zs (..., F, B, L), zhat (..., F, B, m)); for a per-channel bank v is
    (C, ..., F, B, L).

    Every product runs through ``_canonical_matmul`` in calls of ``frames``
    frames (the reference's single-frame guard, generalised to any dispatch
    shape).
    """
    m = op.state_dim
    B = op.frame_blocks
    rows = frames * B  # block rows of ``frames`` frames
    y_zs = _canonical_matmul(v, op.T.mT, rows)
    f = _canonical_matmul(v, op.P.mT, rows)  # (..., F, B, m)
    zhat_flat = _canonical_matmul(f.reshape(*f.shape[:-2], B * m), op.W.mT, frames)
    return y_zs, zhat_flat.reshape(*f.shape[:-2], B, m)


def alb_step(op, z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One frame-chain step: z' = ALB z + w, broadcasting over leading axes.

    ``op`` is anything with an ``ALB`` leaf (``BlockedSOSComposite`` or the
    kernel plan). Written as an elementwise multiply and a sum over the
    last axis, never as a matrix product: the sum's order then depends only
    on m, not on how many channels or frames a dispatch holds, which keeps
    chunked == one-shot bitwise. Every frame chain goes through this helper.
    """
    return (op.ALB * z[..., None, :]).sum(dim=-1) + w


def frame_chain(op, z: torch.Tensor, w_frames: torch.Tensor):
    """The frame chain over a dispatch: z (..., m) entry state, w_frames
    (..., F, m) each frame's zero-state end state -> (z_starts (..., F, m),
    the state after the last frame (..., m)). A Python loop of
    ``alb_step`` over the F frames."""
    starts = []
    for f in range(w_frames.shape[-2]):
        starts.append(z)
        z = alb_step(op, z, w_frames[..., f, :])
    return torch.stack(starts, dim=-2), z


def _composite_emit(op, y_zs, zhat, z_starts, frames: int = CANONICAL_FRAMES):
    """Assemble outputs from per-frame start states z_starts (..., F, m)
    (a bank's: (C, ..., F, m)), products in calls of ``frames`` frames.
    Returns y (..., F, B, L).
    """
    B, m = op.frame_blocks, op.state_dim
    lead = z_starts.shape[:-1]  # (..., F)
    batch = op.APow.shape[:-3]  # () or (C,)
    # z_end[j] = APow[j] z_start + zhat[j]; z_in[0] = z_start, else z_end[j-1].
    z_end = _canonical_matmul(z_starts, op.APow.reshape(*batch, B * m, m).mT, frames)
    z_end = z_end.reshape(*lead, B, m) + zhat
    z_in = torch.cat([z_starts[..., None, :], z_end[..., :-1, :]], dim=-2)
    return y_zs + _canonical_matmul(z_in, op.M.mT, frames * B)


def sosfilt_blocked_composite(
    op: BlockedSOSComposite, x: torch.Tensor, zi: torch.Tensor
):
    """Composite-cascade filter: x (..., T), T a multiple of B*L.

    zi: (..., S, 2) scipy-convention state. Returns (y (..., T),
    zf (..., S, 2)). The frame chain is ``frame_chain``.
    """
    L, B, m = op.block, op.frame_blocks, op.state_dim
    lead = x.shape[:-1]
    F = x.shape[-1] // (B * L)
    v = x.reshape(*lead, F, B, L)
    z = zi.reshape(*lead, m)

    y_zs, zhat = _composite_frame_terms(op, v)

    # Sequential chain across frames: z_{f+1} = ALB z_f + zhat[f, -1].
    z_starts, z = frame_chain(op, z, zhat[..., -1, :])

    y = _composite_emit(op, y_zs, zhat, z_starts)
    return y.reshape(*lead, F * B * L), z.reshape(*lead, m // 2, 2)


def precompute_composite_bank(
    sos_bank: np.ndarray,
    block: int = 128,
    frame_blocks: int = 128,
    *,
    device="cuda",
    dtype=torch.float32,
) -> BlockedSOSComposite:
    """Per-channel composite operators: sos_bank (C, S, 6) -> leaves with a
    leading channel axis, built on ``device`` (host float64 parts per
    channel; each channel's W expanded on the device). One (S, 6) design is
    a 1-channel bank. About (L^2 + (B*m)^2) * 4 bytes a channel (9.5 MB at
    the default shape).
    """
    sos_bank = np.asarray(sos_bank, np.float64)
    if sos_bank.ndim == 2:
        # (S, 6) -> (1, S, 6); np.atleast_3d would append the axis instead
        sos_bank = sos_bank[None]
    parts = [
        _composite_host_parts(sos_bank[c], block, frame_blocks)
        for c in range(sos_bank.shape[0])
    ]
    as_t = lambda k: torch.as_tensor(
        np.stack([p[k] for p in parts]), dtype=dtype, device=device
    )
    ap = as_t(3)  # (C, B+1, m, m)
    m = ap.shape[-1]
    W = torch.empty((ap.shape[0], frame_blocks * m, frame_blocks * m), dtype=dtype, device=device)
    for c in range(ap.shape[0]):
        W[c] = _expand_block_toeplitz(ap[c])
    return BlockedSOSComposite(T=as_t(0), M=as_t(1), P=as_t(2), APow=ap[:, 1:], W=W, ALB=ap[:, -1])


def bank_frames(channels: int) -> int:
    """Frames of each channel per batched product call of a bank: the
    ``CANONICAL_FRAMES`` of one call shared among the bank's channels, so a
    dispatch of 8 channels x 64 frames makes one call per product. The
    channel count is fixed by the bank, so every dispatch calls each
    product at one shape (chunked == one-shot)."""
    return max(1, CANONICAL_FRAMES // channels)


def sosfilt_blocked_composite_bank(
    op: BlockedSOSComposite, x: torch.Tensor, zi: torch.Tensor
):
    """Per-channel-coefficients cascade: x (..., C, T), zi (..., C, S, 2) ->
    (y (..., C, T), zf (..., C, S, 2)).

    The math of ``sosfilt_blocked_composite`` with every constant taken per
    channel: the channel axis leads each product (a batched call of
    ``bank_frames(C)`` frames of every channel), and the frame chain steps
    all channels at once (``alb_step`` broadcasts ALB (C, m, m)). One batched
    call per product held chunked == one-shot on an H100 with less device
    time than one call per channel (``scripts/torch_bank_call_shape.py``).
    """
    L, B, m = op.block, op.frame_blocks, op.state_dim
    C = op.T.shape[0]
    lead = x.shape[:-2]
    F = x.shape[-1] // (B * L)
    v = x.reshape(*lead, C, F, B, L).movedim(-4, 0)  # (C, ..., F, B, L)
    frames = bank_frames(C)
    y_zs, zhat = _composite_frame_terms(op, v, frames)
    w = zhat[..., -1, :].movedim(0, -3)  # (..., C, F, m)
    z_starts, z = frame_chain(op, zi.reshape(*lead, C, m), w)
    y = _composite_emit(op, y_zs, zhat, z_starts.movedim(-3, 0), frames)
    return y.movedim(0, -4).reshape(*lead, C, F * B * L), z.reshape(*lead, C, m // 2, 2)


def pad_sos(sos: np.ndarray, n_sections: int) -> np.ndarray:
    """Pad an SOS cascade to exactly ``n_sections`` with identity sections.

    Padding keeps the engine's state shape static across coefficient
    reloads. More sections than ``n_sections`` is an error.
    """
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    if sos.shape[0] > n_sections:
        raise ValueError(
            f"design has {sos.shape[0]} sections; engine supports at most "
            f"{n_sections} (order {2 * n_sections})"
        )
    if sos.shape[0] < n_sections:
        pad = sos_identity(n_sections - sos.shape[0])
        sos = np.concatenate([sos, pad], axis=0)
    return sos


def sos_identity(n_sections: int = 6) -> np.ndarray:
    """Pass-through cascade (b = a = [1, 0, 0] per section)."""
    sos = np.zeros((n_sections, 6), dtype=np.float64)
    sos[:, 0] = 1.0
    sos[:, 3] = 1.0
    return sos
