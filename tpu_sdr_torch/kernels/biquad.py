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

The per-section form of the reference is here too: ``BlockedSOS`` /
``precompute`` / ``sosfilt_blocked`` (each section a 2-state system, its
products through ``_canonical_matmul``), the float per-sample oracle
``sosfilt_scan_ref``, and the Q15 integer cascade ``sosfilt_q15_scan``,
which on a CUDA tensor launches ``csrc/sosfilt_q15.cu`` and on a CPU tensor
runs ``sosfilt_q15_plain``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch
import torch.nn.functional as nnf

from tpu_sdr_torch.core import comm
from tpu_sdr_torch.core.spans import span
from tpu_sdr_torch.kernels import window
from tpu_sdr_torch.kernels.cuda import launch


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
    with span("tpu_sdr.iir.products"):
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


def frame_chain(op, z: torch.Tensor, w_frames: torch.Tensor, time_axis=None):
    """The frame chain over a dispatch: z (..., m) entry state, w_frames
    (..., F, m) each frame's zero-state end state -> (z_starts (..., F, m),
    the state after the last frame (..., m)). A Python loop of
    ``alb_step`` over the F frames.

    ``time_axis`` (a ``shard.mesh.MeshAxis``): the frames are this shard's
    run of a stream sharded over that axis. The (..., F, m) summaries are
    all-gathered in frame order, every shard replays the identical global
    chain, and each keeps its own frames' starts; the final state is the
    global one, the same on every shard (bit-identical to one device)."""
    with span("tpu_sdr.iir.frame_chain"):
        f_loc = w_frames.shape[-2]
        if time_axis is not None:
            w_frames = comm.all_gather(w_frames, time_axis, -2)
        starts = []
        for f in range(w_frames.shape[-2]):
            starts.append(z)
            z = alb_step(op, z, w_frames[..., f, :])
        starts = torch.stack(starts, dim=-2)
        if time_axis is None:
            return starts, z
        lo = time_axis.index * f_loc
        return starts[..., lo : lo + f_loc, :], z


def _composite_emit(op, y_zs, zhat, z_starts, frames: int = CANONICAL_FRAMES):
    """Assemble outputs from per-frame start states z_starts (..., F, m)
    (a bank's: (C, ..., F, m)), products in calls of ``frames`` frames.
    Returns y (..., F, B, L).
    """
    B, m = op.frame_blocks, op.state_dim
    lead = z_starts.shape[:-1]  # (..., F)
    batch = op.APow.shape[:-3]  # () or (C,)
    with span("tpu_sdr.iir.emit"):
        # z_end[j] = APow[j] z_start + zhat[j]; z_in[0] = z_start, else z_end[j-1].
        z_end = _canonical_matmul(z_starts, op.APow.reshape(*batch, B * m, m).mT, frames)
        z_end = z_end.reshape(*lead, B, m) + zhat
        z_in = torch.cat([z_starts[..., None, :], z_end[..., :-1, :]], dim=-2)
        return y_zs + _canonical_matmul(z_in, op.M.mT, frames * B)


def sosfilt_blocked_composite(
    op: BlockedSOSComposite, x: torch.Tensor, zi: torch.Tensor, *, time_axis=None
):
    """Composite-cascade filter: x (..., T), T a multiple of B*L.

    zi: (..., S, 2) scipy-convention state. Returns (y (..., T),
    zf (..., S, 2)). The frame chain is ``frame_chain``.

    ``time_axis`` (a ``MeshAxis``): x is this shard's run of frames of a
    stream sharded over that axis, and zi the GLOBAL stream-head state
    (replicated). Only the per-frame m-vector summaries cross the axis;
    every shard replays the identical global frame chain and keeps its own
    starts, so y is bit-identical to this shard's frames of the one-device
    result and zf is the global final state.
    """
    L, B, m = op.block, op.frame_blocks, op.state_dim
    lead = x.shape[:-1]
    F = x.shape[-1] // (B * L)
    v = x.reshape(*lead, F, B, L)
    z = zi.reshape(*lead, m)

    y_zs, zhat = _composite_frame_terms(op, v)

    # Sequential chain across frames: z_{f+1} = ALB z_f + zhat[f, -1].
    z_starts, z = frame_chain(op, z, zhat[..., -1, :], time_axis)

    y = _composite_emit(op, y_zs, zhat, z_starts)
    return y.reshape(*lead, F * B * L), z.reshape(*lead, m // 2, 2)


def sosfilt_blocked_composite_timesharded(
    op: BlockedSOSComposite, x_local: torch.Tensor, zi: torch.Tensor, *, time_axis
):
    """The reference's name for ``sosfilt_blocked_composite`` over a time
    axis. Returns (y_local, zf_global)."""
    return sosfilt_blocked_composite(op, x_local, zi, time_axis=time_axis)


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
    op: BlockedSOSComposite, x: torch.Tensor, zi: torch.Tensor, *,
    time_axis=None, channels: int | None = None,
):
    """Per-channel-coefficients cascade: x (..., C, T), zi (..., C, S, 2) ->
    (y (..., C, T), zf (..., C, S, 2)).

    ``time_axis``: the frames are one shard of a stream sharded over that
    mesh axis; only the per-frame (C, m) summaries cross it
    (``frame_chain``). ``channels``: the bank's whole channel count when
    ``op`` holds one channel shard's rows; every product then keeps the
    call shape of the whole bank (``bank_frames(channels)``).

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
    frames = bank_frames(C if channels is None else channels)
    y_zs, zhat = _composite_frame_terms(op, v, frames)
    w = zhat[..., -1, :].movedim(0, -3)  # (..., C, F, m)
    z_starts, z = frame_chain(op, zi.reshape(*lead, C, m), w, time_axis)
    y = _composite_emit(op, y_zs, zhat, z_starts.movedim(-3, 0), frames)
    return y.movedim(0, -4).reshape(*lead, C, F * B * L), z.reshape(*lead, C, m // 2, 2)


@dataclasses.dataclass(frozen=True)
class BlockedSOS:
    """Precomputed blocked operator for one SOS cascade, section by section.

    Leaves:
      T  (S, L, L)  lower-triangular Toeplitz impulse-response operators
      M  (S, L, 2)  initial-state injection: row n = C A^n
      P  (S, 2, L)  end-state forcing: column k = A^(L-1-k) B
      AL (S, 2, 2)  per-block state transition A^L
    """

    T: torch.Tensor
    M: torch.Tensor
    P: torch.Tensor
    AL: torch.Tensor

    @property
    def n_sections(self) -> int:
        return self.T.shape[0]

    @property
    def block(self) -> int:
        return self.T.shape[1]


def precompute(sos, block: int = 128, *, device="cuda", dtype=torch.float32) -> BlockedSOS:
    """Build the blocked operator from SOS coefficients (host float64, each
    leaf rounded once to ``dtype`` on ``device``)."""
    sos = np.atleast_2d(np.asarray(sos, np.float64))
    S = sos.shape[0]
    L = block
    a0 = sos[:, 3:4]
    b0, b1, b2 = (sos[:, i] / a0[:, 0] for i in range(3))
    a1, a2 = sos[:, 4] / a0[:, 0], sos[:, 5] / a0[:, 0]
    A = np.zeros((S, 2, 2))
    A[:, 0, 0] = -a1
    A[:, 0, 1] = 1.0
    A[:, 1, 0] = -a2
    B = np.stack([b1 - a1 * b0, b2 - a2 * b0], axis=-1)
    C = np.zeros((S, 2))
    C[:, 0] = 1.0
    D = b0

    Aks = np.empty((L + 1, S, 2, 2))
    Aks[0] = np.eye(2)
    for k in range(1, L + 1):
        Aks[k] = np.einsum("sij,sjk->sik", A, Aks[k - 1])

    cab = np.einsum("sc,kscd,sd->ks", C, Aks[: L - 1], B)  # (L-1, S)
    h = np.concatenate([D[None, :], cab], axis=0).T  # (S, L)

    delta = np.arange(L)[:, None] - np.arange(L)[None, :]
    gathered = h[:, np.clip(delta, 0, L - 1)]  # (S, L, L)
    T = np.where(delta[None] >= 0, gathered, 0.0)

    M = np.einsum("sc,nscd->snd", C, Aks[:L])
    P = np.einsum("kscd,sd->sck", Aks[L - 1 :: -1], B)

    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return BlockedSOS(T=as_t(T), M=as_t(M), P=as_t(P), AL=as_t(Aks[L]))


# Block rows per call of the per-section products (``_canonical_matmul``):
# 16 frames of 128 blocks. Any fixed count keeps chunked == one-shot; this
# form is a reference, on no runtime path, so its calls stay small.
BLOCK_ROWS = 16 * 128


def _small_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., i, j) @ b (..., j, k) as an elementwise multiply and a sum over
    j: the same reduction whatever the batch shape."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def _affine_combine(left, right):
    """Compose affine maps: right after left. Elements: (mat, vec[..., 2, 1])."""
    m1, v1 = left
    m2, v2 = right
    return _small_mm(m2, m1), _small_mm(m2, v1) + v2


def _within_frame_prefix(AL: torch.Tensor, f: torch.Tensor, frame_blocks: int):
    """Inclusive prefix of the affine maps inside each frame.

    f: (..., G, 2) block forcings -> (cmats (..., F, B, 2, 2), cvecs
    (..., F, B, 2, 1)) with B = frame_blocks, F = G // B. A Hillis-Steele
    scan over exactly B elements, so every rounding is the same whatever
    the number of frames in the dispatch.
    """
    G = f.shape[-2]
    if G % frame_blocks:
        raise ValueError(f"G={G} not a multiple of frame_blocks={frame_blocks}")
    lead = f.shape[:-2]
    fF = f.reshape(*lead, G // frame_blocks, frame_blocks, 2)
    mats = AL.expand(*fF.shape[:-1], 2, 2)
    vecs = fF[..., :, None]
    d = 1
    while d < frame_blocks:
        m, v = _affine_combine((mats[..., :-d, :, :], vecs[..., :-d, :, :]),
                               (mats[..., d:, :, :], vecs[..., d:, :, :]))
        mats = torch.cat([mats[..., :d, :, :], m], dim=-3)
        vecs = torch.cat([vecs[..., :d, :, :], v], dim=-3)
        d *= 2
    return mats, vecs


def _frame_chain(m_frames: torch.Tensor, v_frames: torch.Tensor, z0: torch.Tensor):
    """Sequential affine chain across frames: m_frames (..., F, 2, 2),
    v_frames (..., F, 2, 1), z0 (..., 2) -> (z_final (..., 2), z_starts
    (..., F, 2, 1)), the state at the start of each frame."""
    z = z0[..., :, None]
    starts = []
    for f in range(m_frames.shape[-3]):
        starts.append(z)
        z = _small_mm(m_frames[..., f, :, :], z) + v_frames[..., f, :, :]
    return z[..., 0], torch.stack(starts, dim=-3)


def _z_in_from_prefix(cmats, cvecs, z_starts):
    """Per-block incoming states from the within-frame prefixes: block 0 of
    a frame takes the frame's start, block j the within-frame end of block
    j - 1. Returns (..., G, 2)."""
    lead = cmats.shape[:-4]
    F, B = cmats.shape[-4], cmats.shape[-3]
    zs = z_starts[..., :, None, :, :]  # (..., F, 1, 2, 1)
    z_end_within = _small_mm(cmats, zs) + cvecs  # (..., F, B, 2, 1)
    z_in = torch.cat([zs, z_end_within[..., :-1, :, :]], dim=-3)
    return z_in[..., 0].reshape(*lead, F * B, 2)


def _block_state_chain(AL, f, z0, frame_blocks: int):
    """Solve z_end[g] = AL z_in[g] + f[g] over the blocks: the prefix
    inside each frame, then the sequential chain across frames, so chunked
    streaming at frame granularity is bit-identical to one-shot. Returns
    (z_in (..., G, 2), z_final (..., 2))."""
    cmats, cvecs = _within_frame_prefix(AL, f, frame_blocks)
    z_final, z_starts = _frame_chain(cmats[..., -1, :, :], cvecs[..., -1, :, :], z0)
    return _z_in_from_prefix(cmats, cvecs, z_starts), z_final


def sosfilt_blocked(
    op: BlockedSOS,
    x: torch.Tensor,
    zi: torch.Tensor,
    frame_blocks: int | None = None,
):
    """Filter x (..., T) through the cascade, section by section; T a
    multiple of L. zi: (..., S, 2) incoming state (scipy convention).
    ``frame_blocks`` sets the prefix segment (blocks per FFT frame): chunks
    that are multiples of frame_blocks * L samples give the bits of one-shot
    processing. Default: one segment per dispatch. The block products run
    in calls of ``BLOCK_ROWS`` rows (``_canonical_matmul``).
    Returns (y (..., T), zf (..., S, 2)).
    """
    L = op.block
    lead = x.shape[:-1]
    G = x.shape[-1] // L
    fb = G if frame_blocks is None else frame_blocks
    v = x.reshape(*lead, G, L)
    zf_out = []
    for s in range(op.n_sections):
        y_zs = _canonical_matmul(v, op.T[s].mT, BLOCK_ROWS)
        f = _canonical_matmul(v, op.P[s].mT, BLOCK_ROWS)
        z_in, z_final = _block_state_chain(op.AL[s], f, zi[..., s, :], fb)
        v = y_zs + _canonical_matmul(z_in, op.M[s].mT, BLOCK_ROWS)
        zf_out.append(z_final)
    return v.reshape(*lead, G * L), torch.stack(zf_out, dim=-2)


def sosfilt_blocked_timesharded(
    op: BlockedSOS, x_local: torch.Tensor, zi: torch.Tensor, *, time_axis, frame_blocks: int
):
    """Time-sharded per-section cascade: x_local (..., T_local) is this
    shard's contiguous run of frames of ``frame_blocks`` blocks each, zi
    (..., S, 2) the GLOBAL stream-head state (replicated). Per section, the
    tiny per-frame affine summaries are all-gathered in frame order, every
    shard replays the identical global frame chain (``_frame_chain``) and
    keeps its own frames' starts: bit-identical to ``sosfilt_blocked`` with
    the same ``frame_blocks`` on one device. Returns (y_local, zf_global)."""
    L = op.block
    lead = x_local.shape[:-1]
    G = x_local.shape[-1] // L
    F = G // frame_blocks
    lo = time_axis.index * F
    v = x_local.reshape(*lead, G, L)
    zf_out = []
    for s in range(op.n_sections):
        y_zs = _canonical_matmul(v, op.T[s].mT, BLOCK_ROWS)
        f = _canonical_matmul(v, op.P[s].mT, BLOCK_ROWS)
        cmats, cvecs = _within_frame_prefix(op.AL[s], f, frame_blocks)
        m_all = comm.all_gather(cmats[..., -1, :, :], time_axis, -3)
        v_all = comm.all_gather(cvecs[..., -1, :, :], time_axis, -3)
        z_final, z_starts = _frame_chain(m_all, v_all, zi[..., s, :])
        z_in = _z_in_from_prefix(cmats, cvecs, z_starts[..., lo : lo + F, :, :])
        v = y_zs + _canonical_matmul(z_in, op.M[s].mT, BLOCK_ROWS)
        zf_out.append(z_final)
    return v.reshape(*lead, G * L), torch.stack(zf_out, dim=-2)


def sosfilt_scan_ref(sos, x: torch.Tensor, zi: torch.Tensor):
    """Sequential per-sample TDF-II (the float oracle on the tensor's
    device): the math of scipy.signal.sosfilt in x's dtype, one Python step
    a sample. x: (..., T), zi: (..., S, 2) -> (y (..., T), zf (..., S, 2))."""
    sos = torch.as_tensor(sos, dtype=x.dtype, device=x.device)
    a0 = sos[:, 3]
    b = sos[:, :3] / a0[:, None]
    a = sos[:, 4:6] / a0[:, None]
    z = [[zi[..., s, 0], zi[..., s, 1]] for s in range(sos.shape[0])]
    ys = []
    for n in range(x.shape[-1]):
        v = x[..., n]
        for s, (z1, z2) in enumerate(z):
            y = b[s, 0] * v + z1
            z[s] = [b[s, 1] * v - a[s, 0] * y + z2, b[s, 2] * v - a[s, 1] * y]
            v = y
        ys.append(v)
    zf = torch.stack([torch.stack(zs, dim=-1) for zs in z], dim=-2)
    return torch.stack(ys, dim=-1), zf


# The Q15 cascade's kernel takes at most this many sections, one a lane, and
# hands a section's output on to the next one this many steps later
# (csrc/sosfilt_q15.cu kChunk): a row takes T + Q15_SECTION_DELAY (S - 1)
# steps. The kernel's library states its own delay (q15_section_delay); this
# copy is for code that runs without it, such as the wavefront's CPU model.
Q15_MAX_SECTIONS = 8
Q15_SECTION_DELAY = 32


def q15_section_delay() -> int:
    """The Q15 cascade kernel's hand-over delay in steps, as its library
    states it (``tpu_sdr_sosfilt_q15_section_delay``). Builds the kernel on
    first use; raises where it cannot be built."""
    fn = launch._kernel_lib("sosfilt_q15").tpu_sdr_sosfilt_q15_section_delay
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return int(fn())


def _q15_check(sos: torch.Tensor, x: torch.Tensor, zi: torch.Tensor, rom):
    """Validate sosfilt_q15_window's arguments; returns (rows, T, S)."""
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (S, 6); got {tuple(sos.shape)}")
    if x.ndim != 2 or x.dtype != torch.int16:
        raise ValueError(f"x must be (rows, T) int16; got {tuple(x.shape)} {x.dtype}")
    rows, t = x.shape
    S = sos.shape[0]
    if tuple(zi.shape) != (rows, S, 2) or zi.dtype != torch.int32:
        raise ValueError(f"zi must be {(rows, S, 2)} int32; got {tuple(zi.shape)} {zi.dtype}")
    if rom is not None and (rom.ndim != 1 or rom.dtype != torch.int16 or t % rom.shape[0]):
        raise ValueError(f"rom must be (n,) int16 with n dividing T={t}; got "
                         f"{tuple(rom.shape)} {rom.dtype}")
    return rows, t, S


def sosfilt_q15_plain(sos: torch.Tensor, x: torch.Tensor, zi: torch.Tensor, rom=None):
    """The plain PyTorch version of ``sosfilt_q15_window``.

    The (sample, section) grid is walked by anti-diagonals: at step k section
    s takes sample k - s, its input the output of section s - 1 one step
    before. Each step is a handful of int32 operations on (rows, S) tensors,
    T + S - 1 steps in all; every value is the one the sample-by-sample walk
    computes.
    """
    rows, t, S = _q15_check(sos, x, zi, rom)
    xw = None
    if rom is not None:
        xw = window.window_q15(x.reshape(rows, -1, rom.shape[0]), rom).reshape(rows, t)
    xin = (x if xw is None else xw).to(torch.int32)
    c = sos.to(device=x.device, dtype=torch.int32)
    b0, b1, b2, a1, a2 = c[:, 0], c[:, 1], c[:, 2], c[:, 4], c[:, 5]
    z0 = zi[..., 0].clone()
    z1 = zi[..., 1].clone()
    y = torch.zeros((rows, S), dtype=torch.int32, device=x.device)
    zero = torch.zeros((rows, 1), dtype=torch.int32, device=x.device)
    out = torch.empty((rows, t), dtype=torch.int16, device=x.device)
    for k in range(t + S - 1):
        u = torch.cat([xin[:, k : k + 1] if k < t else zero, y[:, :-1]], dim=1)
        acc = b0 * u + z0
        # round half away from zero: (acc + 32 + (acc >> 31)) >> 6 (csrc/sosfilt_q15.cu)
        y = ((acc + (acc >> 31) + 32) >> 6).clamp_(-32768, 32767)
        n0 = b1 * u - a1 * y + z1
        n1 = b2 * u - a2 * y
        lo, hi = max(0, k - t + 1), min(S, k + 1)  # the sections holding a sample
        if lo == 0 and hi == S:
            z0, z1 = n0, n1
        else:
            z0[:, lo:hi] = n0[:, lo:hi]
            z1[:, lo:hi] = n1[:, lo:hi]
        if k >= S - 1:
            out[:, k - S + 1] = y[:, S - 1]
    return out, xw, torch.stack([z0, z1], dim=-1)


def sosfilt_q15_cuda(sos: torch.Tensor, x: torch.Tensor, zi: torch.Tensor, rom=None):
    """Launch ``csrc/sosfilt_q15.cu`` (a wavefront, one section a lane of a
    warp) on CUDA tensors. T (and the ROM's length) must be multiples of 8
    and S at most 8. Raises if the kernel cannot be built or launched."""
    rows, t, S = _q15_check(sos, x, zi, rom)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    for name, v in (("sos", sos), ("zi", zi), ("rom", rom)):
        if v is not None and v.device != dev:
            raise ValueError(f"{name} must be on {dev}, got {v.device}")
    if sos.dtype != torch.int32:
        raise ValueError(f"sos must be int32, got {sos.dtype}")
    if not 1 <= S <= Q15_MAX_SECTIONS:
        raise ValueError(f"the kernel takes 1 to {Q15_MAX_SECTIONS} sections, got {S}")
    if t % 8 or (rom is not None and rom.shape[0] % 8):
        raise ValueError(f"T ({t}) and the ROM's length must be multiples of 8")
    sos, zi = sos.contiguous(), zi.contiguous()
    x = launch.aligned(x)
    rom = None if rom is None else launch.aligned(rom)
    y = torch.empty_like(x)
    xw = None if rom is None else torch.empty_like(x)
    zf = torch.empty_like(zi)
    ptr = lambda v: None if v is None else v.data_ptr()
    launch.launch(
        "sosfilt_q15", dev, sos.data_ptr(), S, x.data_ptr(), rows, t, ptr(rom),
        0 if rom is None else rom.shape[0], zi.data_ptr(), ptr(xw), y.data_ptr(), zf.data_ptr(),
    )
    return y, xw, zf


def sosfilt_q15_window(sos: torch.Tensor, x: torch.Tensor, zi: torch.Tensor, rom=None):
    """The bit-faithful integer cascade over rows, with the RTL window first
    when ``rom`` is given: sos (S, 6) int32 x64 coefficients, x (rows, T)
    int16, zi (rows, S, 2) int32, rom (n,) int16 with n dividing T. Returns
    (y (rows, T) int16, windowed (rows, T) int16 or None without a ROM, zf
    (rows, S, 2) int32). a0 is not read: the >> 6 is the division by a0 ==
    64, as in the reference's scan (callers such as ``Q15Pipeline`` check
    it). Bit-exact vs window_q15 followed by ``golden.sosfilt_q15_intended``
    per row."""
    if launch.on_cpu("sosfilt_q15", x):
        return sosfilt_q15_plain(sos, x, zi, rom)
    return sosfilt_q15_cuda(sos, x, zi, rom)


def sosfilt_q15_scan(sos_x64, x_q15: torch.Tensor, zi: torch.Tensor):
    """Bit-faithful integer path: int8-x64 coeffs, >>6 round-half-away, int16
    saturation, int32 state; the device twin of
    ``golden.sosfilt_q15_intended``. x_q15 (..., T) int16, zi (..., S, 2)
    int32 -> (y (..., T) int16, zf (..., S, 2) int32)."""
    sos = torch.as_tensor(sos_x64).to(device=x_q15.device, dtype=torch.int32)
    lead, t = x_q15.shape[:-1], x_q15.shape[-1]
    S = sos.shape[0]
    y, _, zf = sosfilt_q15_window(
        sos, x_q15.reshape(-1, t), zi.to(torch.int32).reshape(-1, S, 2)
    )
    return y.reshape(*lead, t), zf.reshape(*lead, S, 2)


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
