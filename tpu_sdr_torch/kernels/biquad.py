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

Both layouts run one body in three steps, one a span (``cascade_products``,
``cascade_chain``, ``cascade_emit``), which the filtered dispatch replays
from CUDA graphs (``runtime/dispatch_graphs.py``). The state step has two
routes, chosen from the operator alone (``takes_state_kernel``): on the
card at B = 128 and m = 12 one hand-written kernel (``csrc/iir_state.cu``,
``state_path``) takes each frame's end state from rest, the frame chain and
every block's entry state as triangular sums of products with the powers
APow; everywhere else the GEMM form above (``gemm_state_path``). W is built
only for operators that take the GEMM form. Where the state kernel runs and
blocks hold L = 128 samples (``takes_emit_kernel``), two more kernels take
the products and the output: ``csrc/iir_force.cu`` (``block_forcing``) reads
the chunk once and writes the blocked input, windowed where the caller
passes the window, and every block's forcing f = xw P^T; ``csrc/iir_emit.cu``
(``block_outputs``) computes y = xw T^T + z_in M^T a block in one pass. y_zs
is never stored, and no product runs in canonical calls.

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
import math

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
    a per-channel bank has a leading channel axis C on each. W is None
    where the operator takes the state kernel (``takes_state_kernel``),
    which does not read it; P is contiguous where it takes the forcing
    kernel (``takes_emit_kernel``).
    """

    T: torch.Tensor
    M: torch.Tensor
    P: torch.Tensor
    APow: torch.Tensor
    W: torch.Tensor | None
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


# The state kernel (``csrc/iir_state.cu``) takes frames of this many blocks
# and states of this size.
STATE_BLOCKS = 128
STATE_DIM = 12


def takes_state_kernel(op) -> bool:
    """Whether the composite cascade's state step runs the state kernel
    (``state_path``) for ``op``: its leaves on the card, B = 128 and m = 12.
    Every other operator takes the GEMM form (``gemm_state_path``) and holds
    W."""
    return op.APow.is_cuda and op.frame_blocks == STATE_BLOCKS and op.state_dim == STATE_DIM


# The emit kernel (``csrc/iir_emit.cu``) takes blocks of this many samples.
EMIT_BLOCK = 128


def takes_emit_kernel(op) -> bool:
    """Whether the composite cascade's output step runs the emit kernel
    (``block_outputs``) for ``op``: an operator that takes the state kernel
    (``takes_state_kernel``) with blocks of L = 128 samples. Every other
    operator takes the GEMM form, y = y_zs + z_in M^T."""
    return takes_state_kernel(op) and op.block == EMIT_BLOCK


def block_toeplitz(op) -> torch.Tensor:
    """The GEMM form's W from ``op``'s powers: W[j*m+a, i*m+b] =
    (A^L)^(j-i)[a, b] for i <= j, else 0; (B*m, B*m), a bank's (C, B*m,
    B*m). Pure placement of the rounded powers, a diagonal of blocks at a
    time, so the result is bit-identical to building W on the host."""
    apow = op.APow
    *lead, B, m, _ = apow.shape
    W = apow.new_zeros((*lead, B, m, B, m))
    for d in range(B):
        p = torch.eye(m, dtype=apow.dtype, device=apow.device) if d == 0 else apow[..., d - 1, :, :]
        torch.diagonal(W, -d, -4, -2).copy_(p[..., None])
    return W.reshape(*lead, B * m, B * m)


def _route_leaves(op: BlockedSOSComposite) -> BlockedSOSComposite:
    """``op`` with the leaves of its route: W where its state step takes the
    GEMM form; P contiguous, as the forcing kernel reads it, where its
    products step takes the pass (the host build leaves P transposed)."""
    if not takes_state_kernel(op):
        return dataclasses.replace(op, W=block_toeplitz(op))
    if takes_emit_kernel(op):
        return dataclasses.replace(op, P=op.P.contiguous())
    return op


def precompute_composite(
    sos: np.ndarray,
    block: int = 128,
    frame_blocks: int = 128,
    *,
    device="cuda",
    dtype=torch.float32,
) -> BlockedSOSComposite:
    """Build the composite blocked operator on ``device`` (host float64
    internals; the large W leaf, where built, is expanded on the device
    from the powers)."""
    T, M, P, alpows = _composite_host_parts(sos, block, frame_blocks)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    ap = as_t(alpows)  # (B+1, m, m)
    return _route_leaves(BlockedSOSComposite(
        T=as_t(T),
        M=as_t(M),
        P=as_t(P),
        APow=ap[1:],
        W=None,
        ALB=ap[-1],
    ))


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
    channel; W, where built, expanded on the device). One (S, 6) design is
    a 1-channel bank. About (L^2 + (B*m)^2) * 4 bytes a channel with W (9.5
    MB at the default shape), 0.15 MB without.
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
    return _route_leaves(BlockedSOSComposite(T=as_t(0), M=as_t(1), P=as_t(2), APow=ap[:, 1:],
                                             W=None, ALB=ap[:, -1]))


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


def _composite_products(op: BlockedSOSComposite, v, frames: int):
    """The zero-state output and the forcing of every block: v (..., F, B, L)
    -> (y_zs (..., F, B, L), f (..., F, B, m)), in calls of ``frames``
    frames; for a per-channel bank v is (C, ..., F, B, L)."""
    rows = frames * op.frame_blocks  # block rows of ``frames`` frames
    return _canonical_matmul(v, op.T.mT, rows), _canonical_matmul(v, op.P.mT, rows)


def alb_step(op, z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One frame-chain step: z' = ALB z + w, broadcasting over leading axes.

    ``op`` is anything with an ``ALB`` leaf (``BlockedSOSComposite`` or the
    kernel plan). Written as an elementwise multiply and a sum over the
    last axis, never as a matrix product: the sum's order then depends only
    on m, not on how many channels or frames a dispatch holds, which keeps
    chunked == one-shot bitwise. Every frame chain walked in Python goes
    through this helper; the state kernel's (``csrc/iir_state.cu``) is the
    same step as a fixed-order FMA sum.
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
        return _walk_chain(op, z, w_frames, time_axis)


def _walk_chain(op, z: torch.Tensor, w_frames: torch.Tensor, time_axis):
    """``frame_chain`` inside its caller's span."""
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


def _gemm_entry_states(op, zhat, z_starts, frames: int = CANONICAL_FRAMES):
    """Every block's entry state by the GEMM form: zhat (..., F, B, m) the
    blocks' end states from rest, z_starts (..., F, m) (a bank's: (C, ...,
    F, m)) -> z_in (..., F, B, m), the APow product in calls of ``frames``
    frames. z_end[j] = APow[j] z_start + zhat[j]; z_in[0] = z_start, else
    z_end[j-1]."""
    B, m = op.frame_blocks, op.state_dim
    lead = z_starts.shape[:-1]  # (..., F)
    batch = op.APow.shape[:-3]  # () or (C,)
    z_end = _canonical_matmul(z_starts, op.APow.reshape(*batch, B * m, m).mT, frames)
    z_end = z_end.reshape(*lead, B, m) + zhat
    return torch.cat([z_starts[..., None, :], z_end[..., :-1, :]], dim=-2)


def gemm_state_path(op, f: torch.Tensor, z: torch.Tensor, frames: int, time_axis=None):
    """The state path of a dispatch by the GEMM form, from its forcing f
    (..., F, B, m) and the entering state z (..., m), in the steps' layout
    (a bank's channel axis first), in the span ``tpu_sdr.iir.frame_chain``
    as ``state_path``: zhat = W's product in calls of ``frames`` frames,
    the frame chain over each frame's last block (over ``time_axis`` as in
    ``frame_chain``), then ``_gemm_entry_states``. Returns (z_in (..., F,
    B, m), the final state (..., m))."""
    with span("tpu_sdr.iir.frame_chain"):
        zhat = _canonical_matmul(f.flatten(-2), op.W.mT, frames).reshape(f.shape)
        w = zhat[..., -1, :]
        if op.T.ndim == 3:  # alb_step broadcasts a bank's ALB over (..., C, m)
            w, z = w.movedim(0, -3), z.movedim(0, -2)
        starts, z = _walk_chain(op, z, w, time_axis)
        if op.T.ndim == 3:
            starts, z = starts.movedim(-3, 0), z.movedim(-2, 0)
        return _gemm_entry_states(op, zhat, starts, frames), z


def _powers(op, rows: int) -> torch.Tensor:
    """P_0 = I .. P_B = ALB of each of ``rows`` rows: (rows, B + 1, m, m).
    A per-channel bank's rows are channel-major, rows // C to a channel."""
    apow = op.APow
    m = apow.shape[-1]
    if apow.ndim == 4:
        apow = apow.repeat_interleave(rows // apow.shape[0], dim=0)
    else:
        apow = apow.expand(rows, *apow.shape)
    eye = torch.eye(m, dtype=apow.dtype, device=apow.device).expand(rows, 1, m, m)
    return torch.cat([eye, apow], dim=1)


def frame_ends_plain(op, f: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``frame_ends``, in the kernel's order:
    per block i and half h of the columns b, the 6 products of P_{B-1-i} with
    f[i] summed in ascending b; then pairwise over the 32 (i % 16, h) of
    each run of 16 blocks; then the 8 runs in ascending order."""
    lead, (F, B, m) = f.shape[:-3], f.shape[-3:]
    rows = math.prod(f.shape[:-3])
    fr = f.reshape(rows, F, B, 2, m // 2)
    pw = _powers(op, rows)[:, :B].flip(1).reshape(rows, 1, B, m, 2, m // 2)
    s = torch.zeros((rows, F, B, 2, m), dtype=f.dtype, device=f.device)
    for c in range(m // 2):
        s = s + pw[..., c].transpose(-1, -2) * fr[..., c, None]
    s = s.reshape(rows, F, B // 16, 32, m)
    while s.shape[-2] > 1:
        s = s[..., 0::2, :] + s[..., 1::2, :]
    w = s[:, :, 0, 0]
    for run in range(1, B // 16):
        w = w + s[:, :, run, 0]
    return w.reshape(*lead, F, m)


def entry_states_plain(op, f: torch.Tensor, z: torch.Tensor, w: torch.Tensor, frame_lo: int = 0):
    """The plain PyTorch version of ``entry_states``, in the kernel's order:
    the frame chain z' = ALB z + w (12 products in ascending order, then
    w); every block's entry state as sum_{1 <= k <= j} P_{j-k} f[k-1] (k,
    then the state, ascending) + P_j z_f."""
    lead, (F, B, m) = f.shape[:-3], f.shape[-3:]
    rows = math.prod(f.shape[:-3])
    fr = f.reshape(rows, F, B, m)
    wr = w.reshape(rows, -1, m)
    pw = _powers(op, rows)
    zr = z.reshape(rows, m)
    starts = []
    for g in range(wr.shape[1]):
        if frame_lo <= g < frame_lo + F:
            starts.append(zr)
        acc = torch.zeros_like(zr)
        for b in range(m):
            acc = acc + pw[:, B, :, b] * zr[:, b, None]
        zr = acc + wr[:, g]
    zs = torch.stack(starts, dim=1) if starts else fr.new_empty((rows, 0, m))
    z_in = torch.zeros_like(fr)
    for k in range(1, B):
        pk = pw[:, None, : B - k]  # P_{j-k} for j = k .. B - 1
        for b in range(m):
            z_in[:, :, k:] = z_in[:, :, k:] + pk[..., b] * fr[:, :, k - 1, None, None, b]
    for b in range(m):
        z_in = z_in + pw[:, None, :B, :, b] * zs[:, :, None, None, b]
    return z_in.reshape(*lead, F, B, m), zr.reshape(*lead, m)


def _state_check(op, f: torch.Tensor) -> tuple[int, int, int]:
    """Validate the state kernel's forcing and constants; returns (rows,
    set_stride, set_rows): row r of the dispatch uses the powers of set r //
    set_rows, set_stride floats apart (0 for a shared design)."""
    apow = op.APow
    if f.dtype != torch.float32 or f.ndim < 3 or tuple(f.shape[-2:]) != (STATE_BLOCKS, STATE_DIM):
        raise ValueError(f"f must be (..., F, {STATE_BLOCKS}, {STATE_DIM}) float32; got "
                         f"{tuple(f.shape)} {f.dtype}")
    if apow.dtype != torch.float32 or apow.device != f.device or apow.ndim not in (3, 4) \
            or tuple(apow.shape[-3:]) != (STATE_BLOCKS, STATE_DIM, STATE_DIM) \
            or tuple(apow.stride()[-3:]) != (STATE_DIM**2, STATE_DIM, 1) \
            or apow.data_ptr() % 16:
        raise ValueError(f"APow must be 16-byte aligned (..., {STATE_BLOCKS}, {STATE_DIM}, "
                         f"{STATE_DIM}) float32 with contiguous powers on {f.device}")
    rows = math.prod(f.shape[:-3])
    if apow.ndim == 3:
        return rows, 0, max(rows, 1)
    C = apow.shape[0]
    if rows % C or apow.stride(0) % 4:
        raise ValueError(f"{rows} rows do not split over a bank of {C} channels")
    return rows, apow.stride(0), rows // C


def frame_ends_cuda(op, f: torch.Tensor) -> torch.Tensor:
    """Launch ``iir_state.cu``'s step 1 on a CUDA tensor: w (..., F, m)."""
    rows, stride, set_rows = _state_check(op, f)
    F = f.shape[-3]
    f = launch.aligned(f)
    w = torch.empty((*f.shape[:-2], STATE_DIM), dtype=torch.float32, device=f.device)
    launch.launch("iir_state", f.device, 0, f.data_ptr(), op.APow.data_ptr(), stride, set_rows,
                  None, w.data_ptr(), None, None, rows, F, F, 0)
    return w


def entry_states_cuda(op, f: torch.Tensor, z: torch.Tensor, w: torch.Tensor, frame_lo: int = 0):
    """Launch ``iir_state.cu``'s steps 2 and 3 on CUDA tensors: (z_in (...,
    F, B, m), the final state (..., m))."""
    rows, stride, set_rows = _state_check(op, f)
    F, m = f.shape[-3], STATE_DIM
    lead = f.shape[:-3]
    f_global = w.shape[-2]
    if tuple(z.shape) != (*lead, m) or tuple(w.shape) != (*lead, f_global, m) \
            or not 0 <= frame_lo <= f_global - F or {z.dtype, w.dtype} != {torch.float32} \
            or z.device != f.device or w.device != f.device:
        raise ValueError(f"z must be {(*lead, m)} and w {(*lead, f_global, m)} float32 on "
                         f"{f.device}, frames {frame_lo} + {F} within {f_global}")
    if F == 0:
        if f_global:
            raise ValueError("a dispatch of no frames of its own walks no chain")
        return torch.empty_like(f), z.clone()
    f, z, w = launch.aligned(f), launch.aligned(z), launch.aligned(w)
    z_in = torch.empty_like(f)
    zf = torch.empty_like(z)
    launch.launch("iir_state", f.device, 1, f.data_ptr(), op.APow.data_ptr(), stride, set_rows,
                  z.data_ptr(), w.data_ptr(), z_in.data_ptr(), zf.data_ptr(), rows, F, f_global,
                  frame_lo)
    return z_in, zf


def frame_ends(op, f: torch.Tensor) -> torch.Tensor:
    """Each frame's end state from rest: f (..., F, B, m), the forcing of
    every block -> w (..., F, m), w_f = sum_i P_{B-1-i} f[i]. A per-channel
    bank's rows are channel-major, (C, ..., F, B, m). The plain version on a
    CPU tensor, ``iir_state.cu`` (B = 128, m = 12) on a CUDA one."""
    if launch.on_cpu("iir_state", f):
        return frame_ends_plain(op, f)
    return frame_ends_cuda(op, f)


def entry_states(op, f: torch.Tensor, z: torch.Tensor, w: torch.Tensor, frame_lo: int = 0):
    """The frame chain and every block's entry state: f (..., F, B, m), z
    (..., m) the state entering frame 0 of w, w (..., F_global, m) every
    frame's end state from rest, the dispatch's frames being frame_lo ..
    frame_lo + F - 1 of w's. Returns (z_in (..., F, B, m), the state after
    all of w's frames (..., m)). As ``frame_ends`` for the layout and the
    device."""
    if launch.on_cpu("iir_state", f):
        return entry_states_plain(op, f, z, w, frame_lo)
    return entry_states_cuda(op, f, z, w, frame_lo)


def state_path(op, f: torch.Tensor, z: torch.Tensor, time_axis=None):
    """The state path of a dispatch from its forcing: ``frame_ends``, then
    ``entry_states``, in the span ``tpu_sdr.iir.frame_chain``. Returns
    (z_in (..., F, B, m), the final state (..., m)).

    ``time_axis``: the frames are this shard's run of a stream sharded over
    that axis; the (..., F, m) end states are all-gathered in frame order,
    every shard walks the identical global chain from the global z, and the
    final state is the global one (bit-identical to one device)."""
    with span("tpu_sdr.iir.frame_chain"):
        w = frame_ends(op, f)
        lo = 0
        if time_axis is not None:
            w = comm.all_gather(w, time_axis, -2)
            lo = time_axis.index * f.shape[-3]
        return entry_states(op, f, z, w, lo)


def blocked(op, x: torch.Tensor) -> torch.Tensor:
    """x (..., T) as the steps' blocks (..., F, B, L), a view; a per-channel
    bank's x (..., C, T) as (C, ..., F, B, L), its channel axis first."""
    v = x.reshape(*x.shape[:-1], -1, op.frame_blocks, op.block)
    return v.movedim(-4, 0) if op.T.ndim == 3 else v


def _windowed(x: torch.Tensor, window: torch.Tensor | None) -> torch.Tensor:
    """x (..., T) times ``window`` a frame of its length at a time."""
    if window is None:
        return x
    n = window.shape[-1]
    return (x.reshape(*x.shape[:-1], -1, n) * window).reshape(x.shape)


def block_forcing_plain(op, x: torch.Tensor, window: torch.Tensor | None = None):
    """The plain PyTorch version of ``block_forcing``, in the kernel's order:
    xw = x w, each product rounded alone; then for each of a block's 32 runs
    of 4 samples (k = 4l .. 4l + 3) the products P[j, k] xw[k] added to 0 in
    ascending k, each product rounded and then added (the kernel's FMAs round
    once); then the 32 partial sums pairwise, l with l + 16, then + 8, + 4,
    + 2 and + 1."""
    xw = blocked(op, _windowed(x, window)).contiguous()
    L, m = xw.shape[-1], op.state_dim
    P = op.P if op.P.ndim == 3 else op.P[None]
    v = xw.reshape(P.shape[0], -1, L // 4, 4)
    pt = P.reshape(P.shape[0], 1, m, L // 4, 4).permute(0, 1, 3, 4, 2)  # (sets, 1, l, 4, m)
    acc = torch.zeros((*v.shape[:-1], m), dtype=xw.dtype, device=xw.device)
    for s in range(4):
        acc = acc + v[..., s, None] * pt[..., s, :]
    while acc.shape[-2] > 1:
        h = acc.shape[-2] // 2
        acc = acc[..., :h, :] + acc[..., h:, :]
    return xw, acc.reshape(*xw.shape[:-1], m)


def _force_check(op, x: torch.Tensor, window: torch.Tensor | None) -> tuple[int, int, int, int]:
    """Validate the forcing kernel's input, window and constants; returns
    (rows, p_stride, set_rows, chans): row r of the steps' layout reads row
    (r % set_rows) * chans + r // set_rows of x and the P of set r //
    set_rows, p_stride floats apart (0 for a shared design)."""
    L, B, m = EMIT_BLOCK, STATE_BLOCKS, STATE_DIM
    if x.dtype != torch.float32 or x.ndim < 1 or x.shape[-1] % (B * L):
        raise ValueError(f"x must be (..., T) float32 with T a multiple of {B * L}; got "
                         f"{tuple(x.shape)} {x.dtype}")
    if window is not None and (window.dtype != torch.float32 or tuple(window.shape) != (B * L,)
                               or window.device != x.device):
        raise ValueError(f"the window must be ({B * L},) float32 on {x.device}")
    P = op.P
    if P.dtype != torch.float32 or P.device != x.device or P.ndim not in (2, 3) \
            or tuple(P.shape[-2:]) != (m, L) or not P.is_contiguous() or P.data_ptr() % 16:
        raise ValueError(f"P must be contiguous 16-byte aligned (..., {m}, {L}) float32 on "
                         f"{x.device}")
    rows = math.prod(x.shape[:-1])
    if P.ndim == 2:
        return rows, 0, max(rows, 1), 1
    C = P.shape[0]
    if x.ndim < 2 or x.shape[-2] != C:
        raise ValueError(f"x must be (..., {C}, T) for a bank of {C} channels; got "
                         f"{tuple(x.shape)}")
    return rows, m * L, max(rows // C, 1), C


def _row_stride(x: torch.Tensor) -> int | None:
    """Floats between the rows of x (..., T) where they are evenly spaced,
    each T contiguous floats from a 16-byte boundary (a chunk cut from a
    longer stream, say), as the forcing kernel reads them; else None."""
    if x.data_ptr() % 16:
        return None
    if x.is_contiguous():
        return x.shape[-1] if x.numel() and x.shape[-1] < 2**31 else None
    if x.numel() == 0 or x.stride(-1) != 1:
        return None
    try:
        stride = x.view(-1, x.shape[-1]).stride(0)
    except RuntimeError:  # the leading axes do not fold into one
        return None
    return stride if stride % 4 == 0 and stride < 2**31 else None


def _out_check(v: torch.Tensor, out) -> None:
    """Validate ``out`` (xw, f) for the blocked view v of a chunk."""
    xw, f = out
    f_shape = (*v.shape[:-1], STATE_DIM)
    if tuple(xw.shape) != tuple(v.shape) or tuple(f.shape) != f_shape \
            or not xw.is_contiguous() or not f.is_contiguous() or xw.data_ptr() % 16 \
            or {xw.dtype, f.dtype} != {torch.float32} \
            or xw.device != v.device or f.device != v.device:
        raise ValueError(f"out must be a 16-byte aligned contiguous {tuple(v.shape)} and a "
                         f"contiguous {f_shape}, float32 on {v.device}")


def _launch_forcing(x: torch.Tensor, consts: tuple, xw, f: torch.Tensor, rows: int) -> None:
    """Launch ``csrc/iir_force.cu`` on chunk x (..., T), its rows read where
    they lie where ``_row_stride`` allows, else from an aligned copy;
    ``consts`` the window's and P's addresses, P's stride, set_rows and
    chans; xw None where the kernel stores no xw."""
    stride = _row_stride(x)
    if stride is None:
        x, stride = launch.aligned(x), x.shape[-1]
    launch.launch("iir_force", x.device, x.data_ptr(), *consts, stride,
                  None if xw is None else xw.data_ptr(), f.data_ptr(), rows,
                  x.shape[-1] // EMIT_BLOCK)


def block_forcing_cuda(op, x: torch.Tensor, window: torch.Tensor | None = None):
    """Launch ``csrc/iir_force.cu`` on CUDA tensors: (xw, f) as
    ``block_forcing``."""
    rows, p_stride, set_rows, chans = _force_check(op, x, window)
    if _row_stride(x) is None:
        x = launch.aligned(x)
    v = blocked(op, x)
    xw = v if window is None and v.is_contiguous() else torch.empty_like(
        v, memory_format=torch.contiguous_format)
    f = x.new_empty((*v.shape[:-1], STATE_DIM))
    w = None if window is None else launch.aligned(window).data_ptr()
    _launch_forcing(x, (w, op.P.data_ptr(), p_stride, set_rows, chans),
                    None if xw is v else xw, f, rows)
    return xw, f


class ForcingLaunch:
    """``block_forcing(op, x, window)`` as a call of x alone that writes
    (xw, f) into ``out``, for chunks of one shape and dtype on one device,
    with the operator, the window and ``out`` checked once, here: the
    graphs' dispatches (``runtime/dispatch_graphs.py``) launch the pass
    every chunk, where the host sets the pace. A CPU chunk takes the plain
    version."""

    def __init__(self, op, x: torch.Tensor, window: torch.Tensor, out):
        self.op, self.window, self.out, self.shape = op, window, out, x.shape
        if x.device.type == "cpu":
            return
        self.rows, p_stride, set_rows, chans = _force_check(op, x, window)
        _out_check(blocked(op, x), out)
        self.window = launch.aligned(window)
        self.consts = (self.window.data_ptr(), op.P.data_ptr(), p_stride, set_rows, chans)

    def __call__(self, x: torch.Tensor) -> None:
        if x.shape != self.shape or x.dtype != torch.float32:
            raise ValueError(f"a chunk of {tuple(self.shape)} float32 was prepared for; got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device.type == "cpu":
            for buf, got in zip(self.out, block_forcing(self.op, x, self.window)):
                buf.copy_(got)
        else:
            _launch_forcing(x, self.consts, self.out[0], self.out[1], self.rows)


def block_forcing(op, x: torch.Tensor, window: torch.Tensor | None = None):
    """The products step where ``takes_emit_kernel(op)``, in one pass over
    the chunk: x (..., T) in its own layout (a per-channel bank's (..., C,
    T)), times ``window`` a frame (B*L samples) at a time where given ->
    (xw, the blocked input as multiplied, in the steps' layout (``blocked``),
    contiguous: x's own view where there is no window and the layout allows;
    f (..., F, B, m), every block's forcing xw P^T). The plain version on a
    CPU tensor, ``iir_force.cu`` (B = L = 128, m = 12) on a CUDA one."""
    if launch.on_cpu("iir_force", x):
        return block_forcing_plain(op, x, window)
    return block_forcing_cuda(op, x, window)


def block_outputs_plain(op, v: torch.Tensor, z_in: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``block_outputs``, in the kernel's
    order: each output y[n] of a block is 0, plus M[n, j] z_in[j] for j
    ascending, plus h[n - k] v[k] for k = 0 .. n ascending, each product
    rounded and then added (the kernel's FMAs round once)."""
    L, m = v.shape[-1], z_in.shape[-1]
    T, M = (op.T, op.M) if op.T.ndim == 3 else (op.T[None], op.M[None])
    h, M = T[:, None, :, 0], M[:, None]  # each set's h (1, L) and M (1, L, m)
    vr = v.reshape(T.shape[0], -1, L)
    zr = z_in.reshape(T.shape[0], -1, m)
    y = torch.zeros_like(vr)
    for j in range(m):
        y = y + M[..., j] * zr[..., j, None]
    for k in range(L):
        y[..., k:] = y[..., k:] + h[..., : L - k] * vr[..., k, None]
    return y.reshape(v.shape)


def _emit_check(op, v: torch.Tensor, z_in: torch.Tensor) -> tuple[int, int, int, int]:
    """Validate the emit kernel's input, entry states and constants; returns
    (rows, t_stride, m_stride, set_rows): row r of the dispatch uses the
    constants of set r // set_rows, the strides apart (0 for a shared
    design)."""
    L, B, m = EMIT_BLOCK, STATE_BLOCKS, STATE_DIM
    if v.dtype != torch.float32 or v.ndim < 3 or tuple(v.shape[-2:]) != (B, L) \
            or not v.is_contiguous():
        raise ValueError(f"v must be contiguous (..., F, {B}, {L}) float32; got "
                         f"{tuple(v.shape)} {v.dtype}")
    if z_in.dtype != torch.float32 or tuple(z_in.shape) != (*v.shape[:-1], m) \
            or not z_in.is_contiguous() or z_in.device != v.device:
        raise ValueError(f"z_in must be contiguous {(*v.shape[:-1], m)} float32 on {v.device}; "
                         f"got {tuple(z_in.shape)} {z_in.dtype} on {z_in.device}")
    T, M = op.T, op.M
    if {T.dtype, M.dtype} != {torch.float32} or T.device != v.device or M.device != v.device \
            or T.ndim not in (2, 3) or M.ndim != T.ndim or tuple(T.shape[-2:]) != (L, L) \
            or tuple(M.shape[-2:]) != (L, m) or T.shape[:-2] != M.shape[:-2] \
            or not T.is_contiguous() or not M.is_contiguous() or M.data_ptr() % 16:
        raise ValueError(f"T and M must be contiguous (..., {L}, {L}) and 16-byte aligned "
                         f"(..., {L}, {m}) float32 on {v.device}")
    rows = math.prod(v.shape[:-3])
    if T.ndim == 2:
        return rows, 0, 0, max(rows, 1)
    C = T.shape[0]
    if rows % C:
        raise ValueError(f"{rows} rows do not split over a bank of {C} channels")
    return rows, L * L, L * m, rows // C


def block_outputs_cuda(op, v: torch.Tensor, z_in: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/iir_emit.cu`` on CUDA tensors: y (..., F, B, L)."""
    rows, t_stride, m_stride, set_rows = _emit_check(op, v, z_in)
    v, z_in = launch.aligned(v), launch.aligned(z_in)
    y = torch.empty_like(v)
    launch.launch("iir_emit", v.device, v.data_ptr(), z_in.data_ptr(), op.T.data_ptr(),
                  op.M.data_ptr(), t_stride, m_stride, set_rows, y.data_ptr(), rows,
                  v.shape[-3] * v.shape[-2])
    return y


def block_outputs(op, v: torch.Tensor, z_in: torch.Tensor) -> torch.Tensor:
    """Every block's output from its input and entry state: v (..., F, B,
    L) the blocked input, z_in (..., F, B, m) -> y = v T^T + z_in M^T (...,
    F, B, L), with T = op.T Toeplitz. A per-channel bank's rows are
    channel-major, (C, ..., F, B, L). The plain version on a CPU tensor,
    ``iir_emit.cu`` (B = L = 128, m = 12) on a CUDA one."""
    if launch.on_cpu("iir_emit", v):
        return block_outputs_plain(op, v, z_in)
    return block_outputs_cuda(op, v, z_in)


# The composite cascade in three steps, one a span, that a caller may run
# one at a time (``runtime/dispatch_graphs.py`` runs the first eagerly and
# replays the other two from CUDA graphs): ``cascade_products``,
# ``cascade_chain`` and ``cascade_emit``; ``cascade_state`` puts the final
# state in the caller's layout. A shared design's steps (op.T (L, L)) take x
# (..., T); a per-channel bank's (op.T (C, L, L)) take x (..., C, T) and
# hold the channel axis first. The GEMM form's products run in calls of
# ``frames`` frames (``cascade_frames``).


def bank_frames(channels: int) -> int:
    """Frames of each channel per batched product call of a bank: the
    ``CANONICAL_FRAMES`` of one call shared among the bank's channels, so a
    dispatch of 8 channels x 64 frames makes one call per product. The
    channel count is fixed by the bank, so every dispatch calls each
    product at one shape (chunked == one-shot)."""
    return max(1, CANONICAL_FRAMES // channels)


def cascade_frames(op, channels: int | None = None) -> int:
    """Frames of each channel per product call: a bank's ``bank_frames``
    of ``channels``, the whole bank's channel count where op holds one
    channel shard's rows (by default op's own); a shared design's
    ``CANONICAL_FRAMES``."""
    if op.T.ndim == 3:
        return bank_frames(op.T.shape[0] if channels is None else channels)
    return CANONICAL_FRAMES


def cascade_products(op, x: torch.Tensor, frames: int, window: torch.Tensor | None = None):
    """Step 1, in the span ``tpu_sdr.iir.products``: x, times ``window`` a
    frame at a time where given, -> (y0, the forcing f (..., F, B, m),
    contiguous). y0 is what step 3 builds the output on: where
    ``takes_emit_kernel(op)`` the blocked input itself, contiguous, from one
    pass that also forms f (``block_forcing``); else the zero-state output
    y_zs = v T^T, after the window's multiply, with f from P's product."""
    with span("tpu_sdr.iir.products"):
        if takes_emit_kernel(op):
            return block_forcing(op, x, window)
        y_zs, f = _composite_products(op, blocked(op, _windowed(x, window)), frames)
        return y_zs, f.contiguous()  # a padded call's rows are a view


def cascade_chain(op, f: torch.Tensor, zi: torch.Tensor, frames: int, time_axis=None):
    """Step 2, the state path, in the span ``tpu_sdr.iir.frame_chain``: f
    from step 1, zi (..., S, 2) (a bank's (..., C, S, 2)) the state entering
    the dispatch -> (z_in (..., F, B, m), the final state (..., m)).
    ``state_path`` where ``takes_state_kernel(op)``, else
    ``gemm_state_path`` in calls of ``frames`` frames."""
    z = zi.reshape(*zi.shape[:-2], -1)
    if op.T.ndim == 3:
        z = z.movedim(-2, 0).contiguous()
    if takes_state_kernel(op):
        return state_path(op, f, z, time_axis)
    return gemm_state_path(op, f, z, frames, time_axis)


def cascade_emit(op, y0: torch.Tensor, z_in: torch.Tensor, frames: int):
    """Step 3, in the span ``tpu_sdr.iir.emit``: the output y from steps 1
    and 2, in x's layout: ``block_outputs`` from the blocked input where
    ``takes_emit_kernel(op)``, else y_zs + z_in M^T."""
    with span("tpu_sdr.iir.emit"):
        if takes_emit_kernel(op):
            y = block_outputs(op, y0, z_in)
        else:
            y = y0 + _canonical_matmul(z_in, op.M.mT, frames * op.frame_blocks)
    if op.T.ndim == 3:
        y = y.movedim(0, -4)
    return y.reshape(*y.shape[:-3], -1)


def cascade_state(op, z: torch.Tensor) -> torch.Tensor:
    """Step 2's final state in zi's layout (..., S, 2) (a bank's (..., C,
    S, 2))."""
    if op.T.ndim == 3:
        z = z.movedim(0, -2)
    return z.reshape(*z.shape[:-1], -1, 2)


def _composite(op, x, zi, time_axis=None, channels=None, window=None):
    """The three steps in turn: (y (..., T), zf (..., S, 2))."""
    frames = cascade_frames(op, channels)
    y0, f = cascade_products(op, x, frames, window)
    z_in, z = cascade_chain(op, f, zi, frames, time_axis)
    return cascade_emit(op, y0, z_in, frames), cascade_state(op, z)


def sosfilt_blocked_composite(
    op: BlockedSOSComposite, x: torch.Tensor, zi: torch.Tensor, *, time_axis=None
):
    """Composite-cascade filter: x (..., T), T a multiple of B*L.

    zi: (..., S, 2) scipy-convention state. Returns (y (..., T),
    zf (..., S, 2)).

    ``time_axis`` (a ``MeshAxis``): x is this shard's run of frames of a
    stream sharded over that axis, and zi the GLOBAL stream-head state
    (replicated). Only the per-frame m-vector summaries cross the axis;
    every shard replays the identical global frame chain and keeps its own
    starts, so y is bit-identical to this shard's frames of the one-device
    result and zf is the global final state.
    """
    return _composite(op, x, zi, time_axis)


def sosfilt_blocked_composite_timesharded(
    op: BlockedSOSComposite, x_local: torch.Tensor, zi: torch.Tensor, *, time_axis
):
    """The reference's name for ``sosfilt_blocked_composite`` over a time
    axis. Returns (y_local, zf_global)."""
    return sosfilt_blocked_composite(op, x_local, zi, time_axis=time_axis)


def sosfilt_blocked_composite_bank(
    op: BlockedSOSComposite, x: torch.Tensor, zi: torch.Tensor, *,
    time_axis=None, channels: int | None = None, window: torch.Tensor | None = None,
):
    """Per-channel-coefficients cascade: x (..., C, T), zi (..., C, S, 2) ->
    (y (..., C, T), zf (..., C, S, 2)). A shared design's op runs here as in
    ``sosfilt_blocked_composite``, ``channels`` unread. ``window``: x is
    filtered as multiplied by it a frame of its length at a time (the
    analyzer's Hann window), in the products step.

    ``time_axis``: the frames are one shard of a stream sharded over that
    mesh axis; only the per-frame (C, m) summaries cross it. ``channels``:
    the bank's whole channel count when ``op`` holds one channel shard's
    rows; every product then keeps the call shape of the whole bank
    (``bank_frames(channels)``).

    The math of ``sosfilt_blocked_composite`` with every constant taken per
    channel: the channel axis leads each product (a batched call of
    ``bank_frames(C)`` frames of every channel), and the state path takes
    each row's constants from its channel. One batched call per product
    held chunked == one-shot on an H100 with less device time than one
    call per channel (``scripts/torch_bank_call_shape.py``).
    """
    return _composite(op, x, zi, time_axis, channels, window)


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
