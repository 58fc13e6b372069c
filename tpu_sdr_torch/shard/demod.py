"""Time/channel-sharded demodulators, AGC and squelch (the counterpart of
``tpu_sdr.shard.demod``).

Every demodulator recurrence here is the first-order affine solver of
``kernels/demod.py``, whose in-block Hillis-Steele tree is fixed at one
block. Sharding the time axis therefore needs only:

1. the in-block prefixes computed locally (the same operations when shard
   boundaries fall on block multiples);
2. ONE all-gather of the per-block affine pairs (2 floats per block), after
   which every rank replays the identical inter-block chain
   (``_chain_blocks``) and keeps its own block inputs: the replay pattern
   of the spectrum pipeline's time sharding;
3. a one-sample left-neighbour halo for the FM discriminator and the AM
   envelope difference.

The sharded FM runs this blocked solver, as the reference does, whether
or not the wrapped ``FMDemodulator`` uses its fused kernel. Sharded ==
single-device (default path) bit for bit for every mesh shape. The channel
axis is communication-free. Outputs are per-rank (channel, time) blocks
(``gather``); states are global.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sdr_torch.kernels.ddc import _nco_cos_sin, _u32, f32, fixed_sum
from tpu_sdr_torch.kernels.demod import (
    AGC,
    AGCState,
    AMDemodulator,
    DemodState,
    FMDemodulator,
    SSBDemodulator,
    Squelch,
    SquelchState,
    _chain_blocks,
    _fm_disc_raw,
    _inblock_prefix,
)
from tpu_sdr_torch.core import comm
from tpu_sdr_torch.core.halo import left_halo
from tpu_sdr_torch.shard.mesh import SdrMesh


def _chain_timesharded(A_l, B_l, y0, time_axis):
    """``_chain_blocks`` over the blocks of a stream sharded over
    ``time_axis``: A_l, B_l (..., G_loc) this shard's block-final affines;
    y0 (...,) the global entry state. The pairs are all-gathered in block
    order (one collective), every shard replays the identical global
    chain and keeps its own blocks' inputs. Returns (y_final (...,),
    y_ins (..., G_loc))."""
    if time_axis is None:
        return _chain_blocks(A_l, B_l, y0)
    g = A_l.shape[-1]
    A_all, B_all = comm.all_gather(torch.stack([A_l, B_l]), time_axis, -1).unbind(0)
    y_final, y_ins = _chain_blocks(A_all, B_all, y0)
    lo = time_axis.index * g
    return y_final, y_ins[..., lo : lo + g]


def _affine_timesharded(a, b, y0, block: int, time_axis):
    """The blocked affine solver on a time-sharded stream: a, b (..., t_loc)
    this shard's run, y0 (...,) replicated. Returns (y (..., t_loc),
    y_final (...,) replicated); bit-identical to the single-device
    ``_affine_prefix_raw`` when t_loc % block == 0."""
    A, B = _inblock_prefix(a, b, block)  # (..., G_loc, L)
    y_final, y_ins = _chain_timesharded(A[..., -1], B[..., -1], y0, time_axis)
    y = A * y_ins[..., None] + B
    return y.reshape(a.shape), y_final


def _prev_sample_halo(last, carried, time_axis):
    """One-sample halo: each shard receives its left neighbour's last
    sample; shard 0 splices the carried stream history. Returns (prev
    (..., 1), new_carried (..., 1) replicated = the global last sample)."""
    return left_halo(last.contiguous(), carried, time_axis)


class _ShardedDemodBase:
    """Shared plumbing: (C, T) planes over the (channel, time) mesh."""

    def __init__(self, inner, mesh: SdrMesh):
        self.inner = inner
        self.mesh = mesh

    def initial_state(self, batch_shape: tuple = ()):
        return self.inner.initial_state(batch_shape)

    def _block(self) -> int:
        return getattr(self.inner, "block", 1)

    def _check(self, shape):
        ts = self.mesh.shape["time"]
        t = shape[-1]
        if t % ts:
            raise ValueError(f"T={t} must divide over {ts} time shards")
        blk = self._block()
        if (t // ts) % blk:
            raise ValueError(f"per-shard slice {t // ts} not a multiple of block={blk}")

    def _place(self, *planes):
        return tuple(self.mesh.block(p, -2, -1) for p in planes)

    def _run(self, planes, state):
        """Check, place the (C, T) planes, run ``_local`` on this rank's
        block and state rows; returns (outputs..., the new global state)."""
        self._check(tuple(planes[0].shape))
        *outs, new = self._local(*self._place(*planes), self.mesh.local_rows(state))
        return (*outs, self.mesh.global_rows(new))

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """The global (C, T) output from every rank's block."""
        return self.mesh.gather(y, -2, -1)


class ShardedFMDemodulator(_ShardedDemodBase):
    """``FMDemodulator`` over the mesh: discriminator halo = 1 sample,
    de-emphasis via the time-sharded affine solver."""

    def __init__(self, fm: FMDemodulator, mesh: SdrMesh):
        super().__init__(fm, mesh)

    def _local(self, re, im, state: DemodState):
        fm, ta = self.inner, self.mesh.time_axis
        prev_r, new_r = _prev_sample_halo(re[..., -1:], state.prev_re, ta)
        prev_i, new_i = _prev_sample_halo(im[..., -1:], state.prev_im, ta)
        audio = _fm_disc_raw(re, im, prev_r, prev_i, fm.fs) * f32(1.0 / fm.deviation_hz)
        filt = state.filt
        if fm._pole is not None:
            b = audio * f32(np.float32(1.0) - np.float32(fm._pole))
            audio, filt = _affine_timesharded(
                torch.full_like(audio, f32(fm._pole)), b, filt, fm.block, ta
            )
        t = re.shape[-1] * self.mesh.shape["time"]
        return audio, DemodState(new_r, new_i, filt, state.offset + t)

    def process(self, re, im, state: DemodState):
        return self._run((re, im), state)


class ShardedAMDemodulator(_ShardedDemodBase):
    """``AMDemodulator`` over the mesh: the envelope is elementwise; the DC
    blocker's x[n-1] rides the one-sample halo."""

    def __init__(self, am: AMDemodulator, mesh: SdrMesh):
        super().__init__(am, mesh)

    def _local(self, re, im, state: DemodState):
        am, ta = self.inner, self.mesh.time_axis
        prev_r, new_r = _prev_sample_halo(re[..., -1:], state.prev_re, ta)
        prev_i, new_i = _prev_sample_halo(im[..., -1:], state.prev_im, ta)
        env = torch.sqrt(re * re + im * im)
        prev_env = torch.sqrt(prev_r * prev_r + prev_i * prev_i)
        env1 = torch.cat([prev_env, env[..., :-1]], dim=-1)
        audio, filt = _affine_timesharded(
            torch.full_like(env, f32(am.dc_pole)), env - env1, state.filt, am.block, ta
        )
        t = re.shape[-1] * self.mesh.shape["time"]
        return audio, DemodState(new_r, new_i, filt, state.offset + t)

    def process(self, re, im, state: DemodState):
        return self._run((re, im), state)


class ShardedSSBDemodulator(_ShardedDemodBase):
    """``SSBDemodulator`` over the mesh: the BFO NCO derives each shard's
    phases from the absolute sample index (wrapping uint32, exact), so the
    mix is shard-invariant by construction."""

    def __init__(self, ssb: SSBDemodulator, mesh: SdrMesh):
        super().__init__(ssb, mesh)

    def _local(self, re, im, state: DemodState):
        word, ta = self.inner._word, self.mesh.time_axis
        t = re.shape[-1]
        start = state.offset + self.mesh.time.index * t
        c, s = _nco_cos_sin(_u32(start * word, re.device), _u32(word, re.device), t)
        audio = re * c + im * s  # Re{z * (c - j*s)}
        _, new_r = _prev_sample_halo(re[..., -1:], state.prev_re, ta)
        _, new_i = _prev_sample_halo(im[..., -1:], state.prev_im, ta)
        return audio, DemodState(
            new_r, new_i, state.filt, state.offset + t * self.mesh.shape["time"]
        )

    def process(self, re, im, state: DemodState):
        return self._run((re, im), state)


class ShardedAGC(_ShardedDemodBase):
    """``AGC`` over the mesh: the time-varying affine gain loop through the
    time-sharded solver; g_prev, the previous sample's gain, is the
    inclusive solve shifted by one, whose first sample comes from the left
    neighbour (shard 0: the carried gain)."""

    def __init__(self, agc: AGC, mesh: SdrMesh):
        super().__init__(agc, mesh)

    def _gains(self, mag, g0):
        agc, ta = self.inner, self.mesh.time_axis
        a = torch.clamp_min(1.0 - mag * f32(agc.mu), 0.0)
        b = torch.full_like(mag, f32(agc.mu * agc.ref))
        g, g_final = _affine_timesharded(a, b, g0, agc.block, ta)
        first = g0[..., None]
        if ta is not None:
            left = comm.shift(g[..., -1:].contiguous(), ta, 1)
            first = first if ta.index == 0 else left
        return torch.cat([first, g[..., :-1]], dim=-1), g_final

    def _local_real(self, x, state: AGCState):
        g_prev, g_final = self._gains(x.abs(), state.gain)
        t = x.shape[-1] * self.mesh.shape["time"]
        return g_prev * x, AGCState(g_final, state.offset + t)

    def _local(self, re, im, state: AGCState):
        g_prev, g_final = self._gains(torch.sqrt(re * re + im * im), state.gain)
        t = re.shape[-1] * self.mesh.shape["time"]
        return g_prev * re, g_prev * im, AGCState(g_final, state.offset + t)

    def process_real(self, x, state: AGCState):
        self._check(tuple(x.shape))
        (x,) = self._place(x)
        y, new = self._local_real(x, self.mesh.local_rows(state))
        return y, self.mesh.global_rows(new)

    def process(self, re, im, state: AGCState):
        return self._run((re, im), state)


class ShardedSquelch(_ShardedDemodBase):
    """``Squelch`` over the mesh: per-block power moments gathered once (one
    float per block), the EMA chain replayed on every shard: gates bit for
    bit as on one device."""

    def __init__(self, sq: Squelch, mesh: SdrMesh):
        super().__init__(sq, mesh)

    def _local(self, re, im, state: SquelchState):
        sq, ta = self.inner, self.mesh.time_axis
        lead = re.shape[:-1]
        L = sq.block
        G = re.shape[-1] // L
        rb = re.reshape(*lead, G, L)
        ib = im.reshape(*lead, G, L)
        pw = fixed_sum(rb * rb + ib * ib) * f32(1.0 / L)
        b = pw * f32(1.0 - sq.leak)
        p_final, p_prev = _chain_timesharded(torch.full_like(b, f32(sq.leak)), b, state.power, ta)
        gate = (p_prev > f32(sq.threshold)).to(torch.float32)
        t = re.shape[-1] * self.mesh.shape["time"]
        return torch.repeat_interleave(gate, L, dim=-1), SquelchState(p_final, state.offset + t)

    def gates(self, re, im, state: SquelchState):
        return self._run((re, im), state)
