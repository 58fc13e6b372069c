"""Time/channel-sharded FM stereo (MPX) decoder (the counterpart of
``tpu_sdr.shard.stereo``).

``kernels/stereo.py``'s decoder is built from pieces the sharding story
already covers:

1. the 19/38 kHz NCOs derive each shard's phases from the absolute sample
   index (wrapping uint32, exact), like the sharded SSB BFO;
2. the per-block pilot correlator is local to each shard;
3. the rotation products B_g = A_g * conj(A_{g-1}) need each shard's FIRST
   block to see the left neighbour's LAST raw block phasor: the re/im pair
   stacked into ONE 2-float halo (shard 0 splices the carried phasor);
4. the four pilot EMAs share one pole and run as one ``_chain_blocks``
   chain over a stacked axis: their per-block forcings ride ONE all-gather,
   and every rank replays the identical chains. The de-lag / gate /
   doubling math (``_track_pilot``) runs on the FULL replicated chain, so
   the global last block's |pilot|^2 needs no further collective; each
   shard keeps its own blocks for the carrier mix;
5. per-channel de-emphasis is the time-sharded affine solver.

Sharded == single-device bit for bit for every mesh shape.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sdr_torch.kernels.ddc import _nco_cos_sin, _u32, f32
from tpu_sdr_torch.kernels.demod import _chain_blocks
from tpu_sdr_torch.kernels.stereo import (
    StereoDecoder,
    StereoDecoderState,
    _block_phasor,
    _hann_corr_win,
    _track_pilot,
)
from tpu_sdr_torch.core import comm
from tpu_sdr_torch.shard.demod import _affine_timesharded
from tpu_sdr_torch.core.halo import left_halo
from tpu_sdr_torch.shard.mesh import SdrMesh


class ShardedStereoDecoder:
    """``StereoDecoder`` over a (channel, time) mesh: MPX (C, T) -> stacked
    L/R planes (C, 2, T), C over ``channel``, T over ``time``; per-shard
    slices must be multiples of the decoder block."""

    def __init__(self, dec: StereoDecoder, mesh: SdrMesh):
        self.dec = dec
        self.mesh = mesh

    def initial_state(self, batch_shape: tuple = ()) -> StereoDecoderState:
        return self.dec.initial_state(batch_shape)

    def _local(self, m, state: StereoDecoderState):
        dec, ta = self.dec, self.mesh.time_axis
        blk, lam = dec.block, dec.leak
        lead = m.shape[:-1]
        t = m.shape[-1]
        g = t // blk
        dev = m.device
        start = state.offset + self.mesh.time.index * t
        phase19, k19 = (start * dec._word) % (1 << 32), dec._word
        c19, s19 = _nco_cos_sin(_u32(phase19, dev), _u32(k19, dev), t)
        # doubled word/phase: the 38 kHz carrier stays phase-locked to the
        # pilot NCO for any stream offset
        c38, s38 = _nco_cos_sin(_u32(phase19 * 2, dev), _u32(k19 * 2, dev), t)
        ar, ai = _block_phasor(m, c19, s19, _hann_corr_win(blk, dev), blk)  # (..., G_loc)

        # the previous block's phasor: re/im stacked into ONE 2-float halo
        tail = torch.stack([ar[..., -1], ai[..., -1]], dim=-1)
        carried = torch.stack([state.last_re, state.last_im], dim=-1)
        halo, new_last = left_halo(tail, carried, ta)
        pr = torch.cat([halo[..., 0:1], ar[..., :-1]], dim=-1)
        pi = torch.cat([halo[..., 1:2], ai[..., :-1]], dim=-1)
        br = ar * pr + ai * pi
        bi = ai * pr - ar * pi

        # The four EMAs share the pole: one chain over a stacked axis, its
        # forcings gathered in block order (one collective).
        forcing = torch.stack([ar, ai, br, bi]) * f32(1.0 - lam)
        if ta is not None:
            forcing = comm.all_gather(forcing, ta, -1)
        fins, prevs = _chain_blocks(
            torch.full_like(forcing, f32(lam)), forcing,
            torch.stack([state.a_re, state.a_im, state.b_re, state.b_im]),
        )
        d2r, d2i, gate, p2 = _track_pilot(
            *prevs, lam=lam, thresh=dec.pilot_threshold, w_max=dec._w_max
        )
        lo = 0 if ta is None else ta.index * g
        d2r, d2i, gate = (v[..., lo : lo + g] for v in (d2r, d2i, gate))

        c38b = c38.reshape(*([1] * len(lead)), g, blk)
        s38b = s38.reshape(*([1] * len(lead)), g, blk)
        carrier = c38b * d2r[..., None] - s38b * d2i[..., None]
        mb = m.reshape(*lead, g, blk)
        diff = (2.0 * f32(dec.subcarrier_gain)) * mb * carrier * gate[..., None]
        left = (mb + diff).reshape(*lead, t)
        right = (mb - diff).reshape(*lead, t)
        lr = torch.stack([left, right], dim=len(lead))  # (..., 2, T_loc)

        filt = state.filt
        if dec._pole is not None:
            b = lr * f32(np.float32(1.0) - np.float32(dec._pole))
            lr, filt = _affine_timesharded(
                torch.full_like(lr, f32(dec._pole)), b, filt, blk, ta
            )
        new = StereoDecoderState(
            *fins, new_last[..., 0], new_last[..., 1], filt,
            state.offset + t * self.mesh.shape["time"], p2[..., -1],
        )
        return lr, new

    def process(self, m, state: StereoDecoderState):
        """MPX (C, T) -> (this rank's (C/cd, 2, T/td) L/R block, the new
        global state)."""
        ts = self.mesh.shape["time"]
        t = m.shape[-1]
        if t % ts:
            raise ValueError(f"T={t} must divide over {ts} time shards")
        if (t // ts) % self.dec.block:
            raise ValueError(
                f"per-shard slice {t // ts} not a multiple of block={self.dec.block}"
            )
        if tuple(state.a_re.shape) != tuple(m.shape[:-1]):
            raise ValueError(
                f"state shape {tuple(state.a_re.shape)} != {tuple(m.shape[:-1])}"
            )
        lr, new = self._local(self.mesh.block(m, 0, -1), self.mesh.local_rows(state))
        return lr, self.mesh.global_rows(new)

    def gather(self, lr: torch.Tensor) -> torch.Tensor:
        """The global (C, 2, T) planes from every rank's block."""
        return self.mesh.gather(lr, 0, -1)
