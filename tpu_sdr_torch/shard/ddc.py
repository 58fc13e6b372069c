"""Time/channel-sharded DDC (the counterpart of ``tpu_sdr.shard.ddc``).

The NCO is trivially shardable: its 32-bit phase is a wrapping multiply of
the absolute sample index, so each time shard computes its slice's phases
exactly (the shard starting at sample ``offset + i*t_loc`` gets the words
the single-device mixer gives those samples). The decimating FIR needs the
previous (P-1)*R MIXED samples: each shard mixes locally, its mixed tail
goes to the right neighbour, and shard 0 splices the carried history
(``core/halo.py``). Outputs are per-rank (channel, time) blocks; the
carried state is global.

Sharded == single-device bit for bit for every mesh shape.
"""

from __future__ import annotations

import torch

from tpu_sdr_torch.kernels.ddc import DDC, DDCState, _fold_decimate, _mix
from tpu_sdr_torch.core.halo import left_halo
from tpu_sdr_torch.shard.mesh import SdrMesh


def _fold_halo(yre, yim, tail_re, tail_im, h2, p: int, r: int, time_axis):
    """The decimating fold of the two mixed planes, each behind its halo.
    Returns (out_re, out_im, new_tail_re, new_tail_im)."""
    hist = (p - 1) * r
    outs, tails = [], []
    for y, carried in ((yre, tail_re), (yim, tail_im)):
        if hist:
            halo, new_tail = left_halo(y[..., y.shape[-1] - hist :].contiguous(), carried,
                                       time_axis)
            y = torch.cat([halo, y], dim=-1)
        else:
            new_tail = carried
        outs.append(_fold_decimate(y, h2, p, r))
        tails.append(new_tail)
    return (*outs, *tails)


class ShardedDDC:
    """``DDC`` over a (channel, time) mesh.

    Input: real ``(C, T)`` or IQ planes ``(2, C, T)``; C must divide over
    the mesh's channel axis; each time shard's slice must be a multiple of
    R and at least the (P-1)*R history length.
    """

    def __init__(self, ddc: DDC, mesh: SdrMesh):
        self.ddc = ddc
        self.mesh = mesh

    def initial_state(self, batch_shape: tuple = ()) -> DDCState:
        return self.ddc.initial_state(batch_shape)

    def _check(self, shape, state, iq: bool):
        ts = self.mesh.shape["time"]
        if shape[-1] % ts:
            raise ValueError(f"T={shape[-1]} must divide over {ts} time shards")
        t_loc = shape[-1] // ts
        if t_loc % self.ddc.r:
            raise ValueError(f"per-shard slice {t_loc} not a multiple of R={self.ddc.r}")
        if t_loc < self.ddc.history_len:
            raise ValueError(
                f"per-shard slice {t_loc} shorter than the halo ({self.ddc.history_len}); "
                "use fewer time shards"
            )
        batch = shape[1:-1] if iq else shape[:-1]
        want = tuple(batch) + (self.ddc.history_len,)
        if tuple(state.tail_re.shape) != want:
            raise ValueError(f"state shape {tuple(state.tail_re.shape)} != {want}")

    def _local(self, x, state: DDCState, iq: bool):
        """This rank's block x (C_loc, t_loc) or (2, C_loc, t_loc) and state
        rows -> (output blocks, new state rows; offset global)."""
        ddc = self.ddc
        t = x.shape[-1]
        axis = self.mesh.time
        c, s = ddc._carrier(state.offset + axis.index * t, t, 1)
        yre, yim = _mix(x, c, s, iq)
        ore, oim, tre, tim = _fold_halo(
            yre, yim, state.tail_re, state.tail_im, ddc._h2, ddc.p, ddc.r, self.mesh.time_axis
        )
        return {"re": ore, "im": oim}, DDCState(
            tre, tim, state.offset + t * self.mesh.shape["time"]
        )

    def _process(self, x, state: DDCState, iq: bool):
        shape = tuple(x.shape)
        self._check(shape, state, iq)  # friendly errors BEFORE any transfer
        out, new = self._local(
            self.mesh.block(x, -2, -1), self.mesh.local_rows(state), iq
        )
        return out, self.mesh.global_rows(new)

    def process(self, x, state: DDCState):
        """Real input (C, T) -> this rank's complex baseband blocks
        (C/cd, T/(R*td)), the new global state."""
        return self._process(x, state, iq=False)

    def process_planes(self, xs, state: DDCState):
        """IQ planes (2, C, T) -> this rank's complex baseband blocks."""
        return self._process(xs, state, iq=True)

    def gather(self, out: dict) -> dict:
        """The global (C, T/R) planes from every rank's blocks."""
        return {k: self.mesh.gather(v, -2, -1) for k, v in out.items()}
