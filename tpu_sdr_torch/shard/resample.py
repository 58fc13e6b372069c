"""Time/channel-sharded rational resampler (the counterpart of
``tpu_sdr.shard.resample``).

The polyphase L/M resampler's outputs depend only on a (P-1)-sample input
window, and its phase pattern restarts whenever the absolute input offset
is a multiple of M, which every shard boundary is (per-shard slices are M
multiples). So sharding the time axis needs exactly one halo: each shard
passes its last P-1 input samples to its right neighbour (shard 0 splices
the carried history) and runs the single-device forward
(``kernels/resample._resample_forward``) on its slice. Sharded ==
single-device bit for bit for every mesh shape.
"""

from __future__ import annotations

import torch

from tpu_sdr_torch.kernels.resample import Resampler, ResamplerState, _resample_forward
from tpu_sdr_torch.core.halo import left_halo
from tpu_sdr_torch.shard.mesh import SdrMesh


class ShardedResampler:
    """``Resampler`` over a (channel, time) mesh: input (C, T) (or (C, 2,
    T), a stereo receiver's L/R planes), C over ``channel``, T over
    ``time``; per-shard slices must be multiples of the reduced M and at
    least P-1 samples."""

    def __init__(self, rs: Resampler, mesh: SdrMesh):
        self.rs = rs
        self.mesh = mesh

    def initial_state(self, batch_shape: tuple = ()) -> ResamplerState:
        return self.rs.initial_state(batch_shape)

    def _check(self, shape, state: ResamplerState):
        ts = self.mesh.shape["time"]
        t = shape[-1]
        if t % ts:
            raise ValueError(f"T={t} must divide over {ts} time shards")
        t_loc = t // ts
        if t_loc % self.rs.down:
            raise ValueError(f"per-shard slice {t_loc} not a multiple of M={self.rs.down}")
        if t_loc < self.rs.history_len:
            raise ValueError(
                f"per-shard slice {t_loc} shorter than the halo ({self.rs.history_len}); "
                "use fewer time shards"
            )
        want = tuple(shape[:-1]) + (self.rs.history_len,)
        if tuple(state.tail.shape) != want:
            raise ValueError(f"state shape {tuple(state.tail.shape)} != {want}")

    def _local(self, x, state: ResamplerState):
        rs = self.rs
        hist = rs.history_len
        if hist:
            halo, new_tail = left_halo(x[..., x.shape[-1] - hist :].contiguous(), state.tail,
                                       self.mesh.time_axis)
        else:
            halo, new_tail = state.tail, state.tail
        out, _ = _resample_forward(x, halo, rs._h, rs.up, rs.down, rs.p)
        t = x.shape[-1] * self.mesh.shape["time"]
        return out, ResamplerState(new_tail, state.offset + t)

    def process(self, x, state: ResamplerState):
        """x (C, T) or (C, 2, T) -> (this rank's output block, the new
        global state)."""
        self._check(tuple(x.shape), state)
        out, new = self._local(self.mesh.block(x, 0, -1), self.mesh.local_rows(state))
        return out, self.mesh.global_rows(new)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """The global output from every rank's block."""
        return self.mesh.gather(y, 0, -1)
