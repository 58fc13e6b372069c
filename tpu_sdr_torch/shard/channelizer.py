"""Time/channel-sharded PFB channelizer (the counterpart of
``tpu_sdr.shard.channelizer``).

Same (channel, time) mesh as the spectrum pipeline: the channel axis is
communication-free; the time axis splits the stream into contiguous runs,
and the only traffic is the (taps-1)*M-sample halo a shard needs from its
left neighbour plus the carried stream head for shard 0
(``core/halo.py``). Outputs are per-rank (channel, steps) blocks
(``gather`` assembles them); the carried state (the stream's global tail)
is global, as the single-device state is.

Sharded == single-device bit for bit for every mesh shape: the fold is
elementwise and the DFT runs at a fixed call shape (or, with
``use_pallas``, in the ``pfb_fold_dft`` kernel, step by step).
"""

from __future__ import annotations

import torch

from tpu_sdr_torch.kernels.pfb import Channelizer, _forward
from tpu_sdr_torch.core.halo import left_halo
from tpu_sdr_torch.shard.mesh import SdrMesh


class ShardedChannelizer:
    """``Channelizer`` over a (channel, time) mesh.

    Input: real ``(C, T)`` or IQ planes ``(2, C, T)``; C must divide over
    the mesh's channel axis, and each time shard's slice must be a
    multiple of M and at least the (taps-1)*M history length.
    """

    def __init__(self, ch: Channelizer, mesh: SdrMesh):
        self.ch = ch
        self.mesh = mesh

    def initial_state(self, batch_shape: tuple = ()) -> torch.Tensor:
        return self.ch.initial_state(batch_shape)

    def _check(self, shape, state):
        ts = self.mesh.shape["time"]
        if shape[-1] % ts:
            raise ValueError(f"T={shape[-1]} must divide over {ts} time shards")
        t_loc = shape[-1] // ts
        cd = self.mesh.shape["channel"]
        if shape[-2] % cd:
            raise ValueError(
                f"channels ({shape[-2]}) must be a multiple of the mesh channel axis ({cd})"
            )
        if t_loc % self.ch.m:
            raise ValueError(f"per-shard slice {t_loc} not a multiple of m={self.ch.m}")
        if t_loc < self.ch.history_len:
            raise ValueError(
                f"per-shard slice {t_loc} shorter than the halo ({self.ch.history_len}); "
                "use fewer time shards"
            )
        want = tuple(shape[:-1]) + (self.ch.history_len,)
        if tuple(state.shape) != want:
            raise ValueError(f"state shape {tuple(state.shape)} != {want}")

    def _local(self, x, state, iq: bool, outputs: str):
        ch = self.ch
        hist = ch.history_len
        if hist:
            halo, new_state = left_halo(x[..., x.shape[-1] - hist :], state, self.mesh.time_axis)
        else:
            halo, new_state = state, state
        cat = torch.cat([halo, x], dim=-1)
        re, im, _ = _forward(
            cat, ch._h2, ch._cos, ch._sin, ch.taps, ch.m, iq=iq,
            use_pallas=ch.use_pallas, kprec=ch._kprec,
        )
        return ch._pack(re, im, outputs), new_state

    def _run(self, x, state, iq: bool, outputs: str):
        self._check(x.shape, state)  # friendly errors BEFORE any transfer
        dim = 1 if iq else 0  # the channel axis of x and state
        out, new_state = self._local(
            self.mesh.block(x, -2, -1), self.mesh.local_rows(state, dim), iq, outputs
        )
        return out, self.mesh.global_rows(new_state, dim)

    def process(self, x, state, outputs: str = "complex"):
        """Real input (C, T) -> (this rank's output blocks (C/cd, steps/td,
        m), the new global state)."""
        return self._run(x, state, False, outputs)

    def process_planes(self, xs, state_planes, outputs: str = "complex"):
        """IQ planes (2, C, T) with the (2, C, history) state stack."""
        return self._run(xs, state_planes, True, outputs)

    def gather(self, out: dict) -> dict:
        """The global (C, steps, m) outputs from every rank's blocks."""
        return {k: self.mesh.gather(v, -3, -2) for k, v in out.items()}
