"""Time/channel-sharded overlap-save FastFIR (the counterpart of
``tpu_sdr.shard.fastconv``).

Same (channel, time) mesh as the rest of the package: the channel axis is
communication-free; the time axis splits the stream into contiguous runs,
and the only traffic is the ``history``-sample input halo each shard takes
from its left neighbour plus the carried stream head for shard 0. Because
overlap-save frames are independent and every shard's block grid lands on
the global grid (per-shard slices are multiples of ``block``), the sharded
output is bit-identical to the single-device run for every mesh shape.
"""

from __future__ import annotations

import torch

from tpu_sdr_torch.kernels.fastconv import FastFIR, FastFIRState, _fastfir_forward
from tpu_sdr_torch.runtime.stream import check_matmul_precision
from tpu_sdr_torch.core.halo import left_halo
from tpu_sdr_torch.shard.mesh import SdrMesh


class ShardedFastFIR:
    """``FastFIR`` over a (channel, time) mesh.

    Input: real ``(C, T)`` or IQ planes ``(2, C, T)``; C must divide over
    the mesh's channel axis, and each time shard's slice must be a multiple
    of ``block`` (T a multiple of ``chunk_granularity`` = block x time
    shards) and at least ``history`` long. Outputs are this rank's blocks
    (``gather`` assembles them); states are global.
    """

    def __init__(self, f: FastFIR, mesh: SdrMesh):
        self.f = f
        self.mesh = mesh

    @property
    def chunk_granularity(self) -> int:
        return self.f.block * self.mesh.shape["time"]

    def initial_state(self, batch_shape: tuple = (), iq: bool | None = None) -> FastFIRState:
        return self.f.initial_state(batch_shape, iq=iq)

    def _check(self, shape, state: FastFIRState):
        t = shape[-1]
        t_shards = self.mesh.shape["time"]
        if t % t_shards:
            raise ValueError(f"T={t} must divide over {t_shards} time shards")
        t_loc = t // t_shards
        if t_loc % self.f.block:
            raise ValueError(
                f"per-shard slice {t_loc} not a multiple of block={self.f.block}; chunk T "
                f"must be a multiple of chunk_granularity={self.chunk_granularity}"
            )
        cd = self.mesh.shape["channel"]
        if shape[-2] % cd:
            raise ValueError(
                f"channels ({shape[-2]}) must be a multiple of the mesh channel axis ({cd})"
            )
        if t_loc < self.f.history:
            raise ValueError(
                f"per-shard slice {t_loc} shorter than the halo ({self.f.history}); "
                "use fewer time shards"
            )
        want = tuple(shape[:-1]) + (self.f.history,)
        if tuple(state.tail.shape) != want:
            raise ValueError(f"state shape {tuple(state.tail.shape)} != {want}")
        check_matmul_precision("highest")

    def _local(self, x, tail, iq: bool):
        f = self.f
        hist = f.history
        halo, new_tail = left_halo(x[..., x.shape[-1] - hist :], tail, self.mesh.time_axis)
        kw = dict(block=f.block, history=hist)
        if iq:
            o_r, o_i, _, _ = _fastfir_forward(
                x[0], x[1], halo[0], halo[1], f._hr, f._hi, f._plan, cplx=True, **kw
            )
            return torch.stack([o_r, o_i]), new_tail
        out, _ = _fastfir_forward(x, None, halo, None, f._hr, f._hi, f._plan, cplx=False, **kw)
        return out, new_tail

    def _run(self, x, state: FastFIRState, iq: bool):
        shape = tuple(x.shape)
        self._check(shape, state)  # friendly errors BEFORE any transfer
        dim = 1 if iq else 0  # the channel axis of x and of the tail
        out, tail = self._local(
            self.mesh.block(x, -2, -1), self.mesh.local_rows(state.tail, dim), iq
        )
        return out, FastFIRState(self.mesh.global_rows(tail, dim), state.offset + shape[-1])

    def process(self, x, state: FastFIRState):
        """Real sharded filtering: x (C, T) -> (this rank's output block,
        the new global state)."""
        if self.f.complex_taps:
            raise ValueError("complex taps produce IQ output; use process_planes")
        return self._run(x, state, False)

    def process_planes(self, planes, state: FastFIRState):
        """IQ sharded filtering: planes (2, C, T) -> (this rank's (2, C/cd,
        T/td) block, the new global state)."""
        if tuple(planes.shape)[0] != 2:
            raise ValueError(f"planes must be (2, C, T); got {tuple(planes.shape)}")
        return self._run(planes, state, True)

    def gather(self, out: torch.Tensor) -> torch.Tensor:
        """The global output from every rank's block."""
        return self.mesh.gather(out, -2, -1)
