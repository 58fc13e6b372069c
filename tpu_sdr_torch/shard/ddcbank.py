"""Carrier-sharded DDC bank: K carriers spread over the mesh (the
counterpart of ``tpu_sdr.shard.ddcbank``).

One shared wideband stream, K tuners. ``DDCBank`` mixes every carrier on
one device; this variant shards the CARRIER axis over the mesh's
``channel`` dimension (each rank mixes only its carriers: no traffic on
that axis) and the TIME axis over ``time`` (the mixed-tail halo, as in
``ShardedDDC``). Each rank reads only its time slice of the stream.

Bit-identity: the per-carrier NCO phases are absolute-index uint32 words,
so every (carrier, time) placement mixes the same bits; the fold is the
shared ``_fold_decimate``. Sharded == single-device ``DDCBank`` bit for
bit for every mesh shape.
"""

from __future__ import annotations

import torch

from tpu_sdr_torch.kernels.ddc import DDCBank, DDCState, _mix, _nco_cos_sin
from tpu_sdr_torch.shard.ddc import _fold_halo
from tpu_sdr_torch.shard.mesh import SdrMesh


class ShardedDDCBank:
    """``DDCBank`` over a (channel, time) mesh: carriers on ``channel``,
    the stream on ``time``.

    Input: real ``(T,)`` or IQ planes ``(2, T)``, ONE shared stream. K must
    divide over the mesh's channel axis; each time shard's slice must be a
    multiple of R and at least the (P-1)*R history."""

    def __init__(self, bank: DDCBank, mesh: SdrMesh):
        self.bank = bank
        self.mesh = mesh

    def initial_state(self) -> DDCState:
        return self.bank.initial_state()

    def retune(self, centers_hz):
        self.bank.retune(centers_hz)

    def _check(self, shape, state, iq: bool):
        k = self.bank.k
        ch_shards = self.mesh.shape["channel"]
        if k % ch_shards:
            raise ValueError(f"K={k} carriers must divide over {ch_shards} channel shards")
        tmpl = self.bank._template
        ts = self.mesh.shape["time"]
        if len(shape) != (2 if iq else 1):
            raise ValueError("sharded bank takes ONE stream: (T,) real or (2, T) IQ")
        if shape[-1] % ts:
            raise ValueError(f"T={shape[-1]} must divide over {ts} time shards")
        t_loc = shape[-1] // ts
        if t_loc % tmpl.r:
            raise ValueError(f"per-shard slice {t_loc} not a multiple of R={tmpl.r}")
        if t_loc < tmpl.history_len:
            raise ValueError(
                f"per-shard slice {t_loc} shorter than the halo ({tmpl.history_len}); "
                "use fewer time shards"
            )
        want = (k, tmpl.history_len)
        if tuple(state.tail_re.shape) != want:
            raise ValueError(f"state shape {tuple(state.tail_re.shape)} != {want}")

    def _local(self, x, state: DDCState, iq: bool):
        """This rank's stream slice and carrier rows -> (output blocks
        (K_loc, t_loc/R), new state rows; offset global)."""
        tmpl = self.bank._template
        t = x.shape[-1]
        lo, hi = self.mesh.channel_range(self.bank.k)
        words = self.bank._words[lo:hi]
        start = state.offset + self.mesh.time.index * t
        dev = x.device
        phase0 = torch.tensor([[(start * w) % (1 << 32)] for w in words], dtype=torch.int64,
                              device=dev)
        wt = torch.tensor([[w] for w in words], dtype=torch.int64, device=dev)
        c, s = _nco_cos_sin(phase0, wt, t)  # (K_loc, t)
        xk = x[:, None] if iq else x[None]  # the carrier axis after IQ's planes
        yre, yim = _mix(xk, c, s, iq)
        ore, oim, tre, tim = _fold_halo(
            yre, yim, state.tail_re, state.tail_im, tmpl._h2, tmpl.p, tmpl.r,
            self.mesh.time_axis,
        )
        return {"re": ore, "im": oim}, DDCState(
            tre, tim, state.offset + t * self.mesh.shape["time"]
        )

    def _process(self, x, state: DDCState, iq: bool):
        shape = tuple(x.shape)
        self._check(shape, state, iq)
        out, new = self._local(
            self.mesh.block(x, None, -1), self.mesh.local_rows(state), iq
        )
        return out, self.mesh.global_rows(new)

    def process(self, x, state: DDCState):
        """Real stream (T,) -> this rank's (carrier, time) blocks of the
        complex planes (K/cd, T/(R*td)), the new global state."""
        return self._process(x, state, iq=False)

    def process_planes(self, xs, state: DDCState):
        """IQ planes (2, T) -> this rank's blocks of the planes (K, T/R)."""
        return self._process(xs, state, iq=True)

    def gather(self, out: dict) -> dict:
        """The global (K, T/R) planes from every rank's blocks."""
        return {k: self.mesh.gather(v, -2, -1) for k, v in out.items()}
