"""Time/channel-sharded Welch PSD (the counterpart of
``tpu_sdr.shard.psd``).

Same (channel, time) mesh as the spectrum pipeline and the channelizer: the
channel axis is communication-free; the time axis splits the stream into
contiguous runs. Welch segments overlap by ``noverlap`` samples, so each
shard needs that many samples from its right neighbour (a segment belongs
to the shard its START falls in): one shift of the neighbour's head to the
left. Per-shard segment PSDs are mask-summed (segments that would run past
the global end are dropped, as the unsharded estimator drops them) and
summed over the time axis; the result is replicated over time.

Median averaging needs a global order statistic and is not shardable this
way: ``average='mean'`` only. Not bitwise against the single-device
estimator (the mean is a sum across shards): within 1e-6 relative.
"""

from __future__ import annotations

import torch

from tpu_sdr_torch.runtime.psd import WelchPSD
from tpu_sdr_torch.core import comm
from tpu_sdr_torch.shard.mesh import SdrMesh


class ShardedWelchPSD:
    """``WelchPSD`` over a (channel, time) mesh.

    Input: real ``(C, T)`` or IQ planes ``(2, C, T)``; C must divide over
    the mesh's channel axis; each time shard's slice must be a multiple of
    the segment step and at least ``nperseg`` samples. Returns this rank's
    channel rows of the PSD ((C/cd, nfreq), replicated over time);
    ``gather`` assembles the (C, nfreq) whole.
    """

    def __init__(self, est: WelchPSD, mesh: SdrMesh):
        if est.average != "mean":
            raise ValueError(
                "sharded Welch supports average='mean' only (median needs a global "
                "order statistic)"
            )
        self.est = est
        self.mesh = mesh

    def _check(self, shape):
        ts = self.mesh.shape["time"]
        if shape[-1] % ts:
            raise ValueError(f"T={shape[-1]} must divide over {ts} time shards")
        t_loc = shape[-1] // ts
        if t_loc % self.est.step:
            raise ValueError(
                f"per-shard slice {t_loc} not a multiple of the segment step {self.est.step}"
            )
        if t_loc < self.est.nperseg:
            raise ValueError(
                f"per-shard slice {t_loc} shorter than nperseg={self.est.nperseg}; use "
                "fewer time shards"
            )

    def _local(self, x, iq: bool):
        est = self.est
        axis = self.mesh.time
        ts = self.mesh.shape["time"]
        halo = est.noverlap
        t_loc = x.shape[-1]
        if halo:
            # shard s receives shard s+1's head; the last shard zeros (its
            # tail segments are masked out below)
            right = comm.shift(x[..., :halo].contiguous(), axis, -1) if ts > 1 else None
            x = torch.cat([x, torch.zeros_like(x[..., :halo]) if right is None else right], -1)
        k = t_loc // est.step  # segments starting in this shard
        xr, xi = (x[0], x[1]) if iq else (x, None)
        p2 = est._run(xr, xi, onesided=not iq, average="none")  # (..., k, nfreq)
        t_global = t_loc * ts
        nseg_global = (t_global - est.noverlap) // est.step
        start = (axis.index * k + torch.arange(k, device=x.device)) * est.step
        valid = (start + est.nperseg <= t_global).to(p2.dtype)
        part = (p2 * valid[:, None]).sum(dim=-2)
        if ts > 1:
            part = comm.all_reduce(part, axis)
        return part / nseg_global

    def _run(self, x, iq: bool):
        self._check(tuple(x.shape))  # friendly errors BEFORE any transfer
        return self._local(self.mesh.block(x, -2, -1), iq)

    def compute(self, x) -> torch.Tensor:
        """Real input (C, T) -> this rank's rows of the one-sided PSD
        (C/cd, nperseg//2 + 1)."""
        return self._run(x, False)

    def compute_iq(self, xs) -> torch.Tensor:
        """IQ planes (2, C, T) -> this rank's rows of the two-sided PSD
        (C/cd, nperseg), unshifted."""
        return self._run(xs, True)

    def gather(self, psd: torch.Tensor) -> torch.Tensor:
        """The (C, nfreq) PSD from every channel shard's rows."""
        return self.mesh.gather(psd, -2, None)
