"""The one left-neighbour halo exchange every streaming stage shares (the
counterpart of ``tpu_sdr.shard.halo``, which ``tpu_sdr_torch.shard.halo``
re-exports).

Every time-sharded streaming stage (channelizer, DDC, DDC bank, resampler,
demodulators, the hop spectrum path) carries the same state shape: a
fixed-length tail of recent samples. Sharding the time axis then always
means: shard i consumes shard i-1's tail (one send to the right), shard 0
consumes the carried stream history, and the new carried state is the LAST
shard's tail, replicated to every shard. This module is that pattern, once.
"""

from __future__ import annotations

import torch

from tpu_sdr_torch.core import comm


def left_halo(my_tail: torch.Tensor, carried: torch.Tensor, time_axis):
    """Exchange each shard's tail rightward along ``time_axis`` (a
    ``MeshAxis``, or None for one shard).

    my_tail: this shard's trailing samples (..., H); carried: the stream
    history (..., H), replicated. Returns (halo, new_carried): the samples
    to prepend to this shard's slice, and the global stream tail
    (replicated) to carry into the next chunk. Pure data movement, so
    sharded == single-device stays bitwise."""
    if time_axis is None or time_axis.size == 1:
        return carried, my_tail
    left = comm.shift(my_tail, time_axis, 1)
    halo = carried if time_axis.index == 0 else left
    return halo, comm.broadcast_from_last(my_tail, time_axis)
