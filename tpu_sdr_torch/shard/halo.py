"""The counterpart of ``tpu_sdr.shard.halo``: the left-neighbour halo
exchange every time-sharded streaming stage shares. It lives in
``tpu_sdr_torch.core.halo``, below the kernels and the runtime that use it."""

from tpu_sdr_torch.core.halo import left_halo

__all__ = ["left_halo"]
