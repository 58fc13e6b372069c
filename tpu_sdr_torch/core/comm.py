"""The collectives of the sharded engines, on one mesh axis each.

Every collective of the sharded engines (``tpu_sdr_torch.shard`` and the
time-sharded forms in ``kernels`` and ``runtime``) goes through these
helpers, which pick the route from the axis group's backend:

- NCCL (each rank on its own GPU): the ``torch.distributed`` call on the
  CUDA tensors;
- Gloo with CPU tensors: the call as is;
- Gloo with CUDA tensors (several ranks on one card, which NCCL refuses):
  the tensors are copied to the host, the call runs there, and the result
  is copied back to the card.

A failed collective raises, as any other call does; there is no other
route to fall back to. Each helper takes its tensor whole and returns a new
one; an axis without a process group (a 1 x 1 mesh outside
``torch.distributed``) returns the single-rank result without a call.
Each call is counted in the axis's ``stats`` and runs in the profiler span
``tpu_sdr.comm.<collective>`` (``SPANS``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpu_sdr_torch.core.spans import span

# The single-tensor forms; older releases name them *_into_tensor / *_tensor.
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

COLLECTIVES = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all", "shift",
               "broadcast_from_last")
SPANS = {name: f"tpu_sdr.comm.{name}" for name in COLLECTIVES}


def _staged(axis, t: torch.Tensor) -> bool:
    return axis.backend == "gloo" and t.is_cuda


def _run(axis, name: str, t: torch.Tensor, call):
    """Run the collective ``name``, ``call(host_or_device_tensor) ->
    result``, on the axis's route in its span, counted in ``axis.stats``;
    returns the result on t's device. The staged route's copy to the host
    waits for ``t``, and its copy back is ordered on the current stream;
    NCCL orders its own stream against the current one."""
    with span(SPANS[name]):
        if _staged(axis, t):
            out = call(t.detach().cpu()).to(t.device)
        else:
            out = call(t.contiguous())
    axis.stats["calls"] += 1
    return out


def all_gather(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in axis order
    (``jax.lax.all_gather(..., tiled=True)``)."""
    if axis.group is None:
        return x
    dim = dim % x.ndim
    xm = x.movedim(dim, 0).contiguous()

    def call(t):
        out = t.new_empty((axis.size * t.shape[0],) + tuple(t.shape[1:]))
        _ALL_GATHER(out, t, group=axis.group)
        return out

    return _run(axis, "all_gather", xm, call).movedim(0, dim)


def reduce_scatter(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """Sum ``x`` over the axis and keep this rank's block of ``dim``
    (``jax.lax.psum_scatter(..., tiled=True)``)."""
    if axis.group is None:
        return x
    dim = dim % x.ndim
    xm = x.movedim(dim, 0).contiguous()
    if xm.shape[0] % axis.size:
        raise ValueError(f"dim of {xm.shape[0]} does not divide over {axis.size} ranks")

    def call(t):
        out = t.new_empty((t.shape[0] // axis.size,) + tuple(t.shape[1:]))
        _REDUCE_SCATTER(out, t, group=axis.group)
        return out

    return _run(axis, "reduce_scatter", xm, call).movedim(0, dim)


def all_reduce(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum ``x`` over the axis (``jax.lax.psum``)."""
    if axis.group is None:
        return x

    def call(t):
        t = t.clone()
        dist.all_reduce(t, group=axis.group)
        return t

    return _run(axis, "all_reduce", x, call)


def all_to_all(x: torch.Tensor, axis, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Split ``x`` along ``split_dim`` into one block a rank, send block j
    to rank j, and concatenate what arrives along ``concat_dim`` in rank
    order (``jax.lax.all_to_all(..., tiled=True)``)."""
    if axis.group is None:
        return x
    n = axis.size
    split_dim, concat_dim = split_dim % x.ndim, concat_dim % x.ndim
    if x.shape[split_dim] % n:
        raise ValueError(f"dim of {x.shape[split_dim]} does not divide over {n} ranks")
    # (n, ...) blocks, block j for rank j, each contiguous.
    blocks = torch.stack(x.chunk(n, dim=split_dim)).contiguous()

    def call(t):
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=axis.group)
        return out

    got = _run(axis, "all_to_all", blocks, call)
    return torch.cat(got.unbind(0), dim=concat_dim)


def shift(x: torch.Tensor, axis, step: int = 1) -> torch.Tensor | None:
    """Send ``x`` to the rank ``step`` places along the axis and receive
    from the rank ``step`` places back (a ``ppermute`` with pairs
    (i, i + step)); step +1 moves data right, -1 left. A rank with no
    sender gets None (the reference's ppermute gives it zeros)."""
    if axis.group is None or axis.size == 1:
        return None
    i = axis.index
    dst, src = i + step, i - step
    has_dst, has_src = 0 <= dst < axis.size, 0 <= src < axis.size

    def call(t):
        got = torch.empty_like(t) if has_src else None
        ops = []
        if has_dst:
            ops.append(dist.P2POp(dist.isend, t, axis.global_rank(dst), axis.group))
        if has_src:
            ops.append(dist.P2POp(dist.irecv, got, axis.global_rank(src), axis.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return t if got is None else got

    out = _run(axis, "shift", x, call)
    return out if has_src else None


def broadcast_from_last(x: torch.Tensor, axis) -> torch.Tensor:
    """The last rank's ``x`` on every rank of the axis (the reference's
    ``all_gather(x)[-1]``)."""
    if axis.group is None:
        return x

    def call(t):
        t = t.clone()
        dist.broadcast(t, axis.global_rank(axis.size - 1), group=axis.group)
        return t

    return _run(axis, "broadcast_from_last", x, call)
