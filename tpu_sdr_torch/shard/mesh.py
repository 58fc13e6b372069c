"""The (channel, time) process grid of the sharded engines (the counterpart
of ``tpu_sdr.shard.mesh``).

Two mesh axes, as in the reference:

- ``channel``: data parallelism over independent receive channels. State is
  per channel, so this axis carries no traffic inside a dispatch.
- ``time``: sequence parallelism over the stream's frame axis. Only the
  per-frame 12-float IIR summaries and the halos of the streaming stages
  cross it.

Execution model. JAX runs one SPMD program over a ``Mesh`` with
``shard_map``. Here each device is driven by a process of its own (one
``torch.distributed`` rank), and every rank runs the same Python program:

- ``make_sdr_mesh`` lays ranks 0 .. channel*time-1 out row-major on a
  ``torch.distributed.device_mesh.DeviceMesh`` with the dimension names
  ("channel", "time"); ``get_group`` on it gives each axis's process group.
  Ranks past channel*time sit outside a sub-mesh (``mesh.member`` is False)
  and must not call its engines. With no process group initialised, the
  mesh is 1 x 1 on the one device and needs no collective.
- Each rank calls ``process(x, state)`` with the same GLOBAL host chunk (or
  a ``ShardedArray``, a block placed earlier by ``shard_input`` or a
  sharded ``StreamFeeder``). The rank slices its own (channel, time) block,
  runs the single-device body on it with the collectives below, and
  returns its local output block. ``gather()`` assembles the global result
  on every rank.
- States are global and replicated on every rank, as the single-device
  engines' states are: each rank reads its channel rows, and the new state
  is all-gathered along the channel axis, so a sharded state can be
  compared with, checkpointed as and handed to a single-device one.
- The bodies port one to one. Each JAX collective becomes one helper of
  ``core/comm.py`` on the axis: ``all_gather(tiled=True)`` ->
  ``all_gather``; a ``ppermute`` to a neighbour -> ``shift``
  (``batch_isend_irecv``); ``psum_scatter`` -> ``reduce_scatter``;
  ``all_to_all`` -> ``all_to_all``; ``psum`` -> ``all_reduce``;
  ``axis_index`` -> ``MeshAxis.index``. A ``time_axis`` argument is a
  ``MeshAxis`` (its group, size and this rank's coordinate), not a name.

Backends (``comm.py`` picks the route from the group's backend, never from
a caught error): NCCL when each rank has its own GPU; Gloo on the CPU; and
Gloo with CUDA tensors when several ranks share one card (NCCL refuses two
ranks on one GPU), where each collective copies its tensors to the host and
back explicitly.
"""

from __future__ import annotations

import copy
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from tpu_sdr_torch.core import comm

AXES = ("channel", "time")


@dataclasses.dataclass(eq=False)
class MeshAxis:
    """One mesh axis as this rank sees it: ``size`` ranks, this rank's
    coordinate ``index`` on it, the global ranks along it in coordinate
    order, and its process group (None without a process group, where the
    axis has size 1 and no collective runs). ``stats`` (shared by the
    mesh's axes) counts the collectives."""

    name: str
    size: int
    index: int
    ranks: tuple
    group: object = None
    backend: str | None = None
    stats: dict = dataclasses.field(default_factory=lambda: {"calls": 0})

    def global_rank(self, index: int) -> int:
        return self.ranks[index]


@dataclasses.dataclass(frozen=True)
class ShardedArray:
    """A global array held as blocks: ``local`` is this rank's block (on
    the mesh's device) and ``shape`` the global shape. What
    ``shard_input`` and a sharded ``StreamFeeder`` hand to ``process``."""

    local: torch.Tensor
    shape: tuple


def _block_range(n: int, parts: int, index: int, what: str) -> tuple[int, int]:
    if n % parts:
        raise ValueError(f"{what} length {n} must divide over {parts} shards")
    size = n // parts
    return index * size, (index + 1) * size


class SdrMesh:
    """The (channel, time) grid of ranks, from this rank's seat.

    ``shape["channel"]`` and ``shape["time"]`` index it as JAX code indexes
    ``Mesh.shape``; ``channel`` and ``time`` are its ``MeshAxis`` objects;
    ``device`` is this rank's device; ``device_mesh`` the underlying
    ``DeviceMesh`` (None without a process group)."""

    def __init__(self, channel: int, time: int, device, device_mesh=None,
                 coords=(0, 0), groups=(None, None), ranks=((0,), (0,)), backend=None):
        self.shape = {"channel": channel, "time": time}
        self.device = torch.device(device)
        self.device_mesh = device_mesh
        self.coords = coords
        self.stats = {"calls": 0}
        if coords is None:
            self.channel = self.time = None
            return
        self.channel, self.time = (
            MeshAxis(name, self.shape[name], coords[i], ranks[i], groups[i], backend, self.stats)
            for i, name in enumerate(AXES)
        )

    @property
    def member(self) -> bool:
        """Whether this rank holds a block of the mesh."""
        return self.coords is not None

    @property
    def time_axis(self) -> MeshAxis | None:
        """The time axis as a stage body takes it: None with one time
        shard, where nothing is exchanged (as the reference passes
        ``time_axis=None``)."""
        return self.time if self.shape["time"] > 1 else None

    def _require_member(self):
        if not self.member:
            raise ValueError("this rank is outside the mesh: it holds no block")

    def channel_range(self, n: int) -> tuple[int, int]:
        """This rank's rows [lo, hi) of an n-row channel axis."""
        self._require_member()
        return _block_range(n, self.shape["channel"], self.channel.index, "channel")

    def time_range(self, n: int) -> tuple[int, int]:
        """This rank's samples [lo, hi) of an n-sample time axis."""
        self._require_member()
        return _block_range(n, self.shape["time"], self.time.index, "time")

    def block_index(self, shape, channel_dim: int | None, time_dim: int | None) -> tuple:
        """The index of this rank's block in an array of ``shape``, whose
        channel and time axes are ``channel_dim`` and ``time_dim`` (None:
        the array has no such axis, or it is not sharded)."""
        sl = [slice(None)] * len(shape)
        for dim, rng in ((channel_dim, self.channel_range), (time_dim, self.time_range)):
            if dim is not None:
                lo, hi = rng(shape[dim])
                sl[dim] = slice(lo, hi)
        return tuple(sl)

    def block(self, x, channel_dim: int | None, time_dim: int | None) -> torch.Tensor:
        """This rank's block of a global array (host or device), as a
        float32 tensor on the mesh's device. Only the block is copied."""
        if isinstance(x, ShardedArray):
            return x.local
        if not torch.is_tensor(x):
            x = np.asarray(x, np.float32)
        blk = x[self.block_index(x.shape, channel_dim, time_dim)]
        if torch.is_tensor(blk):
            return blk.to(self.device, torch.float32)
        return torch.as_tensor(np.ascontiguousarray(blk), device=self.device)

    def put(self, x, channel_dim: int | None, time_dim: int | None) -> ShardedArray:
        """Place a global array: this rank's block on its device, beside
        the global shape."""
        if isinstance(x, ShardedArray):
            return x
        return ShardedArray(self.block(x, channel_dim, time_dim), tuple(np.shape(x)))

    def gather(self, x: torch.Tensor, channel_dim: int | None, time_dim: int | None):
        """Assemble the global array from every rank's block (a collective:
        every rank of the mesh calls it). Returns it on every rank."""
        self._require_member()
        if time_dim is not None and self.shape["time"] > 1:
            x = comm.all_gather(x, self.time, time_dim)
        if channel_dim is not None and self.shape["channel"] > 1:
            x = comm.all_gather(x, self.channel, channel_dim)
        return x

    def local_rows(self, state, dim: int = 0):
        """A copy of a state object (any of the engines' state classes,
        sub-states included) with every tensor leaf cut to this rank's
        rows of its channel axis ``dim``, on the mesh's device."""
        def cut(t):
            lo, hi = self.channel_range(t.shape[dim])
            return t.narrow(dim, lo, hi - lo).to(self.device)

        return map_state(state, cut)

    def global_rows(self, state, dim: int = 0):
        """The inverse of ``local_rows``: every tensor leaf all-gathered
        along the channel axis ``dim`` (a collective)."""
        if self.shape["channel"] == 1:
            return state
        return map_state(state, lambda t: comm.all_gather(t, self.channel, dim))


def map_state(state, fn):
    """Apply ``fn`` to every tensor leaf of a state object: a tensor, None,
    a number, or an object whose attributes are such leaves or further
    state objects. Returns a shallow copy; ``state`` is left as it is."""
    if torch.is_tensor(state):
        return fn(state)
    if state is None or isinstance(state, (int, float, str, np.ndarray, np.generic)):
        return state
    new = copy.copy(state)
    for k, v in vars(state).items():
        setattr(new, k, map_state(v, fn))
    return new


def _device_for(devices, rank: int, world: int) -> torch.device:
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_sdr_mesh: no CUDA device is available; pass devices='cpu' to "
                "put every rank on the CPU"
            )
        local = int(os.environ.get("LOCAL_RANK", rank))
        return torch.device("cuda", local % torch.cuda.device_count())
    if isinstance(devices, (str, torch.device)):
        return torch.device(devices)
    devices = list(devices)
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks: give one per rank")
    return torch.device(devices[rank])


def make_sdr_mesh(channel: int | None = None, time: int | None = None, devices=None) -> SdrMesh:
    """Build a (channel, time) mesh over the ranks of the default process
    group (one rank with none).

    Defaults as in the reference: every rank on the time axis; pass
    ``channel`` to split. channel*time may not exceed the rank count;
    ranks past it sit outside the sub-mesh. ``devices``: None puts each
    rank on its CUDA device (``LOCAL_RANK`` modulo the device count); a
    device (e.g. "cpu", or "cuda:0" for several ranks on one card) puts
    every rank there; a sequence gives rank r ``devices[r]``. Every rank
    calls this together: it creates the axes' process groups.
    """
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    n = world
    if channel is None and time is None:
        channel, time = 1, n
    elif channel is None:
        channel = n // time
    elif time is None:
        time = n // channel
    if channel < 1 or time < 1:
        raise ValueError(f"channel and time must be >= 1; got {channel}, {time}")
    if channel * time > n:
        raise ValueError(f"channel*time = {channel}*{time} > {n} ranks")
    device = _device_for(devices, rank, world)
    if not initialized:
        return SdrMesh(channel, time, device)

    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    backend = dist.get_backend()
    mesh_type = "cuda" if backend == "nccl" else "cpu"
    names = AXES
    if channel * time == world:
        dm = init_device_mesh(mesh_type, (channel, time), mesh_dim_names=names)
    else:
        dm = DeviceMesh(mesh_type, torch.arange(channel * time).reshape(channel, time),
                        mesh_dim_names=names)
    coords = dm.get_coordinate()
    if coords is None:
        return SdrMesh(channel, time, device, dm, coords=None)
    ci, ti = coords
    ranks = (tuple(ci2 * time + ti for ci2 in range(channel)),
             tuple(ci * time + t2 for t2 in range(time)))
    groups = (dm.get_group("channel"), dm.get_group("time"))
    return SdrMesh(channel, time, device, dm, (ci, ti), groups, ranks, backend)
