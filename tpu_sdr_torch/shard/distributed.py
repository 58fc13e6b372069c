"""Multi-process initialisation and scaling helpers (the counterpart of
``tpu_sdr.shard.distributed``).

One process drives one device. On several GPUs, one host or many:

    torchrun --nproc-per-node=4 app.py      # app.py:
    import tpu_sdr_torch.shard.distributed as dist
    dist.initialize(auto=True)              # torch.distributed, NCCL
    mesh = dist.pod_mesh(channel=...)       # hosts-outermost axis layout
    pipe = ShardedSpectrumPipeline(cfg, mesh)

Axis placement: the ``channel`` axis never communicates, so it maps to the
outer (cross-host) dimension; the ``time`` axis exchanges only per-frame
12-float summaries and halos, and stays inside a host.
"""

from __future__ import annotations

import datetime
import os
import warnings

import torch
import torch.distributed as dist

from tpu_sdr_torch.shard.mesh import SdrMesh, make_sdr_mesh

# A collective that waits longer than this fails instead of hanging.
DEFAULT_TIMEOUT_S = 300.0


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    auto: bool = False,
    backend: str | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Bring up the default process group (no-op when single-process).

    Three ways in, as in the reference:

    - explicit arguments: ``coordinator_address`` "host:port" (TCP) or an
      init URL such as "file:///shared/rendezvous", the process count and
      this process's id;
    - the ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
      ``JAX_PROCESS_ID`` env triple, read here for any argument not given;
    - ``auto=True`` under ``torchrun``: its ``MASTER_ADDR``/``MASTER_PORT``,
      ``WORLD_SIZE`` and ``RANK`` (``init_method="env://"``).

    ``backend``: None picks "nccl" when CUDA is available and "gloo"
    otherwise; several ranks sharing one card need "gloo" (NCCL refuses
    two ranks on one GPU). Returns True when a group was created.
    """
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if auto:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
        return True
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if num_processes <= 1 and coordinator_address is None:
        return False  # single process: nothing to do
    if coordinator_address is None or process_id is None:
        raise ValueError(
            "a multi-process group needs a coordinator address and this process's id"
        )
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend, init_method=url, world_size=num_processes, rank=process_id, timeout=timeout
    )
    return True


def pod_mesh(channel: int | None = None, time: int | None = None, devices=None) -> SdrMesh:
    """The (channel, time) mesh over all ranks, hosts-outermost.

    Ranks are numbered host-major (torchrun gives each host a contiguous
    block of ``LOCAL_WORLD_SIZE`` ranks), so a channel axis that is a
    multiple of the hosts keeps the chatty time axis inside each host.
    """
    n = dist.get_world_size() if dist.is_initialized() else 1
    n_hosts = max(n // int(os.environ.get("LOCAL_WORLD_SIZE", n)), 1)
    if channel is None and time is None:
        channel, time = n_hosts, n // n_hosts
    elif channel is None:
        channel = n // time
    elif time is None:
        time = n // channel
    if channel * time != n:
        raise ValueError(f"channel*time = {channel}*{time} != {n} ranks")
    if n_hosts > 1 and channel % n_hosts:
        warnings.warn(
            f"channel axis ({channel}) is not a multiple of hosts ({n_hosts}); the "
            "time axis will cross hosts, hurting the state-exchange latency",
            stacklevel=2,
        )
    return make_sdr_mesh(channel, time, devices)


def scaling_efficiency(rates_per_n: dict[int, float]) -> dict[int, float]:
    """samples/s at n devices -> efficiency vs linear scaling from n=1."""
    if 1 not in rates_per_n:
        raise ValueError("need the n=1 baseline rate")
    base = rates_per_n[1]
    return {n: rates_per_n[n] / (base * n) for n in sorted(rates_per_n)}
