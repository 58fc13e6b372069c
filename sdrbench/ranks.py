"""Run a cell over several cards: one process a card, in lockstep with rank 0.

Rank 0 is the process that was started (``python3 -m sdrbench.run`` or
``sdrbench.calibrate``). ``start`` writes the job, every run that rank 0
will make with its cell, into a directory of its own under
``build/sdrbench/ranks/``, and starts ranks 1 .. n-1 as

    python -m sdrbench.ranks <that directory> <rank> <rank 0's pid>

Each binds ``cuda:<rank>`` (or the CPU) and every rank joins one process
group through ``tpu_sdr_torch.shard.distributed.initialize`` on a
``file://`` rendezvous in that directory (NCCL on cards, Gloo on the CPU),
its collectives timing out after ``COLLECTIVE_TIMEOUT_S``. Then every rank
makes the job's runs in the same order (``execute``, ``run.run_cell``).

Lockstep. A run's statements are the same on every rank and depend only on
the job, save the loops' clock readings, from which follow when a window
ends and which chunks it keeps. Rank 0's loops read the clock through
``Group.clock``, which stores each reading in a ring in a file that all
ranks map (two stores to memory: no system call, collective or device
synchronisation); the other ranks' loops take the same readings in the same
order from that ring, waiting for each, and do not sleep. So they send the
same chunks, keep the same ones and call the same collectives. Each run
starts with one reading (``start_run``), which holds the other ranks until
rank 0 has finished the run before.

Ends. Rank 0 watches the others: a rank that ends with a code other than 0
before ``close`` makes it stop the rest, remove the directory and exit with
``RANK_DIED`` at once, wherever its main thread waits (so rank 0 is never a
test's own process: the tests start it as a command). A rank other than 0 ends when
rank 0 does (a parent-death signal, and a thread that watches rank 0's pid).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import traceback
import uuid

import numpy as np

from sdrbench import spec

# A collective that waits longer than this fails: well inside a run's limit.
COLLECTIVE_TIMEOUT_S = 120.0
# How long rank 0 waits for the others to exit once the last run is done.
EXIT_WAIT_S = 60.0
# Rank 0's exit code when another rank ended before the run did.
RANK_DIED = 4
# Clock readings held in the ring: the other ranks lag rank 0 by a few.
RING = 1 << 16
WATCH_S = 0.5


def log(*parts):
    print("sdrbench ranks:", *parts, file=sys.stderr, flush=True)


def job_run(cell: spec.Cell, seed: int, seconds: float, trace: bool, kind: str = "program") -> dict:
    """One run of a job: the cell as rank 0 runs it, and how."""
    return {"cell": dataclasses.asdict(cell), "seed": seed, "seconds": seconds, "trace": trace,
            "kind": kind}


def execute(run_: dict, group, **kwargs):
    """Make one run of the job on this rank: ``run.run_cell`` under the
    run's kind (``calibrate.setting``). Returns what run_cell returns."""
    from sdrbench import calibrate, run

    kind = run_["kind"]
    with calibrate.setting(kind):
        return run.run_cell(spec.Cell(**run_["cell"]), run_["seed"], run_["seconds"], run_["trace"],
                            device=group.device, control=kind == "control", ranks=group, **kwargs)


class _Ring:
    """The shared clock ring: slot 0 counts the readings, slot 1 + n % RING
    holds reading n."""

    def __init__(self, path: str, create: bool):
        if create:
            np.zeros(RING + 1).tofile(path)
        self.map = np.memmap(path, dtype=np.float64, mode="r+", shape=(RING + 1,))
        self.count = self.map[:1].view(np.int64)
        self.slots = self.map[1:]
        self.n = 0


class Group:
    """This rank's seat in a multi-rank run: what an entry's ``build`` gets
    as ``ranks`` (``rank``, ``world``, ``group``), the clock its loops read,
    and the collectives the harness itself makes, all outside the window
    (``barrier``, ``report``)."""

    def __init__(self, directory: str, rank: int, job: dict):
        self.dir, self.rank, self.job = directory, rank, job
        self.world = job["world"]
        self.device = "cpu" if job["device"] == "cpu" else f"cuda:{rank}"
        self.group = None
        self.forbidden: set[str] = set()
        self._ring = _Ring(os.path.join(directory, "clock"), create=rank == 0)
        if rank == 0:
            self._ring.slots[:] = 0.0  # fault the pages in before any window

    def join(self):
        """Bind this rank's device and join the process group."""
        import torch
        import torch.distributed as dist
        from tpu_sdr_torch.shard import distributed

        if self.job["device"] != "cpu":
            torch.cuda.set_device(self.rank)
        elif self.rank:
            torch.set_num_threads(1)
        distributed.initialize(
            coordinator_address="file://" + os.path.join(self.dir, "rendezvous"),
            num_processes=self.world, process_id=self.rank,
            backend="gloo" if self.job["device"] == "cpu" else "nccl",
            timeout_s=COLLECTIVE_TIMEOUT_S)
        self.group = dist.group.WORLD

    # -- the clock: rank 0 writes, the others replay

    def clock(self) -> float:
        ring = self._ring
        n = ring.n
        if self.rank == 0:
            t = time.perf_counter()
            ring.slots[n % RING] = t
            ring.count[0] = n + 1
        else:
            spins = 0
            while ring.count[0] <= n:
                spins += 1
                if spins > 100_000:  # rank 0 is outside a loop: poll gently
                    time.sleep(1e-3)
            t = float(ring.slots[n % RING])
            if ring.count[0] - n > RING:
                raise RuntimeError(f"rank {self.rank} fell {RING} clock readings behind rank 0")
        ring.n = n + 1
        return t

    def sleep(self, seconds: float):
        """The loops' sleep: rank 0 sleeps, the others only replay."""
        if self.rank == 0:
            time.sleep(seconds)

    def start_run(self):
        """One clock reading at the start of each run: the other ranks wait
        here, outside any collective, until rank 0 begins it."""
        self.clock()

    # -- the harness's own collectives, outside the window

    def barrier(self):
        import torch.distributed as dist

        dist.barrier(device_ids=None if self.device == "cpu" else [self.rank])

    def report(self, peak_bytes: int, forbidden: list[str]) -> int:
        """Every rank's memory peak and forbidden modules, to every rank;
        returns the largest peak and keeps the modules in ``forbidden``."""
        import torch.distributed as dist

        got = [None] * self.world
        dist.all_gather_object(got, (int(peak_bytes), list(forbidden)))
        for r, (_, bad) in enumerate(got):
            if bad:
                self.forbidden |= {f"{m} (rank {r})" for m in bad}
        return max(peak for peak, _ in got)

    def leave(self):
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


class Leader(Group):
    """Rank 0: starts the others, watches them, and cleans up."""

    def __init__(self, directory: str, job: dict):
        super().__init__(directory, 0, job)
        self.procs: list[subprocess.Popen] = []
        self._closing = threading.Event()

    def spawn(self):
        for r in range(1, self.world):
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "sdrbench.ranks", self.dir, str(r), str(os.getpid())],
                cwd=str(spec.ROOT), stdin=subprocess.DEVNULL, stdout=2))
        log(f"started ranks 1-{self.world - 1} in {self.dir}: pids {[p.pid for p in self.procs]}")
        threading.Thread(target=self._watch, name="sdrbench-ranks", daemon=True).start()

    def _watch(self):
        while not self._closing.wait(WATCH_S):
            for r, p in enumerate(self.procs, 1):
                code = p.poll()
                if code not in (None, 0):
                    log(f"rank {r} ended with code {code} before the run did; stopping the others")
                    self._stop_all()
                    os._exit(RANK_DIED)

    def _stop_all(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            with contextlib.suppress(subprocess.TimeoutExpired):
                p.wait(timeout=EXIT_WAIT_S)
        shutil.rmtree(self.dir, ignore_errors=True)

    def close(self):
        """After the last run: leave the group, wait for every rank to exit,
        and raise unless each exited 0."""
        self._closing.set()
        self.leave()
        deadline = time.time() + EXIT_WAIT_S
        codes = []
        for p in self.procs:
            try:
                codes.append(p.wait(timeout=max(0.1, deadline - time.time())))
            except subprocess.TimeoutExpired:
                codes.append(None)
        if any(c != 0 for c in codes):
            raise RuntimeError(f"ranks 1-{self.world - 1} exited with {codes}")

    def stop(self):
        """Whatever happened: no rank and no directory left behind."""
        self._closing.set()
        self._stop_all()


def start(cell: spec.Cell, runs: list[dict], device: str = "cuda") -> Leader:
    """Rank 0: write the job for ``cell.chips`` ranks and start ranks
    1 .. n-1. ``device``: "cuda" (one card a rank, NCCL) or "cpu" (Gloo)."""
    root = os.path.join(spec.ROOT, "build", "sdrbench", "ranks")
    os.makedirs(root, exist_ok=True)
    directory = os.path.join(root, uuid.uuid4().hex)
    os.mkdir(directory)
    job = {"world": cell.chips, "device": device, "runs": runs}
    with open(os.path.join(directory, "job.json"), "w") as f:
        json.dump(job, f)
    leader = Leader(directory, job)
    try:
        leader.spawn()
    except BaseException:
        leader.stop()
        raise
    return leader


def _end_with(parent: int):
    """End this process when rank 0 ends: the kernel's parent-death signal,
    and a thread that watches the parent's pid (the signal is lost if the
    parent ended before it was set)."""
    with contextlib.suppress(OSError, AttributeError):
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG

    def watch():
        while os.getppid() == parent:
            time.sleep(WATCH_S)
        os._exit(RANK_DIED)

    if os.getppid() != parent:
        os._exit(RANK_DIED)
    threading.Thread(target=watch, name="sdrbench-rank0", daemon=True).start()


def follow(directory: str, rank: int, parent: int) -> int:
    """Rank ``rank`` > 0: join the group and make the job's runs."""
    from sdrbench import run

    _end_with(parent)
    run.set_cache_dirs()
    with open(os.path.join(directory, "job.json")) as f:
        job = json.load(f)
    group = Group(directory, rank, job)
    try:
        group.join()
        for run_ in job["runs"]:
            execute(run_, group)
        group.leave()
    except BaseException:
        log(f"rank {rank}:\n{traceback.format_exc()}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(follow(sys.argv[1], int(sys.argv[2]), int(sys.argv[3])))
