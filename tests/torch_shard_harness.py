"""Run the sharded engines' cases in a group of spawned ranks (Gloo on the
CPU; on the card, Gloo or NCCL).

``run_group(tmp_path, "module", world)`` spawns ``world`` processes with
the ``spawn`` start method. Each one brings its process group up through
``tpu_sdr_torch.shard.distributed.initialize`` on a ``file://`` rendezvous
under ``tmp_path`` (no TCP port is picked), sets one torch thread, imports
``module`` (a case module: ``tpu_sdr_torch``, numpy and scipy only, never
JAX) and calls each function of its ``CASES`` list (or the list named by
``cases``) in order, on every rank together. A case returns a dict of results on rank 0 (the other ranks'
returns are dropped). Rank 0 pickles {case name: result} to a file the
parent reads back.

Nothing can hang: the process group's collectives time out after
``COLLECTIVE_TIMEOUT_S``, a rank that raises writes its traceback and exits
non-zero (the parent then stops the others), and the parent kills every rank
once no case has finished for ``STALL_S`` seconds. A case that did not
finish is missing from the results; the tests report the ranks' errors.
"""

from __future__ import annotations

import importlib
import multiprocessing
import os
import pickle
import sys
import time
import traceback
from pathlib import Path

COLLECTIVE_TIMEOUT_S = 60.0
STALL_S = 120.0


def _rank_main(rank: int, world: int, module: str, tmp: str, env: dict, backend: str,
               cases_name: str):
    os.environ.update(env)
    # Batch work: yield the CPU to the test workers beside the group, whose
    # tests (the GUI's HTTP round trips) wait on wall-clock limits.
    os.nice(10)
    out = Path(tmp)
    try:
        import torch

        torch.set_num_threads(1)
        from tpu_sdr_torch.shard import distributed

        distributed.initialize(
            coordinator_address=f"file://{out / 'rendezvous'}", num_processes=world,
            process_id=rank, backend=backend, timeout_s=COLLECTIVE_TIMEOUT_S,
        )
        cases = importlib.import_module(module)
        results = {}
        for fn in getattr(cases, cases_name):
            results[fn.__name__] = fn()
            if rank == 0:  # after each case, so a later failure keeps them
                (out / "results.tmp").write_bytes(pickle.dumps(results))
                (out / "results.tmp").replace(out / "results.pkl")
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "tpu_sdr")]
        if bad:
            raise RuntimeError(f"a rank imported {bad[:5]}")
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)


def run_group(tmp_path, module: str, world: int, env: dict | None = None, backend: str = "gloo",
              cases: str = "CASES") -> tuple[dict, str]:
    """Run the functions listed in ``module``'s ``cases`` attribute on
    ``world`` ranks of a ``backend`` group. Returns (results by case name,
    the ranks' errors as text, empty when every rank finished)."""
    tmp = Path(tmp_path)
    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(target=_rank_main, args=(r, world, module, str(tmp), env or {}, backend, cases),
                    daemon=True)
        for r in range(world)
    ]
    for p in procs:
        p.start()
    progress, last, failed = tmp / "results.pkl", time.monotonic(), False
    seen = None
    try:
        while any(p.is_alive() for p in procs):
            now = time.monotonic()
            done = progress.stat().st_mtime_ns if progress.exists() else None
            if done != seen:
                seen, last = done, now
            if any(p.exitcode not in (None, 0) for p in procs):
                failed = True
                break
            if now - last > STALL_S:
                failed = True
                break
            time.sleep(0.2)
    finally:
        if failed:
            time.sleep(2.0)  # let a failing rank's peers write their errors
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    errors = "\n".join(
        f"rank {r}: {(tmp / f'rank{r}.err').read_text()}"
        for r in range(world) if (tmp / f"rank{r}.err").exists()
    )
    if failed and not errors:
        errors = f"the ranks made no progress for {STALL_S} s; killed"
    results = pickle.loads((tmp / "results.pkl").read_bytes()) if (tmp / "results.pkl").exists() else {}
    return results, errors
