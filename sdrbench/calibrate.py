"""The readings that a cell's limits are set from, in one process.

    python3 -m sdrbench.calibrate --workload <cell> --seconds <s> \
        --seeds <n> ... [--control-seeds <n> ...] [--tf32-seeds <n> ...] \
        [--bf16-seeds <n> ...] [--out <file.jsonl>]

Runs the cell (on the card) once for each seed as the benchmark does, at the
cell's own sizes and load with a window of ``--seconds``, and prints each
run's compared numbers (the lower reading is the largest over the seeds).
Then the controls, once a seed each, whose smallest readings are the upper
ones:

- ``--control-seeds``: the reference computed with TF32 operands in float32,
  the precision just below the configuration's, in the system's place;
- ``--tf32-seeds``: the system itself with its matrix products in TF32
  (PyTorch's TF32 switch on, and the port's check that refuses it passed
  over for the run);
- ``--bf16-seeds``: the system's own bf16 tier with ``bf16_io``.

Each reading is one JSON line, on standard output and in ``--out``. A cell
with ``chips`` > 1 starts its ranks once (``ranks.py``) and makes every run
over them in turn.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

from sdrbench import run, spec


@contextlib.contextmanager
def program_tf32():
    """The port's matrix products in TF32, for the length of the block: the
    check that refuses TF32 is passed over where the single-device and the
    sharded pipeline call it."""
    import torch
    from tpu_sdr_torch.runtime import stream
    from tpu_sdr_torch.shard import pipeline as sharded

    check, before = stream.check_matmul_precision, torch.backends.cuda.matmul.allow_tf32
    stream.check_matmul_precision = sharded.check_matmul_precision = lambda expected: None
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        stream.check_matmul_precision = sharded.check_matmul_precision = check
        torch.backends.cuda.matmul.allow_tf32 = before


def setting(kind: str):
    """What a run of ``kind`` runs under: the port's TF32 for
    ``program_tf32``, nothing else for the others."""
    return program_tf32() if kind == "program_tf32" else contextlib.nullcontext()


def for_kind(cell: spec.Cell, kind: str) -> spec.Cell:
    """The cell as a run of ``kind`` runs it: ``program_bf16`` on the bf16
    tier with ``bf16_io``."""
    if kind == "program_bf16":
        cell = dataclasses.replace(cell, config=dict(cell.config, tier="bf16", bf16_io=True))
    return cell


def _line(cell: spec.Cell, seed: int, kind: str, result: dict, t: float) -> dict:
    return {"workload": cell.name, "seed": seed, "kind": kind, "checks": result["checks"],
            "correct": result["correct"], "attempted": result["attempted"],
            "metrics": result["metrics"], "device": result["device"], "seconds": time.time() - t}


def one_run(bench: dict, workload: str, seed: int, seconds: float, kind: str) -> dict:
    cell = for_kind(spec.find_cell(bench, workload), kind)
    t = time.time()
    with setting(kind):
        result, _ = run.run_cell(cell, seed, seconds, False, control=kind == "control", t_start=t)
    return _line(cell, seed, kind, result, t)


def ranked_runs(cell: spec.Cell, runs: list[tuple[int, str]], seconds: float,
                device: str = "cuda"):
    """Each (seed, kind) of ``runs`` over ``cell.chips`` ranks started once;
    yields each run's line in turn."""
    from sdrbench import ranks

    jobs = [ranks.job_run(for_kind(cell, kind), seed, seconds, False, kind) for seed, kind in runs]
    group = ranks.start(cell, jobs, device)
    try:
        group.join()
        for job in jobs:
            t = time.time()
            result, _ = ranks.execute(job, group, t_start=t)
            yield _line(cell, job["seed"], job["kind"], result, t)
        group.close()
    finally:
        group.stop()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--tf32-seeds", type=int, nargs="*", default=[])
    p.add_argument("--bf16-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out")
    args = p.parse_args(argv)
    run.set_cache_dirs()
    bench = spec.load_benchmark()
    import torch

    if not torch.cuda.is_available():
        run.log("calibrate needs a CUDA device")
        return 2
    runs = ([(s, "program") for s in args.seeds] + [(s, "control") for s in args.control_seeds]
            + [(s, "program_tf32") for s in args.tf32_seeds]
            + [(s, "program_bf16") for s in args.bf16_seeds])
    cell = spec.find_cell(bench, args.workload)
    if cell.chips > 1:
        lines = ranked_runs(cell, runs, args.seconds)
    else:
        lines = (one_run(bench, args.workload, seed, args.seconds, kind) for seed, kind in runs)
    readings = []
    for line in lines:
        readings.append(line)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    for name in readings[0]["checks"]:
        program = [r["checks"][name]["value"] for r in readings if r["kind"] == "program"]
        run.log(f"{args.workload} {name}: lower reading (largest of {len(program)} program runs) "
                f"{max(program)!r}")
        for kind in ("control", "program_tf32", "program_bf16"):
            upper = [r["checks"][name]["value"] for r in readings
                     if r["kind"] == kind and name in r["checks"]]
            if upper:
                run.log(f"{args.workload} {name}: {kind} (smallest of {len(upper)} runs) {min(upper)!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
