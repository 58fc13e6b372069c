"""Rank 0 of ``tiny.sharded()`` as a command, for the tests of the
multi-rank path: rank 0 ends its own process when another rank dies, so a
test starts it as a command and reads what it leaves.

    python -m sdrbench.tests.ranked --out DIR [--tiny] [--device cpu|cuda]
        [--seed N] [--seconds S] [--trace 0|1] [--keep] [--fault answer_altered]
        [--kill-rank R] [--calibrate SEED:KIND ...]

It runs ``run.run_ranked``, the function that ``python3 -m sdrbench.run``
calls for a multi-rank cell, and prints the check lines and the result line
as that does, exiting with its code. With ``--keep``, ``DIR/outputs.pkl``
gets what rank 0 handed the comparison (the compared chunks' gathered
magnitudes, 268 MB a chunk at the pod's size, the state, the frame counter,
the last chunk); with ``--trace 1``, ``DIR/trace.json`` is rank 0's profiler
trace. ``--fault answer_altered``: rank 0's own block of magnitudes has one
bin of every frame moved by a hundredth of the frame's peak where the port
produces it.
``--kill-rank R``: rank R is killed half a second into the window.
``--calibrate``: ``calibrate.ranked_runs`` over the given runs instead, a
reading a line.
"""

from __future__ import annotations

import argparse
import json
import pickle
import shutil
import sys
import threading
from pathlib import Path

from sdrbench import calibrate, check, loops, ranks, run
from sdrbench import trace as tracing
from sdrbench.tests import tiny


def answer_altered(original, *a, **k):
    out, state = original(*a, **k)
    mag = out["magnitude"].clone()
    mag[..., 1] += 0.01 * mag.amax(dim=-1)
    return {"magnitude": mag}, state


def _break_rank0(fault):
    from tpu_sdr_torch.runtime import stream

    original = stream.process_stream
    stream.process_stream = lambda *a, **k: fault(original, *a, **k)
    # the sharded pipeline imported the name itself
    from tpu_sdr_torch.shard import pipeline

    pipeline.process_stream = stream.process_stream


def _save_compared(out: Path):
    compare = check.compare

    def saving(outputs, stream, sos_bank, complex_input, *, last, state=None, frames_counted=None,
               control=False):
        with open(out / "outputs.pkl", "wb") as f:
            pickle.dump({"outputs": outputs, "state": state, "frames_counted": frames_counted,
                         "last": last}, f)
        return compare(outputs, stream, sos_bank, complex_input, last=last, state=state,
                       frames_counted=frames_counted, control=control)

    check.compare = saving


def _save_trace(out: Path):
    parse = tracing.parse

    def saving(path, *a, **k):
        shutil.copy(path, out / "trace.json")
        return parse(path, *a, **k)

    tracing.parse = saving


def _kill_in_window(rank: int, seconds: float):
    """Kill ``rank`` half a second after rank 0's window starts."""
    start, closed = ranks.start, loops.closed_loop
    group = {}

    def starting(*a, **k):
        group["leader"] = start(*a, **k)
        return group["leader"]

    def looping(dispatch, window_s, **k):
        if window_s == seconds:
            threading.Timer(0.5, lambda: group["leader"].procs[rank - 1].kill()).start()
        return closed(dispatch, window_s, **k)

    ranks.start, loops.closed_loop = starting, looping


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cpu")
    p.add_argument("--seed", type=int, default=2**31 + 19)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--keep", action="store_true")
    p.add_argument("--fault")
    p.add_argument("--kill-rank", type=int)
    p.add_argument("--calibrate", nargs="*")
    args = p.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    run.set_cache_dirs()
    cell = tiny.sharded()
    if args.tiny:
        cell = tiny.shrink(cell)
    if args.calibrate:
        runs = [(int(seed), kind) for seed, kind in (r.split(":") for r in args.calibrate)]
        for line in calibrate.ranked_runs(cell, runs, args.seconds, args.device):
            print(json.dumps(line), flush=True)
        return 0
    if args.keep:
        _save_compared(out)
    if args.trace:
        _save_trace(out)
    if args.fault:
        _break_rank0(globals()[args.fault])
    if args.kill_rank:
        _kill_in_window(args.kill_rank, args.seconds)
    code, result, lines = run.run_ranked(cell, args.seed, args.seconds, bool(args.trace),
                                         device=args.device)
    if code:
        return code
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
