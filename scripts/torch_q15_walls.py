"""The Q15 paths' host walls of two source trees, in turns.

    python3 scripts/torch_q15_walls.py [OTHER_ROOT] [--turns K]

Runs ``chip_smoke.py``'s Q15 wall measurements (``q15_walls``: the split
filtered, split bypass and all-device dispatch walls per 16384-sample
chunk, two turns; ``q15_stream_rates``: the split path's halves alone and
side by side, then ``Q15Stream`` at depth 1 against sequential
``process()`` calls, two turns each) on the Q15 pipelines of this
checkout's package and of OTHER_ROOT's (another checkout, for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists), each in a process of its own, K times in the order
other, this, this, other (default K = 1). The measuring code is this
checkout's for both trees; only the package differs. Ends with each
tree's readings over all its processes: min, median and max. Without
OTHER_ROOT, this checkout alone, K processes. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def child(root: Path) -> None:
    """One process: the pipelines of root's package, this checkout's
    chip_smoke measurements. Prints their readings as a last JSON line."""
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from tpu_sdr_torch import PipelineConfig
    from tpu_sdr_torch.runtime.q15 import Q15Pipeline

    cfg = PipelineConfig(channels=1)
    pipes = {"all-device": Q15Pipeline(cfg), "split": Q15Pipeline(cfg, device_fft=True)}
    for p in pipes.values():
        p.upload_sos_q(smoke.Q15_SOS_Q)
    walls, _ = smoke.q15_walls(pipes)
    readings = {label: [s * 1e3 for s in v] for label, v in walls.items()}
    readings.update({f"{k} MSPS": v for k, v in smoke.q15_stream_rates(pipes["split"]).items()})
    print(json.dumps(readings), flush=True)


def main(argv: list[str]) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?", type=Path)
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child.resolve())
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    order = ["other", "this", "this", "other"] if args.other else ["this"]
    roots = {"this": REPO, "other": args.other.resolve() if args.other else None}
    readings = {}
    for turn in range(args.turns):
        for tag in order:
            print(f"== turn {turn}, {tag} ({roots[tag]})", flush=True)
            out = subprocess.run([sys.executable, __file__, "--child", str(roots[tag])],
                                 capture_output=True, text=True, cwd=roots[tag])
            sys.stdout.write(out.stdout)
            if out.returncode:
                raise SystemExit(f"{tag}: exited {out.returncode}\n{out.stderr[-4000:]}")
            for label, v in json.loads(out.stdout.strip().splitlines()[-1]).items():
                readings.setdefault(tag, {}).setdefault(label, []).extend(v)
    for tag, by_label in readings.items():
        for label, v in by_label.items():
            unit = "" if label.endswith("MSPS") else " ms"
            print(f"{tag:5s} {label:22s} over {len(v)}: min {min(v):.4f}, median "
                  f"{statistics.median(v):.4f}, max {max(v):.4f}{unit}")


if __name__ == "__main__":
    main(sys.argv[1:])
