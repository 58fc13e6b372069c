"""Rank 0 of the pod cell, ``pod_bank.custom.x4``, as a command: ``ranked.py``
with the pod in place of its multi-rank cell, and all its options.

    python -m sdrbench.tests.pod [--full] --out DIR [ranked.py's options]

Without ``--full`` the cell is cut to 8 channels x 4 frames a chunk (2 x 2
frames a rank on its (channel 2, time 2) mesh), a ring of three chunks and
every channel compared; the configuration's designs, guarantees and limits,
and the traffic's loop, entry and mode stay. With ``--full`` it runs as
``BENCHMARK.json`` gives it.
"""

from __future__ import annotations

import sys

from sdrbench import spec
from sdrbench.tests import ranked, tiny

NAME = "pod_bank.custom.x4"


def cell(full: bool = False) -> spec.Cell:
    """The pod cell, cut to a CPU test's size unless ``full``."""
    c = spec.find_cell(spec.load_benchmark(), NAME)
    if not full:
        c.config["channels"] = 8
        c.traffic.update(frames_per_chunk=4, ring_chunks=3, trace_chunks=2,
                         check={"chunks": 3, "channels": 8})
    return c


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    full = "--full" in argv
    tiny.sharded = lambda: cell(full)
    return ranked.main([a for a in argv if a != "--full"])


if __name__ == "__main__":
    sys.exit(main())
