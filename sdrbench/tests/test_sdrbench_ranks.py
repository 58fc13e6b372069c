"""The multi-rank path (``ranks.py``, ``run.run_ranked``, ``entries/sharded.py``).

The kept-out cell ``tiny.sharded()``, cut by ``tiny.shrink``, runs over four
Gloo ranks on the CPU through the function that ``python3 -m sdrbench.run``
calls for a multi-rank cell. Rank 0 ends its own process when another rank
dies, so it runs as a command (``sdrbench/tests/ranked.py``), each under a
time limit of its own. On a machine with four cards, the same cell runs at
the pod's intended size over NCCL.
"""

import json
import os
import pickle
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from sdrbench import inputs, loops, ranks, spec
from sdrbench.tests import tiny

# Each command's own time limit: four ranks import torch, join, run a 1 s
# window and are checked in about 25 s here.
LIMIT_S = 200.0
SEED = 2**31 + 19


def _ranked(out, *args, limit=LIMIT_S):
    return subprocess.run([sys.executable, "-m", "sdrbench.tests.ranked", "--out", str(out), *args],
                          cwd=spec.ROOT, capture_output=True, text=True, timeout=limit)


def _result(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _left_behind(stderr: str) -> list:
    """The ranks that rank 0 started and that still run, and its run
    directory if it is still there."""
    started = re.search(r"started ranks \S+ in (\S+): pids \[([^\]]*)\]", stderr)
    pids = [int(p) for p in re.findall(r"\d+", started.group(2))]
    alive = [started.group(1)] if os.path.exists(started.group(1)) else []
    for pid in pids:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if b"sdrbench.ranks" in f.read():
                    alive.append(pid)
        except OSError:
            pass
    return alive


# ------------------------------------------------------------ the clock


class _Mark:
    def wait(self):
        pass


def test_the_other_ranks_replay_rank_0s_clock(tmp_path):
    """Rank 0's closed loop on the real clock and another rank's on the
    replayed one send the same chunks, keep the same ones and end alike,
    though the other rank's dispatch takes no time."""
    job = {"world": 2, "device": "cpu", "runs": []}
    leader = ranks.Group(str(tmp_path), 0, job)
    other = ranks.Group(str(tmp_path), 1, job)
    sent = {0: [], 1: []}
    got = {}

    def follow():
        got[1] = loops.closed_loop(lambda k: sent[1].append(k) or k, 0.2, in_flight=2,
                                   samples_per_chunk=1, mark=_Mark, fractions=[0.3, 0.6],
                                   clock=other.clock)

    t = threading.Thread(target=follow)
    t.start()
    got[0] = loops.closed_loop(lambda k: time.sleep(2e-3) or sent[0].append(k) or k, 0.2,
                               in_flight=2, samples_per_chunk=1, mark=_Mark, fractions=[0.3, 0.6],
                               clock=leader.clock)
    t.join(timeout=30)
    assert not t.is_alive()
    assert got[0].chunks == got[1].chunks >= 5 and sent[0] == sent[1]
    assert got[0].kept == got[1].kept and len(got[0].kept) == 3
    assert (got[0].t0, got[0].t_end) == (got[1].t0, got[1].t_end)


# ------------------------------------------------------------ four Gloo ranks


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    out = tmp_path_factory.mktemp("sound")
    proc = _ranked(out, "--tiny", "--seed", str(SEED), "--keep")
    with open(out / "outputs.pkl", "rb") as f:
        compared = pickle.load(f)
    return proc, compared


def test_a_sharded_cell_over_four_gloo_ranks_is_correct(sound):
    proc, _ = sound
    result = _result(proc)
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert result["device"]["count"] == 4 and result["attempted"] >= 2
    assert set(result["metrics"]) == {"msps", "setup_s"}
    assert "ranks joined" in proc.stderr and "barrier" in proc.stderr
    assert not _left_behind(proc.stderr)


def _equal_to_one_device(cell: spec.Cell, compared: dict, device: str):
    """The single-device entry (``entries/pipeline.py``) on the same seed's
    designs and ring, chunk after chunk to the window's last: the compared
    chunks' magnitudes, the carried state and the frame counter equal what
    the ranks handed the comparison, bit for bit."""
    cfg, traffic = cell.config, dict(cell.traffic, entry="pipeline")
    ring = inputs.make_ring(cfg, traffic, SEED, device)
    _, channels = inputs.check_sample(traffic, cfg["channels"], SEED)
    entry = spec.load_module("entries", "pipeline").build(
        cfg, traffic, inputs.make_designs(cfg, SEED), device)
    assert max(compared["outputs"]) == compared["last"]
    for k in range(compared["last"] + 1):
        out = entry.dispatch(ring[k % ring.shape[0]])
        if k in compared["outputs"]:
            np.testing.assert_array_equal(compared["outputs"][k], entry.to_host(out, channels))
    np.testing.assert_array_equal(compared["state"], entry.iir_state(channels))
    assert compared["frames_counted"] == entry.frames_counted()


def test_its_gathered_outputs_and_state_equal_one_device_bit_for_bit(sound):
    _equal_to_one_device(tiny.shrink(tiny.sharded()), sound[1], "cpu")


def test_one_ranks_block_altered_is_not_correct(tmp_path):
    """Rank 0's own block of magnitudes, one bin of every frame moved by a
    hundredth of the frame's peak where the port produces it."""
    result = _result(_ranked(tmp_path, "--tiny", "--fault", "answer_altered"))
    assert not result["correct"] and result["failed"] >= 1, result["checks"]


def test_a_rank_killed_in_the_window_ends_the_run(tmp_path):
    """Rank 2 killed half a second into a 20 s window: rank 0 exits non-zero
    with no result line, well inside the collective timeout, and leaves no
    rank and no run directory behind."""
    t = time.time()
    proc = _ranked(tmp_path, "--tiny", "--seconds", "20", "--kill-rank", "2")
    assert proc.returncode != 0
    assert time.time() - t < ranks.COLLECTIVE_TIMEOUT_S
    assert not [line for line in proc.stdout.splitlines() if line.startswith("{")]
    assert not _left_behind(proc.stderr)


def test_calibrate_makes_its_runs_over_ranks_started_once(tmp_path):
    """A program run, a control run and a run of the port's TF32 (which the
    sharded pipeline's own precision check must let through), one after the
    other over the same four ranks: the program is correct, the control is
    not. (On the CPU TF32 changes nothing.)"""
    runs = [(SEED, "program"), (SEED + 1, "control"), (SEED + 2, "program_tf32")]
    proc = _ranked(tmp_path, "--tiny", "--calibrate", *(f"{s}:{k}" for s, k in runs))
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert [(r["seed"], r["kind"]) for r in lines] == runs
    assert lines[0]["correct"] and not lines[1]["correct"]
    assert proc.stderr.count("started ranks") == 1 and not _left_behind(proc.stderr)


# ------------------------------------------------------------ four cards


@pytest.fixture
def four_cards():
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")


@pytest.mark.cuda
def test_the_pod_size_over_nccl(four_cards, tmp_path):
    """The kept-out cell at its own size (128 channels x 32 frames a chunk,
    64 x 16 a rank) over NCCL on four cards, a 5 s window, untraced and
    traced: correct under bank64's limits, one result line of four devices,
    no rank left, NCCL's kernels in the traced breakdown; the gathered
    magnitudes and state equal one card's run of the same seed."""
    for trace in (0, 1):
        proc = _ranked(tmp_path, "--device", "cuda", "--seconds", "5", "--trace", str(trace),
                       *(["--keep"] if trace else []), limit=360)
        result = _result(proc)
        assert result["correct"] and result["failed"] == 0, result["checks"]
        assert result["device"]["count"] == 4 and result["device"]["platform"] == "gpu"
        assert not _left_behind(proc.stderr)
        if trace:
            assert result["device"]["busy_s"] > 0 and result["device"]["window_s"] > 0
            assert any("nccl" in name.lower() for name, _ in result["breakdown"]["device_ops"])
    with open(tmp_path / "outputs.pkl", "rb") as f:
        _equal_to_one_device(tiny.sharded(), pickle.load(f), "cuda")
