"""A cell cut to a size that a CPU test run holds: four channels, two
frames a chunk (one in an open loop, sent at a fifth of real time), a ring
of three chunks, two compared chunks of every channel. The frame length,
the designs' kind and the traffic's loop, entry and mode stay.

``benchmark()`` is BENCHMARK.json with the cell it leaves out for now,
``bank64.custom.rt`` (its files are here; PERF.md says why it is out), so
that the tests drive the open loop and the analyzer entry too.

``sharded()`` is a multi-rank cell kept out of BENCHMARK.json: the pod's
intended size over four ranks, for the tests of the multi-rank path."""

import dataclasses

from sdrbench import spec

KEPT_OUT = {"name": "bank64.custom.rt", "config": "bank64", "traffic": "custom.rt", "chips": 1,
            "why": "open loop at 1 MSPS a channel through SpectrumAnalyzer"}
KEPT_OUT_E2E = [{"name": "latency_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
                 "source": "host_clock", "workloads": ["bank64.custom.rt"]}]
KEPT_OUT_PER_LAYER = [
    {"name": name, "unit": unit, "better": "lower", "source": "device_trace",
     "layer": "analyzer facade (control/api.py)", "moves": "latency_p95_ms",
     "workloads": ["bank64.custom.rt"]}
    for name, unit in (("device_ops_per_chunk.rt", "ops/chunk"), ("d2h_copy_ms.rt", "ms/chunk"))]


def benchmark() -> dict:
    bench = spec.load_benchmark()
    if any(w["name"] == KEPT_OUT["name"] for w in bench["workloads"]):
        return bench
    bench["workloads"].append(KEPT_OUT)
    bench["end_to_end"] += KEPT_OUT_E2E
    bench["per_layer"] += KEPT_OUT_PER_LAYER
    return bench


SHARDED = "bank128.sharded.x4"


def sharded() -> spec.Cell:
    """``bank64.custom.sat``'s designs, traffic, limits and metrics on 128
    channels over a (channel 2, time 2) mesh of four ranks through
    ``entries/sharded.py``: chunks of 128 channels x 32 frames (67.1 M
    samples, 268 MB), so each rank's block is bank64's chunk of 64 x 16;
    a ring of 4, every channel compared."""
    base = spec.find_cell(spec.load_benchmark(), "bank64.custom.sat")
    config = dict(base.config, channels=128, mesh={"channel": 2, "time": 2})
    traffic = dict(base.traffic, entry="sharded", frames_per_chunk=32,
                   check=dict(base.traffic["check"], channels=128))
    return dataclasses.replace(base, name=SHARDED, chips=4, config=config, traffic=traffic)


def shrink(cell: spec.Cell, channels: int = 4) -> spec.Cell:
    cell.config["channels"] = channels
    t = cell.traffic
    t["frames_per_chunk"] = 2 if t["loop"] == "closed" else 1
    t["ring_chunks"] = 3
    t["check"] = {"chunks": 2, "channels": channels}
    t["trace_chunks"] = 2
    if t["loop"] == "open":
        t["rate_x_realtime"] = 0.2
    return cell
