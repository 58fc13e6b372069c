"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m sdrbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's CUDA devices. Set-up
makes the designs and the ring of input chunks from the seed, builds the
system under test through the cell's entry driver, and warms up every shape
the window uses; ``setup_s`` runs from process start to the first timed chunk.
Then the window runs for ``--seconds`` under the traffic mix's loop. With
``--trace 1`` a short profiled stretch runs before the window, and the line
carries the per-layer metrics read from it instead of the end-to-end ones.
After the window the compared outputs are copied to the host, the system is
freed, and the float64 reference judges them (``check.py``). The last line of
standard output is the result; the numbers compared, each beside its limit,
are the last lines of standard error.

A cell with ``chips`` > 1 runs one rank a card (``ranks.py``): this process
is rank 0 and starts the others, every rank builds the same inputs and
system on its own card and runs the same statements, and rank 0 alone runs
the loops' clock, traces, checks and prints the line.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from sdrbench import check, inputs, loops, spec  # noqa: E402
from sdrbench import trace as tracing  # noqa: E402

# Top-level module names that may not be loaded in the process that prints
# the result: the JAX package this system was ported from, and JAX.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_sdr")


@dataclasses.dataclass
class Context:
    """What a metric reader reads: the window, the traced stretch (None in an
    untraced run) and the cell."""

    window: loops.Window
    trace: tracing.TraceView | None
    cell: spec.Cell


def set_cache_dirs(root=spec.ROOT):
    """Kernel caches at fixed paths inside the checkout. The port's own nvcc
    builds go to ``build/tpu_sdr_torch/`` beside its package."""
    cache = os.path.join(root, "build", "sdrbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(*parts):
    print("sdrbench:", *parts, file=sys.stderr, flush=True)


class _Mark:
    """The device's progress at a point of the current stream."""

    def __init__(self):
        import torch

        self.event = torch.cuda.Event()
        self.event.record()

    def wait(self):
        self.event.synchronize()


def period_s(cell: spec.Cell) -> float:
    """An open loop's period: a chunk's frames at the deployment's sample
    rate, sped up ``rate_x_realtime`` times."""
    cfg, traffic = cell.config, cell.traffic
    real = traffic["frames_per_chunk"] * cfg["hop"] / cfg["sample_rate_hz"]
    return real / traffic["rate_x_realtime"]


def _loop(cell: spec.Cell, dispatch, mark, clock=time.perf_counter, sleep=time.sleep):
    """The traffic mix's loop as run(seconds, max_chunks, fractions, span,
    wait_span) -> Window."""
    traffic = cell.traffic
    if traffic["loop"] == "closed":
        def run(seconds, max_chunks=None, fractions=(), span=contextlib.nullcontext,
                wait_span=contextlib.nullcontext):
            return loops.closed_loop(dispatch, seconds, in_flight=traffic["in_flight"],
                                     samples_per_chunk=cell.samples_per_chunk, mark=mark,
                                     fractions=fractions, max_chunks=max_chunks, span=span,
                                     clock=clock)
    elif traffic["loop"] == "open":
        def run(seconds, max_chunks=None, fractions=(), span=contextlib.nullcontext,
                wait_span=contextlib.nullcontext):
            return loops.open_loop(dispatch, seconds, period_s=period_s(cell),
                                   samples_per_chunk=cell.samples_per_chunk,
                                   fractions=fractions, max_chunks=max_chunks, span=span,
                                   wait_span=wait_span, clock=clock, sleep=sleep)
    else:
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    return run


def host_counters() -> dict:
    """This process's CPU time and involuntary context switches, and the
    time the machine's cores were taken by others (steal, all cores), to
    tell the host's load on a window apart from the program's own work."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    counters = {"user_s": ru.ru_utime, "sys_s": ru.ru_stime, "involuntary": ru.ru_nivcsw}
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        counters["steal_s"] = int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return counters


def card_line(device: int = 0) -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read ({e})"


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             control: bool = False, t_start: float = T_START,
             stages: list | None = None, ranks=None) -> tuple[dict | None, list[str]]:
    """Run ``cell`` once. Returns the result line's object and the check
    lines. ``control``: the reference in TF32 stands in for the system's
    outputs in the comparison (the runs that set the limit's upper end).
    ``stages``: (name, time it ended) of the set-up so far, from
    ("start", t_start). ``ranks``: this rank's ``ranks.Group`` in a
    multi-rank run, where the other ranks return (None, []) once they have
    sent rank 0 their memory peak."""
    import torch

    on_cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    stages = list(stages or [("start", t_start)])
    cfg, traffic = cell.config, cell.traffic
    if ranks is not None:
        ranks.start_run()
    designs = inputs.make_designs(cfg, seed)
    ring = inputs.make_ring(cfg, traffic, seed, device)
    sync()
    stages.append(("designs and ring", time.time()))
    module = spec.load_module("entries", traffic["entry"])
    if ranks is None:
        entry = module.build(cfg, traffic, designs, device)
    else:
        entry = module.build(cfg, traffic, designs, device, ranks)
    sync()
    stages.append(("system", time.time()))
    slots = ring.shape[0]

    blocks, clock, sleep = ring, time.perf_counter, time.sleep
    if ranks is not None:
        # Each rank's own blocks, placed once, so that no input crosses
        # between cards in the window; rank 0's clock for every rank.
        blocks = entry.place(ring) if hasattr(entry, "place") else ring
        clock, sleep = ranks.clock, ranks.sleep

    def dispatch(k):
        return entry.dispatch(blocks[k % slots])

    run = _loop(cell, dispatch, _Mark if on_cuda else (lambda: None), clock, sleep)
    fractions, channels = inputs.check_sample(traffic, cfg["channels"], seed)

    # Warm up every shape the window runs, holding as many outputs at once
    # as the window may, so the allocator has their blocks before it starts.
    held = [dispatch(k) for k in range(traffic.get("in_flight", 1) + len(fractions) + 2)]
    sync()
    del held
    entry.reset()
    stages.append(("warm-up", time.time()))

    view = None
    if trace and ranks is not None and ranks.rank:
        # The traced stretch without the profiler, as rank 0 runs it.
        for chunks in (2, traffic["trace_chunks"]):
            run(seconds=1e9, max_chunks=chunks)
            sync()
        entry.reset()
    elif trace:
        record = lambda name: (lambda: torch.profiler.record_function(name))
        view = tracing.capture(
            lambda: run(seconds=1e9, max_chunks=2),
            lambda: run(seconds=1e9, max_chunks=traffic["trace_chunks"],
                        span=record(tracing.CHUNK_RANGE), wait_span=record(tracing.WAIT_RANGE)))
        if view is None:
            raise RuntimeError("the profiler recorded no device op in the traced stretch")
        entry.reset()
        stages.append(("traced stretch", time.time()))

    if ranks is not None:
        ranks.barrier()
        stages.append(("barrier", time.time()))
    t_first = time.time()
    host_before = host_counters()
    window = run(seconds=seconds, fractions=fractions)
    window.setup_s = t_first - t_start
    sync()
    host = {k: v - host_before[k] for k, v in host_counters().items() if k in host_before}
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0

    outputs = {k: entry.to_host(out, channels) for k, out in window.kept.items()}
    window.kept = {}
    custom = traffic["mode"] == "CUSTOM"
    state = entry.iir_state(channels) if custom else None
    frames_counted = entry.frames_counted()
    if ranks is not None:
        peak = ranks.report(peak, forbidden_modules())
        if ranks.rank:
            return None, []
    host_ring = (ring[:, :, channels] if cell.complex_input else ring[:, channels]).cpu().numpy()
    del entry, ring, blocks
    if on_cuda:
        torch.cuda.empty_cache()

    t_check = time.time()
    last = window.chunks - 1
    verdict = check.compare(outputs, check.Stream(host_ring, cfg["fft_size"], traffic["frames_per_chunk"]),
                            designs[channels] if custom else None, cell.complex_input, last=last,
                            state=state, frames_counted=frames_counted, control=control)
    per_chunk, per_chunk_ch = verdict.pop("per_chunk"), verdict.pop("per_chunk_ch")
    over = {name for name, value in verdict.items() if not value <= cell.limits[name]}
    wrong = {k for k, err in per_chunk.items() if err > cell.limits["mag_err"]}
    if "mag_err_ch" in verdict:
        wrong |= {k for k, err in per_chunk_ch.items() if err > cell.limits["mag_err_ch"]}
    if over - {"mag_err", "mag_err_ch"}:
        wrong.add(last)

    ctx = Context(window, view, cell)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    log(f"{cell.name} seed {seed}: setup {window.setup_s:.3f} s ("
        + ", ".join(f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(stages, stages[1:]))
        + f"), window {window.seconds:.3f} s, {window.chunks} chunks of {cell.samples_per_chunk} samples")
    log("host in the window: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                         for k, v in host.items())
        + (f", waiting on the device {window.wait_s:.3f} s" if window.kind == "closed" else ""))
    if window.kind == "open":
        lat = np.array(window.latencies_s) * 1e3
        late = np.array(window.lateness_s) * 1e3
        log(f"latency from due time: median {statistics.median(lat):.4f} ms, p95 "
            f"{np.percentile(lat, 95):.4f} ms, max {lat.max():.4f} ms over {lat.size} chunks; "
            f"generator lateness: median {statistics.median(late):.4f} ms, p95 "
            f"{np.percentile(late, 95):.4f} ms, max {late.max():.4f} ms")
    if on_cuda:
        log(f"card: {card_line()}")
    if view is not None:
        log(f"traced {view.n_chunks} chunks: window {view.window_s:.6f} s, busy {view.busy_s:.6f} s, "
            f"{view.unattributed} device ops outside a chunk")
    log(f"compared chunks {sorted(per_chunk)} x {len(channels)} channels in "
        f"{time.time() - t_check:.2f} s; per chunk mag_err "
        + ", ".join(f"{k}: {e:.3e}" for k, e in sorted(per_chunk.items())))

    result = {
        "correct": not over,
        "attempted": window.chunks,
        "failed": len(wrong),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(peak),
        },
    }
    if view is not None:
        result["device"]["busy_s"] = view.busy_s
        result["device"]["window_s"] = view.window_s
        result["breakdown"] = view.breakdown()
    result["checks"] = {name: {"value": value, "limit": cell.limits[name]}
                        for name, value in verdict.items()}
    return result, [f"check {name} {value!r} limit {cell.limits[name]!r}"
                    for name, value in verdict.items()]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_ranked(cell: spec.Cell, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
               stages: list | None = None):
    """Run a cell of ``cell.chips`` ranks from this process, rank 0. Returns
    (exit code, the result line's object, the check lines): 2 where the
    cell's devices are not found, 3 where a rank has a forbidden module
    loaded; the result only with 0. ``device``: "cuda" (one card a rank)
    or "cpu" (every rank on the CPU, Gloo)."""
    from sdrbench import ranks

    stages = list(stages or [("start", T_START)])
    job = ranks.job_run(cell, seed, seconds, trace)
    group = ranks.start(cell, [job], device)
    try:
        stages.append(("ranks started", time.time()))
        import torch

        stages.append(("import torch", time.time()))
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if device != "cpu" and found < cell.chips:
            log(f"{cell.name} needs {cell.chips} CUDA device(s); found {found}")
            return 2, None, []
        group.join()
        stages.append(("ranks joined", time.time()))
        result, lines = ranks.execute(job, group, stages=stages)
        group.close()
    finally:
        group.stop()
    bad = sorted(set(forbidden_modules()) | group.forbidden)
    if bad:
        log(f"modules that may not be loaded are: {bad}")
        return 3, None, []
    return 0, result, lines


def main(argv=None) -> int:
    stages = [("start", T_START), ("python and the harness", time.time())]
    args = parse_args(argv)
    set_cache_dirs()
    cell = spec.find_cell(spec.load_benchmark(), args.workload)
    if cell.chips > 1:
        code, result, lines = run_ranked(cell, args.seed, args.seconds, bool(args.trace),
                                         stages=stages)
        if code:
            return code
        for line in lines:
            print(line, file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
        return 0
    import torch

    stages.append(("import torch", time.time()))
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); found {found}")
        return 2
    stages.append(("CUDA found", time.time()))
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), stages=stages)
    bad = forbidden_modules()
    if bad:
        log(f"modules that may not be loaded are: {bad}")
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
