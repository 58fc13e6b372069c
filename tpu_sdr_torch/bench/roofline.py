"""Roofline model and profiling hook for the spectrum pipeline on an H100.

An analytic FLOP/byte cost model per pipeline stage, a roofline verdict
against the card's peaks, the least time (``bound``) the card could take for
a function, and a ``torch.profiler`` trace helper. The counterpart of
``tpu_sdr.bench.roofline``, with the card the port runs on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
import subprocess

from tpu_sdr_torch.core.config import PipelineConfig

# NVIDIA H100 SXM data sheet: dense peaks at the 700 W power limit. fp32 is
# the CUDA cores' rate (an FMA counts as two), bf16 the tensor cores'.
CHIP_SPECS = {
    "h100": {"fp32_tflops": 67.0, "bf16_tflops": 989.0, "hbm_gbs": 3350.0},
}

# Every product of the port runs in IEEE fp32 at every quality tier (the
# radix FFT kernels on the CUDA cores, the IIR products as fp32 matmuls), so
# each tier's rate is the fp32 peak. ``mxu_passes`` in the reports is
# bf16 peak / that rate, so that "logical rate = bf16 peak / passes" holds
# as in the reference's report.


@dataclasses.dataclass
class StageCost:
    name: str
    flops_per_frame: float
    hbm_bytes_per_frame: float

    @property
    def intensity(self) -> float:
        return self.flops_per_frame / max(self.hbm_bytes_per_frame, 1.0)


def pipeline_cost(cfg: PipelineConfig | None = None) -> list[StageCost]:
    """Analytic per-frame cost of each stage (nominal FLOPs, fused-HBM bytes).

    The stages and their counts are the reference's, except ``fft_4step``:
    the spectrum kernels compute a radix FFT of the real frame, 2.5 N log2 N
    operations, not the reference's dense four-step products."""
    cfg = cfg or PipelineConfig()
    n = cfg.fft_size
    L = cfg.iir_block
    B = n // L
    m = 2 * cfg.n_sections
    f4 = 4.0  # f32 bytes
    return [
        StageCost("window", n, 0.0),  # fused: no extra HBM traffic
        StageCost("iir_toeplitz", 2.0 * B * L * L, 0.0),  # y_zs = x @ T^T per block
        StageCost("iir_forcing", 2.0 * B * L * m, 0.0),
        StageCost("iir_scan", 2.0 * 7 * B * m * m + 2.0 * B * m * 2, 0.0),
        StageCost("iir_inject", 2.0 * B * m * L, 0.0),
        StageCost("fft_4step", 2.5 * n * math.log2(n), 0.0),
        StageCost("magnitude", 4.0 * n, 0.0),
        StageCost("io", 0.0, 2.0 * n * f4),  # one frame in, one mag out
    ]


def _tier_compute(cfg: PipelineConfig, chip: str):
    """The shared prelude of both reports: (spec, stages, flops, passes,
    tier rate, t_compute), so that their fractions cannot diverge."""
    spec = CHIP_SPECS[chip]
    stages = pipeline_cost(cfg)
    flops = sum(s.flops_per_frame for s in stages)
    tflops = spec["fp32_tflops"]
    passes = spec["bf16_tflops"] / tflops
    t_compute = flops / (tflops * 1e12)
    return spec, stages, flops, passes, tflops, t_compute


def roofline_report(
    cfg: PipelineConfig | None = None,
    chip: str = "h100",
    measured_samples_per_sec: float | None = None,
) -> dict:
    """Summarize the pipeline against the card's compute/memory roofs."""
    cfg = cfg or PipelineConfig()
    spec, stages, flops, passes, tflops, t_compute = _tier_compute(cfg, chip)
    hbm = sum(s.hbm_bytes_per_frame for s in stages)
    t_memory = hbm / (spec["hbm_gbs"] * 1e9)
    bound_by = "compute" if t_compute > t_memory else "memory"
    # Ingest ceiling: a frame of compute advances the stream by hop samples
    # (== n for the non-overlapped default; < n for STFT configs).
    ceiling_sps = cfg.effective_hop / max(t_compute, t_memory)
    report = {
        "chip": chip,
        "dtype": cfg.dtype,
        "flops_per_frame": flops,
        "hbm_bytes_per_frame": hbm,
        "arithmetic_intensity": flops / max(hbm, 1.0),
        "mxu_passes": passes,
        "tier_tflops": tflops,
        "bound": bound_by,
        "ceiling_samples_per_sec": ceiling_sps,
        "stages": {s.name: s.flops_per_frame for s in stages},
    }
    if measured_samples_per_sec is not None:
        report["measured_samples_per_sec"] = measured_samples_per_sec
        report["fraction_of_ceiling"] = measured_samples_per_sec / ceiling_sps
    return report


def serial_floor_report(
    cfg: PipelineConfig | None = None,
    chip: str = "h100",
    measured_samples_per_sec: float | None = None,
) -> dict:
    """The floor of the hybrid program if its phases did not overlap, beside
    the ideal ceiling of ``roofline_report``.

    The hybrid path moves four passes of a frame through device memory (x
    in, the IIR output y written by the products and read again by the
    spectrum kernel, the magnitudes out), so its floor is t_compute +
    t_memory with that traffic, not max(t_c, t_m) with in + out only."""
    cfg = cfg or PipelineConfig()
    spec, _stages, _flops, _passes, _tflops, t_compute = _tier_compute(cfg, chip)
    n = cfg.fft_size
    if cfg.dtype == "bf16" and cfg.bf16_io:
        # x in (4 B) + y round-trip in bf16 (2+2) + bf16 magnitudes (2)
        hybrid_hbm = n * (4.0 + 2.0 + 2.0 + 2.0)
    else:
        hybrid_hbm = 4.0 * n * 4.0  # x in + y round-trip + mag out, f32
    t_memory = hybrid_hbm / (spec["hbm_gbs"] * 1e9)
    floor_sps = cfg.effective_hop / (t_compute + t_memory)
    report = {
        "chip": chip,
        "dtype": cfg.dtype,
        "hybrid_hbm_bytes_per_frame": hybrid_hbm,
        "t_compute_us_per_frame": t_compute * 1e6,
        "t_memory_us_per_frame": t_memory * 1e6,
        "serial_floor_samples_per_sec": floor_sps,
    }
    if measured_samples_per_sec is not None:
        report["fraction_of_serial_floor"] = measured_samples_per_sec / floor_sps
    return report


def max_sm_mhz(device: int = 0) -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={device}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.split()[0])


@functools.lru_cache(maxsize=None)
def int32_ops_per_s(device: int = 0) -> float:
    """The card's INT32 issue rate in operations a second: 64 INT32 lanes an
    SM (Hopper), one operation a lane a cycle, on every SM at the highest SM
    clock. The data sheet gives no such rate; its 67 TFLOP/s fp32 is 128
    lanes an SM counting an FMA as two."""
    import torch

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 64 * sms * max_sm_mhz(device) * 1e6


def bound(bytes_moved: float, flops: float, int_ops: float = 0, chip: str = "h100") -> dict:
    """The least time the card could take for a function: each input read
    once and each output written once at the memory rate, or its fp32
    operations at the fp32 peak plus its integer operations at the INT32
    issue rate, whichever is longer."""
    spec = CHIP_SPECS[chip]
    by_bytes = bytes_moved / (spec["hbm_gbs"] * 1e9) * 1e3
    by_ops = (flops / (spec["fp32_tflops"] * 1e12)
              + (int_ops / int32_ops_per_s() if int_ops else 0)) * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": bytes_moved, "flops": flops, "int_ops": int_ops}


@contextlib.contextmanager
def profiled(logdir: str = "tpu_sdr_torch_trace"):
    """Capture a torch.profiler trace (host, and the card's kernels where
    there is one) around a code block; the Chrome trace is written to
    ``logdir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
