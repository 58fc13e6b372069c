"""The least time the card could take for a function, from its shapes.

A frozen copy of the port's ``bench/roofline.bound`` arithmetic (each input
byte read once and each output byte written once at the memory rate, or the
function's fp32 operations at the fp32 peak, whichever is longer) and the
operation and byte counts of the spectrum functions, counted from what the
function needs and not from how a kernel computes it.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit: fp32 on
# the CUDA cores (an FMA counts as two) and HBM3 bandwidth.
H100 = {"fp32_flops_s": 67e12, "hbm_bytes_s": 3.35e12}


def bound_s(bytes_moved: float, flops: float, peaks: dict = H100) -> float:
    """The longer of the bytes at the memory rate and the operations at
    the fp32 peak, in seconds."""
    return max(bytes_moved / peaks["hbm_bytes_s"], flops / peaks["fp32_flops_s"])


def traced_frames(cell) -> int:
    """The frames of a chunk that the traced process's card computes: the
    whole chunk on one card, rank 0's block of it (a chips-th) in a
    multi-rank cell, since only rank 0 traces."""
    return cell.config["channels"] * cell.traffic["frames_per_chunk"] // cell.chips


def spectrum_real(frames: int, n: int) -> tuple[float, float]:
    """(bytes, flops) of magnitudes of ``frames`` real fp32 frames of n
    points: the frames read once and the (frames, n) fp32 magnitudes
    written once; 2.5 n log2 n operations a real frame."""
    return 8.0 * frames * n, 2.5 * n * math.log2(n) * frames


def spectrum_complex(frames: int, n: int) -> tuple[float, float]:
    """(bytes, flops) of magnitudes of ``frames`` complex frames given as
    fp32 re/im planes: both planes read once, the magnitudes written once;
    5 n log2 n operations a complex frame."""
    return 12.0 * frames * n, 5.0 * n * math.log2(n) * frames
