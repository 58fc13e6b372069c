"""Waterfall / spectrogram output (the counterpart of
``tpu_sdr.runtime.waterfall``).

Turns the magnitude stream into display products:

- ``decimate_db``: peak-preserving (or other detector) decimation + dB
  conversion, tensor operations on the magnitudes' own device: 16384 bins
  -> ~1-2K display columns;
- ``detect_bucketed``: the host detector with uneven buckets (NumPy);
- ``Waterfall``: host ring buffer of decimated rows with peak-hold and
  average traces (NumPy).
"""

from __future__ import annotations

import numpy as np
import torch

DETECTORS = ("peak", "minpeak", "avg", "rms", "sample")


def host(x):
    """x as a host array: a tensor (on any device) copied to NumPy, anything
    else as it is."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def decimate_db(
    mag: torch.Tensor,
    points: int = 1024,
    db: bool = True,
    floor: float = 1e-9,
    detector: str = "peak",
) -> torch.Tensor:
    """Bucketed detector decimation of magnitudes (..., N) -> (..., points).

    ``detector`` selects the classic analyzer display detectors: ``peak``
    (default: max-pool keeps a 1-bin tone visible at any zoom), ``minpeak``,
    ``avg`` (mean), ``rms`` (power-correct averaging), ``sample`` (first bin
    per bucket).
    """
    if detector not in DETECTORS:
        raise ValueError(f"detector must be one of {DETECTORS}; got {detector!r}")
    mag = torch.as_tensor(mag)
    n = mag.shape[-1]
    if n % points:
        raise ValueError(f"bins {n} not divisible by points {points}")
    b = mag.reshape(*mag.shape[:-1], points, n // points)
    if detector == "peak":
        pooled = b.amax(dim=-1)
    elif detector == "minpeak":
        pooled = b.amin(dim=-1)
    elif detector == "avg":
        pooled = b.mean(dim=-1)
    elif detector == "rms":
        pooled = torch.sqrt((b * b).mean(dim=-1))
    else:
        pooled = b[..., 0].clone()
    if db:
        pooled = 20.0 * torch.log10(torch.clamp(pooled, min=floor))
    return pooled


def detect_bucketed(x: np.ndarray, edges: np.ndarray, detector: str = "peak"):
    """Host-side bucketed detector with UNEVEN buckets (the GUI's
    display-crop path): x (N,), edges (points+1,) non-decreasing bin
    boundaries -> (points,). Same detector vocabulary as
    ``decimate_db``. Duplicate edges (more display points than bins —
    e.g. a small-FFT config) follow ``np.ufunc.reduceat`` semantics:
    an empty bucket yields its start bin's value, for every detector."""
    x = np.asarray(x)
    edges = np.asarray(edges, int)
    if edges.ndim != 1 or edges.size < 2 or np.any(np.diff(edges) < 0):
        raise ValueError("edges must be non-decreasing, >= 2 entries")
    if edges[0] < 0 or edges[-1] > x.shape[-1]:
        raise ValueError(f"edges out of range for {x.shape[-1]} bins")
    x = x[: edges[-1]]  # reduceat's last bucket runs to the end of x
    L = x.shape[-1]
    starts = edges[:-1]
    clamped = np.minimum(starts, max(L - 1, 0))
    # Duplicate interior edges already follow reduceat semantics (an
    # empty bucket yields its start bin's value). Only trailing empty
    # buckets (start == L) need the clamp above, and the clamp then
    # truncates the last real bucket's segment by one bin, so that one
    # bucket is recomputed over its full extent below.
    j = -1
    if L > 0 and starts.size and starts[-1] >= L:
        j = int(np.searchsorted(starts, L, side="left")) - 1
    if detector == "peak":
        res = np.maximum.reduceat(x, clamped)
        if j >= 0:
            res[j] = x[starts[j]:].max()
        return res
    if detector == "minpeak":
        res = np.minimum.reduceat(x, clamped)
        if j >= 0:
            res[j] = x[starts[j]:].min()
        return res
    # Empty buckets: reduceat returns x[start]; divide by a count of 1.
    counts = np.maximum(np.diff(edges), 1)
    if detector == "avg":
        s = np.add.reduceat(x, clamped)
        if j >= 0:
            s[j] = x[starts[j]:].sum()
        return s / counts
    if detector == "rms":
        s = np.add.reduceat(x * x, clamped)
        if j >= 0:
            s[j] = (x[starts[j]:] ** 2).sum()
        return np.sqrt(s / counts)
    if detector == "sample":
        return x[clamped]
    raise ValueError(f"detector must be one of {DETECTORS}; got {detector!r}")


class Waterfall:
    """Scrolling spectrogram with peak-hold and exponential-average traces."""

    def __init__(self, points: int = 1024, depth: int = 256, avg_alpha: float = 0.1):
        self.points = points
        self.depth = depth
        self.avg_alpha = avg_alpha
        self.rows = np.full((depth, points), -200.0, dtype=np.float32)
        self.peak_hold = np.full(points, -200.0, dtype=np.float32)
        self.average = np.full(points, -200.0, dtype=np.float32)
        self.row_count = 0
        self._head = 0

    def push(self, decimated_db):
        """Add one (or a batch of) decimated dB rows (points,) or (F, points),
        as NumPy or a tensor on any device."""
        rows = np.atleast_2d(np.asarray(host(decimated_db), np.float32))
        for r in rows:
            self.rows[self._head] = r
            self._head = (self._head + 1) % self.depth
            self.row_count += 1
            np.maximum(self.peak_hold, r, out=self.peak_hold)
            if self.row_count == 1:
                self.average[:] = r
            else:
                self.average += self.avg_alpha * (r - self.average)

    def image(self) -> np.ndarray:
        """(depth, points) array, newest row last — ready for display."""
        return np.roll(self.rows, -self._head, axis=0)

    def reset_peak(self):
        self.peak_hold[:] = -200.0

    def clear(self):
        """Full display reset (the GUI 'reset_plot' event)."""
        self.rows[:] = -200.0
        self.peak_hold[:] = -200.0
        self.average[:] = -200.0
        self.row_count = 0
        self._head = 0

    def latest(self) -> np.ndarray:
        return self.rows[(self._head - 1) % self.depth]
