"""Stream capture to disk + playback tee (capability extension).

A copy of ``tpu_sdr.runtime.recorder`` (host NumPy code, no tensors): the
port imports nothing of ``tpu_sdr``.

The reference has no recording at all (spectra fly by at 30 FPS and are
gone); production SDR work needs capture/replay. Two pieces:

- ``SampleRecorder``: accumulates raw sample chunks — real float32 or
  complex64 (IQ), any channel count — and writes ONE ``.npy`` plus a
  JSON sidecar (``<path>.json``: fs, channels, complex flag, sample
  count) on close. ``max_samples`` turns it into a ring that keeps the
  LAST N samples (pre-trigger capture). ``FileSource`` plays the .npy
  back, preserving complex data.
- ``RecordingSource``: wraps any source and tees every ``read()`` into
  a recorder — drop-in for the GUI/feeder to capture exactly what was
  displayed.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np


class SampleRecorder:
    """Accumulate sample chunks; write one .npy (+ .json sidecar) on close.

    Thread-safe: ``append`` and ``close`` serialize on an internal lock, so
    a GUI acquisition thread appending while an HTTP thread closes either
    lands the chunk in the file or raises "recorder is closed" — never a
    torn buffer or a silently dropped tail."""

    def __init__(
        self,
        path: str,
        fs: float = 1_000_000.0,
        max_samples: int | None = None,
    ):
        if max_samples is not None and max_samples < 1:
            raise ValueError(f"max_samples must be >= 1; got {max_samples}")
        self.path = path
        self.fs = float(fs)
        self.max_samples = max_samples
        self._chunks: list[np.ndarray] = []
        self._buffered = 0
        self.samples_written = 0  # total appended (pre-ring)
        self._sig = None  # (channels, is_complex)
        self._closed = False
        self._lock = threading.Lock()

    def append(self, x) -> None:
        x = np.asarray(x)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2:
            raise ValueError(f"need (n,) or (channels, n) chunks; got {x.shape}")
        is_c = np.iscomplexobj(x)
        # ALWAYS copy: ascontiguousarray is a no-copy pass-through for an
        # already-contiguous matching-dtype array, and a source that
        # refills one preallocated read buffer would then alias every
        # stored chunk to that buffer — the capture would replay the last
        # chunk N times
        x = np.array(x, np.complex64 if is_c else np.float32, order="C")
        sig = (x.shape[0], is_c)
        with self._lock:
            if self._closed:
                raise ValueError("recorder is closed")
            if self._sig is None:
                self._sig = sig
            elif sig != self._sig:
                raise ValueError(
                    f"chunk signature {sig} != recorder's {self._sig} "
                    "(channels / real-vs-complex must not change mid-capture)"
                )
            self._chunks.append(x)
            self._buffered += x.shape[-1]
            self.samples_written += x.shape[-1]
            if self.max_samples is not None:
                # ring: drop whole chunks from the front, then trim the first
                while (
                    len(self._chunks) > 1
                    and self._buffered - self._chunks[0].shape[-1]
                    >= self.max_samples
                ):
                    self._buffered -= self._chunks.pop(0).shape[-1]
                excess = self._buffered - self.max_samples
                if excess > 0:
                    # copy, not slice: a view would keep the whole original
                    # chunk array alive, defeating the ring's memory bound
                    # (ascontiguousarray is NOT enough — it returns the view
                    # unchanged when the slice happens to be contiguous)
                    self._chunks[0] = self._chunks[0][..., excess:].copy()
                    self._buffered -= excess

    def close(self) -> dict:
        """Write the capture; returns the sidecar metadata dict."""
        with self._lock:
            if self._closed:
                raise ValueError("recorder already closed")
            if self._sig is None:
                # not fatal: the recorder stays usable (append then close)
                raise ValueError("nothing recorded")
            self._closed = True
            data = np.concatenate(self._chunks, axis=-1)
            self._chunks.clear()
        np.save(self.path, data)
        meta = {
            "fs": self.fs,
            "channels": int(data.shape[0]),
            "complex": bool(self._sig[1]),
            "samples": int(data.shape[-1]),
            "samples_seen": int(self.samples_written),
        }
        npy = self.path if self.path.endswith(".npy") else self.path + ".npy"
        with open(os.path.splitext(npy)[0] + ".json", "w") as f:
            json.dump(meta, f)
        return meta


class RecordingSource:
    """Tee a source's reads into a recorder (drop-in source wrapper)."""

    def __init__(self, source, recorder: SampleRecorder):
        self.source = source
        self.recorder = recorder
        self.fs = getattr(source, "fs", recorder.fs)

    def read(self, n_samples: int, pace: bool = False) -> np.ndarray:
        x = self.source.read(n_samples, pace=pace)
        self.recorder.append(np.atleast_2d(x))
        return x
