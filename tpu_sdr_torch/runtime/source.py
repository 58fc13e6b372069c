"""Sample sources — the acquisition front-end (XADC replacement).

A copy of ``tpu_sdr.runtime.source`` (host NumPy code), and one source of
the port's own that hands out tensors: the port imports nothing of
``tpu_sdr``.

The reference acquires from the XADC at 1 MSPS, 12-bit, sign-extended
(``imp/dsp_system_top.vhd:412-435``). Software equivalents:

- ``SyntheticSource``: tone/multitone + noise generator with optional
  12-bit quantization emulating the ADC transfer function;
- ``FileSource``: playback of a recorded capture (.npy or raw int16/float32),
  looped, for reproducible demos;
- ``CallbackSource``: adapter for external ingest (sockets, SDR hardware);
- ``PinnedRingSource``: a ring of pinned host slots, the buffers a front
  end's DMA fills, handed to ``StreamFeeder`` as tensors that it copies
  straight to the card.

Sources produce frame-aligned float32 blocks shaped (channels, T); pacing to
real time is the caller's choice (``pace=True`` sleeps to the nominal rate —
the GUI demo does; the bench never does).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Sequence

import numpy as np
import torch

from tpu_sdr_torch.core import qformat as qf


class SyntheticSource:
    """Multi-tone + noise generator with phase continuity across blocks."""

    def __init__(
        self,
        tones_hz: Sequence[tuple[float, float]] = ((100_000.0, 0.5),),
        fs: float = 1_000_000.0,
        noise: float = 0.0,
        channels: int = 1,
        adc_bits: int | None = 12,
        seed: int = 0,
        iq: bool = False,
    ):
        """``iq=True``: complex baseband output — tones become complex
        exponentials with SIGNED frequencies (negative = below DC), noise
        is circularly symmetric, output dtype complex64."""
        self.tones = list(tones_hz)
        self.fs = fs
        self.noise = noise
        self.channels = channels
        self.adc_bits = adc_bits
        self.iq = iq
        self.rng = np.random.default_rng(seed)
        self.n = 0  # absolute sample index (phase continuity)

    def set_tones(self, tones_hz: Sequence[tuple[float, float]]):
        self.tones = list(tones_hz)

    def _quantize(self, x: np.ndarray) -> np.ndarray:
        # Emulate the ADC: clip to [-1,1), quantize to adc_bits levels
        # (the XADC's 12-bit window, sign-extended — qformat.adc12_to_q16).
        full = 1 << (self.adc_bits - 1)
        return np.clip(np.rint(x * full), -full, full - 1) / full

    def read(self, n_samples: int, pace: bool = False) -> np.ndarray:
        t = (self.n + np.arange(n_samples)) / self.fs
        if self.iq:
            x = np.zeros(n_samples, dtype=np.complex128)
            for f, a in self.tones:
                x += a * np.exp(2j * np.pi * f * t)
            if self.noise > 0:
                x = x + self.noise * (
                    self.rng.standard_normal(n_samples)
                    + 1j * self.rng.standard_normal(n_samples)
                ) / np.sqrt(2)
        else:
            x = np.zeros(n_samples, dtype=np.float64)
            for f, a in self.tones:
                x += a * np.sin(2 * np.pi * f * t)
            if self.noise > 0:
                x = x + self.noise * self.rng.standard_normal(n_samples)
        self.n += n_samples
        if self.adc_bits is not None:
            if self.iq:
                x = self._quantize(x.real) + 1j * self._quantize(x.imag)
            else:
                x = self._quantize(x)
        dtype = np.complex64 if self.iq else np.float32
        out = np.broadcast_to(x.astype(dtype), (self.channels, n_samples))
        if pace:
            time.sleep(n_samples / self.fs)
        return np.ascontiguousarray(out)


class FileSource:
    """Looped playback of a capture file (.npy — real or complex/IQ, e.g.
    a ``SampleRecorder`` capture — or raw samples). Raw dtype: int16
    (Q15-scaled to float) by default; suffix-selected for the common SDR
    raw formats — ``.f32``/``.float32`` (float32), ``.cf32``/``.c64``
    (complex64 IQ) — or forced via ``raw_dtype``. A JSON sidecar written
    by the recorder overrides ``fs``."""

    _RAW_SUFFIXES = {
        ".f32": np.float32, ".float32": np.float32,
        ".cf32": np.complex64, ".c64": np.complex64,
        ".i16": np.int16, ".s16": np.int16,
    }

    def __init__(self, path: str, fs: float = 1_000_000.0, channels: int = 1,
                 raw_dtype=None):
        if path.endswith(".npy"):
            data = np.load(path)
            sidecar = path[: -len(".npy")] + ".json"
            if os.path.exists(sidecar):
                import json

                with open(sidecar) as f:
                    fs = float(json.load(f).get("fs", fs))
        else:
            if raw_dtype is None:
                ext = os.path.splitext(path)[1].lower()
                # default int16 preserved for unknown suffixes; float/IQ
                # raws would otherwise decode as int16 garbage
                raw_dtype = self._RAW_SUFFIXES.get(ext, np.int16)
            raw_dtype = np.dtype(raw_dtype)
            raw = np.fromfile(path, dtype=raw_dtype)
            if raw_dtype == np.int16:
                data = raw.astype(np.float32) / qf.Q15_SCALE
            else:
                data = raw  # float32 / complex64 raws are already scaled
        dtype = np.complex64 if np.iscomplexobj(data) else np.float32
        self.data = np.atleast_2d(np.asarray(data, dtype))
        self.fs = fs
        # channels=1 (the default) means "the file's native channel count";
        # asking for MORE channels than a mono file has fans channel 0 out
        # (a convenience); any other mismatch would silently drop or invent
        # recorded channels, so it is an error.
        file_ch = self.data.shape[0]
        if channels == 1:
            channels = file_ch
        elif file_ch not in (1, channels):
            raise ValueError(
                f"file has {file_ch} channels, source configured for "
                f"{channels}; only native (channels=1) or mono->C fan-out "
                "is supported"
            )
        self.channels = channels
        self.pos = 0

    def read(self, n_samples: int, pace: bool = False) -> np.ndarray:
        total = self.data.shape[-1]
        idx = (self.pos + np.arange(n_samples)) % total
        self.pos = (self.pos + n_samples) % total
        out = self.data[:, idx]
        if out.shape[0] < self.channels:  # mono->C fan-out (see __init__)
            out = np.broadcast_to(out[0], (self.channels, n_samples))
        if pace:
            time.sleep(n_samples / self.fs)
        return np.ascontiguousarray(out)


class CallbackSource:
    """Wrap any ``f(n_samples) -> (channels, n)`` callable — real
    (float32) or complex/IQ (complex64) output, like the other sources."""

    def __init__(self, fn: Callable[[int], np.ndarray], fs: float = 1_000_000.0):
        self.fn = fn
        self.fs = fs

    def read(self, n_samples: int, pace: bool = False) -> np.ndarray:
        raw = np.asarray(self.fn(n_samples))
        out = np.asarray(
            raw, np.complex64 if np.iscomplexobj(raw) else np.float32)
        if pace:
            time.sleep(n_samples / self.fs)
        return out


class PinnedRingSource:
    """A ring of R host slots of one chunk each, handed out in order.

    The deployment it stands for acquires into pinned host memory (a NIC's
    receive ring, a digitizer driver's buffers), so the feeder can copy a
    slot straight to the card. ``slots`` is R, with the chunk's ``shape``,
    for slots of its own (pinned where CUDA is available, else ordinary
    CPU tensors in the same order), or a sequence of the caller's equal
    tensors to adopt. ``read()`` hands out the next slot itself, float32
    (channels, T), not a copy.

    A slot is handed out again, and refilled, only after the copy that read
    it last has finished: the consumer passes that copy's event to
    ``release(slot, event)``, and ``read()`` waits on it
    (``release_waits`` counts the waits that found it unfinished).
    ``refill(slot)``, where given, writes the next samples into the slot
    before it is handed out (the front end's DMA); without it the ring
    replays what its slots hold. ``reset()`` returns to slot 0.
    """

    def __init__(self, slots: int | Sequence[torch.Tensor], shape: Sequence[int] | None = None,
                 refill: Callable[[torch.Tensor], None] | None = None, fs: float = 1_000_000.0,
                 pin: bool | None = None):
        if isinstance(slots, int):
            if shape is None:
                raise ValueError("PinnedRingSource(R, shape): R slots need the chunk's shape")
            pin = torch.cuda.is_available() if pin is None else pin
            slots = [torch.zeros(tuple(shape), dtype=torch.float32, pin_memory=pin)
                     for _ in range(slots)]
        self.slots = list(slots)
        if not self.slots:
            raise ValueError("PinnedRingSource needs at least one slot")
        first = self.slots[0]
        if any(s.shape != first.shape or s.dtype != torch.float32 or s.device.type != "cpu"
               for s in self.slots):
            raise ValueError("the slots must be equal float32 host tensors")
        self._index = {s.data_ptr(): i for i, s in enumerate(self.slots)}
        self._released: list = [None] * len(self.slots)
        self.refill = refill
        self.fs = fs
        self.release_waits = 0
        self._next = 0

    def read(self, n_samples: int, pace: bool = False) -> torch.Tensor:
        i = self._next
        slot = self.slots[i]
        if slot.shape[-1] != n_samples:
            raise ValueError(f"a slot holds {slot.shape[-1]} samples a channel, not {n_samples}")
        done, self._released[i] = self._released[i], None
        if done is not None and not done.query():
            self.release_waits += 1
            done.synchronize()
        if self.refill is not None:
            self.refill(slot)
        self._next = (i + 1) % len(self.slots)
        if pace:
            time.sleep(n_samples / self.fs)
        return slot

    def release(self, slot: torch.Tensor, event) -> None:
        """``event`` completes when the copy that read ``slot`` has."""
        self._released[self._index[slot.data_ptr()]] = event

    def reset(self) -> None:
        self._next = 0
