"""The comparison that decides ``correct``.

For every compared chunk and channel, the reference rebuilds the stretch of
the stream it needs from the ring of inputs (from rest at the stream's start,
or from rest enough frames before the chunk that the cascade has forgotten
its state, ``reference.settle_frames``) and computes the chunk's magnitudes
in float64. The numbers compared:

- ``mag_err``: the widest gap between the system's magnitudes and the
  reference's in any compared frame, as a share of the largest magnitude of
  that frame's windowed input (before any filter);
- ``mag_err_ch`` (cells with an IIR): the widest gap in any compared chunk
  of a channel as a share of that channel's own output there (the largest
  reference magnitude of the chunk), or of ``OUTPUT_FLOOR`` times the
  largest of its input, whichever is larger: a channel whose design passes
  only noise is held to its own scale, not to its input's;
- ``state_err`` (cells with an IIR): the widest gap between the cascade
  state the system carries after the window's last chunk and the
  reference's, as a share of the largest entry of the reference's state,
  the worst compared channel's;
- ``frames_err``: how far the system's frame counter is from the frames
  sent in the window (exact).
"""

from __future__ import annotations

import numpy as np

from sdrbench import reference

# The least scale ``mag_err_ch`` divides by, as a share of the input's
# largest magnitude: below it a channel's output is rounding of the stopband.
OUTPUT_FLOOR = 1e-3


def frame_errors(got: np.ndarray, ref: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """(..., F, N) magnitudes -> (..., F): each frame's widest gap over
    ``scale`` (..., F)."""
    return np.abs(np.asarray(got, np.float64) - ref).max(axis=-1) / scale


def state_error(got: np.ndarray, ref: np.ndarray) -> float:
    """The widest gap of a (S, 2) state over the reference's largest entry."""
    return float(np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max())


class Stream:
    """The input stream as the reference sees it: chunk k is ring slot
    k mod R. ``ring`` is the host copy of the compared channels, (R, C', T)
    or (R, 2, C', T)."""

    def __init__(self, ring: np.ndarray, n: int, frames_per_chunk: int):
        self.ring, self.n, self.f = ring, n, frames_per_chunk

    @property
    def channels(self) -> int:
        return self.ring.shape[-2]

    def frames(self, ch: int, g0: int, g1: int, plane: int | None = None) -> np.ndarray:
        """Samples of frames g0 .. g1 - 1 of compared channel ``ch``."""
        parts = []
        for g in range(g0, g1):
            slot = self.ring[(g // self.f) % self.ring.shape[0]]
            row = slot[ch] if plane is None else slot[plane, ch]
            parts.append(row[(g % self.f) * self.n:(g % self.f + 1) * self.n])
        return np.concatenate(parts)


def reference_chunk(stream: Stream, k: int, ch: int, sos, complex_input: bool, settle: int,
                    precision: str = "float64"):
    """Chunk k of compared channel ``ch``: its (F, N) magnitudes, the
    cascade's state after it (None without a cascade) and (F,) the peak of
    each windowed input frame."""
    n, f = stream.n, stream.f
    if complex_input:
        mags = reference.magnitudes_complex(stream.frames(ch, k * f, (k + 1) * f, 0),
                                            stream.frames(ch, k * f, (k + 1) * f, 1), n, precision)
        return mags, None, mags.max(axis=-1)
    if sos is None:
        mags = reference.magnitudes_real(stream.frames(ch, k * f, (k + 1) * f), n, None, precision)
        return mags, None, mags.max(axis=-1)
    g0 = max(0, k * f - settle)
    x = stream.frames(ch, g0, (k + 1) * f)
    mags, zf = reference.magnitudes_real(x, n, sos, precision, return_state=True)
    peaks = reference.magnitudes_real(x[-f * n:], n).max(axis=-1)
    return mags[-f:], zf, peaks


def compare(outputs: dict, stream: Stream, sos_bank, complex_input: bool, *, last: int,
            state=None, frames_counted: int | None = None, control: bool = False) -> dict:
    """``outputs``: chunk index -> the system's (C', F, N) magnitudes of the
    compared channels; ``sos_bank``: their (C', S, 6) designs or None;
    ``last``: the window's last chunk; ``state``: the system's (C', S, 2)
    cascade state after it; ``frames_counted``: its frame counter.
    ``control``: the reference in TF32 stands in for the system. Returns
    the numbers compared, ``per_chunk``, each compared chunk's
    ``mag_err``, and ``per_chunk_ch``, its ``mag_err_ch`` (0 without an
    IIR)."""
    settle = [0] * stream.channels if sos_bank is None else [
        reference.settle_frames(s, stream.n) for s in sos_bank]
    per_chunk, per_chunk_ch, state_err = {}, {}, 0.0
    for k, got in sorted(outputs.items()):
        worst = worst_ch = 0.0
        for ch in range(stream.channels):
            sos = None if sos_bank is None else sos_bank[ch]
            ref, zf, peaks = reference_chunk(stream, k, ch, sos, complex_input, settle[ch])
            if control:
                got_ch, z_ch, _ = reference_chunk(stream, k, ch, sos, complex_input, settle[ch], "tf32")
            else:
                got_ch, z_ch = got[ch], None if state is None else state[ch]
            worst = max(worst, float(frame_errors(got_ch, ref, peaks).max()))
            if sos is not None:
                own = max(float(ref.max()), OUTPUT_FLOOR * float(peaks.max()))
                worst_ch = max(worst_ch, float(np.abs(np.asarray(got_ch, np.float64) - ref).max()) / own)
            if k == last and zf is not None:
                state_err = max(state_err, state_error(z_ch, zf))
        per_chunk[k] = worst
        per_chunk_ch[k] = worst_ch
    numbers = {"mag_err": max(per_chunk.values())}
    if sos_bank is not None:
        numbers["mag_err_ch"] = max(per_chunk_ch.values())
        numbers["state_err"] = state_err
    if frames_counted is not None and not control:
        numbers["frames_err"] = float(abs(frames_counted - (last + 1) * stream.f))
    return {**numbers, "per_chunk": per_chunk, "per_chunk_ch": per_chunk_ch}
