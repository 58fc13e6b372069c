"""Window, per-channel IIR with carried state, FFT and magnitude, in float64.

The configuration's datapath, frame by frame (frame-aligned hop):

    samples -> symmetric Hann window -> 12th-order IIR (SOS, state carried
    across frames and chunks) -> N-point FFT -> |X|

for real input, and window -> complex FFT -> |X| for IQ planes. Every
function takes plain arrays; nothing here knows how the system under test
computes.
"""

from __future__ import annotations

import numpy as np
import scipy.fft
import scipy.signal as sps

PRECISIONS = ("float64", "tf32")


def hann(n: int) -> np.ndarray:
    """The configuration's window: symmetric Hann, 0.5 (1 - cos(2 pi k / (n - 1)))."""
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / (n - 1)))


def to_tf32(a) -> np.ndarray:
    """a rounded to TF32 (8 exponent bits, 10 explicit mantissa bits),
    nearest even, as float32."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & 0xFFFFE000
    return bits.astype(np.uint32).view(np.float32)


def _check_precision(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def _fft_abs(frames: np.ndarray, precision: str) -> np.ndarray:
    """|FFT| of each row; the control transforms TF32 operands in float32
    (complex64)."""
    if precision == "tf32":
        if np.iscomplexobj(frames):
            frames = (to_tf32(frames.real) + 1j * to_tf32(frames.imag)).astype(np.complex64)
        else:
            frames = to_tf32(frames)
    return np.abs(scipy.fft.fft(frames, axis=-1, workers=-1))


def magnitudes_real(
    x: np.ndarray, n: int, sos: np.ndarray | None = None, precision: str = "float64",
    return_state: bool = False,
):
    """One channel's stream x (T,), T a multiple of n, from rest -> (T // n, n)
    magnitudes.

    Each frame is windowed, the windowed stream runs through the cascade
    ``sos`` (S, 6) from zero state with its state carried from frame to
    frame (``sos`` None: no filter), and each frame is transformed.
    ``return_state``: also the cascade's state after the last sample
    (S, 2), in SciPy's zi layout."""
    _check_precision(precision)
    frames = np.asarray(x, np.float64).reshape(-1, n)
    zf = None
    if precision == "tf32":
        y = to_tf32(frames) * to_tf32(hann(n))
        if sos is not None:
            sos32 = to_tf32(sos)
            y, zf = sps.sosfilt(sos32, to_tf32(y).reshape(-1), zi=np.zeros((sos32.shape[0], 2), np.float32))
            y = y.reshape(frames.shape)
    else:
        y = frames * hann(n)
        if sos is not None:
            sos = np.asarray(sos, np.float64)
            y, zf = sps.sosfilt(sos, y.reshape(-1), zi=np.zeros((sos.shape[0], 2)))
            y = y.reshape(frames.shape)
    mags = _fft_abs(y, precision)
    return (mags, zf) if return_state else mags


def magnitudes_complex(
    xr: np.ndarray, xi: np.ndarray, n: int, precision: str = "float64"
) -> np.ndarray:
    """IQ planes xr, xi (T,) -> (T // n, n) magnitudes of the windowed
    complex frames."""
    _check_precision(precision)
    win = hann(n)
    if precision == "tf32":
        win = to_tf32(win)
        z = (to_tf32(xr).reshape(-1, n) * win) + 1j * (to_tf32(xi).reshape(-1, n) * win)
        return _fft_abs(z, precision)
    z = np.asarray(xr, np.float64).reshape(-1, n) + 1j * np.asarray(xi, np.float64).reshape(-1, n)
    return _fft_abs(z * win, precision)


def state_matrix(sos: np.ndarray) -> np.ndarray:
    """The (2S, 2S) matrix that advances the cascade's state (SciPy's zi
    layout, section by section) by one sample of zero input.

    Section s (transposed direct form II, a0 = 1) keeps z_s; with input u
    its output is b0 u + z_s[0] and its state becomes
    [-a1 y + b1 u + z_s[1], -a2 y + b2 u]. With zero input the first
    section's u is 0 and each later section's u is the output before it,
    a linear function of the states of the sections before it."""
    sos = np.asarray(sos, np.float64)
    s = sos.shape[0]
    a = np.zeros((2 * s, 2 * s))
    u = np.zeros(2 * s)  # this section's input as a function of the state
    for i in range(s):
        b0, b1, b2, a0, a1, a2 = sos[i] / sos[i, 3]
        y = b0 * u
        y[2 * i] += 1.0
        a[2 * i] = -a1 * y + b1 * u
        a[2 * i, 2 * i + 1] += 1.0
        a[2 * i + 1] = -a2 * y + b2 * u
        u = y
    return a


def settle_frames(sos: np.ndarray, n: int, tol: float = 1e-13, max_frames: int = 64) -> int:
    """Frames after which the cascade has forgotten its state: the fewest
    whole frames of zero input that take every unit initial state (each of
    the 2 S state entries set to 1 in turn) below ``tol``.

    A stream rebuilt from rest that many frames before a chunk then enters
    the chunk with the state of the whole stream, to ``tol`` times that
    state's size. Raises past ``max_frames``: such a design is too narrow
    for a check that rebuilds a stretch of the stream."""
    frame = np.linalg.matrix_power(state_matrix(sos), n)
    p = frame
    for frames in range(1, max_frames + 1):
        if np.abs(p).max() < tol:
            return frames
        p = frame @ p
    raise ValueError(f"the cascade keeps its state past {max_frames} frames of {n} samples")
