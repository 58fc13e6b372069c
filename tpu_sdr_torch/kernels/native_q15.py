"""ctypes bindings for the native Q15 integer SOS filter (the counterpart of
``tpu_sdr.kernels.native_q15``).

``native/q15_filter.cpp`` (the port's copy of the reference's source) is
built with the host C++ compiler on first use into ``build/tpu_sdr_torch/``,
the file named by a hash of the source and the flags, as the CUDA libraries
are (``kernels/cuda/loader.py``). It is the split Q15 path's host stage:
bit-exact vs ``golden.sosfilt_q15_intended``, the NumPy oracle, which stays
callable by its own name. Unlike the reference, which warns and falls back
to the oracle, a missing compiler or a failed build raises here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from tpu_sdr_torch.kernels.cuda import loader

SOURCE = Path(__file__).resolve().parents[1] / "native" / "q15_filter.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-Wall", "-fPIC", "-shared"]

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library of ``native/q15_filter.cpp`` and ``CXX_FLAGS`` lives."""
    key = hashlib.sha256(SOURCE.read_bytes() + b"\0" + " ".join(CXX_FLAGS).encode())
    return loader.BUILD_DIR / f"libq15filter-{key.hexdigest()[:16]}.so"


def _compiler() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("no C++ compiler found (CXX, g++, c++, clang++): the native Q15 "
                       "filter is built from source on first use")


def build(force: bool = False) -> str:
    """Compile the filter unless its library exists; returns the compiler's
    output ("" when nothing was built), raises RuntimeError if it fails."""
    lib = library_path()
    if lib.exists() and not force:
        return ""
    loader.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}")
    proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"native Q15 filter build failed: exit {proc.returncode}\n{log}")
    os.replace(tmp, lib)
    return log


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
            lib.sosfilt_q15_batch.restype = ctypes.c_int
            lib.sosfilt_q15_batch.argtypes = [
                i64p, ctypes.c_int, i16p, ctypes.c_int64, ctypes.c_int64, i64p, i16p,
            ]
            lib.sosfilt_q15_window_batch.restype = ctypes.c_int
            lib.sosfilt_q15_window_batch.argtypes = [
                i64p, ctypes.c_int, i16p, ctypes.c_int64, ctypes.c_int64,
                i16p, ctypes.c_int64, ctypes.c_int64, i64p, i16p, i16p,
            ]
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the filter builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _check_sos(sos_x64) -> np.ndarray:
    sos = np.ascontiguousarray(sos_x64, np.int64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be (S, 6); got {sos.shape}")
    if np.any(sos[:, 3] != 64):
        raise ValueError(f"normalized sections required (a0 == 64); got {sos[:, 3].tolist()}")
    return sos


def _check_rows(x_q15, zi, sections: int):
    x = np.ascontiguousarray(x_q15, np.int16)
    if x.ndim != 2:
        raise ValueError(f"x must be (R, T); got {x.shape}")
    z = np.ascontiguousarray(zi, np.int64).copy()
    if z.shape != (x.shape[0], sections, 2):
        raise ValueError(f"zi must be {(x.shape[0], sections, 2)}; got {z.shape}")
    return x, z


def sosfilt_q15_rows(sos_x64, x_q15, zi):
    """Filter R independent rows: x (R, T) int16, zi (R, S, 2) int64.

    Returns (y (R, T) int16, zf (R, S, 2) int64), bit-exact vs looping
    ``golden.sosfilt_q15_intended`` per row.
    """
    sos = _check_sos(sos_x64)
    x, z = _check_rows(x_q15, zi, sos.shape[0])
    rows, n = x.shape
    y = np.empty_like(x)
    rc = _load().sosfilt_q15_batch(sos, sos.shape[0], x, rows, n, z.reshape(-1), y)
    if rc != 0:  # pragma: no cover - a0 validated above
        raise ValueError("native q15 filter rejected the coefficient set")
    return y, z


def sosfilt_q15_window_rows(sos_x64, x_q15, rom_q16, zi, want_windowed=True):
    """Fused RTL window + filter over R independent rows, one pass.

    x (R, T) int16 raw samples; rom (n,) int16 window ROM (frame-aligned:
    T % n == 0); zi (R, S, 2) int64. Returns (y, yw, zf) with yw the
    windowed intermediate (``windowed_q15``) or None when not requested;
    bit-exact vs ``qformat.window_multiply_q15`` + ``sosfilt_q15_rows``.
    """
    sos = _check_sos(sos_x64)
    x, z = _check_rows(x_q15, zi, sos.shape[0])
    rows, t = x.shape
    rom = np.ascontiguousarray(rom_q16, np.int16)
    if rom.ndim != 1 or t % rom.shape[0]:
        raise ValueError(f"rom must be 1-D with length dividing T; got {rom.shape} vs T={t}")
    y = np.empty_like(x)
    yw = np.empty_like(x)  # always passed (ndpointer argtypes reject None)
    rc = _load().sosfilt_q15_window_batch(
        sos, sos.shape[0], x, rows, t, rom, rom.shape[0], 0, z.reshape(-1), yw, y,
    )
    if rc != 0:  # pragma: no cover - a0 validated above
        raise ValueError("native q15 filter rejected the coefficient set")
    return y, (yw if want_windowed else None), z
