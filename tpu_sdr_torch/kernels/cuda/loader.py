"""Build and load the port's CUDA kernels.

``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, which is loaded with ``ctypes``. The
library's file name carries a hash of the source, of every header in
``csrc/`` (``*.cuh``, which a source may include) and of the compiler flags,
so a change to any of them builds a new library. Libraries go to
``build/tpu_sdr_torch/`` beside the package (listed in ``.gitignore``).
Nothing here runs at import time. Threads of one process may ask for the
same library at once (the GUI launches kernels from several): each library
builds under a lock of its own, into a temporary file named for the process
and the thread, which is renamed into place when nvcc succeeds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpu_sdr_torch"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def _lock(name: str) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(name, threading.Lock())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are built from source on first use"
    )


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu``, the headers of ``csrc/`` and
    ``NVCC_FLAGS`` lives."""
    key = hashlib.sha256()
    for path in (SOURCE_DIR / f"{name}.cu", *sorted(SOURCE_DIR.glob("*.cuh"))):
        key.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def build(name: str, force: bool = False) -> str:
    """Compile ``csrc/<name>.cu`` unless its library already exists.

    Returns the compiler's output ("" when nothing was built); raises
    RuntimeError with that output if nvcc fails.
    """
    lib = library_path(name)
    with _lock(name):
        if lib.exists() and not force:
            return ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".tmp{os.getpid()}-{threading.get_ident()}")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE_DIR / f"{name}.cu")],
            capture_output=True, text=True,
        )
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"CUDA kernel build failed: nvcc exited {proc.returncode}\n{log}")
        os.replace(tmp, lib)
        return log


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, built first if missing."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
