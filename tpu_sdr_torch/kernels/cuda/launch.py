"""Launch plumbing shared by every CUDA kernel wrapper of the port.

One place holds, for all kernels: their names (``KERNELS``, one per
``csrc/<name>.cu``), the launch and plain-call counts (``counts``,
``reset_counts``), each library's C signature, the library cache and
``launch``, which calls a kernel's C entry point on the current stream (in a
profiler span, ``SPANS``) and raises if the launch failed. ``iir_fft.counts``
is this module's ``counts``. Launches made while a CUDA graph is captured
(``captured``) count when the graph is replayed (``add_counts``), and
``graph_counts`` counts the filtered dispatch's graphs.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import threading

import torch

from tpu_sdr_torch.core.spans import span
from tpu_sdr_torch.kernels.cuda import loader

# The kernels, by the name of their source (``csrc/<name>.cu``).
KERNELS = (
    "spectrum_bypass", "spectrum_iir", "iir_summaries", "spectrum_complex",
    "fm_demod", "pfb_fold_dft", "fft_mag_fused", "q15_fft", "sosfilt_q15", "viterbi",
    "iir_state", "iir_emit", "iir_force",
)
# The half spectrum (``iir_fft.spectrum_from_state(half_spectrum=True)``)
# has a plain version of its own and launches spectrum_bypass's or
# spectrum_iir's kernel.
COUNTERS = KERNELS + ("spectrum_half",)

# Per counter: launches of the CUDA kernel ("kernel") and calls of its plain
# version on CPU tensors ("plain"), made by the wrappers. A half-spectrum
# launch counts under "spectrum_half" and under the kernel it runs. Read and
# reset (``reset_counts``) by callers that check which path a run took.
counts = {"kernel": dict.fromkeys(COUNTERS, 0), "plain": dict.fromkeys(COUNTERS, 0)}
# The filtered dispatch's CUDA graphs (``runtime/dispatch_graphs.py``), per
# dispatch they cover: "eager" the first of a key, run without a graph;
# "captures" the second, which captures the graphs and replays them;
# "replays" every later one; and "evictions" the keys the cache dropped as
# least recently used. The hit share is replays / (replays + eager).
graph_counts = dict.fromkeys(("captures", "replays", "eager", "evictions"), 0)
_counts_lock = threading.Lock()
# While a thread captures a CUDA graph, its counts go to a sink of its own
# (``captured``) instead of ``counts``: the capture runs nothing.
_capture = threading.local()

# ctypes argument types of each library's entry point ``tpu_sdr_<name>``
# (p: pointer or stream, i: int, f: float), in the order of its C signature
# in ``csrc/<name>.cu``. The stream is the last argument of each.
_SIGNATURES = {
    "spectrum_bypass": "pipppppiip",
    "spectrum_iir": "pppppppppppiip",
    "iir_summaries": "pppip",
    "spectrum_complex": "ppipppppiip",
    "fm_demod": "ppppppppppppiiffffip",
    "pfb_fold_dft": "ppppppiiiip",
    "fft_mag_fused": "pppppppppip",
    "q15_fft": "ppppppppiip",
    "sosfilt_q15": "pipiipippppp",
    "viterbi": "pppppiiiip",
    "iir_state": "ippiippppiiiip",
    "iir_emit": "ppppiiipiip",
    "iir_force": "pppiiiippiip",
}


def reset_counts():
    with _counts_lock:
        for per_kernel in (*counts.values(), graph_counts):
            for name in per_kernel:
                per_kernel[name] = 0


def count(kind: str, name: str):
    """Add one to ``counts[kind][name]`` ("kernel" or "plain"), or to the
    sink of this thread's capture."""
    sink = getattr(_capture, "sink", None)
    if sink is not None:
        sink[kind, name] += 1
        return
    with _counts_lock:
        counts[kind][name] += 1


def count_graph(event: str):
    """Add one to ``graph_counts[event]``."""
    with _counts_lock:
        graph_counts[event] += 1


@contextlib.contextmanager
def captured():
    """Within the block, this thread's counts go to the yielded sink, a
    Counter of (kind, name), and not to ``counts``."""
    _capture.sink = sink = collections.Counter()
    try:
        yield sink
    finally:
        _capture.sink = None


def add_counts(sink):
    """Add a sink of ``captured`` to ``counts``: a replay of the graph
    whose capture filled it."""
    with _counts_lock:
        for (kind, name), n in sink.items():
            counts[kind][name] += n


# Loaded libraries by name. GUI threads launch kernels concurrently, so
# each library's first load holds a lock of its own and every count update
# holds ``_counts_lock`` (``count``).
_libs: dict[str, ctypes.CDLL] = {}
_lib_locks = {name: threading.Lock() for name in KERNELS}


def _kernel_lib(name: str) -> ctypes.CDLL:
    with _lib_locks[name]:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = _load_bound(name)
    return lib


def _load_bound(name: str) -> ctypes.CDLL:
    lib = loader.load(name)
    types = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    fn = getattr(lib, f"tpu_sdr_{name}")
    fn.argtypes = [types[c] for c in _SIGNATURES[name]]
    fn.restype = ctypes.c_int
    lib.tpu_sdr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tpu_sdr_cuda_error_string.restype = ctypes.c_char_p
    return lib


# The profiler span of each kernel's launch (``core.spans``), named once.
SPANS = {name: f"tpu_sdr.launch.{name}" for name in KERNELS}


def launch(name: str, device: torch.device, *args):
    """Call ``tpu_sdr_<name>`` with ``args`` and the current stream of
    ``device``, in the span ``SPANS[name]``; raise if the launch failed,
    else count it."""
    lib = _kernel_lib(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        with span(SPANS[name]):
            err = getattr(lib, f"tpu_sdr_{name}")(*args, stream)
    if err != 0:
        msg = lib.tpu_sdr_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
    count("kernel", name)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t if contiguous and 16-byte aligned, else a contiguous copy: the
    kernels move 16 bytes a thread, and a contiguous view can start at any
    element (``x1d[3:3 + n]``)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def on_cpu(name: str, x: torch.Tensor, interpret: bool = False) -> bool:
    """True (and a plain call counted) when x lies on the CPU. ``interpret``
    has no meaning for a CUDA kernel: on a CUDA tensor it raises."""
    if x.device.type == "cpu":
        count("plain", name)
        return True
    if interpret:
        raise ValueError("interpret=True: a CUDA kernel has no interpret mode")
    return False
