"""CUDA graphs of the filtered dispatch's IIR, captured once a shape.

``process_stream``'s hybrid branch (FIXED or CUSTOM, magnitudes at the
128x128 geometry, frame-aligned hop, one device) runs the composite IIR on
the card as three steps (``biquad.cascade_products``, ``cascade_chain``,
``cascade_emit``): the forcing pass's one launch, the state kernel's two
and the emit kernel's one, with their copies, each enqueued from Python.
``DispatchGraphs`` replays the last two from two CUDA graphs, one a step
and each inside the step's span, captured once a key (the current stream,
the mode, the chunk's shape and dtype, the bank's operator, the window):

- the first dispatch of a key runs eagerly (the warm-up);
- the second captures the graphs, in one private memory pool, and replays
  them;
- every later one replays them.

Before the replays, a dispatch launches the forcing pass eagerly, in the
products step's span (``biquad.ForcingLaunch``, its operands checked once
at the capture): it reads the caller's chunk and writes the windowed
blocks and their forcing straight into the graphs' static inputs; the
carried state is copied into their static state. After them, the spectrum
kernel reads the static output into a fresh magnitude tensor and the final
state is cloned out, so a later replay overwrites nothing a caller holds.
One lock covers that sequence, so threads that share a stream do not
interleave on the static buffers. The graphs read every constant by
address: the bank's operator they hold is never freed under them, and
``SpectrumPipeline``'s uploads drop them (``clear``). A replay adds to
``launch.counts`` the launches its capture made; ``launch.graph_counts``
counts the keys' eager dispatches, captures, replays and evictions.
"""

from __future__ import annotations

import collections
import threading

import torch

from tpu_sdr_torch.core.spans import span
from tpu_sdr_torch.kernels import biquad
from tpu_sdr_torch.kernels.cuda import launch

# Keys a cache holds at most: a stream's chunk shapes, FIXED and CUSTOM.
CAPACITY = 4
# The span of each step, as the steps open them when run eagerly: the
# forcing pass's, then each graph's.
SPANS = ("tpu_sdr.iir.products", "tpu_sdr.iir.frame_chain", "tpu_sdr.iir.emit")


def _stream_id(device: torch.device) -> int:
    """The current stream of ``device``, as a key."""
    return torch.cuda.current_stream(device).cuda_stream


# Captures run one at a time in the process, on a side stream of each
# device (created on first use), so that two pipelines never capture on one
# stream at once.
_capture_lock = threading.Lock()
_capture_streams: dict = {}


def _capture(steps, device: torch.device) -> list:
    """One CUDA graph for each of ``steps`` (callables run in turn, each
    once, under capture) on ``device``, in one private memory pool.
    "thread_local" leaves other threads' CUDA calls free meanwhile."""
    with _capture_lock, torch.cuda.device(device):
        stream = _capture_streams.get(device)
        if stream is None:
            stream = _capture_streams[device] = torch.cuda.Stream(device)
        pool = torch.cuda.graph_pool_handle()
        graphs = []
        for step in steps:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                step()
            graphs.append(graph)
        return graphs


class _Graphs:
    """One key's graphs and their static buffers: zi the entering state
    (..., [C,] S, 2), and in ``out`` the forcing pass's outputs (y0 the
    windowed blocks, f their forcing), which ``force`` writes, and the
    steps' outputs."""

    def __init__(self, op, x: torch.Tensor, hann_w: torch.Tensor, zi: torch.Tensor,
                 channels: int):
        self.op = op
        self.zi = torch.empty_like(zi, memory_format=torch.contiguous_format)
        v = biquad.blocked(op, x)
        out = self.out = {
            "y0": torch.empty_like(v, memory_format=torch.contiguous_format),
            "f": x.new_empty((*v.shape[:-1], op.state_dim)),
        }
        self.force = biquad.ForcingLaunch(op, x, hann_w, (out["y0"], out["f"]))
        frames = biquad.cascade_frames(op, channels)

        def chain():
            out["z_in"], out["zf"] = biquad.cascade_chain(op, out["f"], self.zi, frames)

        def emit():
            out["y"] = biquad.cascade_emit(op, out["y0"], out["z_in"], frames)

        with launch.captured() as self.launches:
            self.graphs = _capture((chain, emit), x.device)

    def replay(self, x: torch.Tensor, zi: torch.Tensor, spectrum):
        """(spectrum(y), the final state) for chunk x from state zi."""
        with span(SPANS[0]):
            self.force(x)
        self.zi.copy_(zi)
        for name, graph in zip(SPANS[1:], self.graphs):
            with span(name):
                graph.replay()
        launch.add_counts(self.launches)
        return spectrum(self.out["y"]), biquad.cascade_state(self.op, self.out["zf"]).clone()


class DispatchGraphs:
    """The graphs of one pipeline's filtered dispatches, by key, the least
    recently used dropped past ``CAPACITY`` keys."""

    def __init__(self):
        self._lock = threading.Lock()
        # key -> (the bank's operator, its _Graphs once captured)
        self._keys: collections.OrderedDict = collections.OrderedDict()

    def clear(self):
        """Drop every key: the next dispatch of each runs eagerly. A graph
        still running completes (CUDA frees it after), and its pool's
        memory goes to no other allocation."""
        with self._lock:
            self._keys.clear()

    def run(self, mode_index: int, x: torch.Tensor, hann_w: torch.Tensor, op,
            zi: torch.Tensor, channels: int, spectrum):
        """The hybrid branch's IIR and spectrum for chunk x (..., [C,] T)
        from state zi through the bank's operator ``op``: (spectrum(y), the
        final state) from the graphs of this dispatch's key; None where the
        dispatch runs eagerly, the first of its key or one that the forcing,
        state and emit kernels do not take (the CPU, another geometry)."""
        if not biquad.takes_emit_kernel(op):
            return None
        key = (_stream_id(x.device), mode_index, tuple(x.shape), x.dtype, id(op), id(hann_w))
        with self._lock:
            held = self._keys.get(key)
            if held is None:
                self._keys[key] = (op, None)
                if len(self._keys) > CAPACITY:
                    self._keys.popitem(last=False)
                    launch.count_graph("evictions")
                launch.count_graph("eager")
                return None
            self._keys.move_to_end(key)
            graphs = held[1]
            if graphs is None:
                graphs = _Graphs(op, x, hann_w, zi, channels)
                self._keys[key] = (op, graphs)
                launch.count_graph("captures")
            else:
                launch.count_graph("replays")
            return graphs.replay(x, zi, spectrum)
