"""K3: the batched Viterbi decoder's CUDA kernel (``csrc/viterbi.cu``).

It computes ``tpu_sdr.kernels.fec._viterbi`` (a jitted ``lax.scan`` of the
add-compare-select and a reversed one of the traceback, no Pallas kernel).
Two routes, chosen by k in the C entry point: for k <= 7 (up to 64 states)
one warp a codeword row, the path metrics in the lanes' registers, the
decisions in shared memory and the traceback from there (in device memory
only for rows too long for shared memory); for 8 <= k <= 12 one CTA a row,
the metrics in shared memory, the decisions in device memory, one thread a
row walking back from state 0. Its plain version is
``kernels.fec.viterbi_plain``; the dispatch, ``kernels.fec.viterbi``, takes
that only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_sdr_torch.kernels.cuda import launch

MAX_OUT = 8  # output streams the kernel takes (csrc/viterbi.cu kMaxOut)


def viterbi_cuda(x: torch.Tensor, out0: torch.Tensor, out1: torch.Tensor, k: int) -> torch.Tensor:
    """Launch the kernel: x (B, T, n) f32 on a CUDA device, out0/out1
    (2^(k-1),) int32 edge output bits. Returns (B, T) uint8 decisions
    (info bits, tail included). Raises if it cannot be built or launched."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    if x.dtype != torch.float32 or x.ndim != 3:
        raise ValueError(f"x must be (B, T, n) float32, got {tuple(x.shape)} {x.dtype}")
    b, t, n = x.shape
    states = 1 << (k - 1)
    if not 2 <= k <= 12 or not 1 <= n <= MAX_OUT:
        raise ValueError(f"the kernel takes 2 <= k <= 12 and n <= {MAX_OUT}; got k={k}, n={n}")
    for name, v in (("out0", out0), ("out1", out1)):
        if v.device != dev or v.dtype != torch.int32 or tuple(v.shape) != (states,):
            raise ValueError(f"{name} must be ({states},) int32 on {dev}")
    if b >= 2**31 or b * t * n >= 2**62:
        raise ValueError(f"too many rows for one launch: {b}")
    x = x.contiguous()
    bits = torch.empty((b, t), dtype=torch.uint8, device=dev)
    if b and t:
        dec = None
        if needs_scratch(t, k):
            dec = torch.empty((b, t, max(states // 32, 1)), dtype=torch.int32, device=dev)
        launch.launch("viterbi", dev, x.data_ptr(), out0.contiguous().data_ptr(),
                      out1.contiguous().data_ptr(), None if dec is None else dec.data_ptr(),
                      bits.data_ptr(), b, t, n, k)
    return bits


def needs_scratch(steps: int, k: int) -> bool:
    """Whether the kernel keeps the decisions of rows of ``steps`` trellis
    steps in a device-memory scratch (``tpu_sdr_viterbi_needs_scratch``):
    always for k >= 8, and for k <= 7 only where a row's decisions would not
    fit in shared memory."""
    fn = launch._kernel_lib("viterbi").tpu_sdr_viterbi_needs_scratch
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return bool(fn(steps, k))


def step_probe_cycles(states: int, steps: int, device="cuda") -> float:
    """Clock cycles a trellis step of the block route's ``states`` threads
    takes at its latency floor (a dependent add-compare-select and a
    barrier, nothing else; ``tpu_sdr_viterbi_step_probe``), measured over
    ``steps`` steps. Not a launch of the decoder: it is not counted."""
    return _probe("tpu_sdr_viterbi_step_probe", [ctypes.c_int], [states], steps, device)


def warp_step_probe_cycles(steps: int, device="cuda") -> float:
    """Clock cycles a trellis step of the warp route at k = 7 takes at its
    latency floor (the step's dependent chain in one warp: the maximum's
    reduction with its key conversions, a subtraction, an add, a compare
    and a select, nothing else; ``tpu_sdr_viterbi_warp_step_probe``),
    measured over ``steps`` steps. Not a launch of the decoder: it is not
    counted."""
    return _probe("tpu_sdr_viterbi_warp_step_probe", [], [], steps, device)


def _probe(entry: str, types: list, values: list, steps: int, device) -> float:
    fn = getattr(launch._kernel_lib("viterbi"), entry)
    fn.argtypes = [ctypes.c_void_p, *types, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(out.device):
        err = fn(out.data_ptr(), *values, steps, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return out[0].item() / steps
