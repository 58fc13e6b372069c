"""Fixed-point 16-bit scaled FFT modelling the reference xfft core (the
counterpart of ``tpu_sdr.kernels.fft_q15``).

The reference drives the Xilinx xfft 9.1 IP with no config-channel writes
(``imports/new/dsp_system_top.vhd:534-536``), so the core runs its power-on
defaults: forward transform, 16-bit scaled fixed point, truncation
rounding, 16-bit phase factors and the default 1/N scaling schedule
(``ip/xfft_0/xfft_0.xci``). The model here:

- radix-2 decimation-in-frequency ranks, natural-order output;
- a truncating (arithmetic) right shift after every rank, ``schedule[t]``
  bits at rank t (default one bit a rank, the 1/N schedule);
- Q15 phase factors ``clip(round(w * 2^15), -32768, 32767)``, computed on
  the host (``plan_q15``); exponent-0 rotations are bypassed exactly;
- the complex product truncated (>> 15, toward -inf) back to 16 bits and
  saturated to int16.

Its outputs are the int16 words the FPGA drains onto the wire
(``imports/new/sequ2.vhd:153``). The model is schedule-faithful, not
gate-exact; ``fft_q15_np`` (NumPy, int64) is its oracle.

``window_fft_q15`` is the device stage of the Q15 pipeline: [the RTL window,]
the ranks, the bit-reversal gather and the magnitude of the wire words. On
a CUDA tensor it launches ``csrc/q15_fft.cu``: a frame of 16384 on a
cluster of CTAs (the ranks in registers between exchanges through shared
memory, the bit reversal in the store), smaller frames on one CTA each (or
several frames a CTA); ``kernel_route`` says which. On a CPU tensor it runs
``window_fft_q15_plain``, the ranks as int32 tensor operations. The two give
the same bits. ``fft_q15`` is its FFT alone.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpu_sdr_torch.core.qformat import xfft_wire_scale
from tpu_sdr_torch.kernels import window
from tpu_sdr_torch.kernels.cuda import launch

N_DEFAULT = 16384
MAX_N = 16384  # the kernel's largest frame: 128 x 128 on its cluster route

Q15_FULL_SCALE = 1 << 15

# Hardware wire LSBs per unit float-spectrum amplitude: wire = (1/N)*FFT(x_q15)
# = (2^15/N)*FFT(x_float); 2.0 for the reference's 16K.
XFFT_WIRE_SCALE = xfft_wire_scale(N_DEFAULT)

BITREV = ("take", "transpose")


@functools.lru_cache(maxsize=8)
def bit_reverse_indices(n: int) -> np.ndarray:
    """idx such that natural_order[k] = dif_output[idx[k]]."""
    m = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for _ in range(m):
        rev = (rev << 1) | (idx & 1)
        idx >>= 1
    return rev


@functools.lru_cache(maxsize=8)
def plan_q15(n: int = N_DEFAULT):
    """Per-rank Q15 twiddle tables for the DIF ranks (NumPy, cached).

    Returns dict with 'ranks': list over t of (w_re, w_im) int64 arrays of
    length n >> (t+1) (entry j is W_n^(j << t), Q15), and 'bitrev'.
    """
    m = n.bit_length() - 1
    if (1 << m) != n:
        raise ValueError(f"n must be a power of two, got {n}")
    ranks = []
    for t in range(m):
        half = n >> (t + 1)
        exp = (np.arange(half, dtype=np.int64) << t) % n
        ang = -2.0 * np.pi * exp / n
        w_re = np.clip(np.floor(np.cos(ang) * 32768.0 + 0.5), -32768, 32767)
        w_im = np.clip(np.floor(np.sin(ang) * 32768.0 + 0.5), -32768, 32767)
        ranks.append((w_re.astype(np.int64), w_im.astype(np.int64)))
    return {"ranks": ranks, "bitrev": bit_reverse_indices(n)}


def _sat16(x):
    return np.clip(x, -32768, 32767)


def fft_q15_np(x_re, x_im=None, schedule=None):
    """NumPy oracle: scaled fixed-point FFT of int16 frames (..., N).

    ``schedule`` is bits-of-shift per radix-2 rank (default all-ones = the
    xfft default 1/N). Returns (re, im) int16 natural order: the wire words
    of ``sequ2.vhd:153``.
    """
    re = np.asarray(x_re, dtype=np.int64)
    n = re.shape[-1]
    im = np.zeros_like(re) if x_im is None else np.asarray(x_im, dtype=np.int64)
    m = n.bit_length() - 1
    if schedule is None:
        schedule = (1,) * m
    plan = plan_q15(n)
    lead = re.shape[:-1]
    for t in range(m):
        half = n >> (t + 1)
        s = schedule[t]
        w_re, w_im = plan["ranks"][t]
        r = re.reshape(*lead, 1 << t, 2, half)
        i = im.reshape(*lead, 1 << t, 2, half)
        a_re, b_re = r[..., 0, :], r[..., 1, :]
        a_im, b_im = i[..., 0, :], i[..., 1, :]
        sum_re = _sat16((a_re + b_re) >> s)
        sum_im = _sat16((a_im + b_im) >> s)
        d_re = _sat16((a_re - b_re) >> s)
        d_im = _sat16((a_im - b_im) >> s)
        # complex multiply, truncate (>> 15 toward -inf), saturate; exponent-0
        # rotations bypassed exactly (j == 0 is the only zero exponent).
        p_re = _sat16((d_re * w_re - d_im * w_im) >> 15)
        p_im = _sat16((d_re * w_im + d_im * w_re) >> 15)
        p_re[..., 0] = d_re[..., 0]
        p_im[..., 0] = d_im[..., 0]
        re = np.stack([sum_re, p_re], axis=-2).reshape(*lead, n)
        im = np.stack([sum_im, p_im], axis=-2).reshape(*lead, n)
    br = plan["bitrev"]
    return re[..., br].astype(np.int16), im[..., br].astype(np.int16)


def _log2(n: int) -> int:
    m = n.bit_length() - 1
    if n < 2 or (1 << m) != n:
        raise ValueError(f"frame length must be a power of two >= 2, got {n}")
    return m


def _schedule(schedule, m: int) -> tuple:
    schedule = (1,) * m if schedule is None else tuple(int(s) for s in schedule)
    if len(schedule) != m or any(not 0 <= s <= 16 for s in schedule):
        raise ValueError(f"schedule must hold {m} shifts in [0, 16], got {schedule}")
    return schedule


@functools.lru_cache(maxsize=16)
def _rank_twiddles(n: int, device: str) -> tuple:
    """plan_q15's tables as int32 tensors on ``device``, one (w_re, w_im)
    pair a rank."""
    return tuple(
        (torch.as_tensor(w_re, dtype=torch.int32, device=device),
         torch.as_tensor(w_im, dtype=torch.int32, device=device))
        for w_re, w_im in plan_q15(n)["ranks"]
    )


def _ranks_plain(re: torch.Tensor, im: torch.Tensor, schedule: tuple) -> tuple:
    """The DIF ranks on int32 tensors (..., n), natural-index DIF order out.
    Every value is saturated to int16 after every rank; the products of
    two int16 values and their pairwise sums stay inside int32 (|d| |w| <=
    2^15 * sqrt(2) * 2^15 < 2^31)."""
    n = re.shape[-1]
    lead = re.shape[:-1]
    for t, (w_re, w_im) in enumerate(_rank_twiddles(n, str(re.device))):
        half = n >> (t + 1)
        s = schedule[t]
        r = re.reshape(*lead, 1 << t, 2, half)
        i = im.reshape(*lead, 1 << t, 2, half)
        a_re, b_re = r[..., 0, :], r[..., 1, :]
        a_im, b_im = i[..., 0, :], i[..., 1, :]
        sum_re = ((a_re + b_re) >> s).clamp_(-32768, 32767)
        sum_im = ((a_im + b_im) >> s).clamp_(-32768, 32767)
        d_re = ((a_re - b_re) >> s).clamp_(-32768, 32767)
        d_im = ((a_im - b_im) >> s).clamp_(-32768, 32767)
        p_re = ((d_re * w_re - d_im * w_im) >> 15).clamp_(-32768, 32767)
        p_im = ((d_re * w_im + d_im * w_re) >> 15).clamp_(-32768, 32767)
        p_re[..., 0] = d_re[..., 0]
        p_im[..., 0] = d_im[..., 0]
        re = torch.stack([sum_re, p_re], dim=-2).reshape(*lead, n)
        im = torch.stack([sum_im, p_im], dim=-2).reshape(*lead, n)
    return re, im


def _magnitude(fr_q: torch.Tensor, fi_q: torch.Tensor) -> torch.Tensor:
    """The GUI decode of the wire words (fft_analyzer_gui.py:256-260), fp32."""
    fr = fr_q.to(torch.float32)
    fi = fi_q.to(torch.float32)
    return torch.sqrt(fr * fr + fi * fi)


def window_fft_q15_plain(x_re, x_im=None, rom=None, schedule=None, want_magnitude: bool = True):
    """The plain PyTorch version of ``window_fft_q15``: (re, im, |X| or
    None). Takes int16 or int32 frames."""
    n = x_re.shape[-1]
    schedule = _schedule(schedule, _log2(n))
    if rom is not None:
        x_re = window.window_q15(x_re, rom)
        x_im = None if x_im is None else window.window_q15(x_im, rom)
    re = x_re.to(torch.int32)
    im = torch.zeros_like(re) if x_im is None else x_im.to(torch.int32)
    re, im = _ranks_plain(re, im, schedule)
    br = torch.as_tensor(plan_q15(n)["bitrev"], device=re.device)
    fr = re.index_select(-1, br).to(torch.int16)
    fi = im.index_select(-1, br).to(torch.int16)
    return fr, fi, _magnitude(fr, fi) if want_magnitude else None


@functools.lru_cache(maxsize=16)
def _kernel_tables(n: int, schedule: tuple, device: str) -> tuple:
    """(tw (n/2, 2) int16, sched (m,) int32) on ``device``: rank 0's table,
    W_n^e for e < n/2 as interleaved (re, im) Q15 words (rank t's entry j is
    rank 0's entry j << t, the same value), and the schedule."""
    w_re, w_im = plan_q15(n)["ranks"][0]
    tw = torch.as_tensor(np.stack([w_re, w_im], axis=-1).astype(np.int16), device=device)
    return tw.contiguous(), torch.as_tensor(schedule, dtype=torch.int32, device=device)


def _check_int16(name: str, v: torch.Tensor, shape, dev: torch.device):
    if v.device != dev or v.dtype != torch.int16 or tuple(v.shape) != tuple(shape):
        raise ValueError(
            f"{name} must be {tuple(shape)} int16 on {dev}, got "
            f"{tuple(v.shape)} {v.dtype} on {v.device}"
        )


def window_fft_q15_cuda(x_re, x_im=None, rom=None, schedule=None, want_magnitude: bool = True):
    """Launch ``csrc/q15_fft.cu`` on int16 frames (..., n) on a CUDA device,
    n a power of two in [2, 16384]. Returns (re, im) int16 and |X| fp32
    (None unless ``want_magnitude``). Raises if the kernel cannot be built or
    launched."""
    dev = x_re.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {dev}")
    n = x_re.shape[-1]
    m = _log2(n)
    if n > MAX_N:
        raise ValueError(f"the kernel takes frames of at most {MAX_N} samples, got {n}")
    schedule = _schedule(schedule, m)
    _check_int16("x_re", x_re, x_re.shape, dev)
    if x_im is not None:
        _check_int16("x_im", x_im, x_re.shape, dev)
    if rom is not None:
        _check_int16("rom", rom, (n,), dev)
    frames = x_re.numel() // n
    if frames >= 2**31:
        raise ValueError(f"too many frames for one launch: {frames}")
    lead = x_re.shape[:-1]
    tw, sched = _kernel_tables(n, schedule, str(dev))
    x_re = x_re.contiguous()
    x_im = None if x_im is None else x_im.contiguous()
    rom = None if rom is None else rom.contiguous()
    re = torch.empty(x_re.shape, dtype=torch.int16, device=dev)
    im = torch.empty(x_re.shape, dtype=torch.int16, device=dev)
    mag = torch.empty(x_re.shape, dtype=torch.float32, device=dev) if want_magnitude else None
    ptr = lambda v: None if v is None else v.data_ptr()
    if frames:
        launch.launch(
            "q15_fft", dev, x_re.data_ptr(), ptr(x_im), ptr(rom), tw.data_ptr(),
            sched.data_ptr(), re.data_ptr(), im.data_ptr(), ptr(mag), frames, m,
        )
    return re.reshape(*lead, n), im.reshape(*lead, n), mag


def window_fft_q15(x_re, x_im=None, rom=None, schedule=None):
    """The Q15 pipeline's device stage on int16 frames (..., n): with
    ``rom`` (the (n,) int16 window ROM) the RTL window first
    (``window.window_q15``), then the scaled FFT. Returns (re, im) int16 wire
    words in natural order and their magnitude sqrt(re^2 + im^2) in fp32."""
    if launch.on_cpu("q15_fft", x_re):
        return window_fft_q15_plain(x_re, x_im, rom, schedule)
    return window_fft_q15_cuda(x_re, x_im, rom, schedule)


def fft_q15(x_re, x_im=None, schedule=None, bitrev: str = "take"):
    """Scaled fixed-point FFT of int16/int32 frames (..., N), bit-exact vs
    ``fft_q15_np``. Returns (re, im) int16 natural order.

    Arrays that are not tensors become CPU tensors (the plain version). On
    a CUDA tensor it launches ``csrc/q15_fft.cu``, which takes int16 frames.
    ``bitrev`` ("take" or "transpose") is checked and kept for the JAX
    signature: it chose a lowering on the TPU, and both name the same
    permutation, which the index gather performs here.
    """
    if bitrev not in BITREV:
        raise ValueError(f"bitrev must be one of {BITREV}, got {bitrev!r}")
    x_re = torch.as_tensor(x_re)
    x_im = None if x_im is None else torch.as_tensor(x_im, device=x_re.device)
    if launch.on_cpu("q15_fft", x_re):
        re, im, _ = window_fft_q15_plain(x_re, x_im, None, schedule, want_magnitude=False)
        return re, im
    re, im, _ = window_fft_q15_cuda(x_re, x_im, None, schedule, want_magnitude=False)
    return re, im


def kernel_route(frames: int, n: int) -> tuple:
    """The route of a launch of ``frames`` frames of ``n`` samples
    (``tpu_sdr_q15_fft_route``, a pure function of the shape): ("cluster",
    C), a frame on a cluster of C CTAs, or ("block", 1), one CTA a frame or
    several frames a CTA. Builds the kernel's library on first use."""
    fn = launch._kernel_lib("q15_fft").tpu_sdr_q15_fft_route
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    ctas = fn(int(frames), _log2(n))
    return ("cluster", ctas) if ctas > 0 else ("block", 1)


def butterfly_probe_cycles(steps: int, shift: int = 1, device="cuda") -> float:
    """Clock cycles of one butterfly's dependent chain, a rank on the last
    rank's product (``tpu_sdr_q15_butterfly_probe``: one warp, ``steps``
    butterflies at ``shift`` with the twiddle W_8^1), measured over
    ``steps``. Not a launch of the FFT: it is not counted."""
    lib = launch._kernel_lib("q15_fft")
    fn = lib.tpu_sdr_q15_butterfly_probe
    fn.argtypes = [ctypes.c_void_p, *[ctypes.c_int] * 4, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    w_re, w_im = (int(v[1 << 11]) for v in plan_q15(N_DEFAULT)["ranks"][0])
    out = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(out.device):
        err = fn(out.data_ptr(), steps, shift, w_re, w_im, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"tpu_sdr_q15_butterfly_probe launch failed: CUDA error {err}")
    return out[0].item() / steps


def memory_probe_cycles(steps: int = 256, device="cuda") -> tuple:
    """Clock cycles of one read of device memory that misses L2 (a chase of
    ``steps`` dependent reads) and of one write with the fence that waits
    for it (``tpu_sdr_q15_memory_probe``, one thread, on a 256 MB scratch).
    Returns (read cycles, write cycles). Not a launch of the FFT."""
    lib = launch._kernel_lib("q15_fft")
    fn = lib.tpu_sdr_q15_memory_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    buf = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    out = torch.zeros(3, dtype=torch.int64, device=device)
    with torch.cuda.device(out.device):
        err = fn(buf.data_ptr(), buf.numel(), out.data_ptr(), steps,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"tpu_sdr_q15_memory_probe launch failed: CUDA error {err}")
    return out[0].item() / steps, out[1].item() / steps
