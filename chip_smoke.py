"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each raises on failure):
  1. device: card name and power limit, torch/CUDA versions, fp32 matmul
     precision flags (set to IEEE fp32 here);
  2. build: every CUDA kernel library of the port (``launch.KERNELS``), built from
     ``tpu_sdr_torch/csrc`` with nvcc, and the native Q15 host filter and
     the native framer (``tpu_sdr_torch/native/q15_filter.cpp``,
     ``framer.cpp``) with the host C++ compiler, one process per source,
     all started together;
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     card: the spectrum kernels at F = 1, 8 and 512 frames with the stated
     SNR floors (and a relative-error bound for the IIR summaries' states);
     the IIR summaries also against the float64 chain on the plan's own
     constants, no worse than the plain version, on the pipelines' designs
     and on two narrow low-passes (butter(12, 0.01) and butter(12, 0.002));
     the half spectrum (both forms, which launch the bypass and IIR
     kernels) against its plain version, equal to the full spectrum bit for
     bit, its mirrored bins bitwise equal to their partners and
     ``blocked_output`` the same bits; and ``fft_mag_fused`` with the plan's
     planes, planes scaled by 0.5 and random planes;
     the FM kernel at 8 x 2^20 samples bit for bit (and within atol 1e-6),
     twice in a row, and at its edge shapes
     (one block; 1025 blocks; 1000 channels of one block); the PFB kernel at
     the channelizer's real and IQ shapes with the channelizer's and random
     planes (1e-5 of the output scale), and against float64 beside the plain
     version (at most 1 dB below it); the Q15 kernels bit for bit: the
     scaled integer FFT (``q15_fft``) at F = 1, 3, 8, 64 and 133 frames,
     with and without the RTL window, on random int16 frames and
     full-scale tones, also against ``fft_q15_np``, and at every frame
     size 2^1 .. 2^14 (complex input, schedule t % 3; 2^14 at full scale
     with the schedules all 0 and 2, 0), each with its route and C,
     and the saturating Q15 cascade (``sosfilt_q15``, window included) on 1
     and 4 rows of 2 frames with a carried state, and at 1 to 8 sections on
     1, 4 and 33 rows (packed warps left part-full) of full-scale input that
     drives every section to the rails, also against
     ``golden.sosfilt_q15_intended``; the Viterbi decoder (``viterbi``, K3)
     bit for bit on 64 rows of a K = 7 rate-1/2 code (2048 info bits, soft
     and hard, whose metrics tie), a punctured rate, k = 3, 4 and 5 (fewer
     states than lanes), k = 12 (2048 states, the block route), one row and
     rows too long for shared memory (the decisions in device memory);
     the composite IIR's state kernel (``iir_state``, two launches) against
     its plain version and the GEMM form it replaces (W's product, the
     Python frame chain, the APow product) at a bank of 64 of bank64's
     designs x 16 frames and a shared design x 512 frames, both timed
     beside the bound of the triangular sums (and the launch counts); its
     emit kernel (``iir_emit``, one launch) against its plain version and
     the GEMM form it replaces (the T and M products and the add) at the
     same shapes, timed beside its bound; its forcing pass (``iir_force``,
     one launch) against its plain version (xw bit for bit, f within the
     FMAs' gap) and the GEMM form, chunked == one-shot, timed at 64 x 16, 64
     x 256 and 1 x 1 frames beside its bytes bound and the eager window
     multiply and P's canonical GEMMs it replaces;
  4. the paths, each driven with the launch counts set to 0 just before it
     and read just after:
     - the spectrum paths at 8 channels x 64 frames per dispatch (8.4
       Msamples), 5 carried-state dispatches per mode: the default (hybrid)
       path in CUSTOM (butter(12, 0.25)), FIXED and BYPASS (the IIR state
       kernel twice and the emit kernel once a filtered dispatch); the fused
       two-pass path (f32, f32max); complex (IQ) input through ``process``
       and ``process_planes``; each with one kernel launch per dispatch, no
       plain call, a float64 golden, chunked == one-shot;
     - the FM kernel path, ``FMDemodulator(200e3, use_pallas=True)`` with
       and without de-emphasis at 8 x 2^20 samples: one ``fm_demod`` launch
       per dispatch, chunked == one-shot bitwise (mixed chunks), the default
       path within 2e-6, a 1 kHz tone recovered;
     - the channelizer kernel path, ``Channelizer(m=128, taps=8,
       use_pallas=True)`` on 8 x 2^20 real samples and (2, 8, 2^20) IQ
       planes: one ``pfb_fold_dft`` launch per dispatch, the default path
       within 1e-5 of max |re|, chunked == one-shot bitwise, a tone in its
       channel;
     - kernel rows 4 and 6, which no runtime path calls (in either
       package), through their entry points at 8 x 64 frames:
       ``spectrum_from_state(half_spectrum=True)`` in both forms and
       ``fft_mag_fused``, against a float64 golden;
     - hop < N (hop 8192, 128 spectra a channel a dispatch), BYPASS and
       CUSTOM: one spectrum kernel launch a dispatch, a float64 STFT golden
       within 1e-5, chunked == one-shot bitwise with the carried history;
     - a per-channel bank of 8 designs on noise: each channel within 0.05
       dB of its golden, chunked == one-shot bitwise, and the hybrid branch
       (launch counts) under ``fused_two_pass=True`` too;
     - ``SpectrumAnalyzer`` driven by command bytes (bypass + start, a 0xF1
       upload, CUSTOM, a rejected unstable upload, reset), a checkpoint
       restored mid-stream == uninterrupted, ``on_spectrum`` once a frame;
     - the receiver, ``Receiver(fs=1e6, center_hz=250e3, mode="wbfm",
       audio_rate=48e3)`` on 8 x 1,008,000 samples, real and IQ planes (no
       kernel of the port: all counts 0), then nbfm, am, usb, lsb, stereo
       and a 4-station ``ReceiverBank``: tones recovered, chunked ==
       one-shot bitwise, the bank == 4 receivers bitwise;
     - the Q15 path at the reference's width (1 channel, N = 16384, 6
       sections): ``Q15Pipeline`` all-device and split (filtered, bypass),
       two chunks of 2 frames with the state carried, the wire words equal
       to ``fft_q15_np(sosfilt_q15_intended(rtl_window_q15(x)))`` bit for
       bit (the CLI selftest's check); ``display_frame`` == the last frame;
       ``Q15Stream`` at depth 1 and 3 == sequential ``process()`` calls;
     - the host runtime: ``StreamFeeder`` over a ``SyntheticSource``
       feeding ``SpectrumPipeline.process`` (8 chunks of 8 x 131072) ==
       the chunks passed directly; ``WelchPSD.compute`` and ``compute_iq``
       against ``scipy.signal.welch`` in float64 within 1e-5 of the peak
       (mean and median, even and odd segment counts); ``decimate_db``'s
       five detectors against NumPy; the host-fed bank (64 x 16 frames a
       chunk from a ``PinnedRingSource`` of 4) == ``process`` on the
       device ring bit for bit, timed beside the staging path (a NumPy
       source) and the device-fed path, and the link's rate alone;
     - burst + FEC: 64 coded QPSK bursts (K = 7, rate 1/2, 2048 info bits,
       sps 8, starts 0..16 symbols into the capture, 14 dB) through
       ``BurstModem.demodulate``, ``modem_soft_bits`` and
       ``ConvCode.decode``: one K3 launch, BER 0, the frame lags right,
       batched == 64 single calls bit for bit;
     - ``FastFIR`` (1025 taps, real and complex on planes) on 8 channels x
       1,046,528 samples: within 1e-5 of max |y| of float64 lfilter,
       chunked == one-shot bit for bit; ``IQCorrector`` on (2, 8, 2^20)
       planes with 1 dB / 5 deg of imbalance: image rejection up by more
       than 25 dB, chunked == one-shot bit for bit; ``SpectrumScanner``
       on 1 s of the CLI's scan demo at 1 MSPS: exactly its four emitters;
     - the RDS chain of the GUI on 2 s of a 1 MSPS capture (a WBFM station
       with stereo MPX and RDS): DDC /5, ``FMDemodulator(use_pallas=True)``
       (one ``fm_demod`` launch), ``RDSDecoder``: PI, PS and RadioText equal
       to the encoder's and to the CPU decode;
     - the transport: ``Q15Pipeline`` (K1) -> ``frame_bytes_from_q15`` ->
       UDP on 127.0.0.1 -> ``UdpSpectrumReceiver``: the words bit for bit,
       the native framer's bytes equal to the NumPy framer's;
  5. timing with CUDA events: each kernel, its plain version and (where one
     PyTorch call computes the same function) the library yardstick at the
     main path's shape, and the least time the card could take for it
     (``fft_mag_fused`` and ``pfb_fold_dft`` also beside their dense
     tensor-core floors, ``fm_demod`` beside its chain's latency floor; the
     phases inside one launch of ``fm_demod``, ``pfb_fold_dft`` and
     ``iir_summaries`` from ``scripts/torch_spectrum_phases.py``); rows 1,
     2, 5 and 6 and their plain versions against a float64 reference (row 2
     from rest: window, ``sosfilt``, FFT; the kernel at most 1 dB below its
     plain version); each
     path's end-to-end dispatch time (the facade's with its device->host
     copy), compared paths in alternating turns; the Q15 kernels (K1 at F
     = 64 beside its INT32 bound, the operations its schedule needs
     (``q15_fft_int_ops``), at F = 1 beside its two floors, that count and
     its latency: 14 dependent butterflies, a read
     and a write of device memory, from ``tpu_sdr_q15_butterfly_probe``
     and ``tpu_sdr_q15_memory_probe``; at F = 1, 8, 64 its cycles a frame
     and route; K2 at 1 row x 2 frames beside its chain's latency floor, with
     its cycles a step and a sample, and at 4 rows), the Q15 paths' wall
     per 16384-sample chunk and ``Q15Stream``'s steady rate at depth 1; K3
     at the burst path's decode beside its latency floor (measured cycles
     of one dependent step of its warp route,
     ``tpu_sdr_viterbi_warp_step_probe``; and the block route's floor, a
     step and barrier, ``tpu_sdr_viterbi_step_probe``), its cycles a
     step, and at k = 12, and the new paths' walls; K1, K2 or K3 faster
     than a floor, or than the earlier designs' floor, by more than 5 % fails
     (the floor would be wrong);
  6. profile: each path's last traced dispatch as
     ``tpu_sdr_torch.bench.trace.capture_op_table`` attributes it (every
     device op charged to the dispatch that launched it, by the launch's
     correlation id): its device ops, busy and idle time, and the device's
     idle share against the untraced wall of phase 5; the port's kernels
     seen against their wrappers' launch counts. The steps of one K1
     launch (the split Q15 path, filtered and bypass, and the transport)
     and the all-device Q15 step (K2 and K1) are profiled first of all,
     right after the build, where every launch must be seen (a capture
     that loses one is taken again, three times at most); the paths of
     thousands of launches are profiled last;
  7. small dispatches: CUSTOM at 1 channel x 1 and x 4 frames, wall and
     device time, beside the bench shape's of phases 5 and 6;
  8. the web GUI: ``GuiBackend(device="cuda")`` served on 127.0.0.1 and
     read over SSE while it runs BYPASS, FIXED, CUSTOM (the designer's
     preview and apply), the Q15 tap, an IQ source and the zoom: frames
     delivered and samples acquired a second, each wrapper's launches; the
     tap's wire frame against the NumPy oracle chain bit for bit; the
     scan, burst, RDS and roofline routes; any status event with ok=False
     (the tap's watchdog among them) fails;
  9. the full chain: command bytes -> ``SpectrumAnalyzer`` (1 channel x
     16384) -> UDP on 127.0.0.1 -> ``UdpSpectrumReceiver``, decoded within
     0.5 of rint of the analyzer's magnitudes, the filter acting over the
     wire; a checkpoint through files and back, bit for bit;
  10. the CLI: ``selftest`` passes; ``trace`` is a device trace in which
     each port kernel of the dispatch appears as often as it was launched;
     ``bench`` prints a rate;
  11. the roofline: each timed spectrum path's samples/s (phase 5, and the
     CLI's bench) as a fraction of the H100's ceiling and serial floor in
     ``tpu_sdr_torch.bench.roofline``; a fraction of the ceiling above
     1.05 fails (the cost model would count too little).

  13. the sharded engines (``tpu_sdr_torch.shard``): 4 ranks spawned on
     the one card over Gloo (each collective staged through the host; NCCL
     refuses two ranks on one GPU), grids (1, 2), (2, 1) and (2, 2) (the
     2-rank grids sub-meshes of the group), at 8 channels x 64 frames:
     BYPASS, FIXED, CUSTOM, fused f32 CUSTOM, hop 8192, a per-channel bank
     and IQ input through ``ShardedSpectrumPipeline``, the channelizer's
     kernel path (row 8) and the wbfm ``ShardedReceiver``; in each rank
     the launch counts set to 0 just before two carried-state dispatches
     and read just after (rows 1, 2, 3, 5 and 8 must launch, no plain
     call), each rank's dispatch wall and collective calls, the device's
     idle share on CUSTOM and fused (profiler); rank 0 holds the gathered
     output and the final state against the single-device run on the card
     bit for bit. A failed or hung rank fails the phase (collectives time
     out; the group is killed after ``SHARD_JOIN_S``). Then
     ``LatencyPipeline`` on a 1-rank NCCL group in this process, within
     1e-5 of the throughput engine.

Phase 13 runs right after the build, phases 8-10 right after the
one-kernel profiles of phase 6, phase 11 at the end. Each kernel record
also carries ``shard_launches``: its launches in phase 13, every rank,
grid and path.

Prints one JSON line of kernel records, the card's name and power limit,
and as its last line {"ok": true, "device": {...}}. Needs one CUDA device;
exits non-zero without a result line when there is none.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import scipy.signal as sps
import torch

from tpu_sdr_torch.bench.roofline import CHIP_SPECS, bound, max_sm_mhz
from tpu_sdr_torch.bench.roofline import int32_ops_per_s as peak_int32_ops

# The H100's peaks (NVIDIA data sheet, dense, at the 700 W limit), from the
# port's cost model, which bound() uses too.
PEAK_BF16_FLOPS = CHIP_SPECS["h100"]["bf16_tflops"] * 1e12  # tensor cores, dense

N = 16384
CHANNELS, FRAMES = 8, 64  # bench.py's headline dispatch shape
DISPATCHES = 5
SNR_FLOOR_DB = {"float32": 120.0, "bfloat16": 45.0}
# iir_summaries: max |kernel - plain| over max |plain| of the frame-end states.
STATE_REL_TOL = 1e-5
# Its designs against the float64 chain: the pipelines' (CUSTOM, FIXED) and
# two narrow low-passes (5 and 1 kHz at 1 MHz), where the fp32 chain of the
# plain version drifts; the kernel (a direct product) no worse than it.
NARROW_SOS = {"butter(12, 0.01)": sps.butter(12, 0.01, output="sos"),
              "butter(12, 0.002)": sps.butter(12, 0.002, output="sos")}
# The fused path's magnitudes against the hybrid path's (the same function,
# the block prefix as a chain against a block-Toeplitz product).
FUSED_VS_HYBRID_DB = 100.0
KERNEL_FRAMES = (1, 8, CHANNELS * FRAMES)

JAX_KERNELS = "tpu_sdr/kernels/pallas/iir_fft.py"
RECORDS = {  # kernel source name -> the fixed fields of its JSON record
    "spectrum_bypass": dict(name="spectrum_from_state[bypass]", replaces=f"{JAX_KERNELS}:549"),
    "spectrum_iir": dict(name="spectrum_from_state[iir]", replaces=f"{JAX_KERNELS}:549"),
    "iir_summaries": dict(name="iir_summaries", replaces=f"{JAX_KERNELS}:509"),
    "spectrum_complex": dict(name="spectrum_mag_complex", replaces=f"{JAX_KERNELS}:447"),
    "fm_demod": dict(name="fm_demod_pallas",
                     replaces="tpu_sdr/kernels/pallas/affine_scan.py:138"),
    "pfb_fold_dft": dict(name="pfb_fold_dft", replaces="tpu_sdr/kernels/pallas/pfb_kernel.py:73"),
    # Row 4 launches row 1's kernel (the bypass form, timed) or row 2's
    # (the IIR form, in its own fields).
    "spectrum_half": dict(name="spectrum_from_state[half_spectrum]",
                          replaces=f"{JAX_KERNELS}:597",
                          source="tpu_sdr_torch/csrc/spectrum_bypass.cu",
                          iir_form_source="tpu_sdr_torch/csrc/spectrum_iir.cu"),
    "fft_mag_fused": dict(name="fft_mag_fused", replaces="tpu_sdr/kernels/pallas/spectrum.py:63"),
    # The Q15 path's two kernels replace jitted XLA code (no Pallas kernel).
    "q15_fft": dict(name="fft_q15 (window_fft_q15)", replaces="tpu_sdr/kernels/fft_q15.py:149"),
    "sosfilt_q15": dict(name="sosfilt_q15_scan (sosfilt_q15_window)",
                        replaces="tpu_sdr/kernels/biquad.py:746"),
    # K3 replaces the FEC decoder's jitted scans (no Pallas kernel).
    "viterbi": dict(name="_viterbi (ConvCode.decode)", replaces="tpu_sdr/kernels/fec.py:221"),
    # The composite IIR's state path replaces XLA products and a jitted
    # scan (no Pallas kernel).
    "iir_state": dict(name="sosfilt_blocked_composite[_bank] state path (frame_ends, "
                           "entry_states)", replaces="tpu_sdr/kernels/biquad.py:467"),
    # Its output step replaces the T product and _composite_emit's M
    # product and add.
    "iir_emit": dict(name="sosfilt_blocked_composite[_bank] output step (block_outputs)",
                     replaces="tpu_sdr/kernels/biquad.py:417"),
    # Its forcing step replaces the window multiply and P's product.
    "iir_force": dict(name="sosfilt_blocked_composite[_bank] forcing step (block_forcing)",
                      replaces="tpu_sdr/kernels/biquad.py:417"),
}

# The narrowband layer's shapes (scripts/ab_fm_pallas.py's FM dispatch).
NB_CH, NB_T = 8, 1 << 20  # 8 channels x 2^20 samples per dispatch
FM_FS, FM_DEV, FM_TAU, FM_TONE = 200e3, 75e3, 75e-6, 1e3
# The FM kernel's function, per sample: the discriminator (4 mul, 2 add),
# the polynomial atan2 (2 abs, max, min, a division, r^2, 8 Horner steps of
# 2, p*r, 2 octant subtractions, the sign: 25), the two scale multiplies,
# (1 - a) * audio, the 7-level tree (3 a level) and the emit (2): 57.
FM_FLOPS_PER_SAMPLE = 57
FM_KERNEL_ATOL = 1e-6  # the JAX kernel's own bound (tests/test_pallas_kernel.py)
CHAIN_CYCLES_PER_BLOCK = 8  # FMUL then FADD, 4 cycles each, a 128-sample block
FM_PATHS_ATOL = 2e-6  # kernel path vs default path (tests/test_demod.py)
PFB_M, PFB_TAPS = 128, 8
PFB_REL = 1e-5  # of max |re| (tests/test_pfb.py)
RX_FS, RX_CENTER, RX_AUDIO = 1e6, 250e3, 48e3
RX_T = 63 * 16_000  # 63 x the wbfm receiver's chunk granularity


def check(ok, what=""):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def snr_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref = ref.double()
    err = ((ref - got.double()) ** 2).sum().item()
    sig = (ref**2).sum().item()
    return float("inf") if err == 0 else 10 * np.log10(sig / err)


# Cycles a spin kernel holds the device while the host queues the timed
# calls (about 50 ms at the H100's clocks).
HOLD_CYCLES = 100_000_000


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` back-to-back calls. A spin
    kernel holds the device while the host queues them, so a call whose
    wrapper takes longer on the host than its kernels on the device is
    still timed by its device work (unless queueing outlasts the spin, as
    for a plain version that launches thousands of kernels)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def golden_magnitude(x: np.ndarray, sos, win: np.ndarray) -> np.ndarray:
    """float64 window -> sosfilt -> FFT -> |X| of one channel's frames (real
    or complex)."""
    dtype = np.complex128 if np.iscomplexobj(x) else np.float64
    xw = (x.astype(dtype).reshape(-1, N) * win).reshape(-1)
    y = xw if sos is None else sps.sosfilt(sos, xw)
    return np.abs(np.fft.fft(y.reshape(-1, N), axis=-1))


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(f"[1] device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
          f"| torch {torch.__version__} | CUDA {torch.version.cuda}")
    print(f"[1] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    print(f"[1] nvidia-smi: {smi}")
    return smi


def phase_build():
    from tpu_sdr_torch.kernels import native_q15
    from tpu_sdr_torch.kernels.cuda import launch, loader
    from tpu_sdr_torch.transport import native as framer

    host = {"q15_filter (host C++)": native_q15.build, "framer (host C++)": framer.build}

    def build(name):
        t0 = time.perf_counter()
        log = host[name](force=True) if name in host else loader.build(name, force=True)
        return name, time.perf_counter() - t0, log

    names = (*launch.KERNELS, *host)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(build, names))
    print(f"[2] built {len(launch.KERNELS)} kernel libraries, the native Q15 filter and the "
          f"native framer in {time.perf_counter() - t0:.2f} s (nvcc and the host C++ compiler, "
          f"in parallel)")
    for name, seconds, log in built:
        print(f"[2] {name}: {seconds:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[2]   {line.strip()}")


def _compare(tag: str, got, ref, floor_db: float) -> float:
    """Check got against ref at ``floor_db`` SNR; returns max |got - ref|."""
    torch.cuda.synchronize()
    check(got.shape == ref.shape and got.dtype == ref.dtype, (tag, got.shape, got.dtype))
    check(torch.isfinite(got.float()).all(), tag)
    snr = snr_db(ref.float(), got.float())
    diff = (got.float() - ref.float()).abs()
    rel = (diff.max() / ref.float().abs().max()).item()
    print(f"[3] {tag} snr={snr:6.1f} dB max_rel_err={rel:.2e}")
    check(snr >= floor_db, (tag, snr))
    return diff.max().item()


def phase_kernel_vs_plain(pp) -> dict:
    """Each kernel against its plain version; returns the max abs error of
    each at F = 512, fp32 in and out, as the main path calls it."""
    from tpu_sdr_torch.kernels.cuda import iir_fft

    rng = np.random.default_rng(0)
    errs = {}
    for F in KERNEL_FRAMES:
        main = F == CHANNELS * FRAMES
        x32 = torch.as_tensor(rng.standard_normal((F, N)), dtype=torch.float32).cuda()
        x32i = torch.as_tensor(rng.standard_normal((F, N)), dtype=torch.float32).cuda()
        zs = torch.as_tensor(0.1 * rng.standard_normal((F, 12)), dtype=torch.float32).cuda()
        for in_dtype in (torch.float32, torch.bfloat16):
            x, xi = x32.to(in_dtype), x32i.to(in_dtype)
            for apply_window in (True, False):
                for out_dtype in ("float32", "bfloat16"):
                    tag = (f"F={F:3d} in={str(in_dtype)[6:]:8s} window={apply_window!s:5s} "
                           f"out={out_dtype:8s}")
                    err = _compare(
                        f"spectrum_bypass  {tag}",
                        iir_fft.spectrum_bypass_cuda(x, pp, apply_window, out_dtype),
                        iir_fft.spectrum_bypass_plain(x, pp, apply_window, out_dtype),
                        SNR_FLOOR_DB[out_dtype])
                    if main and in_dtype == torch.float32 and not apply_window and out_dtype == "float32":
                        errs["spectrum_bypass"] = err
                    err = _compare(
                        f"spectrum_complex {tag}",
                        iir_fft.spectrum_complex_cuda(x, xi, pp, apply_window, out_dtype),
                        iir_fft.spectrum_complex_plain(x, xi, pp, apply_window, out_dtype),
                        SNR_FLOOR_DB[out_dtype])
                    if main and in_dtype == torch.float32 and not apply_window and out_dtype == "float32":
                        errs["spectrum_complex"] = err
        for apply_window in (True, False):
            tag = f"F={F:3d} in=float32  window={apply_window!s:5s} out=float32 "
            err = _compare(
                f"spectrum_iir     {tag}",
                iir_fft.spectrum_iir_cuda(x32, zs, pp, apply_window),
                iir_fft.spectrum_iir_plain(x32, zs, pp, apply_window),
                SNR_FLOOR_DB["float32"])
            if main and apply_window:
                errs["spectrum_iir"] = err
        got = iir_fft.iir_summaries_cuda(x32, pp)
        ref = iir_fft.iir_summaries_plain(x32, pp)
        torch.cuda.synchronize()
        check(got.shape == (F, 12) and torch.isfinite(got).all(), "iir_summaries")
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        print(f"[3] iir_summaries    F={F:3d} in=float32  window=True  max_rel_err={rel:.2e} "
              f"(max |state| {ref.abs().max().item():.3e})")
        check(rel <= STATE_REL_TOL, ("iir_summaries", F, rel))
        if main:
            errs["iir_summaries"] = (got - ref).abs().max().item()
    return errs


# The IIR state kernel (``csrc/iir_state.cu``) and the GEMM form it replaces:
# a bank of 64 of bank64's designs x 16 frames (the benchmark's chunk) and
# one shared design x 512 frames (the call shape of this file's 8 x 64
# dispatch). The kernel against its plain version and the GEMM form, of the
# reference's largest |state|: tests/test_torch_cuda.py's STATE_KERNEL_REL.
IIR_STATE_SHAPES = {"bank 64 x 16": (64, 16), "shared 1 x 512": (1, 512)}
IIR_STATE_REL = 1e-6


def phase_iir_state() -> tuple[dict, dict]:
    """[3] and [5] for the IIR state kernel: against its plain version and
    the GEMM form at IIR_STATE_SHAPES, two launches a dispatch, chunked ==
    one-shot, and their times beside the bound of what the function needs
    (the triangular sums, each frame's end and the chain; the forcing read
    and the entry states written once, each row's powers read once).
    Returns ({"iir_state": max |kernel - plain|}, {"iir_state": timing at
    the bank shape, the shared shape's under "shared"})."""
    from sdrbench import inputs, spec
    from tpu_sdr_torch.kernels import biquad
    from tpu_sdr_torch.kernels.cuda import launch

    errs, timing = {}, {}
    for label, (C, F) in IIR_STATE_SHAPES.items():
        if C > 1:
            bank64 = spec.find_cell(spec.load_benchmark(), "bank64.custom.sat").config
            op = biquad.precompute_composite_bank(inputs.make_designs(bank64, 64)[:C],
                                                  device="cuda")
            calls = biquad.bank_frames(C)
        else:
            op = biquad.precompute_composite(sps.butter(12, 0.25, output="sos"), device="cuda")
            calls = biquad.CANONICAL_FRAMES
        gen = torch.Generator(device="cuda").manual_seed(C * 1000 + F)
        v = torch.randn((C, F, 128, 128), device="cuda", generator=gen)
        z = torch.randn((C, 12), device="cuda", generator=gen)
        f = biquad._composite_products(op, v, calls)[1].contiguous()
        # What the state kernel replaces, from the forcing f: the port's GEMM
        # form, on the operator given the W that the card's build leaves out.
        gop = dataclasses.replace(op, W=biquad.block_toeplitz(op))
        gemm_state_path = lambda: biquad.gemm_state_path(gop, f, z, calls)
        launch.reset_counts()
        w = biquad.frame_ends(op, f)
        z_in, zf = biquad.entry_states(op, f, z, w)
        torch.cuda.synchronize()
        counts = {kind: launch.counts[kind]["iir_state"] for kind in ("kernel", "plain")}
        check(counts == {"kernel": 2, "plain": 0}, (label, counts))
        pw = biquad.frame_ends_plain(op, f)
        pz_in, pzf = biquad.entry_states_plain(op, f, z, pw)
        gz_in, gzf = gemm_state_path()
        rel = lambda got, ref: ((got - ref).abs().max() / ref.abs().max()).item()
        gaps = {"w": rel(w, pw), "z_in": rel(z_in, pz_in), "zf": rel(zf, pzf),
                "z_in vs GEMM": rel(z_in, gz_in), "zf vs GEMM": rel(zf, gzf)}
        h = F // 2 + 3
        parts, zc = [], z
        for part in (f[:, :h].contiguous(), f[:, h:].contiguous()):
            zp, zc = biquad.entry_states(op, part, zc, biquad.frame_ends(op, part))
            parts.append(zp)
        bitwise = torch.equal(torch.cat(parts, dim=1), z_in) and torch.equal(zc, zf)
        print(f"[3] iir_state {label}: launches {counts['kernel']} (plain {counts['plain']}); "
              f"of the reference's max |state|: "
              + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
              + f" (tol {IIR_STATE_REL}); chunked ({h} + {F - h} frames) == one-shot: {bitwise}")
        check(max(gaps.values()) <= IIR_STATE_REL and bitwise, (label, gaps, bitwise))
        if C > 1:
            errs["iir_state"] = float((z_in - pz_in).abs().max())
        sets = C if op.APow.ndim == 4 else 1
        b = bound(4 * (2 * f.numel() + sets * 128 * 144 + 2 * C * F * 12 + 2 * C * 12),
                  2 * C * F * 144 * (128 * 129 / 2 + 128 + 1))
        kernel = lambda: biquad.entry_states(op, f, z, biquad.frame_ends(op, f))
        t = {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(lambda: biquad.entry_states_plain(
                 op, f, z, biquad.frame_ends_plain(op, f)), iters=2, warmup=1),
             "library_ms": None, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
             "ends_ms": cuda_ms(lambda: biquad.frame_ends(op, f)),
             "entries_ms": cuda_ms(lambda: biquad.entry_states(op, f, z, w)),
             "gemm_form_ms": cuda_ms(gemm_state_path, iters=5, warmup=1)}
        print(f"[5] iir_state {label}: kernel {t['ms']:.4f} ms (frame_ends {t['ends_ms']:.4f}, "
              f"entry_states {t['entries_ms']:.4f}); plain {t['plain_ms']:.4f} ms; the GEMM form "
              f"it replaces {t['gemm_form_ms']:.4f} ms; bound {b['bound_ms']:.4f} ms by "
              f"{b['bound_by']} ({b['bytes'] / 1e6:.1f} MB, {b['flops'] / 1e9:.3f} GFLOP fp32) "
              f"-> kernel at {b['bound_ms'] / t['ms']:.1%} of the bound; {profiled(kernel)}; "
              f"GEMM form: {profiled(gemm_state_path)}")
        if C > 1:
            timing["iir_state"] = t
        else:
            timing["iir_state"]["shared"] = t
    return errs, timing


# The IIR emit kernel (``csrc/iir_emit.cu``) at the state kernel's shapes,
# against its plain version and the GEMM form it replaces (the T and M
# products at their canonical call shapes and the add), of the reference's
# largest |y|: tests/test_torch_cuda.py's EMIT_KERNEL_REL.
IIR_EMIT_REL = 1e-6


def phase_iir_emit() -> tuple[dict, dict]:
    """[3] and [5] for the IIR emit kernel at IIR_STATE_SHAPES: against its
    plain version and the GEMM form, one launch, chunked == one-shot, and
    its time beside the GEMM form's and the bound of what the function needs
    (the input and the entry states read and the output written once, each
    row's h and M read once; the triangle's 128 x 129 / 2 and the z term's
    128 x 12 FMAs a block). Returns ({"iir_emit": max |kernel - plain|},
    {"iir_emit": timing at the bank shape, the shared shape's under
    "shared"})."""
    from sdrbench import inputs, spec
    from tpu_sdr_torch.kernels import biquad
    from tpu_sdr_torch.kernels.cuda import launch

    errs, timing = {}, {}
    for label, (C, F) in IIR_STATE_SHAPES.items():
        if C > 1:
            bank64 = spec.find_cell(spec.load_benchmark(), "bank64.custom.sat").config
            op = biquad.precompute_composite_bank(inputs.make_designs(bank64, 64)[:C],
                                                  device="cuda")
            calls = biquad.bank_frames(C)
        else:
            op = biquad.precompute_composite(sps.butter(12, 0.25, output="sos"), device="cuda")
            calls = biquad.CANONICAL_FRAMES
        gen = torch.Generator(device="cuda").manual_seed(C * 1000 + F + 1)
        v = torch.randn((C, F, 128, 128), device="cuda", generator=gen)
        z = torch.randn((C, F, 128, 12), device="cuda", generator=gen)
        # What the emit kernel replaces: y_zs = v T^T, z_in M^T and their sum.
        rows = calls * 128
        gemm_form = lambda: (biquad._canonical_matmul(v, op.T.mT, rows)
                             + biquad._canonical_matmul(z, op.M.mT, rows))
        launch.reset_counts()
        y = biquad.block_outputs(op, v, z)
        torch.cuda.synchronize()
        counts = {kind: launch.counts[kind]["iir_emit"] for kind in ("kernel", "plain")}
        check(counts == {"kernel": 1, "plain": 0}, (label, counts))
        plain = biquad.block_outputs_plain(op, v, z)
        rel = lambda got, ref: ((got - ref).abs().max() / ref.abs().max()).item()
        gaps = {"plain": rel(y, plain), "GEMM form": rel(y, gemm_form())}
        h = F // 2 + 3
        parts = [biquad.block_outputs(op, v[:, a:b].contiguous(), z[:, a:b].contiguous())
                 for a, b in ((0, h), (h, F))]
        bitwise = torch.equal(torch.cat(parts, dim=1), y)
        print(f"[3] iir_emit {label}: launches {counts['kernel']} (plain {counts['plain']}); of "
              f"the reference's max |y|: " + ", ".join(f"{k} {e:.2e}" for k, e in gaps.items())
              + f" (tol {IIR_EMIT_REL}); chunked ({h} + {F - h} frames) == one-shot: {bitwise}")
        check(max(gaps.values()) <= IIR_EMIT_REL and bitwise, (label, gaps, bitwise))
        if C > 1:
            errs["iir_emit"] = float((y - plain).abs().max())
        sets = C if op.T.ndim == 3 else 1
        b = bound(4 * (2 * v.numel() + z.numel() + sets * 128 * (1 + 12)),
                  2 * C * F * 128 * (128 * 129 / 2 + 128 * 12))
        kernel = lambda: biquad.block_outputs(op, v, z)
        plain_ms = cuda_ms(lambda: biquad.block_outputs_plain(op, v, z), iters=2, warmup=1)
        t = {"ms": cuda_ms(kernel), "plain_ms": plain_ms,
             "library_ms": None, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
             "gemm_form_ms": cuda_ms(gemm_form, iters=5, warmup=1)}
        print(f"[5] iir_emit {label}: kernel {t['ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; the "
              f"GEMM form it replaces {t['gemm_form_ms']:.4f} ms; bound {b['bound_ms']:.4f} ms by "
              f"{b['bound_by']} ({b['bytes'] / 1e6:.1f} MB, {b['flops'] / 1e9:.3f} GFLOP fp32) -> "
              f"kernel at {b['bound_ms'] / t['ms']:.1%} of the bound; {profiled(kernel)}; GEMM "
              f"form: {profiled(gemm_form)}")
        if C > 1:
            timing["iir_emit"] = t
        else:
            timing["iir_emit"]["shared"] = t
    return errs, timing


# The IIR forcing pass (``csrc/iir_force.cu``): bank64's chunk, a pod card's
# chunk and one frame of a shared design, against its plain version, of the
# reference's largest |f| (tests/test_torch_iir_force.py's
# FORCE_KERNEL_REL), and timed beside what it replaces: the eager window
# multiply and P's product in canonical calls.
IIR_FORCE_SHAPES = {"bank 64 x 16": (64, 16), "pod card 64 x 256": (64, 256),
                    "shared 1 x 1": (1, 1)}
IIR_FORCE_REL = 1e-6


def phase_iir_force() -> tuple[dict, dict]:
    """[3] and [5] for the IIR forcing pass at IIR_FORCE_SHAPES, with the
    window: one launch; xw equal to ``torch.mul``'s bits; f against its
    plain version and the GEMM form at every shape (the plain version timed
    up to 64 x 16); the pass without the window (xw then x's own view);
    chunked == one-shot; and its time beside
    the eager window multiply and P's canonical GEMMs and the bound of what
    it moves (x read, xw and f written once, each row's P and the window
    read once). Returns ({"iir_force": max |kernel - plain| at 64 x 16},
    {"iir_force": timing at 64 x 16, the other shapes' under "pod" and
    "single"})."""
    from sdrbench import inputs, spec
    from tpu_sdr_torch.kernels import biquad, window
    from tpu_sdr_torch.kernels.cuda import launch

    errs, timing = {}, {}
    w = window.hann_coefficients(N, device="cuda")
    for label, (C, F) in IIR_FORCE_SHAPES.items():
        if C > 1:
            bank64 = spec.find_cell(spec.load_benchmark(), "bank64.custom.sat").config
            op = biquad.precompute_composite_bank(inputs.make_designs(bank64, 64)[:C],
                                                  device="cuda")
        else:
            op = biquad.precompute_composite(sps.butter(12, 0.25, output="sos"), device="cuda")
        calls = biquad.cascade_frames(op) * 128
        gen = torch.Generator(device="cuda").manual_seed(C * 1000 + F + 2)
        x = torch.randn((C, F * N), device="cuda", generator=gen)
        # What the pass replaces: the window multiply, then P's product in
        # canonical calls, with P in the host build's layout, as it was read.
        p_host = op.P.mT.contiguous().mT
        gemm_form = lambda: biquad._canonical_matmul(
            biquad.blocked(op, (x.reshape(C, F, N) * w).reshape(C, -1)), p_host.mT, calls)
        launch.reset_counts()
        xw, f = biquad.block_forcing(op, x, w)
        torch.cuda.synchronize()
        counts = {kind: launch.counts[kind]["iir_force"] for kind in ("kernel", "plain")}
        check(counts == {"kernel": 1, "plain": 0}, (label, counts))
        window_bits = torch.equal(xw, biquad.blocked(op, (x.reshape(C, F, N) * w).reshape(C, -1)))
        rel = lambda got, ref: ((got - ref).abs().max() / ref.abs().max()).item()
        gaps = {"GEMM form": rel(f, gemm_form())}
        raw_xw, raw_f = biquad.block_forcing(op, x)
        raw_view = raw_xw.data_ptr() == x.data_ptr()
        pxw, pf = biquad.block_forcing_plain(op, x, w)
        gaps["plain"] = rel(f, pf)
        gaps["plain, no window"] = rel(raw_f, biquad.block_forcing_plain(op, x)[1])
        check(torch.equal(xw, pxw), (label, "xw != the plain version's"))
        if label.startswith("bank"):
            errs["iir_force"] = float((f - pf).abs().max())
        del pxw, pf
        h = F // 2 + 1  # one frame: no split, the one-shot pass again
        parts = [biquad.block_forcing(op, xc, w)
                 for xc in (x.split([h * N, (F - h) * N], -1) if F > 1 else (x,))]
        bitwise = (torch.equal(torch.cat([p[0] for p in parts], dim=-3), xw)
                   and torch.equal(torch.cat([p[1] for p in parts], dim=-3), f))
        print(f"[3] iir_force {label}: launches {counts['kernel']} (plain {counts['plain']}); xw "
              f"== torch.mul bit for bit: {window_bits}; without the window xw is x's view: "
              f"{raw_view}; of the reference's max |f|: "
              + ", ".join(f"{k} {e:.2e}" for k, e in gaps.items())
              + f" (tol {IIR_FORCE_REL} against the plain version); chunked ({h} + {F - h} "
              f"frames) == one-shot: {bitwise}")
        check(window_bits and raw_view and bitwise, (label, window_bits, raw_view, bitwise))
        check(all(e <= IIR_FORCE_REL for k, e in gaps.items() if k != "GEMM form"), (label, gaps))
        sets = C if op.P.ndim == 3 else 1
        b = bound(4 * (2 * x.numel() + f.numel() + sets * 12 * 128 + N),
                  x.numel() + 2 * f.numel() * 128)
        kernel = lambda: biquad.block_forcing(op, x, w)
        t = {"ms": cuda_ms(kernel), "library_ms": None, "bound_ms": b["bound_ms"],
             "bound_by": b["bound_by"], "gemm_form_ms": cuda_ms(gemm_form, iters=5, warmup=1),
             "window_ms": cuda_ms(lambda: x.reshape(C, F, N) * w, iters=5, warmup=1),
             "raw_ms": cuda_ms(lambda: biquad.block_forcing(op, x))}
        t["plain_ms"] = (cuda_ms(lambda: biquad.block_forcing_plain(op, x, w), iters=2, warmup=1)
                         if C * F <= 64 * 16 else None)
        plain = "not timed" if t["plain_ms"] is None else f"{t['plain_ms']:.4f} ms"
        print(f"[5] iir_force {label}: kernel {t['ms']:.4f} ms (without the window "
              f"{t['raw_ms']:.4f}); plain {plain}; what it replaces, the window multiply and "
              f"P's GEMMs in calls of {calls} rows, {t['gemm_form_ms']:.4f} ms (the multiply "
              f"alone {t['window_ms']:.4f}); bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
              f"({b['bytes'] / 1e6:.1f} MB, {b['flops'] / 1e9:.3f} GFLOP fp32) -> kernel at "
              f"{b['bound_ms'] / t['ms']:.1%} of the bound; {profiled(kernel)}; replaced: "
              f"{profiled(gemm_form)}")
        if label.startswith("bank"):
            timing["iir_force"] = t
        else:
            timing["iir_force"]["pod" if C > 1 else "single"] = t
    return errs, timing


def summaries64(x: torch.Tensor, pp) -> torch.Tensor:
    """iir_summaries in float64 on the plan's own fp32 constants: window,
    forcing, the block chain from rest."""
    AL, P = pp.AL1T.double().T, pp.PT.double().T
    xw = x.double() * pp.win.double().reshape(-1)
    z = torch.zeros((x.shape[0], pp.state_dim), dtype=torch.float64, device=x.device)
    for j in range(pp.win.shape[0]):
        z = z @ AL.T + xw[:, 128 * j : 128 * (j + 1)] @ P.T
    return z


def phase_summaries_accuracy(pp):
    """Row 3 against the float64 chain at F = 512 on the pipelines' designs
    (also within STATE_REL_TOL of plain there) and the narrow low-passes:
    the kernel's max error over max |state| at most the plain version's."""
    from tpu_sdr_torch.control import golden
    from tpu_sdr_torch.kernels import fft, window
    from tpu_sdr_torch.kernels.cuda import iir_fft

    F = CHANNELS * FRAMES
    x = torch.as_tensor(np.random.default_rng(9).standard_normal((F, N)), dtype=torch.float32,
                        device="cuda")
    win = window.hann_coefficients(N, device="cuda")
    fplan = fft.plan_constants(128, 128, device="cuda")
    designs = {"CUSTOM butter(12, 0.25)": (pp, True),
               "FIXED": (iir_fft.build_plan(golden.fixed_filter_sos(), win, fplan), True),
               **{k: (iir_fft.build_plan(v, win, fplan), False) for k, v in NARROW_SOS.items()}}
    for name, (plan, today) in designs.items():
        ref = summaries64(x, plan)
        got, plain = iir_fft.iir_summaries_cuda(x, plan), iir_fft.iir_summaries_plain(x, plan)
        torch.cuda.synchronize()
        err = lambda t: ((t.double() - ref).abs().max() / ref.abs().max()).item()
        vs_plain = ((got - plain).abs().max() / plain.abs().max()).item()
        print(f"[3] iir_summaries F={F} {name:22s} vs float64: kernel {err(got):.3e}, plain "
              f"{err(plain):.3e} (max |state| {ref.abs().max().item():.3e}); kernel vs plain "
              f"{vs_plain:.2e}" + (f" (tol {STATE_REL_TOL})" if today else ""))
        check(err(got) <= err(plain), ("iir_summaries vs float64", name, err(got), err(plain)))
        check(not today or vs_plain <= STATE_REL_TOL, ("iir_summaries vs plain", name, vs_plain))


TONE_BINS = (1638, 4096)  # ~100 kHz (CUSTOM passband), 250 kHz (FIXED passband)


def two_tone(rng) -> np.ndarray:
    n = np.arange(FRAMES * N)
    tone = sum(0.4 * np.sin(2 * np.pi * k * n / N) for k in TONE_BINS)
    noise = 1e-3 * rng.standard_normal((CHANNELS, FRAMES * N))
    return (tone[None, :] + noise).astype(np.float32)


def two_tone_iq(rng) -> np.ndarray:
    """Complex tones at +TONE_BINS (nothing at -f) plus complex noise."""
    n = np.arange(FRAMES * N)
    tone = sum(0.4 * np.exp(2j * np.pi * k * n / N) for k in TONE_BINS)
    noise = 1e-3 * (rng.standard_normal((CHANNELS, FRAMES * N))
                    + 1j * rng.standard_normal((CHANNELS, FRAMES * N)))
    return (tone[None, :] + noise).astype(np.complex64)


def check_golden(tag: str, mag: torch.Tensor, x_np: np.ndarray, sos) -> list:
    """Channel 0, first two frames of a dispatch's magnitudes vs float64:
    each tone the filter passes (golden above -60 dB of the maximum) peaks
    at the golden's bin within 1 dB, and so do all bins above -60 dB.
    Returns the peak bins."""
    from tpu_sdr_torch.control import golden

    check(mag.shape == (CHANNELS, FRAMES, N) and mag.dtype == torch.float32, tag)
    ref = golden_magnitude(x_np[0, : 2 * N], sos, golden.hann_true(N))
    got = mag[0, :2].double().cpu().numpy()
    db = lambda a: 20 * np.log10(np.maximum(a, 1e-12))
    peaks = []
    for k in TONE_BINS:
        lo = k - 3
        ref_pk = lo + int(np.argmax(ref[0, lo : k + 4]))
        if ref[0, ref_pk] < ref.max() * 1e-3:
            continue
        check(lo + int(np.argmax(got[0, lo : k + 4])) == ref_pk, (tag, k))
        peaks.append(ref_pk)
    check(peaks, tag)
    peak_db = np.abs(db(got[:, peaks]) - db(ref[:, peaks])).max()
    mask = ref > ref.max() * 1e-3
    contract_db = np.abs(db(got[mask]) - db(ref[mask])).max()
    print(f"[4] {tag}: peaks at bins {peaks} within {peak_db:.4f} dB, "
          f"bins above -60 dB within {contract_db:.4f} dB")
    check(peak_db < 1.0 and contract_db < 1.0, tag)
    return peaks


def run_dispatches(run, x, state) -> tuple[list, object]:
    """DISPATCHES calls of run(x, state, ...) on a carried state."""
    outs = []
    for _ in range(DISPATCHES):
        out, state = run(x, state)
        outs.append(out["magnitude"])
    torch.cuda.synchronize()
    check(all(torch.isfinite(o).all() for o in outs))
    return outs, state


def check_counts(tag: str, expected: dict):
    """Every kernel launched exactly as ``expected`` (others 0), and no
    plain version ran."""
    from tpu_sdr_torch.kernels.cuda import launch

    launched = launch.counts["kernel"]
    want = {k: expected.get(k, 0) for k in launched}
    check(launched == want, (tag, launched, want))
    check(not any(launch.counts["plain"].values()), (tag, launch.counts["plain"]))


def phase_main_path(pipe, x_np: np.ndarray, sos_custom) -> int:
    """The default (hybrid) path; returns the spectrum kernel's launches."""
    from tpu_sdr_torch import FilterMode
    from tpu_sdr_torch.control import golden
    from tpu_sdr_torch.kernels.cuda import iir_fft

    x = torch.as_tensor(x_np, device="cuda")
    golden_sos = {FilterMode.CUSTOM: sos_custom, FilterMode.FIXED: golden.fixed_filter_sos(),
                  FilterMode.BYPASS: None}
    iir_fft.reset_counts()
    for k, mode in enumerate((FilterMode.CUSTOM, FilterMode.FIXED, FilterMode.BYPASS), start=1):
        outs, st = run_dispatches(lambda a, s: pipe.process(a, s, mode), x, pipe.initial_state())
        check_counts(mode.name, {"spectrum_bypass": k * DISPATCHES,
                                 "iir_state": 2 * DISPATCHES * min(k, 2),
                                 "iir_emit": DISPATCHES * min(k, 2),
                                 "iir_force": DISPATCHES * min(k, 2)})
        check(int(st.frame_count) == DISPATCHES * FRAMES and int(st.window_phase) == 0)
        check_golden(f"{mode.name:6s} {DISPATCHES} dispatches, spectrum_bypass launches "
                     f"{DISPATCHES}, plain 0", outs[0], x_np, golden_sos[mode])
    return iir_fft.counts["kernel"]["spectrum_bypass"]


def chunked_vs_oneshot(run, x, state, chunks: int = 4):
    """(one-shot magnitudes, one-shot state, chunked magnitudes, chunked
    state) of run(x, state) against ``chunks`` calls on a carried state."""
    one, st_one = run(x, state())
    st = state()
    parts = []
    for chunk in torch.chunk(x, chunks, dim=-1):
        out, st = run(chunk, st)
        parts.append(out["magnitude"])
    torch.cuda.synchronize()
    return one["magnitude"], st_one, torch.cat(parts, dim=-2), st


def phase_chunked(pipe, x_np: np.ndarray):
    from tpu_sdr_torch import FilterMode

    x = torch.as_tensor(x_np, device="cuda")
    one, st_one, chunked, st = chunked_vs_oneshot(
        lambda a, s: pipe.process(a, s, FilterMode.CUSTOM), x, pipe.initial_state)
    bitwise = torch.equal(chunked, one) and torch.equal(st.sos_state, st_one.sos_state)
    dev = ((chunked - one).abs().max() / one.abs().max()).item()
    sdev = (st.sos_state - st_one.sos_state).abs().max().item()
    print(f"[4] chunked (4 x {FRAMES // 4} frames) vs one-shot ({FRAMES} frames), CUSTOM: "
          f"bitwise={bitwise} max_rel_dev={dev:.3e} state_max_abs_dev={sdev:.3e}")
    check(bitwise or dev <= 1e-6, dev)


def fused_pipes(sos_custom) -> dict:
    """tier -> (fused pipeline, hybrid pipeline), CUSTOM bank loaded."""
    from tpu_sdr_torch import PipelineConfig, SpectrumPipeline

    pipes = {}
    for tier in ("f32", "f32max"):
        pair = tuple(SpectrumPipeline(PipelineConfig(channels=CHANNELS, dtype=tier,
                                                     fused_two_pass=fused))
                     for fused in (True, False))
        for p in pair:
            p.upload_sos(sos_custom)
        pipes[tier] = pair
    return pipes


def phase_fused(pipes: dict, x_np: np.ndarray, sos_custom) -> dict:
    """The fused two-pass path; returns the launches of its two kernels."""
    from tpu_sdr_torch import FilterMode
    from tpu_sdr_torch.control import golden
    from tpu_sdr_torch.kernels.cuda import iir_fft

    x = torch.as_tensor(x_np, device="cuda")
    golden_sos = {FilterMode.CUSTOM: sos_custom, FilterMode.FIXED: golden.fixed_filter_sos()}
    iir_fft.reset_counts()
    k = 0
    first = {}
    for tier, (fused, _) in pipes.items():
        for mode in (FilterMode.CUSTOM, FilterMode.FIXED):
            k += 1
            outs, st = run_dispatches(lambda a, s: fused.process(a, s, mode), x,
                                      fused.initial_state())
            check_counts(f"fused {tier} {mode.name}",
                         {"iir_summaries": k * DISPATCHES, "spectrum_iir": k * DISPATCHES})
            check(int(st.frame_count) == DISPATCHES * FRAMES)
            check_golden(f"fused {tier:6s} {mode.name:6s} {DISPATCHES} dispatches, "
                         f"iir_summaries and spectrum_iir launches {DISPATCHES} each, plain 0",
                         outs[0], x_np, golden_sos[mode])
            first[tier, mode] = outs[0]
    launches = {name: iir_fft.counts["kernel"][name] for name in ("iir_summaries", "spectrum_iir")}
    for tier, (fused, hybrid) in pipes.items():
        one, st_one, chunked, st = chunked_vs_oneshot(
            lambda a, s: fused.process(a, s, FilterMode.CUSTOM), x, fused.initial_state)
        bitwise = torch.equal(chunked, one) and torch.equal(st.sos_state, st_one.sos_state)
        print(f"[4] fused {tier:6s} chunked (4 x {FRAMES // 4} frames) vs one-shot, CUSTOM: "
              f"bitwise={bitwise}")
        check(bitwise, ("fused chunked", tier))
        for mode in (FilterMode.CUSTOM, FilterMode.FIXED):
            ref, _ = hybrid.process(x, hybrid.initial_state(), mode)
            snr = snr_db(ref["magnitude"], first[tier, mode])
            print(f"[4] fused {tier:6s} {mode.name:6s} vs hybrid: snr={snr:.1f} dB")
            check(snr >= FUSED_VS_HYBRID_DB, ("fused vs hybrid", tier, mode, snr))
    return launches


def phase_iq(pipe, xc_np: np.ndarray, sos_custom) -> int:
    """Complex input through process and process_planes; returns the
    complex kernel's launches."""
    from tpu_sdr_torch import FilterMode
    from tpu_sdr_torch.kernels.cuda import iir_fft

    xc = torch.as_tensor(xc_np, device="cuda")
    planes = torch.stack([xc.real, xc.imag])
    state = lambda: pipe.initial_state(batch_shape=(2,))
    golden_sos = {FilterMode.CUSTOM: sos_custom, FilterMode.BYPASS: None}
    iir_fft.reset_counts()
    k = 0
    for mode in (FilterMode.BYPASS, FilterMode.CUSTOM):
        k += 2
        outs, st = run_dispatches(lambda a, s: pipe.process(a, s, mode), xc, state())
        p_outs, p_st = run_dispatches(lambda a, s: pipe.process_planes(a, s, mode), planes,
                                      state())
        check_counts(f"IQ {mode.name}", {"spectrum_complex": k * DISPATCHES,
                                         "iir_state": 2 * (k - 2) * DISPATCHES,
                                         "iir_emit": (k - 2) * DISPATCHES,
                                         "iir_force": (k - 2) * DISPATCHES})
        check(int(st.frame_count) == DISPATCHES * FRAMES)
        same = all(torch.equal(a, b) for a, b in zip(outs, p_outs)) and torch.equal(
            st.sos_state, p_st.sos_state)
        check(same, ("process == process_planes", mode))
        peaks = check_golden(f"IQ {mode.name:6s} {DISPATCHES} dispatches each through process "
                             f"and process_planes, spectrum_complex launches "
                             f"{2 * DISPATCHES}, plain 0, process == process_planes bitwise "
                             f"{same}", outs[0], xc_np, golden_sos[mode])
        mag = outs[0][0, 0]
        image = max(mag[N - p].item() / mag[p].item() for p in peaks)
        print(f"[4] IQ {mode.name:6s} image at -f over peak at +f: {image:.2e}")
        check(image < 1e-3, ("IQ single-sided", mode, image))
    launches = iir_fft.counts["kernel"]["spectrum_complex"]
    for mode in (FilterMode.BYPASS, FilterMode.CUSTOM):
        one, st_one, chunked, st = chunked_vs_oneshot(
            lambda a, s: pipe.process(a, s, mode), xc, state)
        bitwise = torch.equal(chunked, one) and torch.equal(st.sos_state, st_one.sos_state)
        print(f"[4] IQ {mode.name:6s} chunked (4 x {FRAMES // 4} frames) vs one-shot: "
              f"bitwise={bitwise}")
        check(bitwise, ("IQ chunked", mode))
    return launches


def dispatch_wall(step, reps: int = 5, calls: int = 10,
                  warmup: int = 3) -> tuple[float, float, float]:
    """Host-clock seconds per call of step() (one dispatch on a carried
    state): median, min and max of ``reps`` reps of ``calls`` chained
    calls, after ``warmup``."""
    for _ in range(warmup):
        step()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / calls)
    return statistics.median(times), min(times), max(times)


# Per wrapper: its device kernels that end a launch, one per launch
# (csrc/<name>.cu; fm_demod runs its three passes in one kernel with
# de-emphasis, its discriminator alone without; viterbi its warp route up to
# k = 7, its block route above).
LAST_DEVICE_KERNEL = {
    "spectrum_bypass": ("spectrum_bypass_kernel",), "spectrum_iir": ("spectrum_iir_kernel",),
    "iir_summaries": ("iir_summaries_kernel",),
    "spectrum_complex": ("spectrum_complex_kernel",),
    "fm_demod": ("fm_fused_kernel", "fm_disc_kernel"),
    "pfb_fold_dft": ("pfb_fold_dft_kernel",),
    "spectrum_half": ("spectrum_bypass_kernel", "spectrum_iir_kernel"),
    "fft_mag_fused": ("fft_mag_fused_kernel",),
    "q15_fft": ("q15_fft_cluster_kernel", "q15_fft_block_kernel"),
    "sosfilt_q15": ("sosfilt_q15_kernel",),
    "viterbi": ("viterbi_warp_kernel", "viterbi_kernel"),
    "iir_state": ("iir_state_ends_kernel", "iir_state_entries_kernel"),
    "iir_emit": ("iir_emit_kernel",),
    "iir_force": ("iir_force_kernel",),
}


def op_table(step, reps: int = 3, tries: int = 1) -> dict:
    """``bench.trace.capture_op_table`` of ``reps`` calls of step(), each
    device op charged to the call that launched it, with "port": {wrapper:
    (launches seen in the recorded calls, launches made by the wrapper in
    them)} for each port kernel launched there. With ``tries`` > 1 a
    capture that saw fewer launches than were made (the profiler drops a
    session's events now and then) is taken again, up to ``tries`` times;
    "tries" says how many it took."""
    from tpu_sdr_torch.bench.trace import capture_op_table
    from tpu_sdr_torch.kernels.cuda import launch

    for attempt in range(1, tries + 1):
        calls = [0]

        def counted():
            if calls[0] == 1:  # the profiler's warm-up call is not recorded
                launch.reset_counts()
            calls[0] += 1
            step()

        table = capture_op_table(counted, reps=reps)
        table["tries"] = attempt
        made = {w: n for w, n in launch.counts["kernel"].items() if n and w in LAST_DEVICE_KERNEL}
        if table["device_trace"]:
            ops = table["ops_all_steps"]
            table["port"] = {
                w: (sum(n for name, (_, n) in ops.items()
                        if any(k in name for k in LAST_DEVICE_KERNEL[w])), n)
                for w, n in made.items()}
            if all(a == b for a, b in table["port"].values()):
                break
    return table


def port_seen(port: dict) -> str:
    """'seen/made' launches of each port kernel in a traced window."""
    return ", ".join(f"{w} {seen}/{made}" + ("" if seen == made else " (NOT all seen)")
                     for w, (seen, made) in port.items())


def profiled(kernel) -> str:
    """The profiler's view of 5 calls of a kernel wrapper: the last call's
    device ms by kernel, beside the CUDA-event time."""
    t = op_table(kernel, reps=5)
    if not t["device_trace"]:
        return f"profiler: no device events ({t['reason']})"
    short = lambda name: (name.replace("(anonymous namespace)::", "").replace("void ", "")
                          .split("(")[0].split("<")[0][-40:])
    parts = ", ".join(f"{short(name)} {ms:.4f} ms x{t['op_counts'][name]}"
                      for name, ms in t["top_ops_ms"][:6])
    return (f"profiler {t['op_sum_ms']:.4f} ms in the last call ({parts}; launches in "
            f"{t['executions']} calls {port_seen(t['port'])})")


def chained(run, x, state):
    """step() for dispatch_wall / op_table: one dispatch run(x, st) on
    a state carried from the previous call."""
    st = [state()]

    def step():
        _, st[0] = run(x, st[0])

    return step


def paths(pipe, pipes, x_np, xc_np) -> dict:
    """label -> step() of each timed and profiled dispatch."""
    from tpu_sdr_torch import FilterMode

    x = torch.as_tensor(x_np, device="cuda")
    xc = torch.as_tensor(xc_np, device="cuda")
    planes = torch.stack([xc.real, xc.imag])
    iq_state = lambda: pipe.initial_state(batch_shape=(2,))
    steps = {}
    for mode in (FilterMode.CUSTOM, FilterMode.FIXED, FilterMode.BYPASS):
        steps[mode.name] = chained(lambda a, s, m=mode: pipe.process(a, s, m), x, pipe.initial_state)
    fused = pipes["f32"][0]
    steps["fused f32 CUSTOM"] = chained(
        lambda a, s: fused.process(a, s, FilterMode.CUSTOM), x, fused.initial_state)
    for mode in (FilterMode.BYPASS, FilterMode.CUSTOM):
        steps[f"IQ {mode.name}"] = chained(
            lambda a, s, m=mode: pipe.process(a, s, m), xc, iq_state)
        steps[f"IQ planes {mode.name}"] = chained(
            lambda a, s, m=mode: pipe.process_planes(a, s, m), planes, iq_state)
    return steps


def fft64_snr(name: str, ref: torch.Tensor, kernel: torch.Tensor, plain: torch.Tensor):
    """The kernel's and the plain version's SNR against a float64 FFT's
    magnitude of the same fp32 input; the kernel may trail by 1 dB at most."""
    torch.cuda.synchronize()
    k, p = snr_db(ref, kernel), snr_db(ref, plain)
    print(f"[5] {name} F={kernel.shape[0]} vs a float64 FFT (torch.fft on the card): kernel "
          f"snr={k:.2f} dB, plain snr={p:.2f} dB")
    check(k >= p - 1.0, (name, "vs float64", k, p))


def phase_timing(pp, sos, x_np: np.ndarray, steps: dict) -> tuple[dict, dict]:
    """Kernel, plain and library times and bounds at the main path's shape
    (F = 512, fp32 in and out, as the paths call each kernel), then each
    path's dispatch wall time. ``sos``: the design of ``pp``."""
    from tpu_sdr_torch.kernels.cuda import iir_fft

    F = CHANNELS * FRAMES
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.as_tensor(x_np, device="cuda").reshape(F, N)
    xi = torch.randn((F, N), device="cuda", generator=gen)
    zs = 0.1 * torch.randn((F, 12), device="cuda", generator=gen)
    m, L = 12, 128
    fft_flops = 2.5 * N * math.log2(N)  # an FFT of a real frame
    consts_dft = 4 * 128 * 4 + 2 * N * 4  # DFT table, twiddle planes
    consts_iir = N * 4 + L * 4 + 2 * L * m * 4 + m * m * 4  # window, h, PT, MT, AL
    timing = {}

    def record(name, kernel, plain, library, b):
        timing[name] = {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
                        "library_ms": None if library is None else cuda_ms(library),
                        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
        t = timing[name]
        lib = "none" if library is None else f"{t['library_ms']:.4f} ms"
        print(f"[5] {name} F={F}: kernel {t['ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; "
              f"library {lib}; bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
              f"({b['bytes'] / 1e6:.1f} MB, {b['flops'] / 1e9:.3f} GFLOP fp32) -> kernel at "
              f"{b['bound_ms'] / t['ms']:.1%} of the bound; {profiled(kernel)}")

    # Window, 16384-point FFT of a real frame, magnitude (4 operations a bin).
    record("spectrum_bypass",
           lambda: iir_fft.spectrum_bypass_cuda(x, pp, False, "float32"),
           lambda: iir_fft.spectrum_bypass_plain(x, pp, False, "float32"),
           lambda: torch.abs(torch.fft.fft(x)),
           bound(F * N * 4 * 2 + consts_dft + N * 4, F * (fft_flops + 4 * N)))
    fft64_snr("spectrum_bypass", torch.fft.fft(x.double()).abs(),
              iir_fft.spectrum_bypass_cuda(x, pp, False, "float32"),
              iir_fft.spectrum_bypass_plain(x, pp, False, "float32"))
    print(f"[5] spectrum_bypass with the window in the kernel: "
          f"{cuda_ms(lambda: iir_fft.spectrum_bypass_cuda(x, pp, True, 'float32')):.4f} ms")
    # Window, forcing (2 m operations a sample), the chain (128 steps of an
    # m x m mat-vec and an add); 48 bytes out a frame. The library call is
    # the product with the plan's summary_matrix (IEEE fp32: TF32 off).
    kw = pp.summary_matrix
    record("iir_summaries",
           lambda: iir_fft.iir_summaries_cuda(x, pp),
           lambda: iir_fft.iir_summaries_plain(x, pp),
           lambda: torch.matmul(x, kw.T),
           bound(F * N * 4 + F * m * 4 + N * 4 + L * m * 4 + m * m * 4,
                 F * (N + 2 * m * N + 128 * (2 * m * m + m))))
    t = timing["iir_summaries"]
    print(f"[5] iir_summaries against torch.matmul(x, summary_matrix.T): {t['ms']:.4f} ms "
          f"against {t['library_ms']:.4f} ms (allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, precision "
          f"{torch.get_float32_matmul_precision()})")
    # Window, the 12th-order IIR as six biquads (9 operations a sample
    # each), the FFT of a real frame, magnitude.
    record("spectrum_iir",
           lambda: iir_fft.spectrum_iir_cuda(x, zs, pp),
           lambda: iir_fft.spectrum_iir_plain(x, zs, pp),
           None,
           bound(F * N * 4 * 2 + F * m * 4 + consts_dft + consts_iir,
                 F * (N + 54 * N + fft_flops + 4 * N)))
    # From rest (zs = 0), each frame is the float64 window (the kernel's
    # fp32 values) -> sosfilt -> FFT.
    zero = torch.zeros_like(zs)
    w64 = pp.win.reshape(-1).double().cpu().numpy()
    y64 = np.stack([sps.sosfilt(sos, f.astype(np.float64) * w64) for f in x.cpu().numpy()])
    fft64_snr("spectrum_iir", torch.fft.fft(torch.as_tensor(y64, device="cuda")).abs(),
              iir_fft.spectrum_iir_cuda(x, zero, pp), iir_fft.spectrum_iir_plain(x, zero, pp))
    # A complex FFT (5 N log2 N) and the magnitude; two planes in.
    record("spectrum_complex",
           lambda: iir_fft.spectrum_complex_cuda(x, xi, pp, False, "float32"),
           lambda: iir_fft.spectrum_complex_plain(x, xi, pp, False, "float32"),
           lambda: torch.abs(torch.fft.fft(torch.complex(x, xi))),
           bound(F * N * 4 * 3 + consts_dft, F * (2 * fft_flops + 4 * N)))
    fft64_snr("spectrum_complex", torch.fft.fft(torch.complex(x.double(), xi.double())).abs(),
              iir_fft.spectrum_complex_cuda(x, xi, pp, False, "float32"),
              iir_fft.spectrum_complex_plain(x, xi, pp, False, "float32"))

    samples = CHANNELS * FRAMES * N
    walls = {}
    # Paths compared with each other run in 10 pairs of turns (a, b, b, a,
    # ...): the host's share of a dispatch drifts within one call.
    turns = lambda a, b: [a, b, b, a] * 5
    order = (turns("CUSTOM", "fused f32 CUSTOM") + ["FIXED", "BYPASS"]
             + turns("IQ BYPASS", "IQ planes BYPASS") + turns("IQ CUSTOM", "IQ planes CUSTOM"))
    for label in order:
        med, lo, hi = dispatch_wall(steps[label])
        walls.setdefault(label, []).append(med)
        print(f"[5] {label:17s} dispatch ({CHANNELS} ch x {FRAMES} frames): median "
              f"{med * 1e3:.4f} ms (min {lo * 1e3:.4f}, max {hi * 1e3:.4f}) "
              f"-> {samples / med:.4e} samples/s")
    for label, meds in walls.items():
        if len(meds) > 1:
            print(f"[5] {label:17s} {len(meds)} turns: median {statistics.median(meds) * 1e3:.4f} ms "
                  f"(turns {', '.join(f'{m * 1e3:.4f}' for m in meds)})")
    for a, b in (("CUSTOM", "fused f32 CUSTOM"), ("IQ BYPASS", "IQ planes BYPASS"),
                 ("IQ CUSTOM", "IQ planes CUSTOM")):
        wins = sum(y < x for x, y in zip(walls[a], walls[b]))
        print(f"[5] {b} faster than {a} in {wins} of {len(walls[a])} pairs")
    return {label: statistics.median(v) for label, v in walls.items()}, timing


# The paths of thousands of launches a dispatch, profiled last (one traced
# dispatch each), in this order. Profiles of one process lose device events
# now and then, and in some runs lost all of them from the Q15 phase on:
# the steps whose launches must all be seen are profiled first
# (phase_one_kernel_steps), these last.
HEAVY_PROFILES = ("Receiver wbfm", "Receiver wbfm IQ", "burst + FEC", "IQ corrector",
                  "FM default")


def phase_profile(steps: dict, walls: dict, reps: dict | None = None,
                  exact: tuple = ()) -> dict:
    """Per path, the last of ``reps`` traced dispatches (3 by default) as
    ``bench.trace.capture_op_table`` attributes it: its device ops, their
    busy time (union) and sum, the device's idle time inside the traced
    dispatch, and the idle share against the untraced wall of phase 5;
    the port's kernels seen against their wrappers' launch counts (which
    must be equal for the labels in ``exact``). Returns label -> table."""
    tables = {}
    for label, wall in walls.items():
        t = op_table(steps[label], (reps or {}).get(label, 3), tries=3 if label in exact else 1)
        tables[label] = t
        if not t["device_trace"]:
            print(f"[6] {label:17s} profiler saw no device events ({t['reason']}): not measured")
            check(label not in exact, (label, "no device trace"))
            continue
        seen = f"; port kernels seen/launched: {port_seen(t['port'])}" if t["port"] else ""
        print(f"[6] {label:17s} last traced dispatch: {t['n_ops']} device ops, busy "
              f"{t['device_busy_ms']:.4f} ms (sum {t['op_sum_ms']:.4f}), traced span "
              f"{t['dispatch_ms']:.4f} ms with {t['device_idle_ms']:.4f} ms idle; against the "
              f"untraced wall {wall * 1e3:.4f} ms -> idle share "
              f"{1 - t['device_busy_ms'] / (wall * 1e3):.1%}; unattributed ops "
              f"{t['unattributed']}{seen}" + (f" (capture {t['tries']})" if t["tries"] > 1 else ""))
        for name, ms in t["top_ops_ms"][:6]:
            print(f"[6]   {ms:8.4f} ms in {t['op_counts'][name]:6d} launches  {name[:80]}")
        if label in exact:
            check(t["port"] and all(a == b for a, b in t["port"].values()),
                  (label, "seen != made", t["port"]))
    return tables


def phase_small_dispatch(sos_custom):
    """CUSTOM dispatch at 1 channel x 1 and x 4 frames (the bench shape's
    is phase 5's): host-clock time, device kernels and busy time."""
    from tpu_sdr_torch import FilterMode, PipelineConfig, SpectrumPipeline

    pipe = SpectrumPipeline(PipelineConfig(channels=1))
    pipe.upload_sos(sos_custom)
    gen = torch.Generator(device="cuda").manual_seed(2)
    for frames in (1, 4):
        x = torch.randn((1, frames * N), device="cuda", generator=gen)
        step = chained(lambda a, s: pipe.process(a, s, FilterMode.CUSTOM), x, pipe.initial_state)
        med, lo, hi = dispatch_wall(step)
        t = op_table(step)
        busy = ("device not measured" if not t["device_trace"]
                else f"{t['n_ops']} device ops, busy {t['device_busy_ms']:.4f} ms")
        print(f"[7] CUSTOM dispatch (1 ch x {frames} frames): median {med * 1e3:.4f} ms "
              f"(min {lo * 1e3:.4f}, max {hi * 1e3:.4f}); {busy}")


# ---------------------------------------------------------------- narrowband


def tone_hz(x: np.ndarray, rate: float) -> float:
    """The frequency of the largest peak of a Hann-windowed spectrum."""
    x = np.asarray(x, np.float64)
    x = x - x.mean()
    spec = np.abs(np.fft.rfft(x * np.hanning(x.size)))
    return float(np.argmax(spec) * rate / x.size)


def check_tone(tag: str, audio: torch.Tensor, rate: float, want_hz: float, skip_s: float):
    a = audio.double().cpu().numpy()[int(skip_s * rate):]
    check(np.isfinite(a).all(), (tag, "finite"))
    got = tone_hz(a, rate)
    tol = 2 * rate / a.size
    print(f"[4] {tag}: tone at {got:.2f} Hz (sent {want_hz:.0f} Hz, +-{tol:.2f}), "
          f"peak |audio| {np.abs(a).max():.4f}")
    check(abs(got - want_hz) <= tol, (tag, got, want_hz))


def _noise(shape, seed: int, scale: float) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return scale * torch.randn(shape, dtype=torch.float64, device="cuda", generator=gen)


def fm_phase(t: int, fs: float, dev: float, tone: float) -> torch.Tensor:
    """The phase (float64, on the card) of a carrier FM-modulated by a tone."""
    n = torch.arange(t, dtype=torch.float64, device="cuda")
    return 2 * np.pi * dev / fs * torch.cumsum(torch.sin(2 * np.pi * tone * n / fs), 0)


def fm_planes() -> tuple:
    """8 channels x 2^20 complex FM baseband (a 1 kHz tone at 75 kHz
    deviation, fs 200 kHz) plus noise at -60 dB, as float32 re/im planes."""
    ph = fm_phase(NB_T, FM_FS, FM_DEV, FM_TONE)
    re = torch.cos(ph) + _noise((NB_CH, NB_T), 20, 1e-3)
    im = torch.sin(ph) + _noise((NB_CH, NB_T), 21, 1e-3)
    return re.float(), im.float()


# The FM kernel's edge shapes (channels, T): one block; one stage of the
# chain (csrc/affine_chain.cuh, 1024 blocks) plus one; more channels than
# SMs, one block each.
FM_EDGE_SHAPES = ((1, 128), (2, 1025 * 128), (1000, 128))
# Row 8's products against float64: the kernel at most this far below its
# plain version.
SNR_VS_PLAIN_DB = 1.0


def fm_inputs(c: int, t: int, gen) -> tuple:
    re, im = (torch.randn((c, t), device="cuda", generator=gen) for _ in range(2))
    pr, pi = (torch.randn((c, 1), device="cuda", generator=gen) for _ in range(2))
    return re, im, pr, pi, 0.1 * torch.randn((c,), device="cuda", generator=gen)


def phase_nb_kernels() -> dict:
    """The FM and PFB kernels against their plain versions at the main
    paths' shapes (FM also at its edge shapes, one launch against three and
    twice in a row; PFB also with random planes and against float64);
    returns the max abs error of each as the path calls it."""
    from tpu_sdr_torch.kernels.cuda import affine_scan, pfb_kernel
    from tpu_sdr_torch.kernels.pfb import Channelizer

    errs = {}
    gen = torch.Generator(device="cuda").manual_seed(22)
    pole_kw = dict(fs=FM_FS, dev=FM_DEV, pole=float(np.exp(-1.0 / (FM_FS * FM_TAU))))
    args = fm_inputs(NB_CH, NB_T, gen)
    for kw in (pole_kw, {**pole_kw, "pole": None}):
        got = affine_scan.fm_demod_cuda(*args, **kw)
        ref = affine_scan.fm_demod_plain(*args, **kw)
        torch.cuda.synchronize()
        err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        bitwise = all(torch.equal(g, r) for g, r in zip(got, ref))
        print(f"[3] fm_demod {NB_CH} x {NB_T} pole={kw['pole']}: max_abs_err={err:.3e} "
              f"(atol {FM_KERNEL_ATOL}) bitwise={bitwise}")
        check(all(g.shape == r.shape for g, r in zip(got, ref)), "fm_demod shapes")
        check(bitwise and err <= FM_KERNEL_ATOL, ("fm_demod", kw["pole"], err))
        errs.setdefault("fm_demod", err)
    once = affine_scan.fm_demod_cuda(*args, **pole_kw)
    again = affine_scan.fm_demod_cuda(*args, **pole_kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(once, again))
    print(f"[3] fm_demod {NB_CH} x {NB_T}: two launches in a row give the same bits: {same}")
    check(same, "fm_demod launches")
    for c, t in FM_EDGE_SHAPES:
        edge = fm_inputs(c, t, gen)
        got = affine_scan.fm_demod_cuda(*edge, **pole_kw)
        ref = affine_scan.fm_demod_plain(*edge, **pole_kw)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(g, r) for g, r in zip(got, ref))
        print(f"[3] fm_demod {c} x {t} (edge shape) with de-emphasis: bitwise={bitwise}")
        check(bitwise, ("fm_demod edge", c, t))
    ch = Channelizer(m=PFB_M, taps=PFB_TAPS, use_pallas=True)
    rand_planes = [torch.randn((PFB_M, PFB_M), device="cuda", generator=gen) for _ in range(2)]
    for label, batch, neg_b in (("real", NB_CH, True), ("IQ", 2 * NB_CH, False)):
        rows = torch.randn((batch, NB_T // PFB_M + PFB_TAPS - 1, PFB_M), device="cuda",
                           generator=gen)
        folded = pfb_kernel.fold_rows(rows, ch._h2, PFB_TAPS).double()
        for which, (cos, sin) in (("channelizer", (ch._cos, ch._sin)), ("random", rand_planes)):
            a, b = pfb_kernel.pfb_fold_dft_cuda(rows, ch._h2, cos, sin, PFB_TAPS, neg_b)
            ra, rb = pfb_kernel.pfb_fold_dft_plain(rows, ch._h2, cos, sin, PFB_TAPS, PFB_M, neg_b)
            torch.cuda.synchronize()
            err = max((a - ra).abs().max().item(), (b - rb).abs().max().item())
            rel = err / ra.abs().max().item()
            sign = -1.0 if neg_b else 1.0
            snr = [(snr_db(folded @ cos.double(), a), snr_db(folded @ cos.double(), ra)),
                   (snr_db(sign * (folded @ sin.double()), b),
                    snr_db(sign * (folded @ sin.double()), rb))]
            print(f"[3] pfb_fold_dft {label} rows {tuple(rows.shape)}, {which} planes: "
                  f"max_abs_err={err:.3e} rel={rel:.2e} (tol {PFB_REL}); vs float64 A kernel "
                  f"{snr[0][0]:.2f} dB plain {snr[0][1]:.2f} dB, B kernel {snr[1][0]:.2f} dB "
                  f"plain {snr[1][1]:.2f} dB")
            check(rel <= PFB_REL, ("pfb_fold_dft", label, which, rel))
            check(all(k >= p - SNR_VS_PLAIN_DB for k, p in snr), ("pfb_fold_dft float64", snr))
            if which == "channelizer":
                errs.setdefault("pfb_fold_dft", err)
    return errs


def phase_fm(planes) -> int:
    """The FM kernel path, with and without de-emphasis; returns fm_demod's
    launches."""
    from tpu_sdr_torch.kernels.cuda import launch
    from tpu_sdr_torch.kernels.demod import FMDemodulator

    re, im = planes
    launch.reset_counts()
    for k, tau in enumerate((FM_TAU, None), start=1):
        fm = FMDemodulator(FM_FS, deviation_hz=FM_DEV, deemphasis_tau=tau, use_pallas=True)
        st = fm.initial_state((NB_CH,))
        for _ in range(DISPATCHES):
            audio, st = fm.process(re, im, st)
        torch.cuda.synchronize()
        check_counts(f"FM kernel tau={tau}", {"fm_demod": k * DISPATCHES})
        check(audio.shape == (NB_CH, NB_T) and st.offset == DISPATCHES * NB_T)
        check_tone(f"FM kernel path tau={tau}: {DISPATCHES} dispatches of {NB_CH} x {NB_T}, "
                   f"fm_demod launches {DISPATCHES}, plain 0; channel 0 of the last",
                   audio[0, -(1 << 17):], FM_FS, FM_TONE, 0.0)
    launches = launch.counts["kernel"]["fm_demod"]
    chunks = (128, 384, 1536, 2048, 4096, 8192, 32768, NB_T - 49152)
    for tau in (FM_TAU, None):
        fm = FMDemodulator(FM_FS, deviation_hz=FM_DEV, deemphasis_tau=tau, use_pallas=True)
        one, st_one = fm.process(re, im, fm.initial_state((NB_CH,)))
        st, parts, pos = fm.initial_state((NB_CH,)), [], 0
        for n in chunks:
            o, st = fm.process(re[:, pos : pos + n], im[:, pos : pos + n], st)
            parts.append(o)
            pos += n
        xla = FMDemodulator(FM_FS, deviation_hz=FM_DEV, deemphasis_tau=tau)
        ref, _ = xla.process(re, im, xla.initial_state((NB_CH,)))
        torch.cuda.synchronize()
        bitwise = torch.equal(torch.cat(parts, dim=-1), one) and torch.equal(st.filt, st_one.filt)
        err = (ref - one).abs().max().item()
        print(f"[4] FM tau={tau}: chunked ({len(chunks)} mixed chunks) vs one-shot bitwise="
              f"{bitwise}; kernel path vs default path max_abs_err={err:.3e} "
              f"(atol {FM_PATHS_ATOL})")
        check(bitwise, ("FM chunked", tau))
        check(err <= FM_PATHS_ATOL, ("FM paths", tau, err))
    return launches


def pfb_inputs() -> tuple:
    """A real tone at channel 37's center (8 x 2^20) and a complex one as
    (2, 8, 2^20) planes, plus noise at -60 dB."""
    n = torch.arange(NB_T, dtype=torch.float64, device="cuda")
    ph = 2 * np.pi * 37 / PFB_M * n
    x = (torch.cos(ph) + _noise((NB_CH, NB_T), 23, 1e-3)).float()
    planes = torch.stack([torch.cos(ph) + _noise((NB_CH, NB_T), 24, 1e-3),
                          torch.sin(ph) + _noise((NB_CH, NB_T), 25, 1e-3)]).float()
    return x, planes


def phase_channelizer(x, planes) -> int:
    """The channelizer kernel path, real and IQ; returns pfb_fold_dft's
    launches."""
    from tpu_sdr_torch.kernels.cuda import launch
    from tpu_sdr_torch.kernels.pfb import Channelizer

    ch = Channelizer(m=PFB_M, taps=PFB_TAPS, use_pallas=True)
    xla = Channelizer(m=PFB_M, taps=PFB_TAPS)
    cases = (("real", ch.process, x, (NB_CH,)), ("IQ", ch.process_planes, planes, (2, NB_CH)))
    launch.reset_counts()
    k = 0
    for label, run, inp, shape in cases:
        k += 1
        st = ch.initial_state(shape)
        for _ in range(DISPATCHES):
            out, st = run(inp, st, outputs="all")
        torch.cuda.synchronize()
        check_counts(f"PFB kernel {label}", {"pfb_fold_dft": k * DISPATCHES})
        mag = out["magnitude"][0, 16:].mean(dim=0).cpu().numpy()
        top = list(np.argsort(mag)[::-1][:3])
        want = {37, PFB_M - 37} if label == "real" else {37}
        print(f"[4] PFB kernel path {label}: {DISPATCHES} dispatches, pfb_fold_dft launches "
              f"{DISPATCHES}, plain 0; strongest channels {top}, next/peak "
              f"{mag[top[len(want)]] / mag[top[0]]:.2e}")
        check(set(top[: len(want)]) == want and mag[top[len(want)]] < 1e-3 * mag[top[0]],
              ("PFB tone", label, top))
    launches = launch.counts["kernel"]["pfb_fold_dft"]
    for label, run, inp, shape in cases:
        xrun = xla.process if label == "real" else xla.process_planes
        one, st_one = run(inp, ch.initial_state(shape))
        ref, _ = xrun(inp, xla.initial_state(shape))
        st, parts, prev = ch.initial_state(shape), [], 0
        for cut in (PFB_M, 9 * PFB_M, NB_T // 3 // PFB_M * PFB_M, NB_T):
            o, st = run(inp[..., prev:cut], st)
            parts.append(o)
            prev = cut
        torch.cuda.synchronize()
        bitwise = all(torch.equal(torch.cat([p[key] for p in parts], dim=-2), one[key])
                      for key in ("re", "im")) and torch.equal(st, st_one)
        scale = ref["re"].abs().max().item()
        rel = max((ref[key] - one[key]).abs().max().item() for key in ("re", "im")) / scale
        print(f"[4] PFB {label}: chunked (4 chunks) vs one-shot bitwise={bitwise}; kernel "
              f"path vs default path max_err/max|re|={rel:.2e} (tol {PFB_REL})")
        check(bitwise, ("PFB chunked", label))
        check(rel <= PFB_REL, ("PFB paths", label, rel))
    return launches


def rx_signal(t: int, mode: str, iq: bool = False) -> torch.Tensor:
    """(8, t) real or (2, 8, t) IQ wideband input at 1 MS/s with a station
    at 250 kHz carrying a test tone: FM (1 kHz, 75 kHz deviation for wbfm;
    300 Hz, 2.5 kHz for nbfm; stereo L 1 kHz, R 3 kHz), AM (800 Hz) or a
    single sideband (the carrier +- 700 Hz); noise at -40 dB."""
    from tpu_sdr_torch.kernels.stereo import make_mpx

    n = torch.arange(t, dtype=torch.float64, device="cuda")
    w = 2 * np.pi * RX_CENTER / RX_FS * n
    if mode == "stereo":
        nn = n.cpu().numpy()
        mpx = make_mpx(np.sin(2 * np.pi * 1e3 * nn / RX_FS), np.sin(2 * np.pi * 3e3 * nn / RX_FS),
                       RX_FS)
        w = w + 2 * np.pi * 75e3 / RX_FS * torch.cumsum(torch.as_tensor(mpx, device="cuda"), 0)
    elif mode in ("wbfm", "nbfm"):
        dev, tone = (75e3, 1e3) if mode == "wbfm" else (2.5e3, 300.0)
        w = w + fm_phase(t, RX_FS, dev, tone)
    elif mode in ("usb", "lsb"):
        w = w + (1 if mode == "usb" else -1) * 2 * np.pi * 700.0 / RX_FS * n
    amp = 0.8 if mode != "am" else 0.5 * (1 + 0.5 * torch.sin(2 * np.pi * 800.0 * n / RX_FS))
    amp = amp if mode not in ("usb", "lsb") else 0.5
    parts = [amp * torch.cos(w)] + ([amp * torch.sin(w)] if iq else [])
    planes = [p + _noise((NB_CH, t), 30 + k, 1e-2) for k, p in enumerate(parts)]
    return (torch.stack(planes) if iq else planes[0]).float()


def _rx_chunked(rx, x, sizes, iq: bool):
    """(one-shot audio, chunked audio, whether the final states are equal)."""
    run = rx.process_planes if iq else rx.process
    batch = x.shape[1:-1] if iq else x.shape[:-1]
    one, st_one = run(x, rx.initial_state(batch))
    st, parts, pos = rx.initial_state(batch), [], 0
    for n in sizes:
        o, st = run(x[..., pos : pos + n], st)
        parts.append(o)
        pos += n
    torch.cuda.synchronize()
    d1, d2 = st.to_numpy(), st_one.to_numpy()
    same = all(np.array_equal(d1[s][k], d2[s][k]) for s in d2 for k in d2[s])
    return one, torch.cat(parts, dim=-1), same


def phase_receiver() -> tuple:
    """The wbfm receiver at full width (real and IQ), the other modes,
    stereo and a 4-station bank; returns (receiver, real input, IQ input)
    for the timing phase."""
    from tpu_sdr_torch.kernels.cuda import launch
    from tpu_sdr_torch.runtime.receiver import Receiver, ReceiverBank

    rx = Receiver(fs=RX_FS, center_hz=RX_CENTER, mode="wbfm", audio_rate=RX_AUDIO)
    g = rx.chunk_granularity
    check(RX_T % g == 0, (RX_T, g))
    x, xs = rx_signal(RX_T, "wbfm"), rx_signal(RX_T, "wbfm", iq=True)
    launch.reset_counts()
    for label, run, inp in (("real", rx.process, x), ("IQ planes", rx.process_planes, xs)):
        st = rx.initial_state((NB_CH,))
        for _ in range(DISPATCHES):
            audio, st = run(inp, st)
        torch.cuda.synchronize()
        check_counts(f"Receiver wbfm {label}", {})
        check(audio.shape == (NB_CH, RX_T * 6 // 125), audio.shape)
        check_tone(f"Receiver wbfm {label}: {DISPATCHES} dispatches of {NB_CH} x {RX_T}, no "
                   f"kernel of the port, plain 0; channel 0 of the last",
                   audio[0], float(rx.realized_audio_rate), 1e3, 0.01)
        a = RX_T // g // 3
        sizes = (a * g, (a + 1) * g, RX_T - (2 * a + 1) * g)
        one, chunked, same = _rx_chunked(rx, inp, sizes, label != "real")
        print(f"[4] Receiver wbfm {label}: chunked ({', '.join(str(n // g) for n in sizes)} "
              f"granules) vs one-shot "
              f"bitwise={torch.equal(one, chunked)}, states equal={same}")
        check(torch.equal(one, chunked) and same, ("Receiver chunked", label))
    # The other modes, each at 8 streams; SSB at 8 kHz audio (a 2.656 M
    # sample granularity at 48 kHz too, and a 996-phase resampler).
    modes = (("nbfm", dict(mode="nbfm"), 2, 300.0, 0.05),
             ("am", dict(mode="am"), 8, 800.0, 0.1),
             ("usb", dict(mode="usb", audio_rate=8e3), 2, 700.0, 0.2),
             ("lsb", dict(mode="lsb", audio_rate=8e3), 2, 700.0, 0.2),
             ("stereo", dict(mode="wbfm", stereo=True), RX_T // g, None, 0.1))
    for label, kw, granules, tone, skip in modes:
        r = Receiver(**{"fs": RX_FS, "center_hz": RX_CENTER, "audio_rate": RX_AUDIO, **kw})
        gr = r.chunk_granularity
        xm = rx_signal(granules * gr, label)
        launch.reset_counts()
        one, chunked, same = _rx_chunked(r, xm, (gr, (granules - 1) * gr), False)
        check_counts(f"Receiver {label}", {})
        rate = float(r.realized_audio_rate)
        tag = (f"Receiver {label} {NB_CH} x {granules * gr}: chunked vs one-shot bitwise="
               f"{torch.equal(one, chunked)}, states equal={same}")
        check(torch.equal(one, chunked) and same, tag)
        if tone is None:
            check_tone(f"{tag}; left", one[0, 0], rate, 1e3, skip)
            check_tone(f"{tag}; right", one[0, 1], rate, 3e3, skip)
        else:
            check_tone(tag, one[0], rate, tone, skip)
    centers = (RX_CENTER, 130e3, 340e3, 420e3)
    bank = ReceiverBank(RX_FS, centers, mode="wbfm", audio_rate=RX_AUDIO)
    xb = x[:, : 8 * g]
    st = bank.initial_state((NB_CH,))
    outs = []
    for chunk in (xb[:, : 3 * g], xb[:, 3 * g :]):
        o, st = bank.process(chunk, st)
        outs.append(o)
    same = True
    for k, c in enumerate(centers):
        r = Receiver(RX_FS, c, mode="wbfm", audio_rate=RX_AUDIO)
        rs = r.initial_state((NB_CH,))
        for chunk, o in zip((xb[:, : 3 * g], xb[:, 3 * g :]), outs):
            ro, rs = r.process(chunk, rs)
            same = same and torch.equal(o[k], ro)
    torch.cuda.synchronize()
    print(f"[4] ReceiverBank of {len(centers)} wbfm stations, {NB_CH} x 8 granules in 2 "
          f"chunks: == {len(centers)} independent receivers bitwise={same}")
    check(same, "ReceiverBank")
    check_tone("ReceiverBank station 0", torch.cat(outs, dim=-1)[0, 0],
               float(bank.realized_audio_rate), 1e3, 0.01)
    return rx, x, xs


def nb_paths(planes, pfb_x, pfb_planes, rx, rx_x, rx_xs) -> dict:
    """label -> step() of each timed and profiled narrowband dispatch."""
    from tpu_sdr_torch.kernels.demod import FMDemodulator
    from tpu_sdr_torch.kernels.pfb import Channelizer

    re, im = planes
    fm_k = FMDemodulator(FM_FS, deviation_hz=FM_DEV, deemphasis_tau=FM_TAU, use_pallas=True)
    fm_x = FMDemodulator(FM_FS, deviation_hz=FM_DEV, deemphasis_tau=FM_TAU)
    fm_state = lambda fm: (lambda: fm.initial_state((NB_CH,)))
    ch_k = Channelizer(m=PFB_M, taps=PFB_TAPS, use_pallas=True)
    ch_x = Channelizer(m=PFB_M, taps=PFB_TAPS)
    ch_state = lambda shape: (lambda: ch_k.initial_state(shape))
    split = lambda run: (lambda p, s: run(p[0], p[1], s))
    return {
        "FM kernel": chained(split(fm_k.process), (re, im), fm_state(fm_k)),
        "FM default": chained(split(fm_x.process), (re, im), fm_state(fm_x)),
        "PFB kernel real": chained(ch_k.process, pfb_x, ch_state((NB_CH,))),
        "PFB default real": chained(ch_x.process, pfb_x, ch_state((NB_CH,))),
        "PFB kernel IQ": chained(ch_k.process_planes, pfb_planes, ch_state((2, NB_CH))),
        "PFB default IQ": chained(ch_x.process_planes, pfb_planes, ch_state((2, NB_CH))),
        "Receiver wbfm": chained(rx.process, rx_x, lambda: rx.initial_state((NB_CH,))),
        "Receiver wbfm IQ": chained(rx.process_planes, rx_xs,
                                    lambda: rx.initial_state((NB_CH,))),
    }


# Light repetitions for the dispatches whose default path walks thousands of
# blocks in a Python loop (seconds a call): reps x calls after warmup.
NB_WALL = {"FM default": (3, 2, 1), "FM kernel": (3, 2, 1),
           "Receiver wbfm": (3, 3, 1), "Receiver wbfm IQ": (3, 3, 1)}


def phase_nb_timing(planes, steps: dict) -> tuple[dict, dict]:
    """The FM and PFB kernels' times, plain times and bounds at the paths'
    shapes, then each narrowband path's dispatch wall time (kernel path
    and default path in alternating turns)."""
    from tpu_sdr_torch.kernels.cuda import affine_scan, pfb_kernel
    from tpu_sdr_torch.kernels.pfb import Channelizer

    re, im = planes
    z = torch.zeros((NB_CH, 1), device="cuda")
    y0 = torch.zeros((NB_CH,), device="cuda")
    kw = dict(fs=FM_FS, dev=FM_DEV, pole=float(np.exp(-1.0 / (FM_FS * FM_TAU))))
    samples = NB_CH * NB_T
    timing = {}

    def record(name, kernel, plain, b, tag, plain_iters=20):
        timing[name] = {"ms": cuda_ms(kernel),
                        "plain_ms": cuda_ms(plain, iters=plain_iters, warmup=1),
                        "library_ms": None, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
        t = timing[name]
        print(f"[5] {name} {tag}: kernel {t['ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; "
              f"library none; bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
              f"({b['bytes'] / 1e6:.1f} MB, {b['flops'] / 1e9:.3f} GFLOP fp32) -> kernel at "
              f"{b['bound_ms'] / t['ms']:.1%} of the bound; {profiled(kernel)}")

    # re, im in, audio out (12 bytes a sample) and 3 floats a channel of
    # state in and out.
    record("fm_demod",
           lambda: affine_scan.fm_demod_cuda(re, im, z, z, y0, **kw),
           lambda: affine_scan.fm_demod_plain(re, im, z, z, y0, **kw),
           bound(samples * 12 + NB_CH * 24, samples * FM_FLOPS_PER_SAMPLE),
           f"{NB_CH} x {NB_T}, de-emphasis on", plain_iters=2)
    # The chain's floor: one dependent multiply and add (4 cycles each) a
    # 128-sample block, at the card's highest SM clock.
    mhz = max_sm_mhz()
    floor_ms = NB_T // 128 * CHAIN_CYCLES_PER_BLOCK / (mhz * 1e6) * 1e3
    print(f"[5] fm_demod chain floor: {NB_T // 128} blocks x {CHAIN_CYCLES_PER_BLOCK} cycles at "
          f"{mhz:.0f} MHz = {floor_ms:.4f} ms -> kernel at {floor_ms / timing['fm_demod']['ms']:.1%} "
          f"of it (bytes bound {timing['fm_demod']['bound_ms']:.4f} ms)")
    nopole = {**kw, "pole": None}
    print(f"[5] fm_demod without de-emphasis: "
          f"{cuda_ms(lambda: affine_scan.fm_demod_cuda(re, im, z, z, y0, **nopole)):.4f} ms")
    gen = torch.Generator(device="cuda").manual_seed(27)
    rre, rim = (torch.randn((NB_CH, NB_T), device="cuda", generator=gen) for _ in range(2))
    print(f"[5] fm_demod on Gaussian noise planes: with de-emphasis "
          f"{cuda_ms(lambda: affine_scan.fm_demod_cuda(rre, rim, z, z, y0, **kw)):.4f} ms, "
          f"without {cuda_ms(lambda: affine_scan.fm_demod_cuda(rre, rim, z, z, y0, **nopole)):.4f} ms")
    del rre, rim
    ch = Channelizer(m=PFB_M, taps=PFB_TAPS, use_pallas=True)
    gen = torch.Generator(device="cuda").manual_seed(26)
    steps_n = NB_T // PFB_M
    consts = (PFB_TAPS * PFB_M + 2 * PFB_M * PFB_M) * 4
    for label, batch, neg_b in (("real", NB_CH, True), ("IQ", 2 * NB_CH, False)):
        rows = torch.randn((batch, steps_n + PFB_TAPS - 1, PFB_M), device="cuda", generator=gen)
        # The fold (a multiply and an add a tap) and the two products with
        # cos/sin counted as a real M-point FFT (2.5 M log2 M a row), as the
        # spectrum kernels' dense DFT is counted: the dense products (4 M
        # operations a sample) are what the kernel does, not what the
        # function needs.
        out_rows = batch * steps_n
        b = bound(rows.numel() * 4 + consts + 2 * out_rows * PFB_M * 4,
                  out_rows * (PFB_M * 2 * PFB_TAPS + 2.5 * PFB_M * math.log2(PFB_M)))
        name = "pfb_fold_dft" if label == "real" else "pfb_fold_dft IQ"
        record(name,
               lambda: pfb_kernel.pfb_fold_dft_cuda(rows, ch._h2, ch._cos, ch._sin, PFB_TAPS, neg_b),
               lambda: pfb_kernel.pfb_fold_dft_plain(rows, ch._h2, ch._cos, ch._sin, PFB_TAPS,
                                                     PFB_M, neg_b),
               b, f"{label}, rows {tuple(rows.shape)}")
        # For arbitrary planes the floor is the dense work: two (rows, 128) @
        # (128, 128) products, six bf16 passes each on the tensor cores.
        dense = out_rows * PFB_M * 4 * PFB_M
        floor_ms = 6 * dense / PEAK_BF16_FLOPS * 1e3
        print(f"[5] {name} dense floor: {dense / 1e9:.3f} GFLOP x 6 bf16 passes at "
              f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s = {floor_ms:.4f} ms -> kernel at "
              f"{floor_ms / timing[name]['ms']:.1%} of it (the bytes bound "
              f"{timing[name]['bound_ms']:.4f} ms)")

    walls = {}
    turns = lambda a, b, k: [a, b, b, a] * k
    order = (turns("FM kernel", "FM default", 2) + turns("PFB kernel real", "PFB default real", 5)
             + turns("PFB kernel IQ", "PFB default IQ", 5) + ["Receiver wbfm", "Receiver wbfm IQ"])
    for label in order:
        med, lo, hi = dispatch_wall(steps[label], *NB_WALL.get(label, (5, 10, 3)))
        walls.setdefault(label, []).append(med)
        n = RX_T * NB_CH if label.startswith("Receiver") else samples
        print(f"[5] {label:17s} dispatch ({n} samples): median {med * 1e3:.4f} ms "
              f"(min {lo * 1e3:.4f}, max {hi * 1e3:.4f}) -> {n / med:.4e} samples/s")
    for a, b in (("FM kernel", "FM default"), ("PFB kernel real", "PFB default real"),
                 ("PFB kernel IQ", "PFB default IQ")):
        wins = sum(x < y for x, y in zip(walls[a], walls[b]))
        print(f"[5] {a} faster than {b} in {wins} of {len(walls[a])} pairs (medians "
              f"{statistics.median(walls[a]) * 1e3:.4f} vs {statistics.median(walls[b]) * 1e3:.4f} ms)")
    return {label: statistics.median(v) for label, v in walls.items()}, timing

def phase_nb_phases(pp, plan: dict):
    """Where rows 7, 8 and 3 spend one launch at the paths' shapes:
    scripts/torch_spectrum_phases.py's instrumented copies (the FM kernel's
    map tiles, walkers and emit tiles; the PFB kernel's fold, products and
    waits; the summaries' groups of 16 frames and cluster barriers)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "scripts" / "torch_spectrum_phases.py"
    spec = importlib.util.spec_from_file_location("torch_spectrum_phases", path)
    phases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(phases)
    for name in ("fm_demod", "pfb_fold_dft", "iir_summaries"):
        print(f"[5] {name}, phases inside one launch:")
        phases.run(name, pp, plan)

# ---------------------------------------------------------------- rows 4 and 6, hop, banks, facade


HOP = 8192  # hop < N: 128 spectra a channel from 64 frames' samples
HOP_GOLDEN_REL = 1e-5  # of max |golden| (tests/test_hop.py)
BANK_DB = 0.05  # each channel of a bank against its golden (tests/test_filterbank.py)


def mirrored(out: torch.Tensor) -> bool:
    """out[k1, k2] == out[127 - k1, 128 - k2] bit for bit for k2 in [65, 127]."""
    g = out.reshape(-1, 128, 128)
    return torch.equal(g[:, :, 65:], g.flip(1)[:, :, 1:64].flip(2))


def fused_planes(fplan: dict) -> dict:
    """Row 6's plane sets: the plan's, the plan's x 0.5 (|X| / 8) and random
    planes from a seeded NumPy generator (no DFT structure at all)."""
    rng = np.random.default_rng(12)
    return {"plan": fplan, "plan x0.5": {k: v * 0.5 for k, v in fplan.items()},
            "random": {k: torch.as_tensor(rng.standard_normal(v.shape), dtype=torch.float32,
                                          device="cuda") for k, v in fplan.items()}}


def phase_half_and_fused_vs_plain(pp, fplan: dict) -> dict:
    """Rows 4 and 6 against their plain versions at F = 1, 8 and 512;
    returns the max abs error of each at F = 512 (the half kernel's bypass
    form, fp32, window in the kernel, as the hop path calls row 1; fft_mag_fused
    with the plan)."""
    from tpu_sdr_torch.kernels.cuda import iir_fft, spectrum

    rng = np.random.default_rng(3)
    win = pp.win.reshape(-1)
    errs = {}
    for F in KERNEL_FRAMES:
        main = F == CHANNELS * FRAMES
        x32 = torch.as_tensor(rng.standard_normal((F, N)), dtype=torch.float32).cuda()
        zs = torch.as_tensor(0.1 * rng.standard_normal((F, 12)), dtype=torch.float32).cuda()
        for form, z, in_dtypes in (("bypass", None, (torch.float32, torch.bfloat16)),
                                   ("iir", zs, (torch.float32,))):
            for in_dtype in in_dtypes:
                x = x32.to(in_dtype)
                for apply_window in (True, False):
                    for out_dtype in ("float32", "bfloat16"):
                        tag = (f"spectrum_half {form:6s} F={F:3d} in={str(in_dtype)[6:]:8s} "
                               f"window={apply_window!s:5s} out={out_dtype:8s}")
                        got = iir_fft.spectrum_half_cuda(x, z, pp, apply_window, out_dtype)
                        err = _compare(tag, got, iir_fft.spectrum_half_plain(
                            x, z, pp, apply_window, out_dtype), SNR_FLOOR_DB[out_dtype])
                        check(mirrored(got), (tag, "mirror"))
                        if (main and form == "bypass" and in_dtype == torch.float32
                                and apply_window and out_dtype == "float32"):
                            errs["spectrum_half"] = err
        for bypass in (True, False):
            run = lambda **kw: iir_fft.spectrum_from_state(x32, zs, pp, bypass=bypass, **kw)
            full, half = run(), run(half_spectrum=True)
            same = torch.equal(half, full)
            blocked = all(torch.equal(run(half_spectrum=h, blocked_output=True), o.view(F, 128, 128))
                          for h, o in ((False, full), (True, half)))
            torch.cuda.synchronize()
            # Row 4 launches rows 1 and 2, whose kernels compute only rows k2
            # <= 64 and copy the mirrored bins: half and full are the same bits.
            print(f"[3] spectrum_half {'bypass' if bypass else 'iir':6s} F={F:3d}: half vs full "
                  f"bitwise (row 4 launches rows 1, 2): {same}; mirrored bins bitwise: "
                  f"{mirrored(half)}; blocked_output the same bits (full and half): {blocked}")
            check(same and mirrored(half) and blocked, ("half vs full", F, bypass))
        for label, planes in fused_planes(fplan).items():
            err = _compare(f"fft_mag_fused F={F:3d} {label:12s}",
                           spectrum.fft_mag_fused_cuda(x32, win, planes),
                           spectrum.fft_mag_fused_plain(x32, win, planes), SNR_FLOOR_DB["float32"])
            if main and label == "plan":
                errs["fft_mag_fused"] = err
    return errs


def phase_rows_4_6(pp, fplan: dict, x_np: np.ndarray) -> dict:
    """Rows 4 and 6 through their entry points at 8 ch x 64 frames,
    DISPATCHES calls each (no runtime path calls them); returns their
    launches."""
    from tpu_sdr_torch.kernels.cuda import iir_fft, launch, spectrum

    x = torch.as_tensor(x_np, device="cuda").reshape(-1, N)
    zs = torch.zeros((x.shape[0], 12), device="cuda")
    win = pp.win.reshape(-1)
    launch.reset_counts()
    for _ in range(DISPATCHES):
        half = iir_fft.spectrum_from_state(x, zs, pp, bypass=True, half_spectrum=True)
        half_iir = iir_fft.spectrum_from_state(x, zs, pp, half_spectrum=True)
        fused = spectrum.fft_mag_fused(x, win, fplan)
    torch.cuda.synchronize()
    check_counts("rows 4 and 6", {"spectrum_half": 2 * DISPATCHES, "spectrum_bypass": DISPATCHES,
                                  "spectrum_iir": DISPATCHES, "fft_mag_fused": DISPATCHES})
    check(mirrored(half) and mirrored(half_iir) and torch.isfinite(half_iir).all(), "rows 4, 6")
    shape = (CHANNELS, FRAMES, N)
    check_golden(f"half spectrum, bypass form, {DISPATCHES} calls each form, spectrum_half "
                 f"launches {2 * DISPATCHES} (spectrum_bypass {DISPATCHES}, spectrum_iir "
                 f"{DISPATCHES})", half.view(shape), x_np, None)
    check_golden(f"fft_mag_fused, {DISPATCHES} calls, launches {DISPATCHES}",
                 fused.view(shape), x_np, None)
    return {name: launch.counts["kernel"][name] for name in ("spectrum_half", "fft_mag_fused")}


def phase_hop(sos_custom, x_np: np.ndarray):
    """The hop path (hop 8192) in BYPASS and CUSTOM; returns the pipeline."""
    from tpu_sdr_torch import FilterMode, PipelineConfig, SpectrumPipeline
    from tpu_sdr_torch.control import golden
    from tpu_sdr_torch.kernels.cuda import launch

    pipe = SpectrumPipeline(PipelineConfig(channels=CHANNELS, hop=HOP))
    pipe.upload_sos(sos_custom)
    x = torch.as_tensor(x_np, device="cuda")
    spectra = FRAMES * N // HOP
    w = golden.hann_true(N)
    launch.reset_counts()
    for k, mode in enumerate((FilterMode.BYPASS, FilterMode.CUSTOM), start=1):
        outs, st = run_dispatches(lambda a, s: pipe.process(a, s, mode), x, pipe.initial_state())
        check_counts(f"hop {mode.name}", {"spectrum_bypass": k * DISPATCHES,
                                          "iir_state": 2 * (k - 1) * DISPATCHES,
                                          "iir_emit": (k - 1) * DISPATCHES,
                                          "iir_force": (k - 1) * DISPATCHES})
        check(outs[0].shape == (CHANNELS, spectra, N), outs[0].shape)
        check(int(st.frame_count) == DISPATCHES * spectra and st.history.shape == (CHANNELS, N - HOP))
        y = x_np[0].astype(np.float64)
        if mode == FilterMode.CUSTOM:
            y = sps.sosfilt(sos_custom, y)
        ext = np.concatenate([np.zeros(N - HOP), y])
        rel = 0.0
        for f in (0, 1, spectra // 2, spectra - 1):
            ref = np.abs(np.fft.fft(ext[f * HOP : f * HOP + N] * w))
            rel = max(rel, np.abs(outs[0][0, f].double().cpu().numpy() - ref).max() / ref.max())
        print(f"[4] hop {HOP} {mode.name:6s}: {DISPATCHES} dispatches of {CHANNELS} x "
              f"{FRAMES * N} samples -> {spectra} spectra a channel, spectrum_bypass launches "
              f"{DISPATCHES}, plain 0; channel 0 vs the float64 STFT (frames 0, 1, "
              f"{spectra // 2}, {spectra - 1}): max_err/max={rel:.2e} (tol {HOP_GOLDEN_REL})")
        check(rel < HOP_GOLDEN_REL, ("hop golden", mode, rel))
    for mode in (FilterMode.BYPASS, FilterMode.CUSTOM):
        one, st_one, chunked, st = chunked_vs_oneshot(
            lambda a, s: pipe.process(a, s, mode), x, pipe.initial_state)
        bitwise = (torch.equal(chunked, one) and torch.equal(st.history, st_one.history)
                   and torch.equal(st.sos_state, st_one.sos_state))
        print(f"[4] hop {mode.name:6s} chunked (4 x {FRAMES // 4} frames' samples) vs one-shot, "
              f"history carried: bitwise={bitwise}")
        check(bitwise, ("hop chunked", mode))
    return pipe


def bank_designs() -> list:
    """8 different designs, one a channel: lowpass, highpass, bandpass and
    bandstop of five families, each at most 6 sections."""
    return [
        sps.butter(12, 0.05, output="sos"),
        sps.butter(12, 0.2, output="sos"),
        sps.cheby1(10, 0.5, 0.3, output="sos"),
        sps.ellip(8, 0.5, 60, 0.4, output="sos"),
        sps.butter(12, 0.3, btype="highpass", output="sos"),
        sps.cheby2(8, 60, 0.25, output="sos"),
        sps.butter(6, [0.2, 0.4], btype="bandpass", output="sos"),
        sps.butter(4, [0.1, 0.15], btype="bandstop", output="sos"),
    ]


def phase_bank(x_noise: np.ndarray):
    """A per-channel bank on noise; returns the pipeline."""
    from tpu_sdr_torch import FilterMode, PipelineConfig, SpectrumPipeline
    from tpu_sdr_torch.control import golden

    designs = bank_designs()
    pipe = SpectrumPipeline(PipelineConfig(channels=CHANNELS))
    fused = SpectrumPipeline(PipelineConfig(channels=CHANNELS, fused_two_pass=True))
    for p in (pipe, fused):
        p.upload_sos_bank(designs)
    x = torch.as_tensor(x_noise, device="cuda")
    from tpu_sdr_torch.kernels.cuda import launch

    launch.reset_counts()
    outs, st = run_dispatches(lambda a, s: pipe.process(a, s, FilterMode.CUSTOM), x,
                              pipe.initial_state())
    check_counts("bank", {"spectrum_bypass": DISPATCHES, "iir_state": 2 * DISPATCHES,
                          "iir_emit": DISPATCHES, "iir_force": DISPATCHES})
    win = golden.hann_true(N)
    worst = []
    for c in range(CHANNELS):
        ref = golden_magnitude(x_noise[c, : 2 * N], designs[c], win)
        got = outs[0][c, :2].double().cpu().numpy()
        mask = ref > ref.max() * 1e-3
        worst.append(np.abs(20 * np.log10(got[mask] / ref[mask])).max())
    print(f"[4] bank of {CHANNELS} designs, {DISPATCHES} dispatches, spectrum_bypass launches "
          f"{DISPATCHES}, plain 0; each channel's bins above -60 dB vs its golden: max "
          f"{max(worst):.2e} dB (tol {BANK_DB}; per channel "
          f"{', '.join(f'{d:.1e}' for d in worst)})")
    check(max(worst) < BANK_DB, ("bank golden", worst))
    launch.reset_counts()
    f_outs, _ = run_dispatches(lambda a, s: fused.process(a, s, FilterMode.CUSTOM), x,
                               fused.initial_state())
    check_counts("bank, fused_two_pass config",
                 {"spectrum_bypass": DISPATCHES, "iir_state": 2 * DISPATCHES,
                  "iir_emit": DISPATCHES, "iir_force": DISPATCHES})
    same = all(torch.equal(a, b) for a, b in zip(outs, f_outs))
    print(f"[4] bank under fused_two_pass=True: the hybrid branch (spectrum_bypass "
          f"{DISPATCHES}, iir_summaries 0, spectrum_iir 0), the same bits: {same}")
    check(same, "bank fused config")
    one, st_one, chunked, st = chunked_vs_oneshot(
        lambda a, s: pipe.process(a, s, FilterMode.CUSTOM), x, pipe.initial_state)
    bitwise = torch.equal(chunked, one) and torch.equal(st.sos_state, st_one.sos_state)
    print(f"[4] bank chunked (4 x {FRAMES // 4} frames) vs one-shot: bitwise={bitwise}")
    check(bitwise, "bank chunked")
    return pipe


def phase_analyzer(x_np: np.ndarray):
    """SpectrumAnalyzer driven by command bytes at 8 ch x 64 frames; returns
    an analyzer running CUSTOM, for the timing phase."""
    from tpu_sdr_torch import FilterMode, PipelineConfig, SpectrumAnalyzer
    from tpu_sdr_torch.control import design_iir_filter
    from tpu_sdr_torch.control.commands import Command, encode_coefficient_upload
    from tpu_sdr_torch.kernels.cuda import launch

    seen = []
    sa = SpectrumAnalyzer(PipelineConfig(channels=CHANNELS),
                          on_spectrum=lambda mag, i: seen.append((i, mag.shape)))
    x = torch.as_tensor(x_np, device="cuda")
    launch.reset_counts()
    check(sa.process(x) is None, "samples before START")
    sa.handle_bytes(bytes([Command.MODE_BYPASS, Command.START]))
    byp = sa.process(x)["magnitude"]
    # A notch at 250 kHz (bin 4096) that passes 100 kHz (bin 1638) and
    # survives the wire's int8 x64 quantization (a narrow lowpass's
    # numerator rounds to 0 there).
    design = design_iir_filter("butterworth", "bandstop", 2, 1e6, (230e3, 270e3))
    sa.handle_bytes(encode_coefficient_upload(design.to_wire_bytes()) + bytes([Command.MODE_CUSTOM]))
    cus = sa.process(x)["magnitude"]
    sa.handle_bytes(bytes([Command.COEFF_HDR]) + bytes([64, 0, 0, 64, 127, 127]) * 2)
    check(sa.stats.uploads_rejected == 1 and "unstable" in sa.last_upload_error, "rejected upload")
    check(sa.filter_mode == FilterMode.CUSTOM and sa.stats.coefficient_uploads == 1)
    ck = sa.checkpoint()
    after = sa.process(x)["magnitude"]
    sb = SpectrumAnalyzer(PipelineConfig(channels=CHANNELS))
    sb.restore(ck)
    resumed = sb.process(x)["magnitude"]
    check_counts("analyzer", {"spectrum_bypass": 4, "iir_state": 2 * 3, "iir_emit": 3,
                              "iir_force": 3})
    same = np.array_equal(after, resumed)
    cut = [cus[0, 0, k] / byp[0, 0, k] for k in TONE_BINS]
    frames = sa.stats.frames_produced
    hook = [i for i, _ in seen] == list(range(frames)) and all(s == (N,) for _, s in seen)
    print(f"[4] SpectrumAnalyzer {CHANNELS} ch x {FRAMES} frames: bytes 0xB1 0x55, 0xF1 + 12 "
          f"(a 230-270 kHz bandstop) 0xA1, an unstable 0xF1 rejected (uploads_rejected "
          f"{sa.stats.uploads_rejected}); tones at bins {TONE_BINS} at "
          f"{', '.join(f'{r:.2e}' for r in cut)} of BYPASS; spectrum_bypass launches 4 in 4 "
          f"process calls, plain 0; restored checkpoint == uninterrupted bitwise: {same}; "
          f"on_spectrum {len(seen)} calls for {frames} frames in order: {hook}; "
          f"host magnitudes {after.dtype} {after.shape}, {after.nbytes} bytes a call")
    check(after.dtype == np.float32 and after.shape == (CHANNELS, FRAMES, N), "analyzer output")
    check(same and hook and 0.9 < cut[0] < 1.1 and cut[1] < 1e-2, ("analyzer", same, hook, cut))
    check_golden("SpectrumAnalyzer BYPASS", torch.as_tensor(byp), x_np, None)
    sa.handle_bytes(bytes([Command.RESET]))
    check(not sa.running and sa.filter_mode == FilterMode.BYPASS
          and not sa.state.sos_state.any() and sa.stats.resets == 1, "reset")
    sa.handle_bytes(bytes([Command.START, Command.MODE_CUSTOM]))
    return sa


def new_paths(hop_pipe, bank_pipe, sa, x_np, x_noise) -> dict:
    """label -> step() of this slice's timed and profiled dispatches."""
    from tpu_sdr_torch import FilterMode

    x = torch.as_tensor(x_np, device="cuda")
    xn = torch.as_tensor(x_noise, device="cuda")
    steps = {f"hop {m.name}": chained(lambda a, s, m=m: hop_pipe.process(a, s, m), x,
                                      hop_pipe.initial_state)
             for m in (FilterMode.BYPASS, FilterMode.CUSTOM)}
    steps["bank CUSTOM"] = chained(lambda a, s: bank_pipe.process(a, s, FilterMode.CUSTOM), xn,
                                   bank_pipe.initial_state)
    steps["analyzer CUSTOM"] = lambda: sa.process(x)
    return steps


def phase_new_timing(pp, fplan: dict, x_np: np.ndarray, steps: dict) -> tuple[dict, dict]:
    """Rows 4 and 6 at F = 512 (kernel, plain, library, bound), then this
    slice's dispatch walls (hop, bank and the facade beside the default
    CUSTOM path's, in alternating turns)."""
    from tpu_sdr_torch.kernels.cuda import iir_fft, spectrum

    F = CHANNELS * FRAMES
    x = torch.as_tensor(x_np, device="cuda").reshape(F, N)
    win = pp.win.reshape(-1)
    fft_flops = 2.5 * N * math.log2(N)
    consts_dft = 4 * 128 * 4 + 2 * N * 4
    timing = {}

    def record(name, kernel, plain, library, b, tag):
        timing[name] = {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
                        "library_ms": cuda_ms(library),
                        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
        t = timing[name]
        print(f"[5] {name} F={F} {tag}: kernel {t['ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; "
              f"library {t['library_ms']:.4f} ms; bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
              f"({b['bytes'] / 1e6:.1f} MB, {b['flops'] / 1e9:.3f} GFLOP fp32) -> kernel at "
              f"{b['bound_ms'] / t['ms']:.1%} of the bound; {profiled(kernel)}")

    # The half spectrum's function is row 1's: the same bytes and an FFT.
    record("spectrum_half",
           lambda: iir_fft.spectrum_half_cuda(x, None, pp, True, "float32"),
           lambda: iir_fft.spectrum_half_plain(x, None, pp, True, "float32"),
           lambda: torch.abs(torch.fft.fft(x * win)),
           bound(F * N * 4 * 2 + consts_dft + N * 4, F * (N + fft_flops + 4 * N)),
           "bypass form, window in the kernel (the hop path's call of row 1)")
    zs = torch.zeros((F, 12), device="cuda")
    timing["spectrum_half"]["iir_form_ms"] = cuda_ms(lambda: iir_fft.spectrum_half_cuda(x, zs, pp))
    print(f"[5] spectrum_half: without the window "
          f"{cuda_ms(lambda: iir_fft.spectrum_half_cuda(x, None, pp, False, 'float32')):.4f} ms "
          f"(row 1 without it: {cuda_ms(lambda: iir_fft.spectrum_bypass_cuda(x, pp, False)):.4f} "
          f"ms); IIR form {timing['spectrum_half']['iir_form_ms']:.4f} ms (row 2: "
          f"{cuda_ms(lambda: iir_fft.spectrum_iir_cuda(x, zs, pp)):.4f} ms)")
    # Window, FFT of a real frame, magnitude; the six plan planes read once.
    record("fft_mag_fused",
           lambda: spectrum.fft_mag_fused_cuda(x, win, fplan),
           lambda: spectrum.fft_mag_fused_plain(x, win, fplan),
           lambda: torch.abs(torch.fft.fft(x * win)),
           bound(F * N * 4 * 2 + N * 4 + 6 * N * 4, F * (N + fft_flops + 4 * N)),
           "the plan's six planes")
    # Arbitrary planes leave no FFT: the kernel's floor is its dense work,
    # two complex 128^3 products a frame (2 real + 4 real GEMMs of 2 x 128^3
    # FLOP), six bf16 passes each on the tensor cores.
    dense = F * 6 * 2 * 128**3
    floor_ms = 6 * dense / PEAK_BF16_FLOPS * 1e3
    print(f"[5] fft_mag_fused dense floor: {dense / 1e9:.3f} GFLOP x 6 bf16 passes at "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s = {floor_ms:.4f} ms -> kernel at "
          f"{floor_ms / timing['fft_mag_fused']['ms']:.1%} of it (the bytes bound "
          f"{timing['fft_mag_fused']['bound_ms']:.4f} ms assumes an FFT)")
    fft64_snr("fft_mag_fused", torch.fft.fft(x.double() * win.double()).abs(),
              spectrum.fft_mag_fused_cuda(x, win, fplan), spectrum.fft_mag_fused_plain(x, win, fplan))

    samples = CHANNELS * FRAMES * N
    walls = {}
    turns = lambda a, b: [a, b, b, a] * 3
    order = (turns("hop BYPASS", "hop CUSTOM") + turns("bank CUSTOM", "CUSTOM")
             + turns("analyzer CUSTOM", "CUSTOM"))
    for label in order:
        med, lo, hi = dispatch_wall(steps[label])
        walls.setdefault(label, []).append(med)
        print(f"[5] {label:17s} dispatch ({CHANNELS} ch x {samples // CHANNELS} samples): median "
              f"{med * 1e3:.4f} ms (min {lo * 1e3:.4f}, max {hi * 1e3:.4f}) "
              f"-> {samples / med:.4e} samples/s")
    for label, meds in walls.items():
        print(f"[5] {label:17s} {len(meds)} turns: median {statistics.median(meds) * 1e3:.4f} ms "
              f"(turns {', '.join(f'{m * 1e3:.4f}' for m in meds)})")
    print(f"[5] the facade's device->host copy: {CHANNELS * FRAMES * N * 4} bytes a call (fp32)")
    return {label: statistics.median(v) for label, v in walls.items()}, timing


# ---------------------------------------------------------------- the Q15 path and the host runtime


# The Q15 path's width: the reference's own (one channel, N = 16384, 6
# sections). Its coefficients: a designed low-pass's int8 x64 wire words
# (three sections, padded with identity sections by upload_sos_q).
Q15_SOS_Q = np.array([[1, 2, 1, 64, -73, 21], [64, 128, 64, 64, -84, 33],
                      [64, 127, 64, 64, -106, 65]], np.int64)
Q15_KERNEL_FRAMES = (1, 3, 8, 64, 133)
Q15_CHUNKS = 6  # Q15Stream's chunks of one frame, at depth 1 and 3
FEED_CHUNKS = 8  # StreamFeeder -> SpectrumPipeline.process
FEED_FRAMES = 8  # frames a channel in one fed chunk (8 channels)
HOSTFED_SEED = 2**31 + 27  # the host-fed bank's designs and ring
HOSTFED_CHECK_CHUNKS = 10  # host-fed against device-fed: 2.5 wraps of the ring of 4
HOSTFED_CHUNKS = 24  # chunks timed a path of the host-fed bank
WELCH_REL = 1e-5  # of the peak, against scipy.signal.welch in float64
# K2's dependent chain in cycles, 4 a dependent integer operation. What
# the function needs: a (sample, section) step, from the previous output of
# its section (or from its input) to its clipped output, is one IMAD (acc
# and acc + 32 side by side), the add of acc's sign, the shift and the
# clip's min and max (20); b0 v + b1 v[n-1] + z1[n-1] and the state update
# are off that chain. The longest path through the T x S grid: S steps
# down and T - 1 across. The thread-a-row design's floor counted six
# operations a step (24) and the state update's IMAD on each step across
# (4), more than the function needs; it is printed beside this one for
# comparison.
Q15_CHAIN_CYCLES = 20
Q15_ROW_STEP_CYCLES, Q15_ROW_STATE_CYCLES = 24, 4


# K2's sweep in [3]: samples a row (the plain version walks them one step of
# tensor operations each, the oracle one Python step a section) and row
# counts (1; a full packed warp at up to 4 sections; 33, part-full).
K2_SWEEP_T, K2_SWEEP_ROWS = 2048, (1, 4, 33)


def q15_tones(frames: int, seed: int) -> np.ndarray:
    """One channel of int16 samples: two tones at 0.45 of full scale each
    (bins 1638 and 4096) plus noise, so the sum reaches the rails."""
    n = np.arange(frames * N)
    x = sum(0.45 * 32767 * np.sin(2 * np.pi * k * n / N) for k in TONE_BINS)
    x = x + 300 * np.random.default_rng(seed).standard_normal(n.size)
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


def q15_kernel_inputs(frames: int, kind: str, seed: int) -> torch.Tensor:
    """(frames, N) int16 on the card: random N(0, 6000) or full-scale tones
    (a different bin each frame, clipped at the rails)."""
    if kind == "random":
        x = np.random.default_rng(seed).standard_normal((frames, N)) * 6000
    else:
        k = 1 + (np.arange(frames)[:, None] * 977) % (N // 2 - 1)
        x = 32767 * np.cos(2 * np.pi * k * np.arange(N) / N + 0.3)
    return torch.as_tensor(np.clip(np.round(x), -32768, 32767).astype(np.int16), device="cuda")


def padded_q15_sos() -> np.ndarray:
    sos = np.tile(np.array([64, 0, 0, 64, 0, 0], np.int64), (6, 1))
    sos[: len(Q15_SOS_Q)] = Q15_SOS_Q
    return sos


def phase_q15_kernels() -> dict:
    """K1 (q15_fft) and K2 (sosfilt_q15) against their plain versions on the
    card, bit for bit; K2 also against golden.sosfilt_q15_intended. Returns
    each one's max abs error at the main path's shape (K1 at F = 64 without
    the window, as the filtered paths call it; K2 on 1 row of 2 frames)."""
    from tpu_sdr_torch.control import golden
    from tpu_sdr_torch.kernels import biquad, fft_q15, window

    rom = window.hann_q16_rom(N, device="cuda")
    errs = {}
    for F in Q15_KERNEL_FRAMES:
        route = fft_q15.kernel_route(F, N)
        for kind in ("random", "tone"):
            x = q15_kernel_inputs(F, kind, 60 + F)
            for bypass in (True, False):
                r = rom if bypass else None
                got = fft_q15.window_fft_q15_cuda(x, rom=r)
                ref = fft_q15.window_fft_q15_plain(x, rom=r)
                torch.cuda.synchronize()
                same = all(g.dtype == p.dtype and torch.equal(g, p) for g, p in zip(got, ref))
                err = max((g.float() - p.float()).abs().max().item() for g, p in zip(got, ref))
                oracle = bypass or all(np.array_equal(g.cpu().numpy(), o) for g, o in
                                       zip(got[:2], fft_q15.fft_q15_np(x.cpu().numpy())))
                print(f"[3] q15_fft F={F:3d} {kind:6s} {'window+fft' if bypass else 'fft':10s} "
                      f"(route {route[0]}, {route[1]} CTA(s) a frame): re, im, |X| bitwise equal to "
                      f"the plain version: {same} (max_abs_err {err}); to fft_q15_np: {oracle}")
                check(same and oracle, ("q15_fft", F, kind, bypass))
                if F == 64 and kind == "random" and not bypass:
                    errs["q15_fft"] = err
    # Every frame size 2^1 .. 2^14 (the block route below 2^14), complex
    # input, schedules t % 3 (shifts of 0, 1 and 2), the window on even
    # sizes; then 2^14 at full scale with the schedule all zeros (every rank
    # saturates) and 2, 0 alternating.
    rng = np.random.default_rng(66)
    cases = [(m, tuple(t % 3 for t in range(m)), "random") for m in range(1, 15)]
    cases += [(14, (0,) * 14, "full"), (14, (2, 0) * 7, "full")]
    for m, sched, kind in cases:
        n, F = 1 << m, 3
        if kind == "random":
            xs = [np.clip(np.round(rng.standard_normal((F, n)) * 6000), -32768, 32767) for _ in range(2)]
        else:
            xs = [rng.choice([-32768.0, 32767.0], (F, n)) for _ in range(2)]
        xr, xi = (torch.as_tensor(v.astype(np.int16), device="cuda") for v in xs)
        r = window.hann_q16_rom(n, device="cuda") if m % 2 == 0 and kind == "random" else None
        got = fft_q15.window_fft_q15_cuda(xr, xi, rom=r, schedule=sched)
        ref = fft_q15.window_fft_q15_plain(xr, xi, rom=r, schedule=sched)
        torch.cuda.synchronize()
        same = all(torch.equal(g, p) for g, p in zip(got, ref))
        oracle = r is not None or all(np.array_equal(g.cpu().numpy(), o) for g, o in zip(
            got[:2], fft_q15.fft_q15_np(xr.cpu().numpy(), xi.cpu().numpy(), schedule=sched)))
        rails = int((got[0].abs() >= 32767).sum())
        route = fft_q15.kernel_route(F, n)
        print(f"[3] q15_fft n=2^{m:<2d} F={F} complex {kind:6s} schedule {''.join(map(str, sched))}"
              f"{' window' if r is not None else ''} (route {route[0]}, {route[1]} CTA(s) a frame): "
              f"bitwise equal to the plain version: {same}; to fft_q15_np: {oracle}; {rails} "
              f"outputs at the rails")
        check(same and oracle, ("q15_fft sizes", m, sched, kind))
    sos = padded_q15_sos()
    sos_t = torch.as_tensor(sos, dtype=torch.int32, device="cuda")
    rom_np = golden.hann_q16_rom(N)
    for rows in (1, 4):
        x_np = np.stack([q15_tones(2, 80 + r) for r in range(rows)])
        zi_np = np.random.default_rng(81).integers(-20000, 20000, (rows, 6, 2)).astype(np.int32)
        x, zi = torch.as_tensor(x_np, device="cuda"), torch.as_tensor(zi_np, device="cuda")
        got = biquad.sosfilt_q15_cuda(sos_t, x, zi, rom=rom)
        ref = biquad.sosfilt_q15_plain(sos_t, x, zi, rom=rom)
        torch.cuda.synchronize()
        same = all(torch.equal(g, p) for g, p in zip(got, ref))
        err = max((g.float() - p.float()).abs().max().item() for g, p in zip(got, ref))
        oracle = True
        for r in range(rows):
            xw = golden.rtl_window_q15(x_np[r])
            y, zf = golden.sosfilt_q15_intended(sos, xw, zi_np[r])
            oracle &= (np.array_equal(got[1][r].cpu().numpy(), xw)
                       and np.array_equal(got[0][r].cpu().numpy(), y)
                       and np.array_equal(got[2][r].cpu().numpy().astype(np.int64), zf))
        print(f"[3] sosfilt_q15 {rows} row(s) x 2 frames, window + 6 sections, carried state: "
              f"windowed, filtered and state bitwise equal to the plain version: {same} (max_abs_err "
              f"{err}); to golden.sosfilt_q15_intended: {oracle}")
        check(same and oracle, ("sosfilt_q15", rows))
        if rows == 1:
            errs["sosfilt_q15"] = err
    # 1 to 8 sections, a lane each; rows packed 32 / G a warp (33 rows leave
    # the last warp part-full), full-scale input and loud sections, so that
    # every section's output reaches the rails.
    rng = np.random.default_rng(85)
    rom_k = window.hann_q16_rom(K2_SWEEP_T // 4, device="cuda")
    for sections in range(1, 9):
        sos = np.zeros((sections, 6), np.int64)
        sos[:, 0] = rng.integers(100, 128, sections)
        sos[:, 1:3] = rng.integers(-128, 128, (sections, 2))
        sos[:, 3] = 64
        sos[:, 4] = rng.integers(-40, 40, sections)
        sos[:, 5] = rng.integers(0, 30, sections)
        sos_t = torch.as_tensor(sos, dtype=torch.int32, device="cuda")
        for rows in K2_SWEEP_ROWS:
            x_np = np.clip(np.round(rng.standard_normal((rows, K2_SWEEP_T)) * 32767), -32768,
                           32767).astype(np.int16)
            zi_np = rng.integers(-200_000, 200_000, (rows, sections, 2)).astype(np.int32)
            x, zi = torch.as_tensor(x_np, device="cuda"), torch.as_tensor(zi_np, device="cuda")
            got = biquad.sosfilt_q15_cuda(sos_t, x, zi, rom=rom_k)
            ref = biquad.sosfilt_q15_plain(sos_t, x, zi, rom=rom_k)
            torch.cuda.synchronize()
            same = all(torch.equal(g, p) for g, p in zip(got, ref))
            rails = int((got[0].abs() >= 32767).sum())
            oracle = True
            for r in range(rows):
                xw = np.asarray(got[1][r].cpu().numpy())
                oracle &= np.array_equal(xw, golden.rtl_window_q15(x_np[r], n=K2_SWEEP_T // 4))
                y, zf = golden.sosfilt_q15_intended(sos, xw, zi_np[r])
                oracle &= (np.array_equal(got[0][r].cpu().numpy(), y)
                           and np.array_equal(got[2][r].cpu().numpy().astype(np.int64), zf))
            print(f"[3] sosfilt_q15 {sections} section(s), {rows:2d} row(s) x {K2_SWEEP_T}, window, "
                  f"full scale: bitwise equal to the plain version: {same}; to "
                  f"golden.sosfilt_q15_intended: {oracle}; {rails} samples at the rails")
            check(same and oracle and rails > 0, ("sosfilt_q15 sweep", sections, rows))
    return errs


def phase_q15_path() -> tuple[dict, dict]:
    """Q15Pipeline on the card at the reference's width: the all-device path
    and the live split (filtered and bypass), two chunks of 2 frames with the
    state carried, against the CLI selftest's oracle chain
    fft_q15_np(sosfilt_q15_intended(rtl_window_q15(x))) bit for bit; then
    display_frame. Returns (launches of K1 and K2 in the path's run, the
    pipelines)."""
    from tpu_sdr_torch import PipelineConfig
    from tpu_sdr_torch.control import golden
    from tpu_sdr_torch.kernels import fft_q15
    from tpu_sdr_torch.kernels.cuda import launch
    from tpu_sdr_torch.runtime.q15 import Q15Pipeline

    cfg = PipelineConfig(channels=1)
    x = q15_tones(4, 90)
    xw = golden.rtl_window_q15(x)
    filt, zf_ref = golden.sosfilt_q15_intended(padded_q15_sos(), xw)
    wire = fft_q15.fft_q15_np(filt.reshape(4, N))
    wire_bypass = fft_q15.fft_q15_np(xw.reshape(4, N))
    dev = Q15Pipeline(cfg)
    split = Q15Pipeline(cfg, device_fft=True)
    for p in (dev, split):
        p.upload_sos_q(Q15_SOS_Q)
    host = lambda v: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    results = {}
    launches = dict.fromkeys(("q15_fft", "sosfilt_q15"), 0)
    for label, pipe, bypass, want in (
            ("all-device", dev, False, {"q15_fft": 2, "sosfilt_q15": 2}),
            ("split filtered", split, False, {"q15_fft": 2}),
            ("split bypass", split, True, {"q15_fft": 2})):
        launch.reset_counts()
        zi, outs = None, []
        for c in range(2):
            out, zi = pipe.process(x[c * 2 * N:(c + 1) * 2 * N], zi, bypass=bypass)
            outs.append({k: host(v) for k, v in out.items()})
        results[label] = (outs, host(zi))
        torch.cuda.synchronize()
        check_counts(f"Q15 {label}", want)
        for k in launches:
            launches[k] += launch.counts["kernel"][k]
    for label, (outs, zf) in results.items():
        ref = wire_bypass if label == "split bypass" else wire
        re = np.concatenate([o["spectrum_re_q15"].reshape(-1, N) for o in outs])
        im = np.concatenate([o["spectrum_im_q15"].reshape(-1, N) for o in outs])
        mag = np.concatenate([o["magnitude"].reshape(-1, N) for o in outs])
        ok = np.array_equal(re, ref[0]) and np.array_equal(im, ref[1])
        fr, fi = ref[0].astype(np.float32), ref[1].astype(np.float32)
        mag_ref = np.sqrt(fr * fr + fi * fi)
        mag_rel = float((np.abs(mag - mag_ref) / np.maximum(mag_ref, 1.0)).max())
        if label != "split bypass":
            ok &= (np.array_equal(np.concatenate([o["windowed_q15"].reshape(-1) for o in outs]), xw)
                   and np.array_equal(np.concatenate([o["filtered_q15"].reshape(-1) for o in outs]),
                                      filt)
                   and np.array_equal(zf.reshape(6, 2).astype(np.int64), zf_ref))
        print(f"[4] Q15 {label:14s} 1 ch x 2 chunks of 2 frames (N = {N}, 6 sections), state "
              f"carried ({zf.dtype}): wire words re/im{'' if label == 'split bypass' else ', windowed, filtered, state'} "
              f"bitwise equal to the oracle chain: {ok}; |X| against NumPy's fp32 sqrt(re^2 + im^2): "
              f"bitwise {mag_rel == 0}, max rel err {mag_rel:.1e} (tol 1e-6)")
        check(ok and mag_rel <= 1e-6, ("Q15 path", label))
    print(f"[4] Q15 path launches, each form counted on its own: q15_fft {launches['q15_fft']} "
          f"(2 a form), sosfilt_q15 {launches['sosfilt_q15']} (the all-device form's 2), plain 0")
    for bypass in (False, True):
        out, _ = split.process(x[: 2 * N], bypass=bypass, display=True)
        disp = out["display_frame"]
        last = torch.stack([out["spectrum_re_q15"][..., -1, :].float(),
                            out["spectrum_im_q15"][..., -1, :].float(), out["magnitude"][..., -1, :]],
                           dim=-2)
        same = disp.shape == (1, 3, N) and torch.equal(disp, last)
        print(f"[4] Q15 split {'bypass' if bypass else 'filtered'} display_frame {tuple(disp.shape)} "
              f"== the last frame's [re, im, |X|]: {same}")
        check(same, ("display_frame", bypass))
    return launches, {"all-device": dev, "split": split}


def phase_q15_stream(split):
    """Q15Stream over the split pipeline: at depth 1 and 3 bitwise equal to
    sequential process() calls, then its steady rate at depth 1 (filtered,
    the magnitude fetched each chunk). Runs after the profiles: its worker
    thread launches on the card."""
    from tpu_sdr_torch.runtime.q15 import Q15Stream

    host = lambda v: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    chunks = [q15_tones(1, 100 + i) for i in range(Q15_CHUNKS)]
    zi, refs = None, []
    for c in chunks:
        o, zi = split.process(c, zi)
        refs.append({k: host(v) for k, v in o.items()})
    for depth in (1, 3):
        stream = Q15Stream(split, fetch=("magnitude", "spectrum_re_q15", "spectrum_im_q15"),
                           depth=depth)
        got = [r for c in chunks if (r := stream.push(c)) is not None]
        while (r := stream.flush()) is not None:
            got.append(r)
        stream.close()
        same = len(got) == len(refs) and all(
            np.array_equal(o[k], ref[k]) for (o, _), ref in zip(got, refs)
            for k in ("magnitude", "spectrum_re_q15", "spectrum_im_q15", "filtered_q15"))
        print(f"[4] Q15Stream depth {depth}: {Q15_CHUNKS} chunks of 1 frame bitwise equal to "
              f"sequential process() calls: {same}")
        check(same, ("Q15Stream", depth))
    q15_stream_rates(split)


def q15_stream_rates(split) -> dict:
    """Q15Stream's steady rate at depth 1 against sequential process()
    calls (filtered, the magnitude fetched each chunk), in turns, after the
    split path's halves alone and side by side. Returns {"stream" |
    "sequential": [MSPS of each turn]}."""
    from tpu_sdr_torch.runtime.q15 import Q15Stream

    chunks = [q15_tones(1, 130 + i) for i in range(8)]
    reps = 64

    def streamed() -> float:
        stream = Q15Stream(split, depth=1)
        t0 = time.perf_counter()
        for i in range(reps):
            stream.push(chunks[i % len(chunks)])
        while stream.flush() is not None:
            pass
        dt = time.perf_counter() - t0
        stream.close()
        return dt

    def sequential() -> float:
        zi = None
        t0 = time.perf_counter()
        for i in range(reps):
            out, zi = split.process(chunks[i % len(chunks)], zi)
            out["magnitude"].cpu().numpy()
        return time.perf_counter() - t0

    streamed(), sequential()  # warm-up
    # The halves Q15Stream runs on two threads: the host stage (the worker's)
    # and the device stage with the fetch (the caller's), each alone, then
    # both at once as the stream runs them.
    staged = [split._split_host(c, None) for c in chunks]

    def host_half() -> float:
        t0 = time.perf_counter()
        for i in range(reps):
            split._split_host(chunks[i % len(chunks)], None)
        return (time.perf_counter() - t0) / reps * 1e3

    def device_half() -> float:
        t0 = time.perf_counter()
        for i in range(reps):
            ys, xw, _ = staged[i % len(staged)]
            split._split_device(ys, xw)["magnitude"].cpu().numpy()
        return (time.perf_counter() - t0) / reps * 1e3

    alone = host_half(), device_half()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        worker = pool.submit(host_half)
        caller = device_half()
        both = worker.result(), caller
    print(f"[5] the split path's halves, ms a chunk of {N}: host stage (native window + 6 "
          f"sections) {alone[0]:.4f} alone, {both[0]:.4f} on a thread beside the device half; "
          f"device half (upload, K1, fetch) {alone[1]:.4f} alone, {both[1]:.4f} beside the host stage")
    rates = {"stream": [], "sequential": []}
    for label in ("stream", "sequential", "sequential", "stream"):
        dt = streamed() if label == "stream" else sequential()
        what = ("Q15Stream depth 1" if label == "stream"
                else "sequential process() + the magnitude's fetch")
        rates[label].append(reps * N / dt / 1e6)
        print(f"[5] {what}, filtered: {reps} chunks of {N} in {dt * 1e3:.2f} ms -> "
              f"{rates[label][-1]:.3f} MSPS ({dt / reps * 1e3:.4f} ms a chunk)")
    return rates


def phase_host_runtime(pipe, sos_custom):
    """StreamFeeder -> SpectrumPipeline.process against the same chunks
    passed directly; WelchPSD against scipy.signal.welch in float64;
    decimate_db's five detectors against NumPy."""
    import scipy.signal as sps_

    from tpu_sdr_torch import FilterMode
    from tpu_sdr_torch.runtime import StreamFeeder, WelchPSD, waterfall
    from tpu_sdr_torch.runtime.source import SyntheticSource

    kw = dict(tones_hz=((100e3, 0.4), (250e3, 0.3)), noise=0.01, channels=CHANNELS, seed=5)
    t_chunk = FEED_FRAMES * N
    feeder = StreamFeeder(SyntheticSource(**kw), chunk_samples=t_chunk, depth=2).start()
    st = pipe.initial_state()
    fed = []
    try:
        t0 = time.perf_counter()
        for _ in range(FEED_CHUNKS):
            out, st = pipe.process(feeder.get(), st, FilterMode.CUSTOM)
            fed.append(out["magnitude"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / FEED_CHUNKS
    finally:
        feeder.stop()
    ref_src = SyntheticSource(**kw)
    st = pipe.initial_state()
    direct = []
    for _ in range(FEED_CHUNKS):
        out, st = pipe.process(torch.as_tensor(ref_src.read(t_chunk), device="cuda"), st,
                               FilterMode.CUSTOM)
        direct.append(out["magnitude"])
    same = all(torch.equal(a, b) for a, b in zip(fed, direct))
    print(f"[4] StreamFeeder (depth 2, pinned buffers {len(feeder._pinned)}) -> SpectrumPipeline."
          f"process CUSTOM, {FEED_CHUNKS} chunks of {CHANNELS} x {t_chunk}: staged "
          f"{feeder.chunks_staged}, wall {wall * 1e3:.4f} ms a chunk (source, copy and dispatch); "
          f"bitwise equal to the chunks passed directly: {same}")
    check(same and feeder.chunks_staged >= FEED_CHUNKS, "feeder")
    rng = np.random.default_rng(6)
    t = np.arange(16 * N) / 1e6
    x = (0.7 * np.sin(2 * np.pi * 123e3 * t) + 0.05 * rng.standard_normal(t.size) + 0.3
         ).astype(np.float32)
    z = (np.exp(2j * np.pi * -200e3 * t) + 0.1 * (rng.standard_normal(t.size)
                                                  + 1j * rng.standard_normal(t.size))
         ).astype(np.complex64)
    for average in ("mean", "median"):
        for noverlap in (None, 0):
            est = WelchPSD(nperseg=N, noverlap=noverlap, average=average)
            nseg = est.segment_count(t.size)
            got = est.compute(x).cpu().numpy()
            _, ref = sps_.welch(x.astype(np.float64), fs=1e6, nperseg=N, noverlap=noverlap,
                                average=average)
            rel = np.abs(got - ref).max() / ref.max()
            got_iq = est.compute_iq(z.real.copy(), z.imag.copy()).cpu().numpy()
            _, ref_iq = sps_.welch(z.astype(np.complex128), fs=1e6, nperseg=N, noverlap=noverlap,
                                   average=average, return_onesided=False)
            rel_iq = np.abs(got_iq - ref_iq).max() / ref_iq.max()
            print(f"[4] WelchPSD nperseg {N} {average:6s} nseg {nseg} "
                  f"({'even' if nseg % 2 == 0 else 'odd'}): compute max_err/peak {rel:.2e}, "
                  f"compute_iq {rel_iq:.2e} vs scipy float64 (tol {WELCH_REL})")
            check(rel < WELCH_REL and rel_iq < WELCH_REL, ("welch", average, noverlap))
    mag = direct[-1]
    host = mag.double().cpu().numpy().reshape(*mag.shape[:-1], 1024, N // 1024)
    refs = {"peak": host.max(-1), "minpeak": host.min(-1), "avg": host.mean(-1),
            "rms": np.sqrt((host * host).mean(-1)), "sample": host[..., 0]}
    for det, ref in refs.items():
        lin = waterfall.decimate_db(mag, 1024, db=False, detector=det).double().cpu().numpy()
        db = waterfall.decimate_db(mag, 1024, detector=det).double().cpu().numpy()
        exact = det in ("peak", "minpeak", "sample")
        err = np.abs(lin - ref).max() / ref.max()
        err_db = np.abs(db - 20 * np.log10(np.maximum(ref, 1e-9))).max()
        print(f"[4] decimate_db {det:7s} {tuple(mag.shape)} -> {tuple(db.shape)}: linear "
              f"{'bitwise' if exact else 'max_err/max'} {err == 0 if exact else f'{err:.2e}'}, "
              f"dB max_err {err_db:.2e} dB vs NumPy float64")
        check((err == 0 if exact else err < 1e-6) and err_db < 1e-4, ("decimate_db", det))


def phase_host_feed():
    """The host-fed bank at ``bank64.custom.hostfed``'s chunk (64 ch x 16
    frames, 67,108,864 B, a ring of 4, feeder depth 2, CUSTOM): the pinned
    ring path (``PinnedRingSource``, no host copy) == ``process`` on the
    device ring bit for bit over 2.5 wraps; then the pinned path, the
    staging path (the same chunks from a NumPy source, copied into the
    feeder's pinned buffers) and the device-fed path each timed over
    ``HOSTFED_CHUNKS`` chunks after a warm-up, the feeder restarted empty
    before the timed chunks; and the link alone, one slot copied ten times,
    timed with CUDA events."""
    from sdrbench import inputs, spec, system
    from tpu_sdr_torch import FilterMode, SpectrumPipeline, StreamFeeder
    from tpu_sdr_torch.runtime.source import CallbackSource, PinnedRingSource

    cell = spec.find_cell(spec.load_benchmark(), "bank64.custom.hostfed")
    cfg, traffic = cell.config, cell.traffic
    ring = inputs.make_ring(cfg, traffic, HOSTFED_SEED, "cuda")
    slots, t = ring.shape[0], ring.shape[-1]
    pipe = SpectrumPipeline(system.pipeline_config(cfg))
    pipe.upload_sos_bank(inputs.make_designs(cfg, HOSTFED_SEED))
    src = PinnedRingSource(slots, tuple(ring.shape[1:]))
    for slot, chunk in zip(src.slots, ring):
        slot.copy_(chunk)
    host = [chunk.cpu().numpy() for chunk in ring]
    nbytes = src.slots[0].numel() * 4
    mode = FilterMode.CUSTOM

    def feed(source, chunks, warm=0):
        """(outputs or None, final state, ms a chunk after ``warm`` chunks, stats)."""
        source_reset = getattr(source, "reset", None)
        if source_reset is not None:
            source_reset()
        feeder = StreamFeeder(source, t, depth=traffic["feeder_depth"]).start()
        st, outs = pipe.initial_state(), []
        try:
            for k in range(warm + chunks):
                if k == warm:
                    if warm:  # staged ahead no more: every timed chunk crosses in the window
                        feeder.stop()
                        feeder.start()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                out, st = pipe.process(feeder.get(), st, mode)
                if not warm:
                    outs.append(out["magnitude"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / chunks * 1e3
        finally:
            feeder.stop()
        return outs or None, st, ms, dict(feeder.stats)

    fed, fed_st, _, stats = feed(src, HOSTFED_CHECK_CHUNKS)
    st, direct = pipe.initial_state(), []
    for k in range(HOSTFED_CHECK_CHUNKS):
        out, st = pipe.process(ring[k % slots], st, mode)
        direct.append(out["magnitude"])
    same = (all(torch.equal(a, b) for a, b in zip(fed, direct))
            and torch.equal(fed_st.sos_state, st.sos_state)
            and int(fed_st.frame_count) == int(st.frame_count))
    del fed, direct
    _, _, pinned_ms, pinned_stats = feed(src, HOSTFED_CHUNKS, warm=slots)
    k_read = iter(range(10**9))
    numpy_src = CallbackSource(lambda n: host[next(k_read) % slots])
    _, _, staged_ms, staged_stats = feed(numpy_src, HOSTFED_CHUNKS, warm=slots)
    st = pipe.initial_state()
    for k in range(slots + HOSTFED_CHUNKS):
        if k == slots:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        _, st = pipe.process(ring[k % slots], st, mode)
    torch.cuda.synchronize()
    device_ms = (time.perf_counter() - t0) / HOSTFED_CHUNKS * 1e3
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    src.slots[0].to("cuda", non_blocking=True)
    a.record()
    for _ in range(10):
        src.slots[0].to("cuda", non_blocking=True)
    b.record()
    b.synchronize()
    link_gb_s = 10 * nbytes / (a.elapsed_time(b) / 1e3) / 1e9
    msps = lambda ms: cell.samples_per_chunk / (ms / 1e3) / 1e6
    print(f"[4] host feed, {cfg['channels']} ch x {traffic['frames_per_chunk']} frames a chunk "
          f"({nbytes:,} B f32), ring of {slots}, depth {traffic['feeder_depth']}, CUSTOM: "
          f"host-fed == device-fed bit for bit over {HOSTFED_CHECK_CHUNKS} chunks (spectra, state, "
          f"frame count): {same}; bytes_staged {stats['bytes_staged']:,} = "
          f"{stats['chunks_staged']} x {nbytes:,}, host_copies {stats['host_copies']}; the ring's "
          f"slots waited for their copies {src.release_waits} times in all")
    for label, ms, s_ in (("pinned ring (no host copy)", pinned_ms, pinned_stats),
                          ("staging path (NumPy source)", staged_ms, staged_stats)):
        print(f"[4] host feed {label}: {ms:.4f} ms a chunk, {msps(ms):.1f} Msamples/s, "
              f"{nbytes / (ms / 1e3) / 1e9:.2f} GB/s over {HOSTFED_CHUNKS} chunks; "
              + ", ".join(f"{k} {v}" for k, v in s_.items()))
    print(f"[4] host feed device-fed (the on-card cell's path): {device_ms:.4f} ms a chunk, "
          f"{msps(device_ms):.1f} Msamples/s; the link alone: {link_gb_s:.2f} GB/s (one pinned "
          f"slot copied 10 times, CUDA events)")
    check(same and stats["host_copies"] == 0 and pinned_stats["host_copies"] == 0
          and stats["bytes_staged"] == stats["chunks_staged"] * nbytes
          and staged_stats["host_copies"] == staged_stats["chunks_staged"], "host feed")


def q15_chain_floor_ms(t: int, sections: int) -> tuple[float, float, float]:
    """K2's latency floor for a row of t samples: (ms, the thread-a-row
    design's floor in ms, SM clock MHz)."""
    mhz = max_sm_mhz()
    cycles = (sections + t - 1) * Q15_CHAIN_CYCLES
    row = sections * Q15_ROW_STEP_CYCLES + (t - 1) * (Q15_ROW_STEP_CYCLES + Q15_ROW_STATE_CYCLES)
    return cycles / (mhz * 1e3), row / (mhz * 1e3), mhz


def q15_fft_int_ops(n: int, schedule) -> int:
    """The int32 operations one frame of fft_q15 needs under ``schedule``,
    an issue slot each. At rank t each of the n / 2 butterflies adds and
    subtracts (4), then shifts by s (4) if s >= 1, where (a +- b) >> s
    already lies in int16, or clamps (8 min / max) if s = 0, where there is
    no shift; the n / 2 - 2^t butterflies with j != 0 (each of rank t's 2^t
    groups has one j = 0, which keeps d as it is) form the complex product
    (2 multiplies and 2 multiply-adds, an IMAD each), shift it (2) and
    clamp it (4 min / max)."""
    return sum(n // 2 * (4 + (4 if s else 8)) + (n // 2 - (1 << t)) * 10
               for t, s in enumerate(schedule))


def phase_q15_timing(pipes: dict) -> tuple[dict, dict, dict]:
    """K1 at F = 64 and K2 at 1 row x 2 frames (kernel, plain, bound; no
    single PyTorch call computes either function), then the Q15 paths'
    wall per 16384-sample chunk. Returns (walls, timing, the paths' steps
    for the profile)."""
    from tpu_sdr_torch.kernels import biquad, fft_q15, window
    timing = {}
    F = 64
    x = q15_kernel_inputs(F, "random", 64)
    # The function per frame: the ranks' int32 operations under the timed
    # schedule (the default, one bit a rank; q15_fft_int_ops), the
    # magnitude in fp32 per sample (2 converts, 2 multiplies, an add, a
    # square root); 2 bytes in and 8 out a sample, the twiddle table once.
    # The uniform count, 28 operations a butterfly at every rank (the sum's
    # and the difference's clamps too, and the product at j = 0), is
    # printed beside it.
    ops = q15_fft_int_ops(N, (1,) * 14)
    b = bound(F * N * (2 + 8) + N // 2 * 4, F * N * 6, int_ops=F * ops)
    b_uniform = bound(F * N * (2 + 8) + N // 2 * 4, F * N * 6, int_ops=F * N * 14 * 14)
    timing["q15_fft"] = {"ms": cuda_ms(lambda: fft_q15.window_fft_q15_cuda(x)),
                         "plain_ms": cuda_ms(lambda: fft_q15.window_fft_q15_plain(x), iters=5),
                         "library_ms": None, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
    t = timing["q15_fft"]
    rom = window.hann_q16_rom(N, device="cuda")
    print(f"[5] q15_fft F={F} (fft, the filtered paths' call): kernel {t['ms']:.4f} ms "
          f"({t['ms'] / F * 1e3:.3f} us a frame); plain {t['plain_ms']:.4f} ms; library none; bound "
          f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bytes'] / 1e6:.2f} MB; {b['int_ops'] / 1e9:.3f} "
          f"G int32 operations at {peak_int32_ops() / 1e12:.2f} T/s, the INT32 issue rate, and "
          f"{b['flops'] / 1e9:.4f} GFLOP fp32) -> kernel at {b['bound_ms'] / t['ms']:.1%} of the "
          f"bound (the uniform count, {b_uniform['int_ops'] / 1e9:.3f} G: {b_uniform['bound_ms']:.4f} ms, "
          f"{b_uniform['bound_ms'] / t['ms']:.1%}); window+fft "
          f"{cuda_ms(lambda: fft_q15.window_fft_q15_cuda(x, rom=rom)):.4f} ms; "
          f"{profiled(lambda: fft_q15.window_fft_q15_cuda(x))}")
    # K1 at the main path's shape (F = 1: one channel's chunk) and between.
    # Its floors at F = 1: the same count of operations, and the latency of
    # a frame: 14 dependent butterflies (a rank on the last rank's product;
    # tpu_sdr_q15_butterfly_probe's cycles), one read of device memory and
    # one write (tpu_sdr_q15_memory_probe's); the exchanges are the design's,
    # not the function's, and are left out.
    mhz = max_sm_mhz()
    chain = fft_q15.butterfly_probe_cycles(8192)
    read, write = fft_q15.memory_probe_cycles(256)
    latency_ms = (14 * chain + read + write) / (mhz * 1e3)
    b1 = bound(N * (2 + 8) + N // 2 * 4, N * 6, int_ops=ops)
    b1_uniform = bound(N * (2 + 8) + N // 2 * 4, N * 6, int_ops=N * 14 * 14)
    for f in (1, 8, 64):
        ms = t["ms"] if f == F else cuda_ms(lambda: fft_q15.window_fft_q15_cuda(x[:f]))
        route = fft_q15.kernel_route(f, N)
        line = (f"[5] q15_fft F={f:2d}: kernel {ms:.4f} ms, {ms * mhz * 1e3 / f:.0f} cycles a frame at "
                f"{mhz:.0f} MHz (route {route[0]}, {route[1]} CTAs a frame, {f * route[1]} CTAs)")
        if f == 1:
            line += (f"; floors: the operations' count {b1['bound_ms'] * 1e3:.3f} us "
                     f"({b1['int_ops'] / 1e6:.2f} M int32 operations at the INT32 issue rate) -> "
                     f"kernel at {b1['bound_ms'] / ms:.1%} (the uniform count "
                     f"{b1_uniform['bound_ms'] * 1e3:.3f} us: {b1_uniform['bound_ms'] / ms:.1%}); the "
                     f"latency, 14 x {chain:.2f} cycles "
                     f"(tpu_sdr_q15_butterfly_probe) + a read {read:.1f} + a write {write:.1f} "
                     f"cycles (tpu_sdr_q15_memory_probe) = {latency_ms * 1e3:.3f} us -> kernel at "
                     f"{latency_ms / ms:.1%}")
            check(b1["bound_ms"] / ms <= 1.05, ("q15_fft faster than its count floor", b1, ms))
            check(latency_ms / ms <= 1.05, ("q15_fft faster than its latency floor", latency_ms, ms))
        print(line)
    sos = torch.as_tensor(padded_q15_sos(), dtype=torch.int32, device="cuda")
    xk = torch.as_tensor(q15_tones(2, 110)[None], device="cuda")
    zi = torch.zeros((1, 6, 2), dtype=torch.int32, device="cuda")
    floor_ms, row_floor_ms, mhz = q15_chain_floor_ms(xk.shape[-1], 6)
    kernel = lambda: biquad.sosfilt_q15_cuda(sos, xk, zi, rom=rom)
    plain = lambda: biquad.sosfilt_q15_plain(sos, xk, zi, rom=rom)
    plain()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    timing["sosfilt_q15"] = {"ms": cuda_ms(kernel, iters=10), "plain_ms": plain_ms,
                             "library_ms": None, "bound_ms": floor_ms, "bound_by": "operations"}
    t = timing["sosfilt_q15"]
    by = bound(xk.numel() * (2 + 4), 0, int_ops=xk.numel() * 6 * 12)
    t_len = xk.shape[-1]
    delay = biquad.q15_section_delay()
    check(delay == biquad.Q15_SECTION_DELAY, ("sosfilt_q15 delay", delay, biquad.Q15_SECTION_DELAY))
    steps = t_len + delay * 5
    ms4 = cuda_ms(lambda: biquad.sosfilt_q15_cuda(sos, xk.expand(4, -1).contiguous(),
                                                  zi.expand(4, -1, -1).contiguous(), rom=rom),
                  iters=10)
    print(f"[5] sosfilt_q15 1 row x 2 frames, window + 6 sections: kernel {t['ms']:.4f} ms "
          f"({t['ms'] / 2:.4f} ms a frame; {t['ms'] * mhz * 1e3 / steps:.2f} cycles a step of the "
          f"wavefront, {steps} steps = T + {delay} x 5; "
          f"{t['ms'] * mhz * 1e3 / t_len:.2f} cycles a sample, at {mhz:.0f} MHz); plain "
          f"{plain_ms:.1f} ms (one call, host clock: {t_len + 5} steps of tensor operations); "
          f"library none; bound: the chain's latency floor, ({6} + {t_len - 1}) x "
          f"{Q15_CHAIN_CYCLES} cycles at {mhz:.0f} MHz = {floor_ms:.4f} ms -> kernel at "
          f"{floor_ms / t['ms']:.1%} of it (the thread-a-row design's floor, {6} x "
          f"{Q15_ROW_STEP_CYCLES} + {t_len - 1} x {Q15_ROW_STEP_CYCLES + Q15_ROW_STATE_CYCLES} "
          f"cycles = {row_floor_ms:.4f} ms: {row_floor_ms / t['ms']:.1%}; a serial walk, samples x sections x {Q15_CHAIN_CYCLES}: "
          f"{t_len * 6 * Q15_CHAIN_CYCLES / (mhz * 1e3):.4f} ms; bytes and throughput "
          f"{by['bound_ms']:.6f} ms); 4 rows {ms4:.4f} ms "
          f"({ms4 * mhz * 1e3 / steps:.2f} cycles a step); {profiled(kernel)}")
    check(floor_ms / t["ms"] <= 1.05, ("sosfilt_q15 faster than its floor", floor_ms, t["ms"]))
    check(row_floor_ms / t["ms"] <= 1.05,
          ("sosfilt_q15 faster than the thread-a-row floor", row_floor_ms, t["ms"]))
    walls, steps = q15_walls(pipes)
    return {label: statistics.median(v) for label, v in walls.items()}, timing, steps


def q15_walls(pipes: dict, turns: int = 2) -> tuple[dict, dict]:
    """The Q15 paths' wall per 16384-sample chunk, ``turns`` turns of the
    three paths. Returns ({label: [median s of each turn]}, {label: step})."""
    chunk = q15_tones(1, 120)
    steps = {}
    dev, split = pipes["all-device"], pipes["split"]
    steps["Q15 all-device"] = chained(lambda a, s: dev.process(a, s), chunk, lambda: None)
    steps["Q15 split filtered"] = chained(lambda a, s: split.process(a, s), chunk, lambda: None)
    steps["Q15 split bypass"] = chained(lambda a, s: split.process(a, s, bypass=True), chunk,
                                        lambda: None)
    walls = {}
    for label in ["Q15 split filtered", "Q15 split bypass", "Q15 all-device"] * turns:
        med, lo, hi = dispatch_wall(steps[label])
        walls.setdefault(label, []).append(med)
        print(f"[5] {label:18s} wall per {N}-sample chunk (process() and a synchronize): median "
              f"{med * 1e3:.4f} ms (min {lo * 1e3:.4f}, max {hi * 1e3:.4f}) -> "
              f"{N / med / 1e6:.3f} MSPS")
    return walls, steps


# ---------------------------------------------------------------- burst modem, FEC, receiver extensions, transport

# The burst + FEC path: the CLI's burst width (sps = 8, __main__.py:506),
# coded QPSK (K = 7, rate 1/2) bursts of 2048 info bits, at the SNR and the
# impairments of tests/test_fec.py's coherent soft path (delay 0.3 samples,
# phase 0.5 rad, Es/N0 14 dB), 64 in one call.
BURSTS, BURST_BITS, BURST_SPS, BURST_SNR_DB = 64, 2048, 8, 14.0
FEC_K, FEC_POLYS = 7, (0o133, 0o171)
# K3's cases against its plain version: (label, k, polys, puncture, rows, info bits, kind).
K3_CASES = (
    ("K=7 r1/2 soft", 7, FEC_POLYS, None, BURSTS, BURST_BITS, "soft"),
    ("K=7 r1/2 hard (ties)", 7, FEC_POLYS, None, BURSTS, BURST_BITS, "hard"),
    ("K=7 r3/4 punctured", 7, FEC_POLYS, "3/4", BURSTS, BURST_BITS, "soft"),
    ("k=3", 3, (0o7, 0o5), None, 8, BURST_BITS, "soft"),
    ("k=4 (8 states)", 4, (0o17, 0o13), None, 8, BURST_BITS, "soft"),
    ("k=5 hard (16 states)", 5, (0o35, 0o23), None, 8, BURST_BITS, "hard"),
    ("k=12 (2048 states)", 12, (0o4335, 0o5723), None, 4, 512, "soft"),
    ("k=12 hard", 12, (0o4335, 0o5723), None, 2, 256, "hard"),
    ("one row", 7, FEC_POLYS, None, 1, BURST_BITS, "soft"),
    # more steps than a row's decisions leave room for in shared memory
    ("K=7 long rows", 7, FEC_POLYS, None, 2, 30000, "soft"),
)
# K3's work a state a step: two branch metrics (n products, n - 1 adds),
# two subtractions of the maximum, two adds, a compare, a select and the max.
K3_FLOPS_PER_STATE = 2 * (2 * 2 - 1) + 2 + 2 + 3
FIR_TAPS, FIR_CH = 1025, 8
FIR_REL = 1e-5  # of max |y|, against float64 lfilter (tests/test_fastconv.py's 2e-6 and less)
IQ_SHAPE = (2, 8, 1 << 20)
IQ_GAIN_DB, IQ_PHASE_DEG, IQ_TONE_HZ, IQ_FS = 1.0, 5.0, 12_300.0, 100_000.0
SCAN_FS = 1e6
SCAN_EMITTERS_HZ = (87.5e3, 212.5e3, 337.5e3, 437.5e3)  # __main__.py:297-308
RDS_FS, RDS_SECONDS, RDS_CENTER, RDS_DEV = 1e6, 2.0, 250e3, 75e3
RDS_STATION = dict(pi=0xC0DE, pty=4, ps="H100 FM ", radiotext="PORT SLICE 10 ON THE CARD")


def _channel(re, im, delay, phase, snr_db, rng):
    """tests/test_digital.py's channel: a fractional delay (an FFT phase
    ramp on a padded buffer), a phase rotation and complex AWGN at Es/N0."""
    z = re.astype(np.float64) + 1j * im.astype(np.float64)
    pad = 256
    z = np.concatenate([np.zeros(pad), z, np.zeros(pad)])
    f = np.fft.fftfreq(len(z))
    z = np.fft.ifft(np.fft.fft(z) * np.exp(-2j * np.pi * f * delay)) * np.exp(1j * phase)
    n0 = 10.0 ** (-snr_db / 10.0)
    z = z + np.sqrt(n0 / 2.0) * (rng.standard_normal(len(z)) + 1j * rng.standard_normal(len(z)))
    z = z[pad:]
    return z.real.astype(np.float32), z.imag.astype(np.float32)


def burst_inputs(dev="cuda"):
    """(modem, code, planes (2, BURSTS, T) on dev, info bits (BURSTS, bits),
    each burst's start in symbols)."""
    from tpu_sdr_torch.kernels import digital, fec

    modem = digital.BurstModem("qpsk", sps=BURST_SPS, differential=False, device=dev)
    code = fec.ConvCode(FEC_K, FEC_POLYS, device=dev)
    rng = np.random.default_rng(30)
    info = rng.integers(2, size=(BURSTS, BURST_BITS)).astype(np.uint8)
    coded = code.encode(info)
    # Each burst starts 0..max_lag_syms symbols into its capture (the last
    # at max_lag_syms, the edge of the frame search); the captures keep one
    # length, and at least span symbols after each burst.
    lags = rng.integers(0, modem.max_lag_syms + 1, BURSTS)
    lags[-1] = modem.max_lag_syms
    rows = []
    for c, lag in zip(coded, lags):
        re, im = modem.modulate(c, pad_syms=modem.max_lag_syms + modem.span)
        lead = np.zeros(lag * modem.sps, np.float32)
        rows.append(_channel(np.concatenate([lead, re])[: re.size],
                             np.concatenate([lead, im])[: im.size], 0.3, 0.5, BURST_SNR_DB, rng))
    planes = torch.as_tensor(np.stack([np.stack([r for r, _ in rows]),
                                       np.stack([i for _, i in rows])]), device=dev)
    return modem, code, planes, info, lags


def burst_fec(modem, code, planes):
    """The path: demodulate all bursts in one call, LLRs, one decode."""
    from tpu_sdr_torch.kernels import fec

    n_coded = code.coded_len(BURST_BITS)
    out = modem.demodulate(planes[0], planes[1], n_coded)
    llrs = fec.modem_soft_bits(modem, *out["symbols"])
    return code.decode(llrs, BURST_BITS), out


def phase_k3_vs_plain() -> float:
    """K3 against its plain version on the card, every decision bit for bit;
    returns the largest |kernel - plain| (0 when equal)."""
    from tpu_sdr_torch.kernels import fec
    from tpu_sdr_torch.kernels.cuda import viterbi

    worst = 0.0
    for label, k, polys, punct, rows, n_bits, kind in K3_CASES:
        code = fec.ConvCode(k, polys, puncture=punct, device="cuda")
        rng = np.random.default_rng(k * 100 + rows)
        bits = rng.integers(2, size=(rows, n_bits)).astype(np.uint8)
        coded = code.encode(bits).astype(np.float32)
        sigma = 0.45 if punct else 0.8  # Eb/N0 about 5 and 2 dB
        soft = (1.0 - 2.0 * coded) + (sigma * rng.standard_normal(coded.shape) if kind == "soft" else 0)
        if kind == "hard":
            flips = rng.random(coded.shape) < 0.05
            soft = np.where(flips, -soft, soft)
        t = code.n_steps(n_bits)
        keep = torch.as_tensor(code._keep_mask(n_bits), device="cuda")
        x = torch.zeros((rows, t, code.n_out), dtype=torch.float32, device="cuda")
        x[:, keep] = torch.as_tensor(soft, dtype=torch.float32, device="cuda")
        got = viterbi.viterbi_cuda(x, code._tables["out0"], code._tables["out1"], k)
        ref = fec.viterbi_plain(x, code._tables["sign0"], code._tables["sign1"], k)
        torch.cuda.synchronize()
        diff = int((got != ref).sum())
        ber = float((got[:, :n_bits].cpu().numpy() != bits).mean())
        route = ("block route" if k > 7 else "warp route, decisions in "
                 + ("device memory" if viterbi.needs_scratch(t, k) else "shared memory"))
        print(f"[3] viterbi {label:22s} {rows} rows x {t} steps, {code.n_states} states"
              f"{', punctured' if punct else ''} ({route}): kernel == plain bit for bit: "
              f"{diff == 0} ({diff} differing decisions); BER vs the sent bits {ber:.2e}")
        check(viterbi.needs_scratch(t, k) == (k > 7 or label == "K=7 long rows"),
              ("viterbi route", label))
        check(diff == 0, ("viterbi", label))
        worst = max(worst, float((got.int() - ref.int()).abs().max()))
    return worst


def phase_burst_fec() -> tuple[int, tuple]:
    """64 coded QPSK bursts through BurstModem.demodulate, modem_soft_bits
    and ConvCode.decode, with the counts zeroed just before; one K3 launch,
    no plain call, BER 0, batched == single bit for bit."""
    from tpu_sdr_torch.kernels.cuda import launch

    modem, code, planes, info, lags = burst_inputs()
    launch.reset_counts()
    decoded, out = burst_fec(modem, code, planes)
    torch.cuda.synchronize()
    k3 = launch.counts["kernel"]["viterbi"]
    check_counts("burst + FEC", {"viterbi": 1})
    ber = float((decoded != info).mean())
    n_coded = code.coded_len(BURST_BITS)
    same = True
    for i in range(BURSTS):
        one, one_out = burst_fec(modem, code, planes[:, i])
        same &= (np.array_equal(one, decoded[i]) and np.array_equal(one_out["bits"], out["bits"][i])
                 and all(torch.equal(one_out[key], out[key][i])
                         for key in ("timing", "cfo", "frame_lag", "phase"))
                 and torch.equal(one_out["symbols"][0], out["symbols"][0][i])
                 and torch.equal(one_out["symbols"][1], out["symbols"][1][i]))
    raw_ber = float((out["bits"] != code.encode(info)).mean())
    lags_ok = np.array_equal(out["frame_lag"].cpu().numpy(), lags)
    print(f"[4] burst + FEC: {BURSTS} QPSK bursts x {n_coded} coded bits (K = {FEC_K}, rate 1/2, "
          f"sps {BURST_SPS}, Es/N0 {BURST_SNR_DB} dB, {planes.shape[-1]} samples each) in one call: "
          f"launches viterbi {k3} (one decode), plain 0; raw BER {raw_ber:.2e}, decoded BER {ber:.2e}; "
          f"frame lags == the bursts' starts (0..{modem.max_lag_syms} symbols): {lags_ok}; "
          f"batched == {BURSTS} single calls bit for bit (bits, symbols, estimates): {same}")
    check(ber == 0.0 and same and lags_ok, ("burst + FEC", ber, same, lags_ok))
    return k3, (modem, code, planes)


def phase_fastfir() -> dict:
    """FastFIR, 1025 taps, real (process) and complex (process_planes) on 8
    channels x the largest multiple of chunk_granularity <= 2^20: float64
    lfilter within 1e-5 of max |y|, chunked == one-shot bit for bit, no
    kernel launch and no plain call."""
    from tpu_sdr_torch.kernels.cuda import launch
    from tpu_sdr_torch.kernels.fastconv import FastFIR

    h_real = sps.firwin(FIR_TAPS, 0.21)
    h_cplx = h_real * np.exp(2j * np.pi * 0.1 * np.arange(FIR_TAPS))
    steps = {}
    for label, h in (("real", h_real), ("complex", h_cplx)):
        f = FastFIR(h)
        g = f.chunk_granularity
        t = (1 << 20) // g * g
        rng = np.random.default_rng(40)
        if label == "real":
            x_np = rng.standard_normal((FIR_CH, t)).astype(np.float32)
            run = lambda a, s, f=f: f.process(a, s)
            state = lambda f=f: f.initial_state((FIR_CH,))
        else:
            x_np = rng.standard_normal((2, FIR_CH, t)).astype(np.float32)
            run = lambda a, s, f=f: f.process_planes(a, s)
            state = lambda f=f: f.initial_state((FIR_CH,))
        x = torch.as_tensor(x_np, device="cuda")
        launch.reset_counts()
        one, _ = run(x, state())
        torch.cuda.synchronize()
        check_counts(f"FastFIR {label}", {})
        st, parts = state(), []
        for a, b in ((0, 3), (3, 64), (64, t // g)):
            o, st = run(x[..., a * g : b * g], st)
            parts.append(o)
        same = torch.equal(torch.cat(parts, dim=-1), one)
        if label == "real":
            want = sps.lfilter(h, 1.0, x_np.astype(np.float64), axis=-1)
            got = one.cpu().numpy().astype(np.float64)
        else:
            want = sps.lfilter(h, 1.0, x_np[0].astype(np.float64) + 1j * x_np[1], axis=-1)
            got = one[0].cpu().numpy() + 1j * one[1].cpu().numpy().astype(np.float64)
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        print(f"[4] FastFIR {label:7s} {FIR_TAPS} taps, nfft {f.nfft}, block {g}, "
              f"{tuple(x.shape)}: vs float64 lfilter max err / max |y| {rel:.2e} (tol {FIR_REL:g}); "
              f"chunked (3 + 61 + {t // g - 64} blocks) == one-shot bit for bit: {same}; "
              f"launches 0, plain 0")
        check(rel <= FIR_REL and same, ("FastFIR", label, rel, same))
        steps[f"FastFIR {label}"] = chained(run, x, state)
    return steps


def image_ratio_db(z: np.ndarray, f: float, fs: float) -> float:
    n = z.size
    spec = np.abs(np.fft.fft(z * np.hanning(n))) ** 2
    k = int(round(f / fs * n))
    return 10 * np.log10(spec[n - k - 1 : n - k + 2].sum() / spec[max(k - 1, 0) : k + 2].sum())


def phase_iqcorr() -> dict:
    """IQCorrector on planes (2, 8, 2^20) with 1 dB / 5 deg of imbalance:
    image rejection up by more than 25 dB in every channel, chunked ==
    one-shot bit for bit, no kernel launch and no plain call."""
    from tpu_sdr_torch.kernels.cuda import launch
    from tpu_sdr_torch.kernels.iqcorr import IQCorrector, apply_imbalance

    _, ch, t = IQ_SHAPE
    n = np.arange(t)
    rng = np.random.default_rng(41)
    zs = [apply_imbalance(np.exp(2j * np.pi * (IQ_TONE_HZ * (1 + 0.1 * c)) * n / IQ_FS
                                 + 1j * rng.uniform(0, 2 * np.pi)), IQ_GAIN_DB, IQ_PHASE_DEG)
          for c in range(ch)]
    planes = torch.as_tensor(np.stack([np.stack([z.real for z in zs]),
                                       np.stack([z.imag for z in zs])]).astype(np.float32),
                             device="cuda")
    corr = IQCorrector(leak=0.95)
    launch.reset_counts()
    wre, wim, _ = corr.process(planes[0], planes[1], corr.initial_state((ch,)))
    torch.cuda.synchronize()
    check_counts("IQ corrector", {})
    gains = []
    for c in range(ch):
        f = IQ_TONE_HZ * (1 + 0.1 * c)
        before = image_ratio_db(zs[c][-16384:], f, IQ_FS)
        w = wre[c, -16384:].cpu().numpy() + 1j * wim[c, -16384:].cpu().numpy().astype(np.float64)
        gains.append(before - image_ratio_db(w, f, IQ_FS))
    st, pr, pi = corr.initial_state((ch,)), [], []
    for a, b in ((0, 3 * 128), (3 * 128, t // 2), (t // 2, t)):
        r, i, st = corr.process(planes[0][..., a:b], planes[1][..., a:b], st)
        pr.append(r)
        pi.append(i)
    same = torch.equal(torch.cat(pr, -1), wre) and torch.equal(torch.cat(pi, -1), wim)
    print(f"[4] IQ corrector {IQ_SHAPE} ({IQ_GAIN_DB} dB / {IQ_PHASE_DEG} deg): image rejection "
          f"improved by {min(gains):.1f} to {max(gains):.1f} dB (> 25 dB each); chunked (3 blocks, "
          f"the rest of half, half) == one-shot bit for bit: {same}; launches 0, plain 0")
    check(min(gains) > 25 and same, ("IQ corrector", gains, same))

    def run(a, s):
        r, i, s = corr.process(a[0], a[1], s)
        return (r, i), s

    return {"IQ corrector": chained(run, planes, lambda: corr.initial_state((ch,)))}


def scan_signal(seconds: float = 1.0) -> np.ndarray:
    """The CLI's scan demo signal (__main__.py:297-308): three tones of very
    different strengths and one narrowband FM emitter on the 25 kHz grid."""
    rng = np.random.default_rng(0)
    n = np.arange(int(seconds * SCAN_FS))
    x = 2e-4 * rng.standard_normal(n.size)
    for fc, a in ((87.5e3, 0.5), (212.5e3, 0.1), (337.5e3, 0.02)):
        x = x + a * np.cos(2 * np.pi * fc * n / SCAN_FS)
    msg = np.sin(2 * np.pi * 300.0 * n / SCAN_FS)
    x = x + 0.05 * np.cos(2 * np.pi * 437.5e3 * n / SCAN_FS
                          + 2 * np.pi * 2.5e3 / SCAN_FS * np.cumsum(msg))
    return x.astype(np.float32)


def phase_scanner() -> dict:
    """SpectrumScanner over 0-500 kHz in 25 kHz channels on 1 s of the CLI's
    demo signal at 1 MSPS: the hits are exactly the four emitters."""
    from tpu_sdr_torch.kernels.cuda import launch
    from tpu_sdr_torch.runtime.scanner import SpectrumScanner

    x = torch.as_tensor(scan_signal(), device="cuda")
    sc = SpectrumScanner(SCAN_FS, 0.0, 500e3, channel_bw=25e3, threshold_db=10.0)
    launch.reset_counts()
    res = sc.scan(x)
    check_counts("scanner", {})
    hits = sorted(h["center_hz"] for h in res.hits)
    print(f"[4] scanner {sc.n_channels} channels x 25 kHz on {x.numel()} samples (decimation "
          f"{sc.decimation}, {sc.k} carriers a dispatch): hits {hits} Hz, floor "
          f"{res.noise_floor_db:.2f} dB, SNRs {[round(h['snr_db'], 2) for h in res.hits]} dB; "
          f"exactly the four emitters: {hits == list(SCAN_EMITTERS_HZ)}; launches 0, plain 0")
    check(hits == list(SCAN_EMITTERS_HZ), ("scanner", hits))
    return {"scanner": lambda: sc.scan(x)}


def rds_capture() -> tuple[np.ndarray, object]:
    """2 s of a 1 MSPS real capture: one WBFM station at 250 kHz carrying
    make_mpx_rds stereo MPX with RDS (PI, PS, RadioText), plus noise."""
    from tpu_sdr_torch.kernels import rds

    n = int(RDS_SECONDS * RDS_FS)
    t = np.arange(n) / RDS_FS
    enc = rds.RDSEncoder(**RDS_STATION)
    mpx = rds.make_mpx_rds(0.5 * np.sin(2 * np.pi * 1000 * t), 0.5 * np.sin(2 * np.pi * 2500 * t),
                           RDS_FS, enc, n_groups=64)
    phase = 2 * np.pi * RDS_DEV / RDS_FS * np.cumsum(mpx)
    x = 0.5 * np.cos(2 * np.pi * RDS_CENTER * t + phase)
    x = x + 1e-2 * np.random.default_rng(42).standard_normal(n)
    return x.astype(np.float32), enc


class RdsChain:
    """The GUI's chain (gui/backend_audio.py:131-190): DDC /5 to 200 kHz,
    FMDemodulator(200e3, deemphasis_tau=None, use_pallas=True) (one fm_demod
    launch), RDSDecoder(200e3)."""

    def __init__(self, dev="cuda"):
        from tpu_sdr_torch.kernels.ddc import DDC
        from tpu_sdr_torch.kernels.demod import FMDemodulator
        from tpu_sdr_torch.kernels.rds import RDSDecoder

        self.dec = RDSDecoder(RDS_FS / 5, device=dev)
        self.ddc = DDC(RDS_FS, center_hz=RDS_CENTER, decimation=5, taps_per_phase=12, device=dev)
        self.fm = FMDemodulator(self.dec.fs, deviation_hz=RDS_DEV, deemphasis_tau=None,
                                use_pallas=True, device=dev)

    def __call__(self, x):
        t = (x.shape[-1] // (self.ddc.r * 128)) * (self.ddc.r * 128)
        bb, _ = self.ddc.process(x[:t], self.ddc.initial_state())
        mpx, _ = self.fm.process(bb["re"], bb["im"], self.fm.initial_state())
        return self.dec.decode(mpx)


def phase_rds() -> dict:
    """The RDS chain on the card: one fm_demod launch, PI, PS and RadioText
    equal to the encoder's and to the port's decode of the same capture on
    the CPU."""
    from tpu_sdr_torch.kernels.cuda import launch

    x_np, enc = rds_capture()
    x = torch.as_tensor(x_np, device="cuda")
    chain = RdsChain()
    launch.reset_counts()
    res = chain(x)
    torch.cuda.synchronize()
    n_fm = launch.counts["kernel"]["fm_demod"]
    check_counts("RDS chain", {"fm_demod": 1})
    cpu = RdsChain("cpu")(torch.as_tensor(x_np))
    want_rt = enc.radiotext.split("\r")[0].rstrip()
    fields = lambda r: (r.pi, r.pty, r.ps_name, r.radiotext)
    ok = fields(res) == (enc.pi, enc.pty, enc.ps, want_rt) and fields(res) == fields(cpu)
    print(f"[4] RDS chain on {x.numel()} samples at 1 MSPS (WBFM at {RDS_CENTER / 1e3:.0f} kHz, "
          f"DDC /5, FM kernel, RDSDecoder(200e3)): PI {res.pi:04X} PTY {res.pty} PS {res.ps_name!r} "
          f"RT {res.radiotext!r}; groups {res.groups}, {res.n_blocks} blocks, block error rate "
          f"{res.block_error_rate:.4f}; == the encoder's and == the CPU decode "
          f"(groups {cpu.groups}): {ok}; launches fm_demod {n_fm}, plain 0")
    check(ok, ("RDS", fields(res), fields(cpu)))
    return {"RDS chain": lambda: chain(x)}


def phase_transport() -> dict:
    """Q15Pipeline on the card (K1) -> framing.frame_bytes_from_q15 ->
    UdpSpectrumSender to 127.0.0.1 -> UdpSpectrumReceiver: the received
    words equal the sent ones bit for bit; the native framer's bytes equal
    the NumPy framer's."""
    from tpu_sdr_torch import PipelineConfig
    from tpu_sdr_torch.kernels.cuda import launch
    from tpu_sdr_torch.runtime.q15 import Q15Pipeline
    from tpu_sdr_torch.transport import crc32, framing, native
    from tpu_sdr_torch.transport.udp_stream import UdpSpectrumReceiver, UdpSpectrumSender

    frames = 4
    pipe = Q15Pipeline(PipelineConfig(channels=1), device_fft=True)
    x = q15_tones(frames, 130)
    got = []
    rx = UdpSpectrumReceiver(port=0, bind_ip="127.0.0.1", fps_cap=1e9,
                             on_frame=lambda re, im, mag: got.append((re.copy(), im.copy())))
    rx.start()
    port = rx.port
    tx = UdpSpectrumSender("127.0.0.1", port)
    try:
        launch.reset_counts()
        out, _ = pipe.process(x, bypass=True)
        re_q = out["spectrum_re_q15"].cpu().numpy().reshape(frames, N)
        im_q = out["spectrum_im_q15"].cpu().numpy().reshape(frames, N)
        sent = [framing.frame_bytes_from_q15(re_q[f], im_q[f]) for f in range(frames)]
        for frame in sent:
            tx.send_frame_bytes(frame)
        n_k1 = launch.counts["kernel"]["q15_fft"]
        check_counts("transport", {"q15_fft": n_k1})
        deadline = time.time() + 10.0
        while len(got) < frames and time.time() < deadline:
            time.sleep(0.01)
    finally:
        rx.stop()
        tx.close()
    same = len(got) == frames and all(
        np.array_equal(r.astype(np.int16), re_q[f]) and np.array_equal(i.astype(np.int16), im_q[f])
        for f, (r, i) in enumerate(got))
    re_f, im_f = re_q[0].astype(np.float32), im_q[0].astype(np.float32)
    native_same = (native.spectrum_to_frame_bytes(re_f, im_f, 1.0)
                   == framing.spectrum_to_frame_bytes(re_f, im_f, 1.0) == sent[0]
                   and native.frame_to_packets(sent[0]) == framing.frame_to_packets(sent[0])
                   and native.crc32_ethernet(sent[0]) == crc32.crc32_ethernet(sent[0]))
    print(f"[4] transport: Q15Pipeline (split bypass, K1) {frames} frames -> frame_bytes_from_q15 -> "
          f"UDP 127.0.0.1:{port} (native sendmmsg/recvmmsg): {len(got)} frames received "
          f"({rx.frames_received} assembled), words == sent bit for bit: {same}; native framer "
          f"bytes, packets and CRC == NumPy's: {native_same}; launches q15_fft {n_k1}, plain 0")
    check(same and native_same and n_k1 >= 1, ("transport", same, native_same, n_k1))

    tx2 = UdpSpectrumSender("127.0.0.1", 9)  # discard port: fire and forget

    def step():
        o, _ = pipe.process(x[:N], bypass=True)
        tx2.send_frame_bytes(framing.frame_bytes_from_q15(
            o["spectrum_re_q15"].cpu().numpy().reshape(N), o["spectrum_im_q15"].cpu().numpy().reshape(N)))

    return {"transport": step}


def k3_floor_ms(steps: int) -> tuple[float, float, float, float, float]:
    """K3's latency floor at k = 7: ``steps`` dependent trellis steps at the
    measured cycles of one step of the warp route
    (tpu_sdr_viterbi_warp_step_probe) at the highest SM clock; and the
    block route's floor (tpu_sdr_viterbi_step_probe, 64 threads), kept for
    comparison. Returns (ms, cycles a step, the block floor's ms, its
    cycles, MHz)."""
    from tpu_sdr_torch.kernels.cuda import viterbi

    cyc = viterbi.warp_step_probe_cycles(8192)
    block_cyc = viterbi.step_probe_cycles(64, 8192)
    mhz = max_sm_mhz()
    return steps * cyc / (mhz * 1e3), cyc, steps * block_cyc / (mhz * 1e3), block_cyc, mhz


def phase_pr10_timing(k3_inputs, steps: dict) -> tuple[dict, dict, dict]:
    """K3 at the burst path's shape (64 rows x 2054 steps, K = 7): kernel,
    plain version, bound; then the wall per call of each new path
    (``steps``: label -> step()). Returns (walls, timing, all steps)."""
    from tpu_sdr_torch.kernels import fec
    from tpu_sdr_torch.kernels.cuda import viterbi

    modem, code, planes = k3_inputs
    rng = np.random.default_rng(50)
    t = code.n_steps(BURST_BITS)
    x = torch.as_tensor(rng.standard_normal((BURSTS, t, 2)).astype(np.float32), device="cuda")
    kernel = lambda: viterbi.viterbi_cuda(x, code._tables["out0"], code._tables["out1"], FEC_K)
    ms = cuda_ms(kernel, iters=20)
    fec.viterbi_plain(x, code._tables["sign0"], code._tables["sign1"], FEC_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fec.viterbi_plain(x, code._tables["sign0"], code._tables["sign1"], FEC_K)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    floor_ms, cyc, block_floor_ms, block_cyc, mhz = k3_floor_ms(t)
    b = bound(x.numel() * 4 + BURSTS * t, BURSTS * t * code.n_states * K3_FLOPS_PER_STATE)
    bound_ms = max(b["bound_ms"], floor_ms)
    one_row = cuda_ms(lambda: viterbi.viterbi_cuda(x[:1], code._tables["out0"],
                                                   code._tables["out1"], FEC_K), iters=20)
    timing = {"viterbi": {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                          "bound_ms": bound_ms, "bound_by": "operations"}}
    print(f"[5] viterbi {BURSTS} rows x {t} steps, {code.n_states} states (the burst path's "
          f"decode, the warp route): kernel {ms:.4f} ms ({ms * mhz * 1e3 / t:.1f} cycles a step at "
          f"{mhz:.0f} MHz, forward and traceback); one row {one_row:.4f} ms; plain {plain_ms:.1f} ms (one call, "
          f"host clock: {t} Python steps); library none; bound: the latency floor, {t} steps x "
          f"{cyc:.2f} cycles (tpu_sdr_viterbi_warp_step_probe: the warp route's dependent step, "
          f"the maximum's reduction and keys, a subtraction, an add, a compare and a select) at "
          f"{mhz:.0f} MHz = {floor_ms:.4f} ms (bytes and fp32 operations {b['bound_ms']:.6f} ms) "
          f"-> kernel at {bound_ms / ms:.1%} of it (the block route's floor, {t} steps x "
          f"{block_cyc:.2f} cycles of tpu_sdr_viterbi_step_probe, a dependent ACS and a barrier of "
          f"64 threads, = {block_floor_ms:.4f} ms: {block_floor_ms / ms:.1%}); {profiled(kernel)}")
    check(bound_ms / ms <= 1.05, ("viterbi faster than its floor", bound_ms, ms))
    check(block_floor_ms / ms <= 1.05, ("viterbi faster than the block floor", block_floor_ms, ms))
    k12 = fec.ConvCode(12, (0o4335, 0o5723), device="cuda")
    x12 = torch.as_tensor(rng.standard_normal((4, 523, 2)).astype(np.float32), device="cuda")
    ms12 = cuda_ms(lambda: viterbi.viterbi_cuda(x12, k12._tables["out0"], k12._tables["out1"], 12),
                   iters=10)
    print(f"[5] viterbi k=12 (2048 states, 1024 threads, the block route) 4 rows x 523 steps: "
          f"kernel {ms12:.4f} ms ({ms12 * mhz * 1e3 / 523:.1f} cycles a step)")
    steps = {"burst + FEC": lambda: burst_fec(modem, code, planes), **steps}
    walls = {}
    light = {"burst + FEC", "IQ corrector", "RDS chain", "scanner"}
    for label in list(steps) * 2:
        reps, calls = (3, 2) if label in light else (5, 5)
        med, lo, hi = dispatch_wall(steps[label], reps=reps, calls=calls, warmup=1)
        walls.setdefault(label, []).append(med)
        print(f"[5] {label:17s} wall per call (and a synchronize): median {med * 1e3:.4f} ms "
              f"(min {lo * 1e3:.4f}, max {hi * 1e3:.4f})")
    return {label: statistics.median(v) for label, v in walls.items()}, timing, steps


# ---------------------------------------------------------------- the user-facing layer: GUI, chain, CLI, roofline

GUI_SEGMENT_S = 2.0  # seconds each GUI setting runs while /events is read


class SseReader:
    """Reads the GUI server's /events stream on a thread of its own into
    ``events`` ((monotonic time, event, payload dict)) until ``close()``."""

    def __init__(self, port: int):
        import http.client
        import threading

        self.events = []
        self._conn = http.client.HTTPConnection("127.0.0.1", port, timeout=20)
        self._conn.request("GET", "/events")
        self._resp = self._conn.getresponse()
        check(self._resp.status == 200, ("/events", self._resp.status))
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        event = None
        while not self._stop:
            try:
                line = self._resp.readline()
            except OSError:
                return
            if not line:
                return
            line = line.decode().rstrip("\n")
            if line.startswith("event: "):
                event = line[7:]
            elif line.startswith("data: ") and event:
                self.events.append((time.monotonic(), event, json.loads(line[6:])))
                event = None

    def since(self, t0: float, name: str) -> list:
        return [d for t, e, d in list(self.events) if t >= t0 and e == name]

    def close(self):
        self._stop = True
        self._conn.close()
        self._thread.join(timeout=5)


def _api(port: int, route: str, body=None, method="POST"):
    import urllib.request

    data = None if method == "GET" else json.dumps(body or {}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def phase_one_kernel_steps() -> dict:
    """The steps that launch one or two port kernels each, profiled before
    any other work of the process: the Q15 path at the reference's width
    (one 16384-sample chunk; split filtered: the native host filter, then
    K1; split bypass: K1; all-device: K2, then K1) and the transport (a
    bypass chunk, K1, and its wire frame out over UDP). Each traced step
    shows its launches (seen == made), with its device ops, busy and idle
    time and its untraced wall. Returns label -> op table."""
    from tpu_sdr_torch import PipelineConfig
    from tpu_sdr_torch.runtime.q15 import Q15Pipeline
    from tpu_sdr_torch.transport import framing
    from tpu_sdr_torch.transport.udp_stream import UdpSpectrumSender

    split = Q15Pipeline(PipelineConfig(channels=1), device_fft=True)
    split.upload_sos_q(Q15_SOS_Q)
    dev = Q15Pipeline(PipelineConfig(channels=1))
    dev.upload_sos_q(Q15_SOS_Q)
    chunk = q15_tones(1, 120)
    tx = UdpSpectrumSender("127.0.0.1", 9)  # discard port: fire and forget

    def transport():
        o, _ = split.process(chunk, bypass=True)
        tx.send_frame_bytes(framing.frame_bytes_from_q15(
            o["spectrum_re_q15"].cpu().numpy().reshape(N),
            o["spectrum_im_q15"].cpu().numpy().reshape(N)))

    steps = {"Q15 split filtered": chained(lambda a, s: split.process(a, s), chunk, lambda: None),
             "Q15 split bypass": chained(lambda a, s: split.process(a, s, bypass=True), chunk,
                                         lambda: None),
             "Q15 all-device": chained(lambda a, s: dev.process(a, s), chunk, lambda: None),
             "transport": transport}
    try:
        walls = {label: dispatch_wall(step)[0] for label, step in steps.items()}
        return phase_profile(steps, walls, exact=tuple(steps))
    finally:
        tx.close()


def phase_gui() -> dict:
    """The web GUI on the card: ``GuiBackend(device="cuda")`` behind
    ``serve(port=0, bind="127.0.0.1", block=False)``, /events read over SSE
    while the settings change (BYPASS, FIXED, CUSTOM by the designer's
    preview and apply, the Q15 tap, the IQ source with the zoom), then the
    scan, burst, RDS and roofline routes. Per setting: frames delivered a
    second, acquisition samples a second and each wrapper's launches. The
    tap's wire frame equals the NumPy oracle chain's on the same chunk bit
    for bit. Any status event with ok=False (the watchdog's "degraded"
    among them) fails the phase. Returns the measured rates by setting."""
    import base64

    from tpu_sdr_torch import PipelineConfig
    from tpu_sdr_torch.control import golden
    from tpu_sdr_torch.core import qformat
    from tpu_sdr_torch.gui import GuiBackend, serve
    from tpu_sdr_torch.kernels import fft_q15
    from tpu_sdr_torch.kernels.cuda import launch
    from tpu_sdr_torch.kernels.digital import BurstModem
    from tpu_sdr_torch.kernels.rds import RDSEncoder, make_mpx_rds
    from tpu_sdr_torch.runtime.source import SyntheticSource
    from tpu_sdr_torch.transport.framing import decode_frame

    backend = GuiBackend(source=SyntheticSource(tones_hz=((100_000.0, 0.5), (250_000.0, 0.2)),
                                                noise=0.01),
                         display_fps=1000.0, device="cuda")
    check(backend.device.type == "cuda" and backend.sa.cfg == PipelineConfig(channels=1),
          "GuiBackend on the card")
    srv, _ = serve(backend, port=0, bind="127.0.0.1", block=False)
    port = srv.server_address[1]
    sse = SseReader(port)
    rates = {}
    t_start = time.monotonic()

    def segment(label: str, setup):
        setup()
        time.sleep(0.3)  # the setting takes effect at the next dispatch
        launch.reset_counts()
        t0, s0, f0 = time.monotonic(), backend.sa.stats.samples_consumed, len(sse.since(0, "frame_data"))
        time.sleep(GUI_SEGMENT_S)
        dt = time.monotonic() - t0
        frames = len(sse.since(0, "frame_data")) - f0
        samples = backend.sa.stats.samples_consumed - s0
        made = {k: v for k, v in launch.counts["kernel"].items() if v}
        plain = {k: v for k, v in launch.counts["plain"].items() if v}
        rates[label] = {"frames_per_s": frames / dt, "samples_per_s": samples / dt,
                        "launches": made}
        print(f"[8] GUI {label:18s}: {frames / dt:.1f} frame_data events/s over SSE, acquisition "
              f"{samples / dt:.4e} samples/s ({samples / backend.sa.cfg.fft_size / dt:.1f} "
              f"frames/s); launches {made}, plain calls {plain}")
        check(frames > 0 and not plain, (label, frames, plain))
        return made

    try:
        made = segment("BYPASS", lambda: _api(port, "/api/set_filter_type", {"mode": "bypass"}))
        check(made.get("spectrum_bypass", 0) > 0, ("GUI BYPASS launches", made))
        made = segment("FIXED", lambda: _api(port, "/api/set_filter_type", {"mode": "fixed"}))
        check(made.get("spectrum_bypass", 0) > 0, ("GUI FIXED launches", made))

        def custom():
            _api(port, "/api/update_filter_config",
                 {"kind": "elliptic", "btype": "lowpass", "order": 6, "cutoff_hz": 150_000.0})
            p = _api(port, "/api/generate_filter_preview")
            check(p["ok"] and len(p["sos"]) == 3, "designer preview")
            check(_api(port, "/api/apply_filter_to_fpga")["ok"], "designer apply")

        made = segment("CUSTOM (designer)", custom)
        check(made.get("spectrum_bypass", 0) > 0, ("GUI CUSTOM launches", made))
        made = segment("Q15 tap (CUSTOM)",
                       lambda: _api(port, "/api/update_config", {"q15_faithful": True}))
        check(made.get("q15_fft", 0) > 0, ("GUI Q15 tap launches", made))
        # Turn the tap off (a fresh state on its next use) and stop the
        # acquisition, then run one known chunk through the tap and hold its
        # wire frame to the oracle chain.
        _api(port, "/api/update_config", {"q15_faithful": False})
        _api(port, "/api/stop_receiver")
        x = SyntheticSource(tones_hz=((100_000.0, 0.5), (250_000.0, 0.2)), noise=0.01,
                            seed=11).read(2 * N)
        backend._q15_step(x, backend._q15_gen)
        frame = _api(port, "/api/q15_frame", method="GET")
        re_w, im_w, _ = decode_frame(base64.b64decode(frame["frame_b64"]))
        xq = np.clip(np.rint(np.asarray(x)[0] * 32767.0), -32768, 32767).astype(np.int16)
        sos_q = np.asarray(qformat.quantize_coeff_x64(backend.sa.custom_sos), np.int64)
        y, _ = golden.sosfilt_q15_intended(sos_q, golden.rtl_window_q15(xq),
                                           np.zeros((sos_q.shape[0], 2), np.int64))
        rr, ri = fft_q15.fft_q15_np(y.reshape(-1, N)[-1:])
        exact = (np.array_equal(np.asarray(re_w, np.int16), rr[0])
                 and np.array_equal(np.asarray(im_w, np.int16), ri[0]))
        print(f"[8] GUI Q15 tap wire frame ({frame['bytes']} bytes, {frame['filter_mode']}) == "
              f"fft_q15_np(sosfilt_q15_intended(rtl_window_q15(x))) on the same chunk, bit for "
              f"bit: {exact}")
        check(exact and frame["filter_mode"] == "CUSTOM", "GUI Q15 wire frame vs the oracle")

        def iq_source():
            _api(port, "/api/stop_receiver")
            backend.source = SyntheticSource(tones_hz=((150_000.0, 0.5), (-300_000.0, 0.25)),
                                             noise=0.01, iq=True)
            _api(port, "/api/fpga_reset")  # a new stream kind needs the reset
            _api(port, "/api/start_receiver")

        made = segment("IQ source", iq_source)
        check(made.get("spectrum_complex", 0) > 0, ("GUI IQ launches", made))
        made = segment("IQ + zoom (pfb)",
                       lambda: _api(port, "/api/set_zoom", {"enabled": True, "channel": 19}))
        zooms = sse.since(t_start, "zoom_frame")
        check(zooms and abs(zooms[-1]["peak_freq_khz"] - 150.0) < 0.1,
              ("zoom frames", len(zooms), zooms[-1]["peak_freq_khz"] if zooms else None))
        print(f"[8] GUI zoom: {len(zooms)} zoom_frame events, peak at "
              f"{zooms[-1]['peak_freq_khz']:.4f} kHz (tone 150 kHz), {zooms[-1]['hz_per_bin']:.3f} "
              f"Hz a bin; launches in the zoom segment {made}")
        _api(port, "/api/set_zoom", {"enabled": False})

        scan = _api(port, "/api/scan", {"start_khz": -500, "stop_khz": 500, "bw_khz": 25})
        hits = sorted(h["center_khz"] for h in scan["hits"])
        check(scan["ok"] and any(abs(h - 150.0) <= 13 for h in hits)
              and any(abs(h + 300.0) <= 13 for h in hits), ("GUI scan", hits))
        _api(port, "/api/stop_receiver")
        rng = np.random.default_rng(0xB0B)
        mod = BurstModem("qpsk", sps=8, device="cuda")
        bits = rng.integers(2, size=512).astype(np.uint8)
        re, im = mod.modulate(bits, pad_syms=mod.max_lag_syms + mod.span)
        z = (re + 1j * im) * np.exp(2j * np.pi * 150e3 / 1e6 * np.arange(re.size) + 0.4j)
        backend._scan_ring = np.concatenate([np.zeros(40), z]).astype(np.complex64)
        burst = _api(port, "/api/demod_burst", {"scheme": "qpsk", "bits": 512, "center_khz": 150.0})
        want = np.packbits(bits).tobytes().hex()
        check(burst["ok"] and burst["bits_hex"] == want, "GUI burst bits")
        fs = backend.sa.cfg.sample_rate
        t = np.arange(int(2.0 * fs)) / fs
        enc = RDSEncoder(pi=0xF00D, pty=7, ps="GUI H100")
        mpx = make_mpx_rds(0.4 * np.sin(2 * np.pi * 900 * t), 0.4 * np.sin(2 * np.pi * 1700 * t),
                           fs, enc, n_groups=32)
        backend._scan_ring = (0.5 * np.cos(2 * np.pi * np.cumsum(200e3 + 75e3 * mpx) / fs)
                              ).astype(np.float32)
        launch.reset_counts()
        rds = _api(port, "/api/rds", {"center_khz": 200.0})
        check(rds["ok"] and rds["pi"] == "F00D" and rds["ps"] == "GUI H100", ("GUI RDS", rds))
        roof = _api(port, "/api/roofline", method="GET")
        check(roof["chip"] == "h100" and roof.get("fraction_of_ceiling", 0) <= 1.05,
              ("GUI roofline", roof))
        print(f"[8] GUI scan hits {hits} kHz; burst 512 bits == sent: True (frame lag "
              f"{burst['frame_lag_syms']} syms); RDS PI {rds['pi']} PS {rds['ps']!r} (launches "
              f"{ {k: v for k, v in launch.counts['kernel'].items() if v} }); /api/roofline: "
              f"{roof['chip']}, ceiling {roof['ceiling_samples_per_sec']:.4e} samples/s, the "
              f"session's measured {roof.get('measured_samples_per_sec', 0):.4e} -> fraction "
              f"{roof.get('fraction_of_ceiling', 0):.4f}")
    finally:
        backend.stop_receiver()
        srv.shutdown()
        sse.close()
    statuses = sse.since(t_start, "receiver_status")
    bad = [d for d in statuses if not d["ok"] or "degraded" in d["message"]]
    print(f"[8] GUI: {len(statuses)} status events, {len(bad)} with ok=False or 'degraded'"
          + (f": {bad}" if bad else ""))
    check(not bad, ("GUI status events", bad))
    return rates


def phase_chain():
    """The full chain (ROADMAP A19) at the reference's width (one channel,
    N = 16384): command bytes into ``SpectrumAnalyzer`` on the card,
    ``UdpSpectrumSender`` over 127.0.0.1, ``UdpSpectrumReceiver`` decoding
    within int16 quantisation, the filter acting over the wire; then a
    checkpoint through files and back, bit for bit."""
    from tpu_sdr_torch import PipelineConfig, SpectrumAnalyzer
    from tpu_sdr_torch.control import design_iir_filter, golden
    from tpu_sdr_torch.control.commands import Command, encode_coefficient_upload
    from tpu_sdr_torch.kernels.cuda import launch
    from tpu_sdr_torch.transport.udp_stream import UdpSpectrumReceiver, UdpSpectrumSender

    got = []
    rx = UdpSpectrumReceiver(port=0, bind_ip="127.0.0.1", fps_cap=1e9,
                             on_frame=lambda re, im, mag: got.append(mag.copy()))
    rx.start()
    tx = UdpSpectrumSender("127.0.0.1", rx.port)
    try:
        sa = SpectrumAnalyzer(PipelineConfig(channels=1), on_spectrum=lambda mag, idx:
                              tx.send_spectrum(mag, np.zeros_like(mag), scale=1.0))
        launch.reset_counts()
        sa.handle_bytes(bytes([Command.MODE_BYPASS, Command.START]))
        x = golden.synth_tone(100e3, N).astype(np.float32)[None, :]
        out_bypass = sa.process(x)
        d = design_iir_filter("butterworth", "lowpass", 4, 1e6, 50e3)
        sa.handle_bytes(encode_coefficient_upload(d.to_wire_bytes()))
        sa.handle_bytes(bytes([Command.MODE_CUSTOM]))
        out_custom = sa.process(x)
        deadline = time.time() + 10
        while len(got) < 2 and time.time() < deadline:
            time.sleep(0.02)
    finally:
        rx.stop()
        tx.close()
    n_row1 = launch.counts["kernel"]["spectrum_bypass"]
    check(len(got) == 2, ("chain: frames over UDP", len(got)))
    err = [float(np.abs(g - np.abs(np.rint(o["magnitude"][0, 0]))).max())
           for g, o in zip(got, (out_bypass, out_custom))]
    cut = got[1][1638] / got[0][1638]
    print(f"[9] full chain: command bytes -> SpectrumAnalyzer (1 ch x {N}) -> UDP 127.0.0.1 -> "
          f"UdpSpectrumReceiver: {len(got)} frames ({rx.frames_received} assembled), decoded vs "
          f"rint(analyzer magnitudes) max |err| {err[0]:.3f} / {err[1]:.3f} (<= 0.5); 100 kHz "
          f"after the 50 kHz lowpass at {cut:.2e} of BYPASS; launches spectrum_bypass {n_row1}")
    check(max(err) <= 0.5 and cut < 0.05 and n_row1 == 2, ("chain", err, cut, n_row1))

    ckdir = os.path.join("build", "chip_smoke_checkpoint")
    os.makedirs(ckdir, exist_ok=True)
    sa = SpectrumAnalyzer(PipelineConfig(channels=1))
    sa.handle_bytes(bytes([Command.START, Command.MODE_CUSTOM]))
    sa.upload_filter(sps.ellip(10, 0.5, 60, 0.3, output="sos"))
    rng = np.random.default_rng(5)
    x1, x2 = (rng.standard_normal((1, N)).astype(np.float32) for _ in range(2))
    sa.process(x1)
    ckpt = sa.checkpoint()
    state = ckpt.pop("state")
    np.savez(os.path.join(ckdir, "ckpt.npz"), **{k: v for k, v in state.items() if v is not None})
    with open(os.path.join(ckdir, "meta.json"), "w") as f:
        json.dump(ckpt, f)
    with open(os.path.join(ckdir, "meta.json")) as f:
        meta = json.load(f)
    loaded = dict(np.load(os.path.join(ckdir, "ckpt.npz")))
    meta["state"] = {k: loaded.get(k) for k in ("sos_state", "window_phase", "frame_count", "history")}
    sb = SpectrumAnalyzer(PipelineConfig(channels=1))
    sb.restore(meta)
    same = np.array_equal(sa.process(x2)["magnitude"], sb.process(x2)["magnitude"])
    print(f"[9] checkpoint through files ({ckdir}) and back: the resumed analyzer == the "
          f"uninterrupted one bit for bit: {same}")
    check(same and int(sb.state.frame_count) == int(sa.state.frame_count), "chain checkpoint")


def _cli(argv: list) -> tuple[int, str]:
    import contextlib
    import io

    from tpu_sdr_torch.__main__ import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    return rc, buf.getvalue()


def phase_cli():
    """``python -m tpu_sdr_torch``'s ``selftest``, ``trace`` and ``bench`` on
    the card: the selftest passes; the trace is a device trace in which
    every port kernel the dispatch launched appears as often as its wrapper
    launched it; the bench prints a rate. Returns the bench record."""
    from tpu_sdr_torch.kernels.cuda import launch

    rc, out = _cli(["selftest"])
    print("\n".join(f"[10] selftest {line}" for line in out.splitlines()))
    check(rc == 0 and "selftest: PASS" in out, "CLI selftest")
    reps = 3
    launch.reset_counts()
    rc, out = _cli(["trace", "--reps", str(reps)])
    table = json.loads(out.strip().splitlines()[-1])
    made = {k: v for k, v in launch.counts["kernel"].items() if v}
    check(rc == 0 and table["device_trace"], ("CLI trace", table))
    # the command's warm-up dispatch, the profiler's warm-up call, then reps
    per = {k: v / (reps + 2) for k, v in made.items()}
    seen = {w: sum(n for name, n in table["op_counts"].items()
                   if any(k in name for k in LAST_DEVICE_KERNEL[w])) for w in per}
    print(f"[10] trace (8 ch x 64 frames, CUSTOM, hybrid): device_trace true; last dispatch "
          f"{table['n_ops']} device ops, busy {table['device_busy_ms']:.4f} ms, span "
          f"{table['dispatch_ms']:.4f} ms, idle {table['device_idle_ms']:.4f} ms; port kernels "
          f"seen in it {seen}, launched a dispatch {per}")
    check(per and all(seen[w] == per[w] for w in per), ("CLI trace seen vs made", seen, per))
    rc, out = _cli(["bench"])
    rec = json.loads(out.strip().splitlines()[-1])
    print(f"[10] bench (8 ch x 64 frames, CUSTOM, slope of 12 - 2 chained dispatches): "
          f"{rec['value']:.4e} samples/s, {rec['per_dispatch_ms']:.4f} ms a dispatch on "
          f"{rec['device']}")
    check(rc == 0 and rec["value"] > 0 and rec["device"] == torch.cuda.get_device_name(0),
          ("CLI bench", rec))
    return rec


def phase_roofline(walls: dict, bench: dict):
    """Each timed spectrum path's measured samples/s against the H100's
    roofline ceiling and serial floor (``bench.roofline``); a fraction of
    the ceiling above 1.05 means the cost model's count is wrong."""
    from tpu_sdr_torch import PipelineConfig
    from tpu_sdr_torch.bench.roofline import roofline_report, serial_floor_report

    samples = CHANNELS * FRAMES * N
    default = PipelineConfig(channels=CHANNELS)
    cfgs = {"BYPASS": default, "FIXED": default, "CUSTOM": default,
            "fused f32 CUSTOM": PipelineConfig(channels=CHANNELS, fused_two_pass=True),
            "IQ BYPASS": default, "IQ CUSTOM": default, "IQ planes BYPASS": default,
            "IQ planes CUSTOM": default,
            "hop BYPASS": PipelineConfig(channels=CHANNELS, hop=HOP),
            "hop CUSTOM": PipelineConfig(channels=CHANNELS, hop=HOP),
            "bank CUSTOM": default, "analyzer CUSTOM": default}
    rates = {label: samples / walls[label] for label in cfgs}
    rates["CLI bench CUSTOM"] = bench["value"]
    cfgs["CLI bench CUSTOM"] = default
    worst = 0.0
    for label, rate in rates.items():
        rr = roofline_report(cfgs[label], measured_samples_per_sec=rate)
        sf = serial_floor_report(cfgs[label], measured_samples_per_sec=rate)
        worst = max(worst, rr["fraction_of_ceiling"])
        print(f"[11] roofline {label:17s}: {rate:.4e} samples/s; ceiling "
              f"{rr['ceiling_samples_per_sec']:.4e} ({rr['bound']}-bound, "
              f"{rr['flops_per_frame'] / 1e6:.3f} MFLOP a frame at {rr['tier_tflops']:g} TFLOP/s) "
              f"-> fraction_of_ceiling {rr['fraction_of_ceiling']:.4f}; serial floor "
              f"{sf['serial_floor_samples_per_sec']:.4e} -> fraction_of_serial_floor "
              f"{sf['fraction_of_serial_floor']:.4f}")
    check(worst <= 1.05, ("a measured rate above the roofline ceiling", worst))


# ---------------------------------------------------------------- shard/
# The sharded engines (tpu_sdr_torch.shard) in ranks spawned on the one
# card: 4 processes on cuda:0 over Gloo (NCCL refuses two ranks on one GPU;
# each collective stages its tensors through the host), the 2-rank grids as
# sub-meshes of the 4-rank group. Each rank drives every path at the main
# path's width (8 channels x 64 frames of 16384), rank 0 holds the
# gathered result against the single-device pipeline on the card.
SHARD_GRIDS = ((1, 2), (2, 1), (2, 2))
SHARD_WORLD = 4
SHARD_DISPATCHES = 2
SHARD_COLLECTIVE_S = 300.0  # a collective (or a sub-mesh's wait) fails after this
SHARD_JOIN_S = 540.0  # the phase kills its ranks and fails after this
SHARD_IIR = ("iir_state", "iir_emit", "iir_force")  # a filtered dispatch's IIR kernels
SHARD_PATHS = {  # label -> (PipelineConfig kwargs, mode, input, kernels it must launch)
    "BYPASS": (dict(), "BYPASS", "real", ("spectrum_bypass",)),
    "FIXED": (dict(), "FIXED", "real", ("spectrum_bypass", *SHARD_IIR)),
    "CUSTOM": (dict(), "CUSTOM", "real", ("spectrum_bypass", *SHARD_IIR)),
    "fused f32 CUSTOM": (dict(fused_two_pass=True), "CUSTOM", "real",
                         ("iir_summaries", "spectrum_iir")),
    "hop 8192 CUSTOM": (dict(hop=8192), "CUSTOM", "real",
                        ("spectrum_bypass", *SHARD_IIR)),
    "bank CUSTOM": (dict(), "CUSTOM", "bank", ("spectrum_bypass", *SHARD_IIR)),
    "IQ CUSTOM": (dict(), "CUSTOM", "iq", ("spectrum_complex", *SHARD_IIR)),
}
SHARD_PROFILED = ("CUSTOM", "fused f32 CUSTOM")
SHARD_RX_T = 62 * 16_000  # the wbfm receiver's granularity x 62, split over 2 time shards
SHARD_SOS = sps.butter(12, 0.25, output="sos")


def _shard_input(kind: str):
    rng = np.random.default_rng(1)
    if kind == "iq":
        return two_tone_iq(rng)
    if kind == "bank":
        return np.random.default_rng(8).standard_normal((CHANNELS, FRAMES * N)).astype(np.float32)
    return two_tone(rng)


def _shard_pipe(cls, label: str, **kw):
    from tpu_sdr_torch import FilterMode, PipelineConfig

    cfg_kw, mode, kind, _ = SHARD_PATHS[label]
    pipe = cls(PipelineConfig(channels=CHANNELS, **cfg_kw), **kw)
    pipe.upload_sos(SHARD_SOS)
    if kind == "bank":
        pipe.upload_sos_bank(bank_designs())
    init = lambda: pipe.initial_state(batch_shape=(2,) if kind == "iq" else ())
    return pipe, init, FilterMode[mode]


def _timed(mesh, run):
    """run() with the launch counts and the mesh's collective counters set
    to 0 just before it, read just after: (result, walls, launches, plain
    calls and collective calls)."""
    from tpu_sdr_torch.kernels.cuda import launch

    launch.reset_counts()
    mesh.stats.update(calls=0)
    res, walls = run()
    return (res, walls, {k: v for k, v in launch.counts["kernel"].items() if v},
            sum(launch.counts["plain"].values()), dict(mesh.stats))


def _shard_spectrum_path(mesh, label: str, rank: int) -> dict:
    from tpu_sdr_torch import SpectrumPipeline
    from tpu_sdr_torch.bench.trace import capture_op_table
    from tpu_sdr_torch.shard import ShardedSpectrumPipeline

    pipe, init, mode = _shard_pipe(ShardedSpectrumPipeline, label, mesh=mesh)
    x = _shard_input(SHARD_PATHS[label][2])
    pipe.process(x, init(), mode)  # warm-up: first launches
    torch.cuda.synchronize()

    def run():
        st, walls = init(), []
        for _ in range(SHARD_DISPATCHES):
            t0 = time.perf_counter()
            out, st = pipe.process(x, st, mode)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return (out, st), walls

    (out, st), walls, launches, plain, coll = _timed(mesh, run)
    rec = dict(walls=walls, launches=launches, plain=plain, coll_calls=coll["calls"])
    if label in SHARD_PROFILED:
        stc = [init()]

        def step():
            _, stc[0] = pipe.process(x, stc[0], mode)

        t = capture_op_table(step, reps=1)
        rec["busy_ms"] = t["device_busy_ms"] if t["device_trace"] else None
    mag = pipe.gather(out)["magnitude"]
    if rank == 0:
        single, sinit, _ = _shard_pipe(SpectrumPipeline, label)
        sst = sinit()
        for _ in range(SHARD_DISPATCHES):
            sout, sst = single.process(x, sst, mode)
        ref = sout["magnitude"]
        rec["equal"] = bool(
            mag.shape == ref.shape and torch.equal(mag, ref)
            and torch.equal(st.sos_state, sst.sos_state)
            and (st.history is None or torch.equal(st.history, sst.history))
            and int(st.frame_count) == int(sst.frame_count)
            and int(st.window_phase) == int(sst.window_phase))
        rec["max_abs"] = float((mag.float() - ref.float()).abs().max())
    return rec


def _leaves(v) -> list:
    """Every tensor leaf of an output or a carried state (a tensor, a dict
    of them, or a state object with nested states), in a fixed order."""
    from tpu_sdr_torch.shard.mesh import map_state

    if isinstance(v, dict):
        return [t for k in sorted(v) for t in _leaves(v[k])]
    found = []
    map_state(v, found.append)
    return found


def _shard_stage(mesh, rank: int, sharded, single, x, state, call) -> dict:
    """A streaming stage (channelizer, receiver): two carried-state calls,
    timed and counted; rank 0 holds the gathered output and the final
    state against the single-device stage."""
    call(sharded, x, state(sharded))  # warm-up
    torch.cuda.synchronize()

    def run():
        st, walls = state(sharded), []
        for _ in range(SHARD_DISPATCHES):
            t0 = time.perf_counter()
            out, st = call(sharded, x, st)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return (out, st), walls

    (out, st), walls, launches, plain, coll = _timed(mesh, run)
    got = sharded.gather(out)
    rec = dict(walls=walls, launches=launches, plain=plain, coll_calls=coll["calls"])
    if rank == 0:
        sst = state(single)
        for _ in range(SHARD_DISPATCHES):
            ref, sst = call(single, x, sst)
        a_got, a_ref = _leaves(got) + _leaves(st), _leaves(ref) + _leaves(sst)
        pairs = list(zip(a_got, a_ref))
        rec["leaves"] = len(pairs)
        rec["equal"] = len(a_got) == len(a_ref) and all(
            a.shape == b.shape and torch.equal(a, b) for a, b in pairs)
        rec["max_abs"] = max(float((a.double() - b.double()).abs().max())
                             for a, b in pairs if a.shape == b.shape)
    return rec


def shard_rank(rank: int, out_dir: str):
    """One rank of the shard phase's group (spawned; every rank runs this).
    Writes rank<r>.json, or rank<r>.err with its traceback and exits 1."""
    import traceback

    out = __import__("pathlib").Path(out_dir)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        from tpu_sdr_torch.kernels.pfb import Channelizer
        from tpu_sdr_torch.runtime.receiver import Receiver
        from tpu_sdr_torch.shard import (ShardedChannelizer, ShardedReceiver, distributed,
                                         make_sdr_mesh)

        distributed.initialize(coordinator_address=f"file://{out / 'rendezvous'}",
                               num_processes=SHARD_WORLD, process_id=rank, backend="gloo",
                               timeout_s=SHARD_COLLECTIVE_S)
        report = {}
        for grid in SHARD_GRIDS:
            mesh = make_sdr_mesh(*grid, devices="cuda:0")
            if not mesh.member:
                continue
            g = f"{grid[0]}x{grid[1]}"
            for label in SHARD_PATHS:
                report[f"{g} {label}"] = _shard_spectrum_path(mesh, label, rank)
            x = np.load(out / "pfb_x.npy")
            mk = lambda: Channelizer(m=PFB_M, taps=PFB_TAPS, use_pallas=True, device="cuda:0")
            report[f"{g} channelizer (row 8)"] = _shard_stage(
                mesh, rank, ShardedChannelizer(mk(), mesh), mk(), x,
                lambda e: e.initial_state((NB_CH,)), lambda e, v, s: e.process(v, s))
            x = np.load(out / "rx_x.npy")
            mk = lambda: Receiver(fs=RX_FS, center_hz=RX_CENTER, mode="wbfm",
                                  audio_rate=RX_AUDIO, device="cuda:0")
            report[f"{g} receiver wbfm"] = _shard_stage(
                mesh, rank, ShardedReceiver(mk(), mesh), mk(), x,
                lambda e: e.initial_state((NB_CH,)), lambda e, v, s: e.process(v, s))
        (out / f"rank{rank}.json").write_text(json.dumps(report))
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)


def phase_shard(smi: str) -> dict:
    """Spawn the 4-rank group, wait for it within SHARD_JOIN_S (killing
    every rank and failing on a hang or a failed rank), and print each
    path's per-rank wall, collectives and launches. Returns the launches of
    each port kernel summed over every rank, grid and path."""
    import multiprocessing
    import pathlib
    import shutil

    out = pathlib.Path("build/chip_smoke_shard").resolve()
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    # The streaming stages' inputs are made once, here, and read by every
    # rank: the FM signal's phase is a float64 cumsum on the card, whose
    # bits can differ between runs (and so between processes).
    np.save(out / "pfb_x.npy", pfb_inputs()[0].cpu().numpy())
    np.save(out / "rx_x.npy", rx_signal(SHARD_RX_T, "wbfm").cpu().numpy())
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=shard_rank, args=(r, str(out))) for r in range(SHARD_WORLD)]
    for p in procs:
        p.start()
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.perf_counter() - t0 > SHARD_JOIN_S:
                break
            time.sleep(0.5)
    finally:
        time.sleep(1.0 if any(p.is_alive() for p in procs) else 0.0)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    errs = "".join(f"rank {r}:\n{(out / f'rank{r}.err').read_text()}"
                   for r in range(SHARD_WORLD) if (out / f"rank{r}.err").exists())
    check(not errs and all(p.exitcode == 0 for p in procs),
          f"shard phase: exit codes {[p.exitcode for p in procs]}\n{errs}")
    reports = [json.loads((out / f"rank{r}.json").read_text()) for r in range(SHARD_WORLD)]
    print(f"[13] shard/: {SHARD_WORLD} ranks on cuda:0 over Gloo (host-staged collectives), "
          f"grids {', '.join(f'{c}x{t}' for c, t in SHARD_GRIDS)}, {SHARD_DISPATCHES} "
          f"carried-state dispatches a path, on {smi}; the group took "
          f"{time.perf_counter() - t0:.1f} s")
    totals: dict = {}
    for key in reports[0]:
        members = [(r, rep[key]) for r, rep in enumerate(reports) if key in rep]
        r0 = members[0][1]
        label = key.split(" ", 1)[1]
        want = SHARD_PATHS[label][3] if label in SHARD_PATHS else (
            ("pfb_fold_dft",) if "channelizer" in label else ())
        for r, rec in members:
            check(rec["plain"] == 0, (key, r, "plain calls", rec["plain"]))
            check(all(rec["launches"].get(k, 0) > 0 for k in want), (key, r, rec["launches"]))
            for k, v in rec["launches"].items():
                totals[k] = totals.get(k, 0) + v
        check(r0["equal"], (key, "sharded != single-device", r0["max_abs"]))
        held = f", {r0['leaves']} output and state leaves" if "leaves" in r0 else ""
        print(f"[13] {key:30s} == single-device bit for bit (max |diff| {r0['max_abs']}{held})")
        for r, rec in members:
            wall = statistics.mean(rec["walls"]) * 1e3
            busy = rec.get("busy_ms")
            idle = "" if "busy_ms" not in rec else (
                "; idle share not measured (no device trace)" if busy is None else
                f"; device busy {busy:.4f} ms -> idle share {1 - busy / wall:.1%}")
            n = len(rec["walls"])
            print(f"[13]   rank {r}: dispatch wall {wall:.4f} ms (mean of {n}), collectives "
                  f"{rec['coll_calls'] / n:g} calls a dispatch, "
                  f"launches {rec['launches'] or 'none'}{idle}")
    return totals


def phase_shard_nccl():
    """LatencyPipeline on a 1-rank NCCL group in this process: the NCCL
    route's collectives (all-gather, all-to-all, reduce-scatter) run on the
    card; the result within 1e-5 of the throughput engine's peak."""
    import pathlib
    import shutil

    from tpu_sdr_torch import FilterMode, PipelineConfig, SpectrumPipeline
    from tpu_sdr_torch.shard import LatencyPipeline, distributed, make_sdr_mesh

    store = pathlib.Path("build/chip_smoke_nccl").resolve()
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    distributed.initialize(coordinator_address=f"file://{store / 'rendezvous'}",
                           num_processes=1, process_id=0, backend="nccl",
                           timeout_s=SHARD_COLLECTIVE_S)
    try:
        mesh = make_sdr_mesh(channel=1)
        check(mesh.time.backend == "nccl" and mesh.time.group is not None, "NCCL group")
        lat = LatencyPipeline(PipelineConfig(channels=1), mesh)
        thr = SpectrumPipeline(PipelineConfig(channels=1))
        lat.upload_sos(SHARD_SOS)
        thr.upload_sos(SHARD_SOS)
        x = two_tone(np.random.default_rng(3))[0, : 3 * N]
        ref = thr.process(x, thr.initial_state(), FilterMode.CUSTOM)[0]["magnitude"][0]
        lat.process_frame(x[:N], lat.initial_state(), FilterMode.CUSTOM)  # NCCL's set-up
        torch.cuda.synchronize()
        z, worst = lat.initial_state(), 0.0
        mesh.stats.update(calls=0)
        t0 = time.perf_counter()
        for f in range(3):
            mag, z = lat.process_frame(x[f * N : (f + 1) * N], z, FilterMode.CUSTOM)
            worst = max(worst, float((lat.gather(mag) - ref[f]).abs().max() / ref[f].abs().max()))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3
        check(worst < 1e-5, ("latency engine vs throughput", worst))
        check(mesh.stats["calls"] > 0, "no NCCL collective ran")
        print(f"[13] LatencyPipeline on a 1-rank NCCL group: 3 CUSTOM frames within {worst:.3g} "
              f"of the throughput engine's peak (bound 1e-5); {mesh.stats['calls']} NCCL "
              f"collectives; {wall * 1e3:.4f} ms a frame")
    finally:
        torch.distributed.destroy_process_group()


def main():
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    shard_launches = phase_shard(smi)
    phase_shard_nccl()
    phase_one_kernel_steps()
    phase_gui()
    phase_chain()
    bench = phase_cli()
    from tpu_sdr_torch import PipelineConfig, SpectrumPipeline
    from tpu_sdr_torch.kernels.cuda import launch

    sos_custom = sps.butter(12, 0.25, output="sos")
    pipe = SpectrumPipeline(PipelineConfig(channels=CHANNELS))
    pipe.upload_sos(sos_custom)
    pp = pipe.bank_custom["pp"]
    errs = phase_kernel_vs_plain(pp)
    state_errs, state_timing = phase_iir_state()
    errs.update(state_errs)
    emit_errs, emit_timing = phase_iir_emit()
    errs.update(emit_errs)
    force_errs, force_timing = phase_iir_force()
    errs.update(force_errs)
    phase_summaries_accuracy(pp)
    rng = np.random.default_rng(1)
    x_np = two_tone(rng)
    xc_np = two_tone_iq(rng)
    launches = {"spectrum_bypass": phase_main_path(pipe, x_np, sos_custom)}
    launches["iir_state"] = launch.counts["kernel"]["iir_state"]
    launches["iir_emit"] = launch.counts["kernel"]["iir_emit"]
    launches["iir_force"] = launch.counts["kernel"]["iir_force"]
    phase_chunked(pipe, x_np)
    pipes = fused_pipes(sos_custom)
    launches.update(phase_fused(pipes, x_np, sos_custom))
    launches["spectrum_complex"] = phase_iq(pipe, xc_np, sos_custom)
    steps = paths(pipe, pipes, x_np, xc_np)
    walls, timing = phase_timing(pp, sos_custom, x_np, steps)
    timing.update(state_timing)
    timing.update(emit_timing)
    timing.update(force_timing)
    phase_profile(steps, walls)
    phase_small_dispatch(sos_custom)
    fplan = pipe.plan
    errs.update(phase_half_and_fused_vs_plain(pp, fplan))
    launches.update(phase_rows_4_6(pp, fplan, x_np))
    hop_pipe = phase_hop(sos_custom, x_np)
    x_noise = np.random.default_rng(8).standard_normal((CHANNELS, FRAMES * N)).astype(np.float32)
    bank_pipe = phase_bank(x_noise)
    sa = phase_analyzer(x_np)
    new_steps = {**new_paths(hop_pipe, bank_pipe, sa, x_np, x_noise), "CUSTOM": steps["CUSTOM"]}
    new_walls, new_timing = phase_new_timing(pp, fplan, x_np, new_steps)
    timing.update(new_timing)
    phase_profile(new_steps, {k: v for k, v in new_walls.items() if k != "CUSTOM"})
    errs.update(phase_nb_kernels())
    planes = fm_planes()
    launches["fm_demod"] = phase_fm(planes)
    pfb_x, pfb_planes = pfb_inputs()
    launches["pfb_fold_dft"] = phase_channelizer(pfb_x, pfb_planes)
    rx, rx_x, rx_xs = phase_receiver()
    nb_steps = nb_paths(planes, pfb_x, pfb_planes, rx, rx_x, rx_xs)
    nb_walls, nb_timing = phase_nb_timing(planes, nb_steps)
    timing.update(nb_timing)
    phase_nb_phases(pp, fplan)
    late = {label: (nb_steps[label], nb_walls.pop(label))
            for label in HEAVY_PROFILES if label in nb_walls}
    phase_profile(nb_steps, nb_walls)
    errs.update(phase_q15_kernels())
    q15_launches, q15_pipes = phase_q15_path()
    launches.update(q15_launches)
    q15_walls, q15_timing, q15_steps = phase_q15_timing(q15_pipes)
    timing.update(q15_timing)
    phase_profile(q15_steps, q15_walls)
    phase_q15_stream(q15_pipes["split"])
    phase_host_runtime(pipe, sos_custom)
    phase_host_feed()
    errs["viterbi"] = phase_k3_vs_plain()
    launches["viterbi"], k3_inputs = phase_burst_fec()
    pr10_steps = {**phase_fastfir(), **phase_iqcorr(), **phase_scanner()}
    pr10_steps.update({**phase_rds(), **phase_transport()})
    pr10_walls, pr10_timing, pr10_steps = phase_pr10_timing(k3_inputs, pr10_steps)
    timing.update(pr10_timing)
    late.update({label: (pr10_steps[label], pr10_walls.pop(label))
                 for label in HEAVY_PROFILES if label in pr10_walls})
    phase_profile(pr10_steps, pr10_walls, {"RDS chain": 1, "scanner": 1})
    phase_roofline({**walls, **new_walls}, bench)
    phase_profile({k: late[k][0] for k in HEAVY_PROFILES},
                  {k: late[k][1] for k in HEAVY_PROFILES}, dict.fromkeys(HEAVY_PROFILES, 1))
    print(f"[12] chip_smoke wall time {time.perf_counter() - t_start:.1f} s (the kernels' build "
          f"included)")
    records = [
        {"route": "cuda", "source": f"tpu_sdr_torch/csrc/{name}.cu", **fixed,
         "launches": launches[name], "shard_launches": shard_launches.get(name, 0),
         "max_abs_err": errs[name], **timing[name]}
        for name, fixed in RECORDS.items()
    ]
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
