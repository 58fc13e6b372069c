"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each raises on failure):
  1. device: card name and power limit, torch/CUDA versions, fp32 matmul
     precision flags (set to IEEE fp32 here);
  2. build: every CUDA kernel library of the port, built from
     ``tpu_sdr_torch/csrc`` with nvcc (all sources at once);
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     card, at the main path's shapes, with the stated SNR floors;
  4. main path: ``SpectrumPipeline.process`` at 8 channels x 64 frames per
     dispatch (8.4 Msamples), CUSTOM (butter(12, 0.25)), FIXED and BYPASS,
     5 carried-state dispatches each; checks that every dispatch launched
     the kernel and never the plain version, the two-tone peaks against a
     float64 NumPy/SciPy golden (1 dB), and chunked vs one-shot;
  5. timing with CUDA events: each kernel, its plain version and the
     library yardstick at the main path's shape, the bound, and each
     mode's end-to-end dispatch time;
  6. profile: device time per dispatch by kernel, launches per dispatch,
     and the device's idle share, per mode;
  7. small dispatches: CUSTOM at 1 channel x 1 and x 4 frames, wall and
     device time, beside the bench shape's of phases 5 and 6.

Prints one JSON line of kernel records, the card's name and power limit,
and as its last line {"ok": true, "device": {...}}. Needs one CUDA device;
exits non-zero without a result line when there is none.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import scipy.signal as sps
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

N = 16384
CHANNELS, FRAMES = 8, 64  # bench.py's headline dispatch shape
DISPATCHES = 5
SNR_FLOOR_DB = {"float32": 120.0, "bfloat16": 45.0}


def check(ok, what=""):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def snr_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref = ref.double()
    err = ((ref - got.double()) ** 2).sum().item()
    sig = (ref**2).sum().item()
    return float("inf") if err == 0 else 10 * np.log10(sig / err)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def golden_magnitude(x: np.ndarray, sos, win: np.ndarray) -> np.ndarray:
    """float64 window -> sosfilt -> FFT -> |X| of one channel's frames."""
    xw = (x.reshape(-1, N) * win).reshape(-1).astype(np.float64)
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
    from tpu_sdr_torch.kernels.cuda import loader

    t0 = time.perf_counter()
    log = loader.build("spectrum_bypass", force=True)
    print(f"[2] built spectrum_bypass in {time.perf_counter() - t0:.2f} s (nvcc)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[2]   {line.strip()}")


def phase_kernel_vs_plain(pp) -> dict:
    from tpu_sdr_torch.kernels.cuda import iir_fft

    rng = np.random.default_rng(0)
    errs = {}
    for F in (1, 8, CHANNELS * FRAMES):
        x32 = torch.as_tensor(rng.standard_normal((F, N)), dtype=torch.float32).cuda()
        for in_dtype in (torch.float32, torch.bfloat16):
            x = x32.to(in_dtype)
            for apply_window in (True, False):
                for out_dtype in ("float32", "bfloat16"):
                    got = iir_fft.spectrum_bypass_cuda(x, pp, apply_window, out_dtype)
                    ref = iir_fft.spectrum_bypass_plain(x, pp, apply_window, out_dtype)
                    torch.cuda.synchronize()
                    check(got.shape == (F, N) and got.dtype == ref.dtype)
                    check(torch.isfinite(got.float()).all())
                    snr = snr_db(ref.float(), got.float())
                    diff = (got.float() - ref.float()).abs()
                    rel = (diff.max() / ref.float().abs().max()).item()
                    print(f"[3] F={F:3d} in={str(in_dtype)[6:]:8s} window={apply_window!s:5s} "
                          f"out={out_dtype:8s} snr={snr:6.1f} dB max_rel_err={rel:.2e}")
                    check(snr >= SNR_FLOOR_DB[out_dtype], (F, apply_window, out_dtype, snr))
                    if F == CHANNELS * FRAMES and in_dtype == torch.float32 and not apply_window:
                        errs[out_dtype] = diff.max().item()
    return errs


TONE_BINS = (1638, 4096)  # ~100 kHz (CUSTOM passband), 250 kHz (FIXED passband)


def two_tone(rng) -> np.ndarray:
    n = np.arange(FRAMES * N)
    tone = sum(0.4 * np.sin(2 * np.pi * k * n / N) for k in TONE_BINS)
    noise = 1e-3 * rng.standard_normal((CHANNELS, FRAMES * N))
    return (tone[None, :] + noise).astype(np.float32)


def phase_main_path(pipe, x_np: np.ndarray, sos_custom) -> int:
    from tpu_sdr_torch import FilterMode
    from tpu_sdr_torch.control import golden
    from tpu_sdr_torch.kernels.cuda import iir_fft

    x = torch.as_tensor(x_np, device="cuda")
    win = golden.hann_true(N)
    golden_sos = {FilterMode.CUSTOM: sos_custom, FilterMode.FIXED: golden.fixed_filter_sos(),
                  FilterMode.BYPASS: None}
    for k in iir_fft.counts:
        iir_fft.counts[k] = 0
    for mode in (FilterMode.CUSTOM, FilterMode.FIXED, FilterMode.BYPASS):
        before = iir_fft.counts["kernel"]
        st = pipe.initial_state()
        outs = []
        for _ in range(DISPATCHES):
            out, st = pipe.process(x, st, mode)
            outs.append(out["magnitude"])
        torch.cuda.synchronize()
        launched = iir_fft.counts["kernel"] - before
        check(launched == DISPATCHES, (mode, launched))
        check(iir_fft.counts["plain"] == 0, iir_fft.counts)
        check(int(st.frame_count) == DISPATCHES * FRAMES and int(st.window_phase) == 0)
        mag = outs[0]
        check(mag.shape == (CHANNELS, FRAMES, N) and mag.dtype == torch.float32)
        check(all(torch.isfinite(o).all() for o in outs))
        # channel 0, first two frames of the first dispatch vs float64
        ref = golden_magnitude(x_np[0, : 2 * N], golden_sos[mode], win)
        got = mag[0, :2].double().cpu().numpy()
        db = lambda a: 20 * np.log10(np.maximum(a, 1e-12))
        # each tone that the mode passes (golden above -60 dB of the
        # maximum): the port's peak sits at the golden's bin, within 1 dB
        peaks = []
        for k in TONE_BINS:
            lo = k - 3
            ref_pk = lo + int(np.argmax(ref[0, lo : k + 4]))
            if ref[0, ref_pk] < ref.max() * 1e-3:
                continue
            check(lo + int(np.argmax(got[0, lo : k + 4])) == ref_pk, (mode, k))
            peaks.append(ref_pk)
        check(peaks, mode)
        peak_db = np.abs(db(got[:, peaks]) - db(ref[:, peaks])).max()
        mask = ref > ref.max() * 1e-3
        contract_db = np.abs(db(got[mask]) - db(ref[mask])).max()
        print(f"[4] {mode.name:6s} {DISPATCHES} dispatches: kernel launches {launched}, "
              f"plain {iir_fft.counts['plain']}, peaks at bins {peaks} "
              f"within {peak_db:.4f} dB, bins above -60 dB within {contract_db:.4f} dB")
        check(peak_db < 1.0 and contract_db < 1.0, mode)
    return iir_fft.counts["kernel"]


def phase_chunked(pipe, x_np: np.ndarray):
    from tpu_sdr_torch import FilterMode

    x = torch.as_tensor(x_np, device="cuda")
    one, st_one = pipe.process(x, pipe.initial_state(), FilterMode.CUSTOM)
    st = pipe.initial_state()
    parts = []
    for chunk in torch.chunk(x, 4, dim=-1):
        out, st = pipe.process(chunk, st, FilterMode.CUSTOM)
        parts.append(out["magnitude"])
    chunked = torch.cat(parts, dim=1)
    torch.cuda.synchronize()
    bitwise = torch.equal(chunked, one["magnitude"]) and torch.equal(
        st.sos_state, st_one.sos_state
    )
    dev = ((chunked - one["magnitude"]).abs().max() / one["magnitude"].abs().max()).item()
    sdev = (st.sos_state - st_one.sos_state).abs().max().item()
    print(f"[4] chunked (4 x {FRAMES // 4} frames) vs one-shot ({FRAMES} frames), CUSTOM: "
          f"bitwise={bitwise} max_rel_dev={dev:.3e} state_max_abs_dev={sdev:.3e}")
    check(bitwise or dev <= 1e-6, dev)


def dispatch_wall(step) -> tuple[float, float, float]:
    """Host-clock seconds per call of step() (one dispatch on a carried
    state): median, min and max of 5 reps of 10 chained calls, after 3."""
    for _ in range(3):
        step()
    reps = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step()
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) / 10)
    return statistics.median(reps), min(reps), max(reps)


def device_kernels(step, reps: int = 3):
    """Device kernels of ``reps`` calls of step() under torch.profiler:
    (kernels per call, device busy ms per call, {name: ms per call}), or
    None when the profiler saw no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / reps / 1e3
    return len(kernels) / reps, sum(by_name.values()), by_name


def chained(pipe, x, mode):
    """step() for dispatch_wall / device_kernels: one dispatch of x on a
    state carried from the previous call."""
    st = [pipe.initial_state()]

    def step():
        _, st[0] = pipe.process(x, st[0], mode)

    return step


def phase_timing(pipe, pp, x_np: np.ndarray) -> tuple[dict, dict]:
    from tpu_sdr_torch import FilterMode
    from tpu_sdr_torch.kernels.cuda import iir_fft

    F = CHANNELS * FRAMES
    x = torch.as_tensor(x_np, device="cuda").reshape(F, N)
    # The kernel as the default CUSTOM dispatch calls it: fp32 in and out,
    # the window already applied before the IIR.
    kernel_ms = cuda_ms(lambda: iir_fft.spectrum_bypass_cuda(x, pp, False, "float32"))
    plain_ms = cuda_ms(lambda: iir_fft.spectrum_bypass_plain(x, pp, False, "float32"))
    library_ms = cuda_ms(lambda: torch.abs(torch.fft.fft(x)))
    kernel_win_ms = cuda_ms(lambda: iir_fft.spectrum_bypass_cuda(x, pp, True, "float32"))
    # Least time for the same function on these inputs: each input (frames,
    # DFT table, twiddle planes) read once and the output written once; the
    # operations of an FFT of a real frame, 2.5 N log2 N, plus the magnitude
    # (re^2 + im^2 and a square root, 4 per bin).
    bytes_moved = F * N * 4 * 2 + 4 * 128 * 4 + 2 * N * 4
    flops = F * (2.5 * N * math.log2(N) + 4 * N)
    bound_bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    bound_ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    # The kernel's dense four-step DFT does 2 * (2 + 4) * 128^3 operations
    # per frame: a property of its algorithm, not of the function; printed
    # as a note, not used in the bound.
    dense_flops = F * 2 * (2 * 128**3 + 4 * 128**3)
    print(f"[5] spectrum kernel F={F}: {kernel_ms:.4f} ms (window in kernel: {kernel_win_ms:.4f} ms); "
          f"plain {plain_ms:.4f} ms; library |fft| {library_ms:.4f} ms")
    print(f"[5] bound: bytes {bytes_moved / 1e6:.1f} MB -> {bound_bytes_ms:.4f} ms, "
          f"FFT + magnitude {flops / 1e9:.3f} GFLOP fp32 -> {bound_ops_ms:.4f} ms; "
          f"kernel at {bound_ms / kernel_ms:.1%} of the bound, library at "
          f"{bound_ms / library_ms:.1%}")
    print(f"[5] note: the kernel's dense DFT as written is {dense_flops / 1e9:.2f} GFLOP, "
          f"{dense_flops / PEAK_FP32_FLOPS * 1e3:.4f} ms at the fp32 peak")
    xs = torch.as_tensor(x_np, device="cuda")
    samples = xs.numel()
    walls = {}
    for mode in (FilterMode.CUSTOM, FilterMode.FIXED, FilterMode.BYPASS):
        med, lo, hi = dispatch_wall(chained(pipe, xs, mode))
        walls[mode] = med
        print(f"[5] {mode.name:6s} dispatch ({CHANNELS} ch x {FRAMES} frames): median "
              f"{med * 1e3:.4f} ms (min {lo * 1e3:.4f}, max {hi * 1e3:.4f}) "
              f"-> {samples / med:.4e} samples/s")
    return walls, {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms,
                   "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"}


def phase_profile(pipe, x_np: np.ndarray, walls: dict):
    """Device time per dispatch by kernel (torch.profiler), kernel launches
    per dispatch, and the device's idle share against the untraced
    dispatch time of phase 5."""
    xs = torch.as_tensor(x_np, device="cuda")
    for mode, wall in walls.items():
        prof = device_kernels(chained(pipe, xs, mode))
        if prof is None:
            print(f"[6] {mode.name:6s} profiler saw no device events: not measured")
            continue
        n_kernels, busy_ms, by_name = prof
        print(f"[6] {mode.name:6s} per dispatch: {n_kernels:.0f} device kernels, "
              f"busy {busy_ms:.4f} ms of {wall * 1e3:.4f} ms -> idle share "
              f"{1 - busy_ms / (wall * 1e3):.1%}")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            print(f"[6]   {ms:8.4f} ms  {name[:90]}")


def phase_small_dispatch(sos_custom):
    """CUSTOM dispatch at 1 channel x 1 and x 4 frames (the bench shape's
    is phase 5's): host-clock time, device kernels and busy time."""
    from tpu_sdr_torch import FilterMode, PipelineConfig, SpectrumPipeline

    pipe = SpectrumPipeline(PipelineConfig(channels=1))
    pipe.upload_sos(sos_custom)
    gen = torch.Generator(device="cuda").manual_seed(2)
    for frames in (1, 4):
        x = torch.randn((1, frames * N), device="cuda", generator=gen)
        step = chained(pipe, x, FilterMode.CUSTOM)
        med, lo, hi = dispatch_wall(step)
        prof = device_kernels(step)
        busy = ("device not measured" if prof is None
                else f"{prof[0]:.0f} device kernels, busy {prof[1]:.4f} ms")
        print(f"[7] CUSTOM dispatch (1 ch x {frames} frames): median {med * 1e3:.4f} ms "
              f"(min {lo * 1e3:.4f}, max {hi * 1e3:.4f}); {busy}")


def main():
    smi = phase_device()
    phase_build()
    from tpu_sdr_torch import PipelineConfig, SpectrumPipeline

    sos_custom = sps.butter(12, 0.25, output="sos")
    pipe = SpectrumPipeline(PipelineConfig(channels=CHANNELS))
    pipe.upload_sos(sos_custom)
    pp = pipe.bank_custom["pp"]
    errs = phase_kernel_vs_plain(pp)
    x_np = two_tone(np.random.default_rng(1))
    launches = phase_main_path(pipe, x_np, sos_custom)
    phase_chunked(pipe, x_np)
    walls, timing = phase_timing(pipe, pp, x_np)
    phase_profile(pipe, x_np, walls)
    phase_small_dispatch(sos_custom)
    record = {
        "name": "spectrum_from_state[bypass]",
        "route": "cuda",
        "source": "tpu_sdr_torch/csrc/spectrum_bypass.cu",
        "replaces": "tpu_sdr/kernels/pallas/iir_fft.py:549",
        "launches": launches,
        "max_abs_err": errs["float32"],
        **timing,
    }
    print(json.dumps({"kernels": [record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
