"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each raises on failure):
  1. device: card name and power limit, torch/CUDA versions, fp32 matmul
     precision flags (set to IEEE fp32 here);
  2. build: every CUDA kernel library of the port, built from
     ``tpu_sdr_torch/csrc`` with nvcc, one process per source, all started
     together;
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     card at F = 1, 8 and 512 frames, with the stated SNR floors (and a
     relative-error bound for the IIR summaries' states);
  4. the paths, each driven with the launch counts set to 0 just before it
     and read just after, at 8 channels x 64 frames per dispatch
     (8.4 Msamples), 5 carried-state dispatches per mode:
     - the default (hybrid) path: ``SpectrumPipeline.process`` in CUSTOM
       (butter(12, 0.25)), FIXED and BYPASS: one spectrum-kernel launch per
       dispatch, no plain call, the two-tone peaks against a float64
       NumPy/SciPy golden (1 dB), chunked vs one-shot;
     - the fused two-pass path (``fused_two_pass=True``) at the f32 and
       f32max tiers, CUSTOM and FIXED: one summaries and one in-kernel-IIR
       launch per dispatch, the golden, chunked == one-shot bitwise, and
       fused vs hybrid magnitudes;
     - complex (IQ) input through ``process`` and ``process_planes``,
       BYPASS and CUSTOM: one complex-kernel launch per dispatch, a complex
       tone at +f only, the golden, chunked == one-shot bitwise, and
       process == process_planes bitwise;
  5. timing with CUDA events: each kernel, its plain version and (where one
     PyTorch call computes the same function) the library yardstick at the
     main path's shape, and the least time the card could take for it; each
     path's end-to-end dispatch time;
  6. profile: device time per dispatch by kernel, launches per dispatch,
     and the device's idle share, per path and mode;
  7. small dispatches: CUSTOM at 1 channel x 1 and x 4 frames, wall and
     device time, beside the bench shape's of phases 5 and 6.

Prints one JSON line of kernel records, the card's name and power limit,
and as its last line {"ok": true, "device": {...}}. Needs one CUDA device;
exits non-zero without a result line when there is none.
"""

from __future__ import annotations

import concurrent.futures
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
# iir_summaries: max |kernel - plain| over max |plain| of the frame-end states.
STATE_REL_TOL = 1e-5
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
}


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


def bound(bytes_moved: float, flops: float) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the function's operations at
    the fp32 peak, whichever is longer."""
    by_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": bytes_moved, "flops": flops}


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
    from tpu_sdr_torch.kernels.cuda import iir_fft, loader

    def build(name):
        t0 = time.perf_counter()
        log = loader.build(name, force=True)
        return name, time.perf_counter() - t0, log

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(iir_fft.KERNELS)) as pool:
        built = list(pool.map(build, iir_fft.KERNELS))
    print(f"[2] built {len(built)} kernel libraries in {time.perf_counter() - t0:.2f} s "
          f"(nvcc, in parallel)")
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
    from tpu_sdr_torch.kernels.cuda import iir_fft

    launched = iir_fft.counts["kernel"]
    want = {k: expected.get(k, 0) for k in launched}
    check(launched == want, (tag, launched, want))
    check(not any(iir_fft.counts["plain"].values()), (tag, iir_fft.counts["plain"]))


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
        check_counts(mode.name, {"spectrum_bypass": k * DISPATCHES})
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
        check_counts(f"IQ {mode.name}", {"spectrum_complex": k * DISPATCHES})
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


def chained(run, x, state):
    """step() for dispatch_wall / device_kernels: one dispatch run(x, st) on
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


def phase_timing(pp, x_np: np.ndarray, steps: dict) -> tuple[dict, dict]:
    """Kernel, plain and library times and bounds at the main path's shape
    (F = 512, fp32 in and out, as the paths call each kernel), then each
    path's dispatch wall time."""
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
              f"{b['bound_ms'] / t['ms']:.1%} of the bound")

    # Window, 16384-point FFT of a real frame, magnitude (4 operations a bin).
    record("spectrum_bypass",
           lambda: iir_fft.spectrum_bypass_cuda(x, pp, False, "float32"),
           lambda: iir_fft.spectrum_bypass_plain(x, pp, False, "float32"),
           lambda: torch.abs(torch.fft.fft(x)),
           bound(F * N * 4 * 2 + consts_dft + N * 4, F * (fft_flops + 4 * N)))
    print(f"[5] spectrum_bypass with the window in the kernel: "
          f"{cuda_ms(lambda: iir_fft.spectrum_bypass_cuda(x, pp, True, 'float32')):.4f} ms; "
          f"the dense DFT as written is {F * 2 * 6 * 128**3 / 1e9:.2f} GFLOP")
    # Window, forcing (2 m operations a sample), the chain (128 steps of an
    # m x m mat-vec and an add); 48 bytes out a frame.
    record("iir_summaries",
           lambda: iir_fft.iir_summaries_cuda(x, pp),
           lambda: iir_fft.iir_summaries_plain(x, pp),
           None,
           bound(F * N * 4 + F * m * 4 + N * 4 + L * m * 4 + m * m * 4,
                 F * (N + 2 * m * N + 128 * (2 * m * m + m))))
    # Window, the 12th-order IIR as six biquads (9 operations a sample
    # each), the FFT of a real frame, magnitude.
    record("spectrum_iir",
           lambda: iir_fft.spectrum_iir_cuda(x, zs, pp),
           lambda: iir_fft.spectrum_iir_plain(x, zs, pp),
           None,
           bound(F * N * 4 * 2 + F * m * 4 + consts_dft + consts_iir,
                 F * (N + 54 * N + fft_flops + 4 * N)))
    # A complex FFT (5 N log2 N) and the magnitude; two planes in.
    record("spectrum_complex",
           lambda: iir_fft.spectrum_complex_cuda(x, xi, pp, False, "float32"),
           lambda: iir_fft.spectrum_complex_plain(x, xi, pp, False, "float32"),
           lambda: torch.abs(torch.fft.fft(torch.complex(x, xi))),
           bound(F * N * 4 * 3 + consts_dft, F * (2 * fft_flops + 4 * N)))

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


def phase_profile(steps: dict, walls: dict):
    """Device time per dispatch by kernel (torch.profiler), kernel launches
    per dispatch, and the device's idle share against the untraced
    dispatch time of phase 5."""
    for label, wall in walls.items():
        prof = device_kernels(steps[label])
        if prof is None:
            print(f"[6] {label:17s} profiler saw no device events: not measured")
            continue
        n_kernels, busy_ms, by_name = prof
        print(f"[6] {label:17s} per dispatch: {n_kernels:.0f} device kernels, "
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
        step = chained(lambda a, s: pipe.process(a, s, FilterMode.CUSTOM), x, pipe.initial_state)
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
    rng = np.random.default_rng(1)
    x_np = two_tone(rng)
    xc_np = two_tone_iq(rng)
    launches = {"spectrum_bypass": phase_main_path(pipe, x_np, sos_custom)}
    phase_chunked(pipe, x_np)
    pipes = fused_pipes(sos_custom)
    launches.update(phase_fused(pipes, x_np, sos_custom))
    launches["spectrum_complex"] = phase_iq(pipe, xc_np, sos_custom)
    steps = paths(pipe, pipes, x_np, xc_np)
    walls, timing = phase_timing(pp, x_np, steps)
    phase_profile(steps, walls)
    phase_small_dispatch(sos_custom)
    records = [
        {**fixed, "route": "cuda", "source": f"tpu_sdr_torch/csrc/{name}.cu",
         "launches": launches[name], "max_abs_err": errs[name], **timing[name]}
        for name, fixed in RECORDS.items()
    ]
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
