"""The port's CUDA kernel and pipeline on an NVIDIA GPU.

Every test here needs a card and skips without one. Nothing here imports
JAX, so the file also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import scipy.signal as sps
import torch

from tpu_sdr_torch import FilterMode, PipelineConfig, SpectrumPipeline
from tpu_sdr_torch.kernels import biquad, fft, window
from tpu_sdr_torch.kernels.cuda import affine_scan, iir_fft, launch, pfb_kernel

pytestmark = pytest.mark.cuda

N = 16384
SOS = sps.butter(12, 0.25, output="sos")
# Kernel vs its plain version: fp32 results agree to fp32 rounding; a bf16
# store keeps 8 mantissa bits, rounded once on each side.
SNR_FLOOR_DB = {"float32": 120.0, "bfloat16": 45.0}


def snr_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref = ref.double().cpu()
    err = ((ref - got.double().cpu()) ** 2).sum().item()
    return float("inf") if err == 0 else 10 * np.log10((ref**2).sum().item() / err)


@pytest.fixture(scope="module")
def cuda_plan():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.set_float32_matmul_precision("highest")
    return iir_fft.build_plan(
        SOS,
        window.hann_coefficients(N, device="cuda"),
        fft.plan_constants(128, 128, device="cuda"),
    )


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(5).standard_normal((8, N)).astype(np.float32)


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16], ids=["f32in", "bf16in"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("apply_window", [True, False], ids=["win", "nowin"])
def test_kernel_matches_plain(cuda_plan, frames, apply_window, out_dtype, in_dtype):
    x = torch.as_tensor(frames, device="cuda").to(in_dtype)
    got = iir_fft.spectrum_bypass_cuda(x, cuda_plan, apply_window, out_dtype)
    ref = iir_fft.spectrum_bypass_plain(x, cuda_plan, apply_window, out_dtype)
    assert got.dtype == ref.dtype and got.shape == (8, N)
    assert snr_db(ref.float(), got.float()) >= SNR_FLOOR_DB[out_dtype]


def test_kernel_frames_independent_of_launch(cuda_plan, frames):
    """A frame's bits do not depend on how many frames share the launch."""
    x = torch.as_tensor(frames, device="cuda")
    whole = iir_fft.spectrum_bypass_cuda(x, cuda_plan)
    parts = torch.cat([iir_fft.spectrum_bypass_cuda(c, cuda_plan) for c in x.split(3)])
    assert torch.equal(whole, parts)


def test_kernel_takes_unaligned_view(cuda_plan, frames):
    """A contiguous view that starts off a 16-byte boundary gives the same
    bits as an aligned tensor (the wrapper copies it)."""
    x = torch.as_tensor(frames, device="cuda")
    buf = torch.empty(x.numel() + 1, device="cuda")
    buf[1:] = x.reshape(-1)
    view = buf[1:].view(8, N)
    assert view.data_ptr() % 16 != 0
    got = iir_fft.spectrum_bypass_cuda(view, cuda_plan)
    torch.cuda.synchronize()
    assert torch.equal(got, iir_fft.spectrum_bypass_cuda(x, cuda_plan))


def test_wrapper_launches_and_counts(cuda_plan, frames):
    x = torch.as_tensor(frames[:2], device="cuda")
    iir_fft.reset_counts()
    iir_fft.spectrum_from_state(x, torch.zeros((2, 12), device="cuda"), cuda_plan, bypass=True)
    assert iir_fft.counts["kernel"]["spectrum_bypass"] == 1
    assert not any(iir_fft.counts["plain"].values())
    with pytest.raises(ValueError, match="interpret"):
        iir_fft.spectrum_from_state(
            x, torch.zeros((2, 12), device="cuda"), cuda_plan, bypass=True, interpret=True
        )


@pytest.mark.parametrize("mode", list(FilterMode), ids=lambda m: m.name)
def test_pipeline_on_card_matches_cpu(cuda_plan, mode):
    cfg = PipelineConfig(channels=2)
    gpu = SpectrumPipeline(cfg)
    cpu = SpectrumPipeline(cfg, device="cpu")
    gpu.upload_sos(SOS)
    cpu.upload_sos(SOS)
    x = np.random.default_rng(0).standard_normal((2, 4 * N)).astype(np.float32)
    a, sa = gpu.process(x, gpu.initial_state(), mode)
    b, sb = cpu.process(x, cpu.initial_state(), mode)
    assert a["magnitude"].is_cuda and a["magnitude"].shape == (2, 4, N)
    assert snr_db(b["magnitude"], a["magnitude"]) >= 120.0
    np.testing.assert_allclose(
        sa.sos_state.cpu().numpy(), sb.sos_state.numpy(), rtol=1e-4, atol=1e-6
    )


def test_pipeline_chunked_equals_oneshot_on_card(cuda_plan):
    p = SpectrumPipeline(PipelineConfig(channels=2))
    p.upload_sos(SOS)
    x = torch.as_tensor(
        np.random.default_rng(1).standard_normal((2, 8 * N)).astype(np.float32),
        device="cuda",
    )
    whole, st_whole = p.process(x, p.initial_state(), FilterMode.CUSTOM)
    st = p.initial_state()
    parts = []
    for chunk in x.chunk(4, dim=-1):
        out, st = p.process(chunk, st, FilterMode.CUSTOM)
        parts.append(out["magnitude"])
    assert torch.equal(torch.cat(parts, dim=1), whole["magnitude"])
    assert torch.equal(st.sos_state, st_whole.sos_state)


@pytest.mark.parametrize("rows", [1, 5, 16, 300])
def test_canonical_matmul_is_row_count_independent_on_card(cuda_plan, rows):
    """On cuBLAS too, each row's bits are those of the same row in any
    other dispatch, through one padded call or several calls."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    a = torch.randn((300, 1536), device="cuda", generator=gen)
    bt = torch.randn((1536, 1536), device="cuda", generator=gen)
    whole = biquad._canonical_matmul(a, bt, 128)
    assert torch.equal(biquad._canonical_matmul(a[-rows:], bt, 128), whole[-rows:])


def test_plan_leaves_match_cpu_build(cuda_plan):
    cpu = iir_fft.build_plan(
        SOS,
        window.hann_coefficients(N, device="cpu"),
        fft.plan_constants(128, 128, device="cpu"),
    )
    for f in dataclasses.fields(iir_fft.PallasSOSPlan):
        assert torch.equal(getattr(cuda_plan, f.name).cpu(), getattr(cpu, f.name)), f.name


# ------------------------------------------------ the IIR and complex kernels

# iir_summaries: max |kernel - plain| over max |plain| of the (F, 12)
# frame-end states, fp32 sums taken in different orders (the kernel's direct
# product with the plan's summary_matrix against the plain block chain).
STATE_REL_TOL = 1e-5
# Row 3 against the float64 chain on the designs of the pipelines (SOS, the
# FIXED design) and two narrow low-passes at fs = 1 MHz (5 and 1 kHz),
# where the fp32 chain of the plain version drifts.
SUMMARY_DESIGNS = {
    "custom": SOS,
    "butter12-5k": sps.butter(12, 0.01, output="sos"),
    "butter12-1k": sps.butter(12, 0.002, output="sos"),
}


def rel_err(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref = ref.double().cpu()
    return ((ref - got.double().cpu()).abs().max() / ref.abs().max()).item()


@pytest.fixture(scope="module")
def entry_states():
    return (0.1 * np.random.default_rng(6).standard_normal((8, 12))).astype(np.float32)


def _noise(frames: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((frames, N)).astype(np.float32), device="cuda")


@pytest.mark.parametrize("F", [1, 15, 16, 17, 512])
def test_iir_summaries_kernel_matches_plain(cuda_plan, F):
    """Row 3 at frame counts around its 16-frame groups and at the main
    path's 512."""
    x = _noise(F, 20 + F)
    got = iir_fft.iir_summaries_cuda(x, cuda_plan)
    ref = iir_fft.iir_summaries_plain(x, cuda_plan)
    assert got.shape == (F, 12) and got.dtype == torch.float32
    assert rel_err(ref, got) <= STATE_REL_TOL


def test_iir_summaries_frame_bits_independent_of_count_and_place(cuda_plan):
    """A frame's 12 floats do not depend on how many frames the launch
    holds, nor on the cluster that takes it or its slot in that cluster's
    batches."""
    x = _noise(600, 30)
    whole = iir_fft.iir_summaries_cuda(x, cuda_plan)
    for a, b in ((0, 1), (5, 6), (3, 20), (15, 33), (17, 40), (1, 600), (99, 512)):
        assert torch.equal(iir_fft.iir_summaries_cuda(x[a:b], cuda_plan), whole[a:b]), (a, b)
    assert torch.equal(iir_fft.iir_summaries_cuda(x, cuda_plan), whole)


@pytest.mark.parametrize("name", list(SUMMARY_DESIGNS))
def test_iir_summaries_vs_float64(name):
    """Against the float64 chain on the plan's own fp32 constants: the
    kernel at least as close as the plain version, and within 1e-6 of max
    |state|, also where the plain chain drifts (1e-4 and 1e-3 on the
    narrow designs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    plan = iir_fft.build_plan(SUMMARY_DESIGNS[name], window.hann_coefficients(N, device="cuda"),
                              fft.plan_constants(128, 128, device="cuda"))
    x = _noise(64, 31)
    AL, P = plan.AL1T.double().T, plan.PT.double().T
    xw = x.double() * plan.win.double().reshape(-1)
    z = torch.zeros((64, 12), dtype=torch.float64, device="cuda")
    for j in range(128):
        z = z @ AL.T + xw[:, 128 * j : 128 * (j + 1)] @ P.T
    got = rel_err(z, iir_fft.iir_summaries_cuda(x, plan))
    plain = rel_err(z, iir_fft.iir_summaries_plain(x, plan))
    assert got <= plain and got <= 1e-6, (name, got, plain)


def test_summary_matrix_matches_cpu_build(cuda_plan):
    """K_w built in float64 on the card is the CPU build's, rounded once
    either way (the two float64 products may round apart by one step)."""
    cpu = iir_fft.build_plan(
        SOS, window.hann_coefficients(N, device="cpu"), fft.plan_constants(128, 128, device="cpu"),
    )
    got, ref = cuda_plan.summary_matrix.cpu().double(), cpu.summary_matrix.double()
    assert cuda_plan.summary_matrix.is_cuda
    assert ((got - ref).abs() <= 2.0**-23 * ref.abs() + 1e-12 * ref.abs().max()).all()


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("apply_window", [True, False], ids=["win", "nowin"])
def test_spectrum_iir_kernel_matches_plain(cuda_plan, frames, entry_states, apply_window, out_dtype):
    x = torch.as_tensor(frames, device="cuda")
    zs = torch.as_tensor(entry_states, device="cuda")
    got = iir_fft.spectrum_iir_cuda(x, zs, cuda_plan, apply_window, out_dtype)
    ref = iir_fft.spectrum_iir_plain(x, zs, cuda_plan, apply_window, out_dtype)
    assert got.dtype == ref.dtype and got.shape == (8, N)
    assert snr_db(ref.float(), got.float()) >= SNR_FLOOR_DB[out_dtype]


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16], ids=["f32in", "bf16in"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("apply_window", [True, False], ids=["win", "nowin"])
def test_spectrum_complex_kernel_matches_plain(cuda_plan, frames, apply_window, out_dtype, in_dtype):
    x = torch.as_tensor(frames, device="cuda").to(in_dtype)
    xr, xi = x[:4], x[4:]
    got = iir_fft.spectrum_complex_cuda(xr, xi, cuda_plan, apply_window, out_dtype)
    ref = iir_fft.spectrum_complex_plain(xr, xi, cuda_plan, apply_window, out_dtype)
    assert got.dtype == ref.dtype and got.shape == (4, N)
    assert snr_db(ref.float(), got.float()) >= SNR_FLOOR_DB[out_dtype]


@pytest.mark.parametrize("apply_window", [True, False], ids=["win", "nowin"])
@pytest.mark.parametrize("kind", ["bypass", "complex"])
def test_radix_kernels_snr_vs_float64_fft(cuda_plan, frames, kind, apply_window):
    """Rows 1 and 5 (radix FFTs) against a float64 NumPy FFT's magnitude at
    F = 8, fp32 in and out: each kernel's SNR is at least its plain
    version's (the dense four-step in fp32) minus 1 dB."""
    xi_np = np.random.default_rng(7).standard_normal((8, N)).astype(np.float32)
    x, xi = torch.as_tensor(frames, device="cuda"), torch.as_tensor(xi_np, device="cuda")
    win = cuda_plan.win.reshape(-1).double().cpu().numpy() if apply_window else 1.0
    if kind == "bypass":
        got = iir_fft.spectrum_bypass_cuda(x, cuda_plan, apply_window)
        plain = iir_fft.spectrum_bypass_plain(x, cuda_plan, apply_window)
        z = frames.astype(np.float64)
    else:
        got = iir_fft.spectrum_complex_cuda(x, xi, cuda_plan, apply_window)
        plain = iir_fft.spectrum_complex_plain(x, xi, cuda_plan, apply_window)
        z = frames.astype(np.float64) + 1j * xi_np.astype(np.float64)
    ref = torch.as_tensor(np.abs(np.fft.fft(z * win, axis=-1)))
    assert snr_db(ref, got) >= snr_db(ref, plain) - 1.0


def test_complex_kernel_takes_unaligned_view(cuda_plan, frames):
    """Row 5 as row 1: planes that start off a 16-byte boundary give the
    same bits as aligned ones (the wrapper copies them)."""
    x = torch.as_tensor(frames, device="cuda")
    buf = torch.empty(2 * x.numel() + 2, device="cuda")
    buf[1 : 1 + x.numel()] = x.reshape(-1)
    buf[x.numel() + 2 :] = x.flip(0).reshape(-1)
    xr, xi = buf[1 : 1 + x.numel()].view(8, N), buf[x.numel() + 2 :].view(8, N)
    assert xr.data_ptr() % 16 != 0
    got = iir_fft.spectrum_complex_cuda(xr, xi, cuda_plan)
    torch.cuda.synchronize()
    assert torch.equal(got, iir_fft.spectrum_complex_cuda(x, x.flip(0).contiguous(), cuda_plan))


def test_new_kernels_frames_independent_of_launch(cuda_plan, frames, entry_states):
    x = torch.as_tensor(frames, device="cuda")
    zs = torch.as_tensor(entry_states, device="cuda")
    split = lambda fn, *ts: torch.cat([fn(*parts) for parts in zip(*(t.split(3) for t in ts))])
    summaries = lambda a: iir_fft.iir_summaries_cuda(a, cuda_plan)
    spectrum = lambda a, z: iir_fft.spectrum_iir_cuda(a, z, cuda_plan)
    iq = lambda a, b: iir_fft.spectrum_complex_cuda(a, b, cuda_plan)
    assert torch.equal(summaries(x), split(summaries, x))
    assert torch.equal(spectrum(x, zs), split(spectrum, x, zs))
    assert torch.equal(iq(x, x.flip(0)), split(iq, x, x.flip(0)))


def test_refused_launch_raises(cuda_plan, frames, monkeypatch):
    """A launch the runtime refuses (the C entry point returns its CUDA
    error code) raises and is not counted."""

    class Refusing:
        @staticmethod
        def tpu_sdr_iir_summaries(*args):
            return 1  # cudaErrorInvalidValue

        @staticmethod
        def tpu_sdr_cuda_error_string(err):
            return b"invalid argument"

    monkeypatch.setattr(launch, "_kernel_lib", lambda name: Refusing)
    iir_fft.reset_counts()
    with pytest.raises(RuntimeError, match="iir_summaries kernel launch failed.*invalid argument"):
        iir_fft.iir_summaries(torch.as_tensor(frames[:1], device="cuda"), cuda_plan)
    assert not any(iir_fft.counts["kernel"].values())
    assert not any(iir_fft.counts["plain"].values())


def _chunked(p, x, state, mode, chunks, planes=False):
    run = p.process_planes if planes else p.process
    whole, st_whole = run(x, state(), mode)
    st = state()
    parts = []
    for chunk in x.chunk(chunks, dim=-1):
        out, st = run(chunk, st, mode)
        parts.append(out["magnitude"])
    return whole, st_whole, torch.cat(parts, dim=-2), st


@pytest.mark.parametrize("tier", ["f32", "f32max"])
def test_fused_pipeline_on_card(cuda_plan, tier):
    """The fused two-pass path launches one summaries and one in-kernel-IIR
    kernel per dispatch, is chunked == one-shot bitwise on the card, and
    agrees with the hybrid path."""
    fused = SpectrumPipeline(PipelineConfig(channels=2, dtype=tier, fused_two_pass=True))
    hybrid = SpectrumPipeline(PipelineConfig(channels=2, dtype=tier))
    fused.upload_sos(SOS)
    hybrid.upload_sos(SOS)
    x = torch.as_tensor(
        np.random.default_rng(2).standard_normal((2, 8 * N)).astype(np.float32), device="cuda"
    )
    iir_fft.reset_counts()
    whole, st_whole, chunked, st = _chunked(fused, x, fused.initial_state, FilterMode.CUSTOM, 4)
    torch.cuda.synchronize()
    assert iir_fft.counts["kernel"]["iir_summaries"] == 5
    assert iir_fft.counts["kernel"]["spectrum_iir"] == 5
    assert iir_fft.counts["kernel"]["spectrum_bypass"] == 0
    assert not any(iir_fft.counts["plain"].values())
    assert torch.equal(chunked, whole["magnitude"])
    assert torch.equal(st.sos_state, st_whole.sos_state)
    ref, _ = hybrid.process(x, hybrid.initial_state(), FilterMode.CUSTOM)
    assert snr_db(ref["magnitude"], whole["magnitude"]) >= 100.0


@pytest.mark.parametrize("mode", [FilterMode.BYPASS, FilterMode.CUSTOM], ids=lambda m: m.name)
def test_iq_pipeline_on_card(cuda_plan, mode):
    """Complex input launches the complex kernel once per dispatch, is
    chunked == one-shot bitwise on the card, process == process_planes, and
    the card agrees with the CPU."""
    p = SpectrumPipeline(PipelineConfig(channels=2))
    cpu = SpectrumPipeline(PipelineConfig(channels=2), device="cpu")
    p.upload_sos(SOS)
    cpu.upload_sos(SOS)
    rng = np.random.default_rng(3)
    xc = (rng.standard_normal((2, 8 * N)) + 1j * rng.standard_normal((2, 8 * N))).astype(np.complex64)
    x = torch.as_tensor(xc, device="cuda")
    state = lambda: p.initial_state(batch_shape=(2,))
    iir_fft.reset_counts()
    whole, st_whole, chunked, st = _chunked(p, x, state, mode, 4)
    torch.cuda.synchronize()
    assert iir_fft.counts["kernel"]["spectrum_complex"] == 5
    assert not any(iir_fft.counts["plain"].values())
    assert torch.equal(chunked, whole["magnitude"])
    assert torch.equal(st.sos_state, st_whole.sos_state)
    planes = torch.stack([x.real, x.imag])
    p_whole, p_st, p_chunked, _ = _chunked(p, planes, state, mode, 4, planes=True)
    assert torch.equal(p_whole["magnitude"], whole["magnitude"])
    assert torch.equal(p_st.sos_state, st_whole.sos_state)
    assert torch.equal(p_chunked, chunked)
    ref, _ = cpu.process(xc, cpu.initial_state(batch_shape=(2,)), mode)
    assert snr_db(ref["magnitude"], whole["magnitude"]) >= 120.0


# ------------------------------------------ the narrowband layer's kernels

FM_KW = dict(fs=200e3, dev=75e3)
FM_POLE = float(np.exp(-1.0 / (200e3 * 75e-6)))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.set_float32_matmul_precision("highest")


def _planes(c, t, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal((c, t)).astype(np.float32), device="cuda")
                 for _ in range(2))


# (channels, T): the small shapes, the chain's edge shapes (one block; one
# stage of csrc/affine_chain.cuh, 1024 blocks, less and plus one; many
# channels of one block, more than the card has SMs) and the FM kernel
# path's dispatch (8 x 2^20).
FM_SHAPES = {"3x640": (3, 5 * 128), "8x8192": (8, 64 * 128), "1x128": (1, 128),
             "2x1023blocks": (2, 1023 * 128), "2x1024blocks": (2, 1024 * 128),
             "2x1025blocks": (2, 1025 * 128), "300x128": (300, 128), "1000x128": (1000, 128),
             "8x2^20": (8, 1 << 20)}


@pytest.mark.parametrize("shape", list(FM_SHAPES.values()), ids=list(FM_SHAPES))
@pytest.mark.parametrize("pole", [None, FM_POLE], ids=["nopole", "pole"])
def test_fm_kernel_equals_plain_bitwise(card, shape, pole):
    """The kernel does the plain version's fp32 operations in its order,
    with no FMA contraction: every output equals it bit for bit."""
    re, im = _planes(*shape, seed=11)
    rng = np.random.default_rng(12)
    pr, pi = (torch.as_tensor(rng.standard_normal((shape[0], 1)).astype(np.float32),
                              device="cuda") for _ in range(2))
    y0 = torch.as_tensor(0.1 * rng.standard_normal(shape[0]), dtype=torch.float32, device="cuda")
    got = affine_scan.fm_demod_cuda(re, im, pr, pi, y0, pole=pole, **FM_KW)
    ref = affine_scan.fm_demod_plain(re, im, pr, pi, y0, pole=pole, **FM_KW)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.shape == r.shape and torch.equal(g, r)


def test_fm_kernel_twice_in_a_row_same_bits(card):
    """Two launches in a row on the same inputs and stream give the same
    bits, and the plain version's."""
    re, im = _planes(8, 4096 * 128, seed=15)
    z, y0 = torch.zeros((8, 1), device="cuda"), torch.zeros(8, device="cuda")
    first = affine_scan.fm_demod_cuda(re, im, z, z, y0, pole=FM_POLE, **FM_KW)
    second = affine_scan.fm_demod_cuda(re, im, z, z, y0, pole=FM_POLE, **FM_KW)
    ref = affine_scan.fm_demod_plain(re, im, z, z, y0, pole=FM_POLE, **FM_KW)
    torch.cuda.synchronize()
    for a, b, r in zip(first, second, ref):
        assert torch.equal(a, b) and torch.equal(a, r)


def test_fm_demodulator_kernel_path_on_card(card):
    """FMDemodulator(use_pallas=True): one kernel launch per dispatch, no
    plain call, chunked == one-shot bitwise, and the default path within
    2e-6 on the card."""
    from tpu_sdr_torch.kernels.demod import FMDemodulator

    re, im = _planes(2, 16 * 128, seed=13)
    fm = FMDemodulator(200e3, use_pallas=True)
    launch.reset_counts()
    one, st_one = fm.process(re, im, fm.initial_state((2,)))
    st, parts, pos = fm.initial_state((2,)), [], 0
    for n in (128, 384, 1536):
        o, st = fm.process(re[:, pos : pos + n], im[:, pos : pos + n], st)
        parts.append(o)
        pos += n
    torch.cuda.synchronize()
    assert launch.counts["kernel"]["fm_demod"] == 4 and launch.counts["plain"]["fm_demod"] == 0
    assert torch.equal(torch.cat(parts, dim=-1), one) and torch.equal(st.filt, st_one.filt)
    xla = FMDemodulator(200e3)
    ref, _ = xla.process(re, im, xla.initial_state((2,)))
    assert (ref - one).abs().max().item() <= 2e-6 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("steps,taps", [(1, 8), (7, 2), (9, 1), (300, 33), (1000, 8), (70, 256)])
def test_pfb_kernel_matches_plain(card, steps, taps):
    rng = np.random.default_rng(steps + taps)
    rows = torch.as_tensor(rng.standard_normal((2, steps + taps - 1, 128)).astype(np.float32),
                           device="cuda")
    h2 = torch.as_tensor(rng.standard_normal((taps, 128)).astype(np.float32), device="cuda")
    pk = np.outer(np.arange(128), np.arange(128)) % 128
    cos = torch.as_tensor(np.cos(2 * np.pi * pk / 128).astype(np.float32), device="cuda")
    sin = torch.as_tensor(np.sin(2 * np.pi * pk / 128).astype(np.float32), device="cuda")
    for neg_b in (False, True):
        a, b = pfb_kernel.pfb_fold_dft_cuda(rows, h2, cos, sin, taps, neg_b)
        ra, rb = pfb_kernel.pfb_fold_dft_plain(rows, h2, cos, sin, taps, 128, neg_b)
        torch.cuda.synchronize()
        scale = ra.abs().max().item()
        assert (a - ra).abs().max().item() <= 1e-5 * scale
        assert (b - rb).abs().max().item() <= 1e-5 * scale


def _pfb_inputs(steps, taps, planes, seed, batch=2):
    """rows (batch, steps + taps - 1, 128), h2 and the (cos, sin) planes:
    the Channelizer's, or seeded standard-normal ones."""
    from tpu_sdr_torch.kernels.pfb import Channelizer

    rng = np.random.default_rng(seed)
    cuda = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")
    rows = cuda(rng.standard_normal((batch, steps + taps - 1, 128)))
    ch = Channelizer(m=128, taps=taps, device="cuda")
    if planes == "random":
        return rows, ch._h2, cuda(rng.standard_normal((128, 128))), cuda(rng.standard_normal((128, 128)))
    return rows, ch._h2, ch._cos, ch._sin


@pytest.mark.parametrize("scale", [1.0, 2.0**-40, 2.0**40], ids=["1", "2^-40", "2^40"])
@pytest.mark.parametrize("planes", ["channelizer", "random"])
def test_pfb_kernel_planes_and_scales_match_plain(card, planes, scale):
    """With the Channelizer's and with random planes, and rows scaled by
    2^+-40: within 1e-5 of max |A| of the plain version."""
    rows, h2, cos, sin = _pfb_inputs(300, 8, planes, seed=16)
    rows = rows * scale
    for neg_b in (False, True):
        a, b = pfb_kernel.pfb_fold_dft_cuda(rows, h2, cos, sin, 8, neg_b)
        ra, rb = pfb_kernel.pfb_fold_dft_plain(rows, h2, cos, sin, 8, 128, neg_b)
        torch.cuda.synchronize()
        tol = 1e-5 * ra.abs().max().item()
        assert torch.isfinite(a).all() and torch.isfinite(b).all()
        assert (a - ra).abs().max().item() <= tol and (b - rb).abs().max().item() <= tol


@pytest.mark.parametrize("planes", ["channelizer", "random"])
def test_pfb_kernel_snr_vs_float64(card, planes):
    """Against the float64 function (the fp32 fold, both products in
    float64), the kernel reaches at least the plain version's SNR - 1 dB."""
    rows, h2, cos, sin = _pfb_inputs(2000, 8, planes, seed=17, batch=4)
    folded = pfb_kernel.fold_rows(rows, h2, 8).double()
    a, b = pfb_kernel.pfb_fold_dft_cuda(rows, h2, cos, sin, 8)
    pa, pb = pfb_kernel.pfb_fold_dft_plain(rows, h2, cos, sin, 8, 128)
    for got, plain, plane in ((a, pa, cos), (b, pb, sin)):
        ref = folded @ plane.double()
        assert snr_db(ref, got) >= snr_db(ref, plain) - 1.0


def test_pfb_kernel_steps_independent_of_launch(card):
    """A step's bits do not depend on the launch: the steps of one launch
    equal those of launches over parts of the rows (each with its halo)."""
    taps = 8
    rows, h2, cos, sin = _pfb_inputs(1000, taps, "random", seed=18)
    whole = pfb_kernel.pfb_fold_dft_cuda(rows, h2, cos, sin, taps, True)
    cuts = (0, 1, 65, 200, 1000)
    parts = [pfb_kernel.pfb_fold_dft_cuda(rows[:, lo : hi + taps - 1].contiguous(), h2, cos,
                                          sin, taps, True)
             for lo, hi in zip(cuts, cuts[1:])]
    one_row = pfb_kernel.pfb_fold_dft_cuda(rows[1:].contiguous(), h2, cos, sin, taps, True)
    torch.cuda.synchronize()
    for k in range(2):
        assert torch.equal(torch.cat([p[k] for p in parts], dim=1), whole[k])
        assert torch.equal(one_row[k], whole[k][1:])


@pytest.mark.parametrize("iq", [False, True], ids=["real", "iq"])
def test_channelizer_kernel_path_on_card(card, iq):
    from tpu_sdr_torch.kernels.pfb import Channelizer

    ker = Channelizer(m=128, taps=8, use_pallas=True)
    xla = Channelizer(m=128, taps=8)
    shape = (2, 3) if iq else (3,)
    x = torch.as_tensor(np.random.default_rng(14).standard_normal(shape + (40 * 128,)),
                        dtype=torch.float32, device="cuda")
    run = (lambda c: c.process_planes) if iq else (lambda c: c.process)
    launch.reset_counts()
    one, st_one = run(ker)(x, ker.initial_state(shape))
    st, parts, prev = ker.initial_state(shape), [], 0
    for cut in (128, 9 * 128, 40 * 128):
        o, st = run(ker)(x[..., prev:cut], st)
        parts.append(o)
        prev = cut
    torch.cuda.synchronize()
    assert launch.counts["kernel"]["pfb_fold_dft"] == 4
    assert not any(launch.counts["plain"].values())
    for k in ("re", "im"):
        assert torch.equal(torch.cat([p[k] for p in parts], dim=-2), one[k])
    ref, _ = run(xla)(x, xla.initial_state(shape))
    scale = ref["re"].abs().max().item()
    for k in ("re", "im"):
        assert (ref[k] - one[k]).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("mode", ["wbfm", "am", "usb"])
def test_receiver_on_card_matches_cpu_and_chunks(card, mode):
    from tpu_sdr_torch.runtime.receiver import Receiver

    rate = {"wbfm": 16e3, "am": 5000.0, "usb": 1e6 / 166 / 2}[mode]
    gpu = Receiver(center_hz=250e3, mode=mode, audio_rate=rate)
    cpu = Receiver(center_hz=250e3, mode=mode, audio_rate=rate, device="cpu")
    g = gpu.chunk_granularity
    n = np.arange(4 * g)
    x = (0.8 * np.cos(2 * np.pi * 250e3 * n / 1e6 + 0.3 * np.sin(2 * np.pi * 1e3 * n / 1e6))
         + 0.01 * np.random.default_rng(15).standard_normal(n.size)).astype(np.float32)
    xg = torch.as_tensor(x, device="cuda")
    one, _ = gpu.process(xg, gpu.initial_state())
    st, parts = gpu.initial_state(), []
    for chunk in (xg[:g], xg[g:]):
        o, st = gpu.process(chunk, st)
        parts.append(o)
    assert one.is_cuda and torch.equal(torch.cat(parts), one)
    ref, _ = cpu.process(x, cpu.initial_state())
    assert (one.cpu() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


# ---------------------------------------------------------------- rows 4 and 6, hop, banks, facade


def _mirror_ok(out: torch.Tensor) -> bool:
    g = out.view(-1, 128, 128)
    return torch.equal(g[:, :, 65:], g.flip(1)[:, :, 1:64].flip(2))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("apply_window", [True, False], ids=["win", "nowin"])
@pytest.mark.parametrize(
    "form,in_dtype",
    [("bypass", torch.float32), ("bypass", torch.bfloat16), ("iir", torch.float32)],
    ids=["bypass-f32in", "bypass-bf16in", "iir-f32in"],
)
def test_half_kernel_matches_plain(cuda_plan, frames, entry_states, form, in_dtype,
                                   apply_window, out_dtype):
    """Both forms (the IIR form takes fp32 frames, as the full kernel)."""
    x = torch.as_tensor(frames, device="cuda").to(in_dtype)
    zs = None if form == "bypass" else torch.as_tensor(entry_states, device="cuda")
    got = iir_fft.spectrum_half_cuda(x, zs, cuda_plan, apply_window, out_dtype)
    ref = iir_fft.spectrum_half_plain(x, zs, cuda_plan, apply_window, out_dtype)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert snr_db(ref.float(), got.float()) >= SNR_FLOOR_DB[out_dtype]
    assert _mirror_ok(got)


def test_half_kernel_frames_independent_and_blocked(cuda_plan, frames, entry_states):
    x = torch.as_tensor(frames, device="cuda")
    zs = torch.as_tensor(entry_states, device="cuda")
    for bypass in (True, False):
        run = lambda a, z, **kw: iir_fft.spectrum_from_state(
            a, z, cuda_plan, bypass=bypass, half_spectrum=True, **kw)
        whole = run(x, zs)
        parts = torch.cat([run(a, z) for a, z in zip(x.split(3), zs.split(3))])
        assert torch.equal(whole, parts)
        assert torch.equal(run(x, zs, blocked_output=True).reshape(whole.shape), whole)
        full = iir_fft.spectrum_from_state(x, zs, cuda_plan, bypass=bypass)
        assert torch.equal(whole, full)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("apply_window", [True, False], ids=["win", "nowin"])
@pytest.mark.parametrize(
    "form,in_dtype",
    [("bypass", torch.float32), ("bypass", torch.bfloat16), ("iir", torch.float32)],
    ids=["bypass-f32in", "bypass-bf16in", "iir-f32in"],
)
def test_half_spectrum_is_the_full_spectrum_bitwise(cuda_plan, frames, entry_states, form,
                                                    in_dtype, apply_window, out_dtype):
    """Row 4 launches rows 1 and 2, whose kernels transform rows k2 <= 64
    and copy the mirrored bins: the half spectrum is the full one, bit for
    bit, in every form and type, and counted under both names."""
    x = torch.as_tensor(frames, device="cuda").to(in_dtype)
    zs = torch.as_tensor(entry_states, device="cuda")
    kw = dict(bypass=form == "bypass", apply_window=apply_window, out_dtype=out_dtype)
    launch.reset_counts()
    half = iir_fft.spectrum_from_state(x, zs, cuda_plan, half_spectrum=True, **kw)
    kernel = "spectrum_bypass" if form == "bypass" else "spectrum_iir"
    assert launch.counts["kernel"] == {**dict.fromkeys(launch.COUNTERS, 0),
                                       kernel: 1, "spectrum_half": 1}
    full = iir_fft.spectrum_from_state(x, zs, cuda_plan, **kw)
    assert half.dtype == full.dtype == iir_fft.OUT_DTYPES[out_dtype]
    assert torch.equal(half, full) and _mirror_ok(half)


def test_fft_mag_fused_kernel_uses_the_given_planes(cuda_plan, frames):
    from tpu_sdr_torch.kernels.cuda import spectrum

    x = torch.as_tensor(frames, device="cuda")
    win = window.hann_coefficients(N, device="cuda")
    plan = fft.plan_constants(128, 128, device="cuda")
    launch.reset_counts()
    for scale in (1.0, 0.5):
        p = {k: v * scale for k, v in plan.items()}
        got = spectrum.fft_mag_fused(x, win, p)
        ref = spectrum.fft_mag_fused_plain(x, win, p)
        assert snr_db(ref, got) >= SNR_FLOOR_DB["float32"]
    assert launch.counts["kernel"]["fft_mag_fused"] == 2
    assert not any(launch.counts["plain"].values())
    with pytest.raises(ValueError, match="n1 = n2 = 128"):
        spectrum.fft_mag_fused(x, win, fft.plan_constants(64, 256, device="cuda"), n1=64, n2=256)


def _random_planes(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    keys = ("w2r", "w2i", "twr", "twi", "w1r", "w1i")
    return {k: torch.as_tensor(rng.standard_normal((128, 128)), dtype=torch.float32, device="cuda")
            for k in keys}


def test_fft_mag_fused_kernel_takes_random_planes(cuda_plan, frames):
    """Row 6 computes with any planes, here with no DFT structure at all."""
    from tpu_sdr_torch.kernels.cuda import spectrum

    x = torch.as_tensor(frames, device="cuda")
    win = window.hann_coefficients(N, device="cuda")
    p = _random_planes(13)
    launch.reset_counts()
    got = spectrum.fft_mag_fused(x, win, p)
    assert launch.counts["kernel"]["fft_mag_fused"] == 1
    assert snr_db(spectrum.fft_mag_fused_plain(x, win, p), got) >= SNR_FLOOR_DB["float32"]


def test_fft_mag_fused_frames_independent_of_launch(cuda_plan, frames):
    """Row 6's blocks walk several frames each: a frame's bits do not
    depend on how many frames share the launch."""
    from tpu_sdr_torch.kernels.cuda import spectrum

    x = torch.as_tensor(frames, device="cuda")
    win = window.hann_coefficients(N, device="cuda")
    for p in (fft.plan_constants(128, 128, device="cuda"), _random_planes(14)):
        whole = spectrum.fft_mag_fused_cuda(x, win, p)
        parts = torch.cat([spectrum.fft_mag_fused_cuda(c, win, p) for c in x.split(3)])
        assert torch.equal(whole, parts)


@pytest.mark.parametrize("kind", ["spectrum_iir", "fft_mag_fused"])
def test_redesigned_kernels_snr_vs_float64(cuda_plan, frames, kind):
    """Rows 2 and 6 against a float64 reference at F = 8, fp32 in and out:
    each kernel's SNR is at least its plain version's minus 1 dB. Row 2
    from rest (zero entry states): the float64 window (the kernel's fp32
    values), scipy's sosfilt, the FFT; row 6 with the plan's planes: the
    FFT of the windowed frame."""
    from tpu_sdr_torch.kernels.cuda import spectrum

    x = torch.as_tensor(frames, device="cuda")
    win = cuda_plan.win.reshape(-1)
    w64 = win.double().cpu().numpy()
    if kind == "spectrum_iir":
        zs = torch.zeros((x.shape[0], 12), device="cuda")
        got = iir_fft.spectrum_iir_cuda(x, zs, cuda_plan)
        plain = iir_fft.spectrum_iir_plain(x, zs, cuda_plan)
        y = np.stack([sps.sosfilt(SOS, f.astype(np.float64) * w64) for f in frames])
    else:
        plan = fft.plan_constants(128, 128, device="cuda")
        got = spectrum.fft_mag_fused_cuda(x, win, plan)
        plain = spectrum.fft_mag_fused_plain(x, win, plan)
        y = frames.astype(np.float64) * w64
    ref = torch.as_tensor(np.abs(np.fft.fft(y, axis=-1)))
    assert snr_db(ref, got) >= snr_db(ref, plain) - 1.0


@pytest.mark.parametrize("mode", [FilterMode.BYPASS, FilterMode.CUSTOM], ids=lambda m: m.name)
def test_hop_pipeline_on_card(cuda_plan, mode):
    """hop < N launches the spectrum kernel once per dispatch, is chunked ==
    one-shot bitwise with the carried history, and agrees with the CPU."""
    cfg = PipelineConfig(channels=2, hop=4096)
    p, cpu = SpectrumPipeline(cfg), SpectrumPipeline(cfg, device="cpu")
    p.upload_sos(SOS)
    cpu.upload_sos(SOS)
    x = torch.as_tensor(
        np.random.default_rng(3).standard_normal((2, 4 * N)).astype(np.float32), device="cuda"
    )
    iir_fft.reset_counts()
    whole, st_whole, chunked, st = _chunked(p, x, p.initial_state, mode, 4)
    torch.cuda.synchronize()
    assert iir_fft.counts["kernel"]["spectrum_bypass"] == 5
    assert not any(iir_fft.counts["plain"].values())
    assert torch.equal(chunked, whole["magnitude"]) and torch.equal(st.history, st_whole.history)
    ref, _ = cpu.process(x.cpu(), cpu.initial_state(), mode)
    assert snr_db(ref["magnitude"], whole["magnitude"]) >= 120.0


def test_bank_pipeline_on_card(cuda_plan):
    """A per-channel bank: the hybrid branch even with fused_two_pass,
    chunked == one-shot bitwise, and the card agrees with the CPU."""
    bank = [sps.butter(12, 0.1 * (c + 1), output="sos") for c in range(4)]
    cfg = PipelineConfig(channels=4, fused_two_pass=True)
    p, cpu = SpectrumPipeline(cfg), SpectrumPipeline(cfg, device="cpu")
    p.upload_sos_bank(bank)
    cpu.upload_sos_bank(bank)
    x = torch.as_tensor(
        np.random.default_rng(4).standard_normal((4, 8 * N)).astype(np.float32), device="cuda"
    )
    iir_fft.reset_counts()
    whole, st_whole, chunked, st = _chunked(p, x, p.initial_state, FilterMode.CUSTOM, 4)
    torch.cuda.synchronize()
    assert iir_fft.counts["kernel"]["spectrum_bypass"] == 5
    assert iir_fft.counts["kernel"]["spectrum_iir"] == iir_fft.counts["kernel"]["iir_summaries"] == 0
    assert torch.equal(chunked, whole["magnitude"]) and torch.equal(st.sos_state, st_whole.sos_state)
    ref, _ = cpu.process(x.cpu(), cpu.initial_state(), FilterMode.CUSTOM)
    assert snr_db(ref["magnitude"], whole["magnitude"]) >= 120.0


def test_analyzer_on_card(cuda_plan):
    """The facade on CUDA: wire bytes, an upload, host float32 magnitudes
    equal to the pipeline's, and a checkpoint that resumes bit for bit."""
    from tpu_sdr_torch import SpectrumAnalyzer
    from tpu_sdr_torch.control import design_iir_filter
    from tpu_sdr_torch.control.commands import encode_coefficient_upload

    sa = SpectrumAnalyzer(PipelineConfig(channels=2))
    x = torch.as_tensor(
        np.random.default_rng(5).standard_normal((2, 2 * N)).astype(np.float32), device="cuda"
    )
    sa.handle_bytes(bytes([0xB1, 0x55]))
    d = design_iir_filter("butterworth", "bandstop", 2, 1e6, (230e3, 270e3))
    sa.handle_bytes(encode_coefficient_upload(d.to_wire_bytes()) + bytes([0xA1]))
    out = sa.process(x)
    assert isinstance(out["magnitude"], np.ndarray) and out["magnitude"].shape == (2, 2, N)
    ck = sa.checkpoint()
    a = sa.process(x)["magnitude"]
    sb = SpectrumAnalyzer(PipelineConfig(channels=2))
    sb.restore(ck)
    assert np.array_equal(sb.process(x)["magnitude"], a)


# ---------------------------------------------------------------- the Q15 path


def _q15_frames(shape, seed: int, kind: str) -> np.ndarray:
    """int16 frames: random (N(0, 6000)) or full-scale tones, one a row."""
    if kind == "random":
        return (np.random.default_rng(seed).standard_normal(shape) * 6000).astype(np.int16)
    n = shape[-1]
    rows = int(np.prod(shape[:-1]))
    k = 1 + (np.arange(rows)[:, None] * 977) % (n // 2 - 1)
    tone = 32767 * np.cos(2 * np.pi * k * np.arange(n) / n + 0.3)
    return np.clip(np.round(tone), -32768, 32767).astype(np.int16).reshape(shape)


Q15_SOS = np.array([[18, 36, 18, 64, -38, 14], [64, -120, 64, 64, -110, 52], [64, 0, 0, 64, 0, 0],
                    [64, 0, 0, 64, 0, 0], [64, 0, 0, 64, 0, 0], [64, 0, 0, 64, 0, 0]])


K1_CLUSTER_CTAS = 8  # csrc/q15_fft.cu kClusterCtas (tests/test_torch_q15_fft_schedule.py)


@pytest.mark.parametrize("kind", ["random", "tone"])
@pytest.mark.parametrize("bypass", [True, False], ids=["bypass", "fft"])
@pytest.mark.parametrize("frames_", [1, 3, 8, 64, 133])
def test_q15_fft_kernel_matches_plain_bitwise(card, frames_, bypass, kind):
    """F frames of 16384 on the cluster route (133 x 8 CTAs are more than
    the card holds at once), with and without the ROM: one launch, the
    plain version's bits, and the last frame's bits as when it is launched
    alone."""
    from tpu_sdr_torch.kernels import fft_q15

    x = torch.as_tensor(_q15_frames((frames_, N), 60 + frames_, kind), device="cuda")
    rom = window.hann_q16_rom(N, device="cuda") if bypass else None
    assert fft_q15.kernel_route(frames_, N) == ("cluster", K1_CLUSTER_CTAS)
    launch.reset_counts()
    got = fft_q15.window_fft_q15(x, rom=rom)
    torch.cuda.synchronize()
    assert launch.counts["kernel"]["q15_fft"] == 1 and not any(launch.counts["plain"].values())
    ref = fft_q15.window_fft_q15_plain(x, rom=rom)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    if not bypass:
        oracle = fft_q15.fft_q15_np(x.cpu().numpy())
        assert all(np.array_equal(g.cpu().numpy(), o) for g, o in zip(got[:2], oracle))
    last = fft_q15.window_fft_q15_cuda(x[-1:].clone(), rom=rom)
    assert all(torch.equal(g[-1:], one) for g, one in zip(got, last))


@pytest.mark.parametrize("n", [1 << m for m in range(1, 15)])
def test_q15_fft_kernel_sizes_schedule_and_complex_input(card, n):
    """Every frame size 2^1 .. 2^14, complex input, schedule t % 3 (shifts
    0, 1 and 2): the route the library reports (the cluster route at 2^14,
    one CTA below) gives fft_q15_np's and the plain version's bits."""
    from tpu_sdr_torch.kernels import fft_q15

    x = torch.as_tensor(_q15_frames((3, n), 70, "random"), device="cuda")
    xi = torch.as_tensor(_q15_frames((3, n), 71, "random"), device="cuda")
    m = n.bit_length() - 1
    sched = tuple((t % 3) for t in range(m))
    assert fft_q15.kernel_route(3, n) == (("cluster", K1_CLUSTER_CTAS) if m == 14 else ("block", 1))
    got = fft_q15.fft_q15(x, xi, schedule=sched)
    ref = fft_q15.fft_q15_np(x.cpu().numpy(), xi.cpu().numpy(), schedule=sched)
    assert all(np.array_equal(g.cpu().numpy(), r) for g, r in zip(got, ref))
    plain = fft_q15.window_fft_q15_plain(x, xi, schedule=sched)
    assert all(torch.equal(g, p) for g, p in zip(fft_q15.window_fft_q15_cuda(x, xi, schedule=sched), plain))


@pytest.mark.parametrize("schedule", ["zeros", "twos", "t%3"])
def test_q15_fft_full_scale_schedules(card, schedule):
    """16384-point complex frames at full scale (+-32768 samples): every
    rank of the all-zero schedule saturates; 2, 0 alternating; t % 3."""
    from tpu_sdr_torch.kernels import fft_q15

    sched = {"zeros": (0,) * 14, "twos": (2, 0) * 7, "t%3": tuple(t % 3 for t in range(14))}[schedule]
    rng = np.random.default_rng(95)
    x, xi = (torch.as_tensor(rng.choice(np.array([-32768, 32767], np.int16), (2, N)), device="cuda")
             for _ in range(2))
    got = fft_q15.fft_q15(x, xi, schedule=sched)
    oracle = fft_q15.fft_q15_np(x.cpu().numpy(), xi.cpu().numpy(), schedule=sched)
    assert all(np.array_equal(g.cpu().numpy(), o) for g, o in zip(got, oracle))
    if schedule == "zeros":
        assert int((got[0].abs() >= 32767).sum()) > 0


@pytest.mark.parametrize("rows", [1, 4])
def test_sosfilt_q15_kernel_matches_plain_and_oracle(card, rows):
    from tpu_sdr_torch.control import golden

    x = _q15_frames((rows, 2 * N), 80 + rows, "random")
    zi = np.random.default_rng(82).integers(-5000, 5000, (rows, 6, 2)).astype(np.int32)
    sos = torch.as_tensor(Q15_SOS, dtype=torch.int32)
    rom = window.hann_q16_rom(N, device="cpu")
    launch.reset_counts()
    got = biquad.sosfilt_q15_window(sos.cuda(), torch.as_tensor(x, device="cuda"),
                                    torch.as_tensor(zi, device="cuda"), rom=rom.cuda())
    torch.cuda.synchronize()
    assert launch.counts["kernel"]["sosfilt_q15"] == 1
    ref = biquad.sosfilt_q15_plain(sos, torch.as_tensor(x), torch.as_tensor(zi), rom=rom)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g.cpu(), r)
    for r in range(rows):
        xw = golden.rtl_window_q15(x[r])
        y, zf = golden.sosfilt_q15_intended(Q15_SOS, xw, zi[r])
        assert np.array_equal(got[0][r].cpu().numpy(), y)
        assert np.array_equal(got[2][r].cpu().numpy(), zf)
    # without a ROM: the scan, chunked == one-shot
    y1, z1 = biquad.sosfilt_q15_scan(Q15_SOS, torch.as_tensor(x[:, :N], device="cuda"),
                                     torch.as_tensor(zi, device="cuda"))
    y2, z2 = biquad.sosfilt_q15_scan(Q15_SOS, torch.as_tensor(x[:, N:], device="cuda"), z1)
    yw, zw = biquad.sosfilt_q15_scan(Q15_SOS, torch.as_tensor(x, device="cuda"),
                                     torch.as_tensor(zi, device="cuda"))
    assert torch.equal(torch.cat([y1, y2], dim=-1), yw) and torch.equal(z2, zw)


def _loud_sos(sections: int, rng) -> np.ndarray:
    """int8 x64 sections whose gains drive every section to the rails on
    full-scale input."""
    sos = np.zeros((sections, 6), np.int64)
    sos[:, 0] = rng.integers(100, 128, sections)
    sos[:, 1:3] = rng.integers(-128, 128, (sections, 2))
    sos[:, 3] = 64
    sos[:, 4] = rng.integers(-40, 40, sections)
    sos[:, 5] = rng.integers(0, 30, sections)
    return sos


@pytest.mark.parametrize("windowed", [True, False], ids=["window", "nowindow"])
@pytest.mark.parametrize("rows", [1, 4, 33])
@pytest.mark.parametrize("sections", range(1, 9))
def test_sosfilt_q15_wavefront_sections_rows_and_rails(card, sections, rows, windowed):
    """K2 (one section a lane, rows packed a warp) at 1 to 8 sections on 1,
    4 and 33 rows (33: the last packed warp part-full), full-scale input
    that reaches the rails: bit for bit the plain version and
    golden.sosfilt_q15_intended; two calls with the state carried equal
    one."""
    from tpu_sdr_torch.control import golden

    rng = np.random.default_rng(1000 + 10 * sections + rows)
    t = 1024
    sos = _loud_sos(sections, rng)
    x = np.clip(np.round(rng.standard_normal((rows, t)) * 32767), -32768, 32767).astype(np.int16)
    zi = rng.integers(-200_000, 200_000, (rows, sections, 2)).astype(np.int32)
    sos_t = torch.as_tensor(sos, dtype=torch.int32, device="cuda")
    xt, zt = torch.as_tensor(x, device="cuda"), torch.as_tensor(zi, device="cuda")
    rom = window.hann_q16_rom(t // 2, device="cuda") if windowed else None
    launch.reset_counts()
    got = biquad.sosfilt_q15_window(sos_t, xt, zt, rom=rom)
    torch.cuda.synchronize()
    assert launch.counts["kernel"]["sosfilt_q15"] == 1
    ref = biquad.sosfilt_q15_plain(sos_t, xt, zt, rom=rom)
    for g, r in zip(got, ref):
        assert (g is None and r is None) or (g.dtype == r.dtype and torch.equal(g, r))
    assert int((got[0].abs() >= 32767).sum()) > 0
    for r in range(rows):
        xw = golden.rtl_window_q15(x[r], n=t // 2) if windowed else x[r]
        y, zf = golden.sosfilt_q15_intended(sos, xw, zi[r])
        assert np.array_equal(got[0][r].cpu().numpy(), y)
        assert np.array_equal(got[2][r].cpu().numpy().astype(np.int64), zf)
    h = t // 2
    y1, xw1, z1 = biquad.sosfilt_q15_cuda(sos_t, xt[:, :h].contiguous(), zt, rom=rom)
    y2, xw2, z2 = biquad.sosfilt_q15_cuda(sos_t, xt[:, h:].contiguous(), z1, rom=rom)
    assert torch.equal(torch.cat([y1, y2], dim=-1), got[0]) and torch.equal(z2, got[2])
    if windowed:
        assert torch.equal(torch.cat([xw1, xw2], dim=-1), got[1])


def test_viterbi_step_probes_measure_a_step(card):
    """Both latency probes run and give a step of a few dozen to a few
    hundred cycles; the warp route's step is no longer than its kernel's
    (64 rows x 2054 steps at k = 7, forward pass and traceback)."""
    from tpu_sdr_torch.bench.roofline import max_sm_mhz
    from tpu_sdr_torch.kernels import fec
    from tpu_sdr_torch.kernels.cuda import viterbi

    warp = viterbi.warp_step_probe_cycles(4096)
    block = viterbi.step_probe_cycles(64, 4096)
    assert 10 < warp < 1000 and 10 < block < 1000, (warp, block)
    code = fec.ConvCode(7, (0o133, 0o171), device="cuda")
    x = torch.randn((64, 2054, 2), device="cuda", generator=torch.Generator("cuda").manual_seed(4))
    call = lambda: viterbi.viterbi_cuda(x, code._tables["out0"], code._tables["out1"], 7)
    call()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        call()
    end.record()
    torch.cuda.synchronize()
    mhz = max_sm_mhz()
    assert warp <= start.elapsed_time(end) / 20 * mhz * 1e3 / 2054 * 1.05


def test_q15_pipeline_on_card_equals_the_cpu_bitwise(card):
    from tpu_sdr_torch.runtime.q15 import Q15Pipeline

    x = _q15_frames(2 * N, 90, "random")
    cfg = PipelineConfig(channels=1)
    for device_fft, bypass in ((False, False), (True, False), (True, True)):
        gpu = Q15Pipeline(cfg, device_fft=device_fft)
        cpu = Q15Pipeline(cfg, device_fft=device_fft, device="cpu")
        for p in (gpu, cpu):
            p.upload_sos_q(Q15_SOS[:2])
        launch.reset_counts()
        got, zg = gpu.process(x, bypass=bypass)
        torch.cuda.synchronize()
        assert launch.counts["kernel"]["q15_fft"] == 1
        assert launch.counts["kernel"]["sosfilt_q15"] == int(not device_fft)
        ref, zc = cpu.process(x, bypass=bypass)
        for k, r in ref.items():
            g = np.asarray(got[k].cpu() if isinstance(got[k], torch.Tensor) else got[k])
            if k != "magnitude":
                assert np.array_equal(g, np.asarray(r)), (device_fft, bypass, k)
        # |X|: the card's root is NumPy's correctly rounded one, bit for bit;
        # torch's CPU root may round 1 ulp from it (tests/test_torch_q15.py)
        fr = got["spectrum_re_q15"].cpu().numpy().astype(np.float32)
        fi = got["spectrum_im_q15"].cpu().numpy().astype(np.float32)
        mag = got["magnitude"].cpu().numpy()
        assert np.array_equal(mag, np.sqrt(fr * fr + fi * fi)), (device_fft, bypass)
        cpu_mag = ref["magnitude"].numpy()
        assert np.abs(mag.view(np.int32) - cpu_mag.view(np.int32)).max() <= 1, (device_fft, bypass)
        zg = zg.cpu().numpy() if isinstance(zg, torch.Tensor) else zg
        zc = zc.numpy() if isinstance(zc, torch.Tensor) else zc
        assert np.array_equal(zg, zc)


@pytest.mark.parametrize("depth", [1, 3])
def test_q15_stream_on_card_equals_sequential(card, depth):
    from tpu_sdr_torch.runtime.q15 import Q15Pipeline, Q15Stream

    pipe = Q15Pipeline(PipelineConfig(channels=1), device_fft=True)
    pipe.upload_sos_q(Q15_SOS[:2])
    chunks = [_q15_frames(N, 100 + i, "random") for i in range(5)]
    zi, refs = None, []
    for c in chunks:
        o, zi = pipe.process(c, zi)
        refs.append(o["magnitude"].cpu().numpy())
    stream = Q15Stream(pipe, depth=depth)
    got = [r[0]["magnitude"] for c in chunks if (r := stream.push(c)) is not None]
    while (r := stream.flush()) is not None:
        got.append(r[0]["magnitude"])
    stream.close()
    assert len(got) == 5 and all(np.array_equal(a, b) for a, b in zip(got, refs))


def test_feeder_on_card_stages_through_pinned_buffers(card):
    from tpu_sdr_torch.runtime import StreamFeeder
    from tpu_sdr_torch.runtime.source import SyntheticSource

    kw = dict(tones_hz=((100e3, 0.5),), noise=0.1, channels=2, seed=3)
    f = StreamFeeder(SyntheticSource(**kw), chunk_samples=N, depth=2).start()
    try:
        chunks = [f.get() for _ in range(6)]
    finally:
        f.stop()
    assert all(c.device.type == "cuda" and c.shape == (2, N) for c in chunks)
    assert len(f._pinned) == 3 and all(b.is_pinned() for b, _ in f._pinned if b is not None)
    ref = SyntheticSource(**kw).read(6 * N)
    assert np.array_equal(torch.cat(chunks, dim=-1).cpu().numpy(), ref)


def test_welch_on_card_matches_scipy(card):
    from tpu_sdr_torch.runtime import WelchPSD

    x = np.random.default_rng(7).standard_normal(16 * 1024).astype(np.float32)
    for average in ("mean", "median"):
        got = WelchPSD(nperseg=1024, average=average, noverlap=0).compute(x).cpu().numpy()
        _, ref = sps.welch(x.astype(np.float64), fs=1e6, nperseg=1024, average=average, noverlap=0)
        assert np.abs(got - ref).max() <= 1e-5 * ref.max()


# ------------------------------------------- burst modem, FEC (K3), FastFIR


@pytest.mark.parametrize("k,polys,rows,steps,kind", [
    (7, (0o133, 0o171), 64, 2054, "soft"), (7, (0o133, 0o171), 8, 500, "hard"),
    (3, (0o7, 0o5), 4, 300, "soft"), (12, (0o4335, 0o5723), 1, 400, "soft"),
    (12, (0o4335, 0o5723), 2, 200, "hard"), (2, (0o3, 0o1), 3, 64, "hard"),
    (7, (0o133, 0o145, 0o175), 4, 300, "soft"),
    (4, (0o17, 0o13), 5, 700, "soft"), (5, (0o35, 0o23), 5, 700, "hard"),
    (7, (0o133, 0o171), 2, 30000, "soft"),
])
def test_viterbi_kernel_equals_plain_bitwise(card, k, polys, rows, steps, kind):
    """K3 against its plain version: every decision, tail included, on
    soft and on hard (tie-rich) observations, k = 2..12: the warp route up
    to k = 7 (k = 4 and 5: fewer states than lanes; 30000 steps: more
    decisions than shared memory holds, so they go to device memory), the
    block route above."""
    from tpu_sdr_torch.kernels import fec
    from tpu_sdr_torch.kernels.cuda import viterbi

    code = fec.ConvCode(k, polys, device="cuda")
    rng = np.random.default_rng(k * 1000 + rows)
    x = rng.standard_normal((rows, steps, len(polys))).astype(np.float32)
    if kind == "hard":
        x = np.sign(x)
    xt = torch.as_tensor(x, device="cuda")
    got = viterbi.viterbi_cuda(xt, code._tables["out0"], code._tables["out1"], k)
    ref = fec.viterbi_plain(xt, code._tables["sign0"], code._tables["sign1"], k)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8 and torch.equal(got, ref)
    assert viterbi.needs_scratch(steps, k) == (k > 7 or steps > 28032)


def test_conv_decode_on_card_one_launch_and_equals_cpu(card):
    from tpu_sdr_torch.kernels import fec

    rng = np.random.default_rng(21)
    gpu = fec.ConvCode(7, puncture="3/4", device="cuda")
    cpu = fec.ConvCode(7, puncture="3/4", device="cpu")
    bits = rng.integers(2, size=(6, 300)).astype(np.uint8)
    coded = gpu.encode(bits)
    soft = ((1.0 - 2.0 * coded) + 0.4 * rng.standard_normal(coded.shape)).astype(np.float32)
    launch.reset_counts()
    got = gpu.decode(soft, 300)
    assert launch.counts["kernel"]["viterbi"] == 1 and launch.counts["plain"]["viterbi"] == 0
    np.testing.assert_array_equal(got, cpu.decode(soft, 300))
    np.testing.assert_array_equal(got, bits)


def test_burst_demod_on_card_batched_equals_single_and_skips_cudnn(card):
    """Batched == single bit for bit, and the same bits with cuDNN off and
    with cuDNN's TF32 on: the modem's convolutions do not go through it."""
    from tpu_sdr_torch.kernels import digital

    rng = np.random.default_rng(22)
    modem = digital.BurstModem("qpsk", sps=8, differential=False)
    rows = []
    for d in (0.3, 1.7, 4.2, 6.9):
        bits = rng.integers(2, size=256).astype(np.uint8)
        re, im = modem.modulate(bits, pad_syms=modem.max_lag_syms + modem.span)
        z = (re + 1j * im) * np.exp(0.5j) + 0.05 * (rng.standard_normal(re.size)
                                                      + 1j * rng.standard_normal(re.size))
        rows.append(np.roll(np.stack([z.real, z.imag]).astype(np.float32), int(d), axis=-1))
    planes = np.stack(rows, axis=1)  # (2, 4, T)
    keys = ("timing", "cfo", "frame_lag", "phase")
    try:
        torch.backends.cudnn.allow_tf32 = False
        batched = modem.demodulate(planes[0], planes[1], 256)
        torch.backends.cudnn.allow_tf32 = True
        tf32 = modem.demodulate(planes[0], planes[1], 256)
        with torch.backends.cudnn.flags(enabled=False):
            off = modem.demodulate(planes[0], planes[1], 256)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    for other in (tf32, off):
        np.testing.assert_array_equal(other["bits"], batched["bits"])
        assert all(torch.equal(other[k], batched[k]) for k in keys)
    for i in range(4):
        one = modem.demodulate(planes[0, i], planes[1, i], 256)
        np.testing.assert_array_equal(one["bits"], batched["bits"][i])
        assert all(torch.equal(one[k], batched[k][i]) for k in keys)
        assert torch.equal(one["symbols"][0], batched["symbols"][0][i])


def test_fastfir_on_card_chunked_equals_oneshot_and_lfilter(card):
    from tpu_sdr_torch.kernels.fastconv import FastFIR

    h = sps.firwin(1025, 0.21)
    f = FastFIR(h)
    g = f.chunk_granularity
    x = np.random.default_rng(23).standard_normal((4, 6 * g)).astype(np.float32)
    one, _ = f.process(x, f.initial_state((4,)))
    st, outs = f.initial_state((4,)), []
    for a, b in ((0, 1), (1, 4), (4, 6)):
        o, st = f.process(x[:, a * g : b * g], st)
        outs.append(o)
    assert torch.equal(torch.cat(outs, dim=-1), one)
    want = sps.lfilter(h, 1.0, x.astype(np.float64), axis=-1)
    assert np.abs(one.cpu().numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_capture_op_table_counts_a_one_kernel_step(card):
    """One launch of the scaled integer FFT a step: the op table of the last
    step holds exactly that kernel, charged by its launch's correlation."""
    from tpu_sdr_torch.bench.trace import capture_op_table
    from tpu_sdr_torch.kernels import fft_q15

    x = torch.as_tensor(np.random.default_rng(31).integers(-32768, 32767, (1, N), dtype=np.int16),
                        device="cuda")
    fft_q15.window_fft_q15_cuda(x)
    torch.cuda.synchronize()
    t = capture_op_table(lambda: fft_q15.window_fft_q15_cuda(x), reps=3)
    assert t["device_trace"] and t["executions"] == 3 and t["unattributed"] == 0
    assert t["n_ops"] == 1 and list(t["op_counts"].values()) == [1]
    assert "q15_fft_cluster_kernel" in next(iter(t["op_counts"]))
    assert 0 < t["device_busy_ms"] == t["op_sum_ms"] <= t["dispatch_ms"]
    assert t["device_idle_ms"] >= 0


def test_capture_op_table_charges_ops_to_the_port_spans(card):
    """A CUSTOM bank dispatch of 4 channels x 2 frames: every op of the
    step is launched inside ``tpu_sdr.dispatch``, the frame chain's are 3 a
    frame and the stack, and the spectrum kernel lies in its launch span."""
    from tpu_sdr_torch.bench.trace import capture_op_table

    pipe = SpectrumPipeline(PipelineConfig(channels=4))
    pipe.upload_sos_bank([sps.butter(6, 0.05 * (c + 1), output="sos") for c in range(4)])
    x = torch.as_tensor(np.random.default_rng(37).standard_normal((4, 2 * N)).astype(np.float32),
                        device="cuda")
    held = {"st": pipe.initial_state()}

    def step():
        _, held["st"] = pipe.process(x, held["st"], FilterMode.CUSTOM)

    step()
    torch.cuda.synchronize()
    t = capture_op_table(step, reps=2)
    spans = t["spans"]
    iir = ("tpu_sdr.iir.products", "tpu_sdr.iir.frame_chain", "tpu_sdr.iir.emit")
    assert t["device_trace"] and spans["tpu_sdr.dispatch"]["calls"] == 1
    assert spans["tpu_sdr.dispatch"]["device_ops"] == t["n_ops"]
    assert all(spans[name]["calls"] == 1 for name in iir)
    assert spans["tpu_sdr.iir.frame_chain"]["device_ops"] == 3 * 2 + 1
    assert spans["tpu_sdr.launch.spectrum_bypass"]["device_ops"] == 1
    assert sum(spans[name]["device_ms"] for name in iir) <= spans["tpu_sdr.dispatch"]["device_ms"]


def test_gui_backend_on_card_serves_a_frame(card):
    import json
    import queue
    import time

    from tpu_sdr_torch.gui import GuiBackend, serve

    backend = GuiBackend(display_fps=1000.0)  # device None: the card
    assert backend.device.type == "cuda"
    q = backend.subscribe()
    launch.reset_counts()
    srv, _ = serve(backend, port=0, bind="127.0.0.1", block=False)
    try:
        frame, deadline = None, time.time() + 10
        while frame is None and time.time() < deadline:
            try:
                ev, payload = q.get(timeout=1.0)
            except queue.Empty:
                continue
            if ev == "frame_data":
                frame = json.loads(payload)
    finally:
        backend.stop_receiver()
        srv.shutdown()
    assert frame is not None and abs(frame["peak_freq_khz"] - 100.0) < 1.0
    assert launch.counts["kernel"]["spectrum_bypass"] >= 1
    assert launch.counts["plain"]["spectrum_bypass"] == 0


def test_cli_selftest_passes_on_card(card, capsys):
    from tpu_sdr_torch.__main__ import main

    assert main(["selftest"]) == 0
    out = capsys.readouterr().out
    assert "selftest: PASS" in out and out.count("[PASS]") == 6


# ---------------------------------------------------------------- shard/


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """A 2-rank Gloo group on cuda:0 (two ranks on one card: NCCL refuses
    them, so each collective stages through the host)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch_shard_harness import run_group

    return run_group(tmp_path_factory.mktemp("gloo_cuda"), "shard_cases_cuda", 2,
                     backend="gloo", cases="GLOO")


@pytest.fixture(scope="module")
def nccl_rank(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch_shard_harness import run_group

    return run_group(tmp_path_factory.mktemp("nccl_cuda"), "shard_cases_cuda", 1,
                     backend="nccl", cases="NCCL")


@pytest.mark.parametrize("mode", ["BYPASS", "CUSTOM"])
def test_sharded_gloo_ranks_on_one_card_equal_single_device(gloo_ranks, mode):
    import shard_cases_cuda as cases

    results, errors = gloo_ranks
    assert "gloo_spectrum" in results, errors
    got = results["gloo_spectrum"]
    assert got["backend"] == "gloo"
    pipe = SpectrumPipeline(PipelineConfig(channels=4))
    pipe.upload_sos(cases.SOS)
    st, mags = pipe.initial_state(), []
    for part in np.split(cases.spectrum_input(), 2, axis=-1):
        out, st = pipe.process(part, st, FilterMode[mode])
        mags.append(out["magnitude"].cpu().numpy())
    mag, sos_state = got[mode]
    assert np.array_equal(mag, np.concatenate(mags, axis=-2))
    assert np.array_equal(sos_state, st.sos_state.cpu().numpy())


def test_latency_pipeline_on_a_one_rank_nccl_group(nccl_rank):
    """The NCCL route's all-gather, all-to-all and reduce-scatter on the
    card; the latency engine within 1e-5 of the throughput engine's peak."""
    import shard_cases_cuda as cases

    results, errors = nccl_rank
    assert "nccl_latency" in results, errors
    got = results["nccl_latency"]
    assert got["backend"] == "nccl" and got["collectives"] > 0
    pipe = SpectrumPipeline(PipelineConfig(channels=1))
    x = cases.latency_input()
    ref = pipe.process(x[:N], pipe.initial_state())[0]["magnitude"][0, 0].cpu().numpy()
    assert np.abs(got["BYPASS"] - ref).max() / ref.max() < 1e-5
    pipe.upload_sos(cases.SOS)
    ref = pipe.process(x, pipe.initial_state(), FilterMode.CUSTOM)[0]["magnitude"][0].cpu().numpy()
    for f in range(3):
        assert np.abs(got["CUSTOM"][f] - ref[f]).max() / ref[f].max() < 1e-5, f
