"""A NumPy model of the arithmetic of ``csrc/iir_summaries.cu`` (kernel row
3, ``iir_summaries``), which takes each frame's zero-state end state as one
product with the plan's ``summary_matrix`` K_w (12 x 16384, the window
folded in) instead of walking the 128-block chain.

No CUDA kernel runs here, so this file is the readable spec of that
arithmetic: K_w from the plan in float64, rounded once (checked against
the float64 chain on unit impulses); then per frame, in IEEE fp32, each
thread's eight samples n = 2048 r + 1024 j + 4 t + q (rank r of the
cluster, thread t = 32 w + l of the CTA) by a chain of FMAs from 0, j then
q ascending; the warp's 32 lanes by a butterfly over lane bits 4, 3, 2, 1,
0; the CTA's 8 warps, then the cluster's 8 ranks, each in ascending order.
An fp32 FMA is modelled as one rounding of the float64 sum of the exact
product and the addend (a float64 rounding first can differ from it in
rare ties). The model is held against ``tpu_sdr``'s ``iir_summaries`` in
Pallas interpret mode and against the float64 chain on the plan's own fp32
constants; it is not a plain version: nothing on any path calls it. The
designs, at fs = 1 MHz: the pipelines' CUSTOM design, three designs of
other shapes and two narrow low-passes, whose poles near the unit circle
cost the 128-step fp32 chains (the plain version's and the JAX kernel's)
digits that the direct product keeps.
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch
import jax.numpy as jnp

from tpu_sdr.kernels import fft as jfft
from tpu_sdr.kernels import window as jwindow
from tpu_sdr.kernels.pallas import iir_fft as jiir
from tpu_sdr_torch.kernels import fft, window
from tpu_sdr_torch.kernels.cuda import iir_fft

torch.set_num_threads(1)

N = 16384
M = 12
RANKS, WARPS, LANES = 8, 8, 32
DESIGNS = {
    "custom-butter12-0.25": sps.butter(12, 0.25, output="sos"),
    "butter12-300k": sps.butter(12, 0.6, output="sos"),
    "cheby1-6-bandpass-100-120k": sps.cheby1(6, 1, [0.2, 0.24], btype="bandpass", output="sos"),
    "ellip12-highpass-200k": sps.ellip(12, 1, 80, 0.4, btype="highpass", output="sos"),
    "butter12-5k": sps.butter(12, 0.01, output="sos"),
    "butter12-1k": sps.butter(12, 0.002, output="sos"),
}
# The model against the JAX kernel: both fp32, sums in other orders; of
# max |JAX| (tests/test_torch_fused.py's bound), beside the JAX kernel's
# own distance from float64 (its doubling scan loses digits on the narrow
# designs as the plain chain does).
STATE_REL_TOL = 1e-5
# K_w against the float64 chain on unit impulses: each entry rounded once
# to fp32 (relative 2^-24), plus float64's own noise, 1e-12 of max |K_w|:
# the powers of AL cancel on the narrow designs, where two float64 orders
# of the same products differ by 2e-14 of max |K_w| (the chain against the
# port's powers, 1 kHz low-pass) and up to 2e-9 (against powers by squaring).
KW_ROUNDING = 2.0**-24 * (1 + 1e-9)
KW_FLOAT64_NOISE = 1e-12


@pytest.fixture(scope="module")
def frames():
    """16 frames of N(0, 1) from seed 0, the comparison of ROADMAP C9."""
    return np.random.default_rng(0).standard_normal((16, N)).astype(np.float32)


@pytest.fixture(scope="module", params=list(DESIGNS))
def design(request):
    """(name, JAX plan, port plan) of one design."""
    sos = DESIGNS[request.param]
    jp = jiir.build_plan(sos, jwindow.hann_coefficients(N), jfft.plan_constants(128, 128))
    pp = iir_fft.build_plan(
        sos, window.hann_coefficients(N, device="cpu"), fft.plan_constants(128, 128, device="cpu"),
    )
    return request.param, jp, pp


def plan64(pp):
    """(AL (m, m), P (m, L), win (N,)) float64 from the plan's fp32 leaves."""
    return (pp.AL1T.double().numpy().T, pp.PT.double().numpy().T,
            pp.win.double().numpy().reshape(-1))


def chain64(x: np.ndarray, pp) -> np.ndarray:
    """The function in float64 on the plan's constants: window, forcing,
    the block chain from rest; (F, N) -> (F, m)."""
    AL, P, win = plan64(pp)
    xw = x.astype(np.float64) * win
    z = np.zeros((x.shape[0], M))
    for j in range(N // 128):
        z = z @ AL.T + xw[:, 128 * j : 128 * (j + 1)] @ P.T
    return z


def fma32(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def model(x: np.ndarray, kw: np.ndarray) -> np.ndarray:
    """iir_summaries as the kernel computes it: (F, N) fp32 -> (F, m) fp32."""
    F = x.shape[0]
    xs = x.reshape(F, RANKS, 2, WARPS, LANES, 4)  # n = 2048 r + 1024 j + 128 w + 4 l + q
    ks = kw.reshape(M, RANKS, 2, WARPS, LANES, 4)
    acc = np.zeros((F, M, RANKS, WARPS, LANES), np.float32)
    for j in range(2):
        for q in range(4):
            acc = fma32(xs[:, None, :, j, :, :, q], ks[None, :, :, j, :, :, q], acc)
    lanes = acc.reshape(F, M, RANKS, WARPS, 2, 2, 2, 2, 2)  # lane bits 4 .. 0
    for _ in range(5):  # each level pairs the lanes that differ in its bit
        lanes = lanes[:, :, :, :, 0] + lanes[:, :, :, :, 1]
    warps = lanes[:, :, :, 0]
    for w in range(1, WARPS):
        warps = warps + lanes[:, :, :, w]
    out = warps[:, :, 0]
    for r in range(1, RANKS):
        out = out + warps[:, :, r]
    return out


def rel(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    return np.abs(ref - np.asarray(got, np.float64)).max() / np.abs(ref).max()


def test_summary_matrix_is_the_float64_chain_on_unit_impulses(design):
    """K_w[:, n] is the float64 chain's end state for a unit impulse at n,
    rounded once: all 16384 impulses at once, one state column each."""
    _, _, pp = design
    AL, P, win = plan64(pp)
    Z = np.zeros((M, N))
    cols = np.arange(N)
    for j in range(N // 128):
        Z = AL @ Z
        blk = cols[128 * j : 128 * (j + 1)]
        Z[:, blk] += P * win[blk]
    kw = pp.summary_matrix
    assert kw.dtype == torch.float32 and tuple(kw.shape) == (M, N) and kw.is_contiguous()
    got = kw.double().numpy()
    assert np.all(np.abs(got - Z) <= KW_ROUNDING * np.abs(Z) + KW_FLOAT64_NOISE * np.abs(Z).max())
    assert pp.summary_matrix is kw  # built once per plan


def test_model_matches_jax_interpret(design, frames):
    name, jp, pp = design
    ref = np.asarray(jiir.iir_summaries(jnp.asarray(frames), jp, interpret=True,
                                        precision="highest"))
    got = model(frames, pp.summary_matrix.numpy())
    assert got.shape == ref.shape == (16, M) and got.dtype == np.float32
    assert rel(ref, got) <= STATE_REL_TOL + rel(ref, chain64(frames, pp)), name


def test_model_vs_float64_no_worse_than_plain(design, frames):
    """Against the float64 chain: the model at least as close as the plain
    version (the fp32 chain), and within 1e-6 of max |state| on every
    design, where the chain drifts to 1e-3 on the 1 kHz low-pass."""
    name, _, pp = design
    ref = chain64(frames, pp)
    got = rel(ref, model(frames, pp.summary_matrix.numpy()))
    plain = rel(ref, iir_fft.iir_summaries_plain(torch.as_tensor(frames), pp).numpy())
    assert got <= plain, (name, got, plain)
    assert got <= 1e-6, (name, got)


def test_model_is_the_product_with_the_summary_matrix(design, frames):
    """The kernel's order changes only roundings: the model is within fp32
    noise of x @ K_w.T taken in float64."""
    _, _, pp = design
    kw = pp.summary_matrix.numpy()
    exact = frames.astype(np.float64) @ kw.astype(np.float64).T
    assert rel(exact, model(frames, kw)) <= 1e-6
