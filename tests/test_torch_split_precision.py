"""A NumPy model of the arithmetic of ``csrc/fft_mag_fused.cu`` (kernel row
6, ``fft_mag_fused``), which runs its two dense complex products on the
tensor cores with fp32 operands split into bf16 pieces.

No CUDA kernel runs here, so this file is the readable spec of that
arithmetic: each fp32 operand a is split as a0 = bf16(a), a1 = bf16(a - a0),
a2 = bf16(a - a0 - a1) (round to nearest even; the subtractions are exact);
a product takes the six piece products with i + j <= 2, smallest first
(a2b0, a1b1, a0b2, a1b0, a0b1, a0b0), each an MMA over a k-step of 16 that
adds 16 exact products to its accumulator with one fp32 rounding (the
model's MMA: an exact float64 sum, rounded once); a k-step's six (or, for
Zi, twelve) MMAs start from zero and their sum is added to the running fp32
total with one IEEE add. The twiddle and the magnitude are IEEE fp32
operations, as in the plain version. The model is held against ``tpu_sdr``'s
``fft_mag_fused`` in Pallas interpret mode and against a float64 reference;
it is not a plain version: nothing on any path calls it.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpu_sdr.kernels import fft as jfft
from tpu_sdr.kernels.pallas import spectrum as jspectrum
from tpu_sdr_torch.kernels.cuda import spectrum

N = 16384
F = 2
# The model against the JAX kernel in interpret mode (dense fp32 at
# "highest", about 133 dB against float64): the kernel-vs-plain floor.
JAX_FLOOR_DB = 120.0
# The products the kernel takes, (A piece, B piece), in its order.
ORDER = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))
KSTEP = 16


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.sum((ref - np.asarray(got, np.float64)) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(ref**2) / err)


def bf16(a) -> np.ndarray:
    """float32 -> the nearest bfloat16 (ties to even), as float32."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def split3(a, pieces: int = 3) -> list:
    """The kernel's split_pair: a = a0 + a1 + a2, each a bfloat16."""
    rest = np.asarray(a, np.float32)
    out = []
    for _ in range(pieces):
        p = bf16(rest)
        out.append(p)
        rest = (rest - p).astype(np.float32)
    return out


def kstep(terms) -> np.ndarray:
    """One k-step's chain of MMAs from a zero accumulator: each adds its
    exact products (float64) and rounds once to fp32."""
    acc = None
    for a, b in terms:
        s = a.astype(np.float64) @ b.astype(np.float64)
        acc = (s if acc is None else acc.astype(np.float64) + s).astype(np.float32)
    return acc


def model(frames, win, plan, pieces: int = 3) -> np.ndarray:
    """fft_mag_fused as the kernel computes it: (F, N) float32."""
    order = ORDER if pieces == 3 else ((0, 0),)
    p = {k: np.asarray(v, np.float32) for k, v in plan.items()}
    xw = (np.asarray(frames, np.float32) * np.asarray(win, np.float32)).reshape(-1, 128, 128)
    x = split3(xw, pieces)
    w2r, w2i = split3(p["w2r"], pieces), split3(p["w2i"], pieces)
    w1r = [w.T for w in split3(p["w1r"], pieces)]
    w1i = [w.T for w in split3(p["w1i"], pieces)]
    yr = np.zeros(xw.shape, np.float32)
    yi = np.zeros(xw.shape, np.float32)
    for s in range(128 // KSTEP):
        k = slice(KSTEP * s, KSTEP * (s + 1))
        yr = yr + kstep([(w2r[i][:, k], x[j][:, k, :]) for i, j in order])
        yi = yi + kstep([(w2i[i][:, k], x[j][:, k, :]) for i, j in order])
    tr = split3(yr * p["twr"] - yi * p["twi"], pieces)
    ti = split3(yr * p["twi"] + yi * p["twr"], pieces)
    zr = np.zeros(xw.shape, np.float32)
    zi = np.zeros(xw.shape, np.float32)
    for s in range(128 // KSTEP):
        k = slice(KSTEP * s, KSTEP * (s + 1))
        a = kstep([(tr[i][:, :, k], w1r[j][k]) for i, j in order])
        b = kstep([(ti[i][:, :, k], w1i[j][k]) for i, j in order])
        zr = zr + (a - b)
        both = []
        for i, j in order:
            both += [(tr[i][:, :, k], w1i[j][k]), (ti[i][:, :, k], w1r[j][k])]
        zi = zi + kstep(both)
    mag = np.sqrt(zr * zr + zi * zi)
    return mag.transpose(0, 2, 1).reshape(-1, N)


def reference64(frames, win, plan) -> np.ndarray:
    """The function in float64 from the same float32 inputs and planes."""
    p = {k: np.asarray(v, np.float64) for k, v in plan.items()}
    xw = (np.asarray(frames, np.float64) * np.asarray(win, np.float64)).reshape(-1, 128, 128)
    yr, yi = p["w2r"] @ xw, p["w2i"] @ xw
    tr = yr * p["twr"] - yi * p["twi"]
    ti = yr * p["twi"] + yi * p["twr"]
    zr = tr @ p["w1r"].T - ti @ p["w1i"].T
    zi = tr @ p["w1i"].T + ti @ p["w1r"].T
    return np.sqrt(zr**2 + zi**2).transpose(0, 2, 1).reshape(-1, N)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(31)
    frames = rng.standard_normal((F, N)).astype(np.float32)
    win = np.hanning(N).astype(np.float32)
    plan = {k: np.array(v) for k, v in jfft.plan_constants(128, 128).items()}
    planes = {
        "plan": plan,
        "plan-x0.5": {k: (v * 0.5).astype(np.float32) for k, v in plan.items()},
        "random": {k: rng.standard_normal((128, 128)).astype(np.float32) for k in plan},
    }
    return frames, win, planes


def test_split_reconstructs_fp32():
    """Three bf16 pieces carry an fp32 value to within 2^-24 relative (in
    practice exactly): the 24 bits of its significand."""
    rng = np.random.default_rng(32)
    a = (rng.standard_normal(100_000) * 2.0 ** rng.integers(-60, 60, 100_000)).astype(np.float32)
    pieces = split3(a)
    for p in pieces:
        assert not np.any(p.view(np.uint32) & 0xFFFF)  # each piece is a bfloat16
    back = sum(p.astype(np.float64) for p in pieces)
    rel = np.abs(back - a.astype(np.float64)) / np.abs(a.astype(np.float64))
    assert rel.max() <= 2.0**-24


@pytest.mark.parametrize("which", ["plan", "plan-x0.5", "random"])
def test_model_matches_jax_interpret(inputs, which):
    """The model against ``tpu_sdr``'s ``fft_mag_fused`` in Pallas interpret
    mode at precision "highest", F = 2, with the plan's planes, the plan's
    x 0.5 (|X| / 8) and random planes."""
    frames, win, planes = inputs
    p = planes[which]
    ref = jspectrum.fft_mag_fused(
        jnp.asarray(frames), jnp.asarray(win), {k: jnp.asarray(v) for k, v in p.items()},
        interpret=True, precision="highest",
    )
    assert snr_db(np.asarray(ref), model(frames, win, p)) >= JAX_FLOOR_DB


@pytest.mark.parametrize("which", ["plan", "random"])
def test_model_is_as_accurate_as_plain_fp32(inputs, which):
    """Against the float64 function, the model reaches at least the port's
    plain fp32 version's SNR minus 1 dB (the bar the kernel meets on the
    card), and the one-piece bf16 product, the precision the split exists to
    avoid, falls far below it."""
    frames, win, planes = inputs
    p = planes[which]
    ref = reference64(frames, win, p)
    plain = spectrum.fft_mag_fused_plain(
        torch.as_tensor(frames), torch.as_tensor(win), {k: torch.as_tensor(v) for k, v in p.items()}
    ).numpy()
    plain_db = snr_db(ref, plain)
    assert snr_db(ref, model(frames, win, p)) >= plain_db - 1.0
    assert snr_db(ref, model(frames, win, p, pieces=1)) < plain_db - 60.0
