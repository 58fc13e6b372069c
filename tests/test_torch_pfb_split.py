"""A NumPy model of the arithmetic of ``csrc/pfb_fold_dft.cu`` (kernel row
8, ``pfb_fold_dft``), which runs the channelizer's two 128 x 128 products
on the tensor cores with fp32 operands split into bf16 pieces.

No CUDA kernel runs here, so this file is the readable spec of that
arithmetic: the fold in IEEE fp32, acc = rows[s] h2[0], then acc + rows[s +
t] h2[t] for t ascending (the plain version's order); each folded value and
each plane value split into three bf16 pieces; each product over k-steps of
16, a k-step's six piece products (i + j <= 2, smallest first) each an MMA
that adds 16 exact products to its accumulator with one fp32 rounding, from
a zero accumulator, the k-step's sum added to the running fp32 total with
one IEEE add (``split3``, ``kstep`` and ``ORDER`` are row 6's model's, in
``tests/test_torch_split_precision.py``). The model is held against
``tpu_sdr``'s ``pfb_fold_dft`` in Pallas interpret mode and against a
float64 reference; it is not a plain version: nothing on any path calls it.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_torch_split_precision import KSTEP, ORDER, kstep, snr_db, split3
from tpu_sdr.kernels import pfb as jpfb
from tpu_sdr.kernels.pallas import pfb_kernel as jkern
from tpu_sdr_torch.kernels.cuda import pfb_kernel

M = 128
# The model against the JAX kernel in interpret mode (fp32 products of 128
# terms, summed in another order): the kernel-vs-plain bound of the card,
# of max |A| (tests/test_pfb.py's bound).
PFB_REL = 1e-5
SHAPES = [(1, 8), (7, 2), (300, 20)]  # (steps, taps)


def fold(rows, h2, taps) -> np.ndarray:
    """The kernel's fold: (B, steps + taps - 1, M) -> (B, steps, M) float32."""
    steps = rows.shape[1] - (taps - 1)
    acc = rows[:, 0:steps] * h2[0]
    for t in range(1, taps):
        acc = acc + rows[:, t : t + steps] * h2[t]
    return acc


def product(folded, plane) -> np.ndarray:
    """(rows, M) @ (M, M) as the kernel takes it: six bf16 piece products a
    k-step of 16, each k-step joined to the running sum by one fp32 add."""
    f, p = split3(folded), split3(plane)
    acc = np.zeros((folded.shape[0], M), np.float32)
    for s in range(M // KSTEP):
        k = slice(KSTEP * s, KSTEP * (s + 1))
        acc = acc + kstep([(f[i][:, k], p[j][k, :]) for i, j in ORDER])
    return acc


def model(rows, h2, cos, sin, taps, neg_b=False):
    """pfb_fold_dft as the kernel computes it: (A, B), each (B, steps, M)."""
    folded = fold(rows, h2, taps)
    flat = folded.reshape(-1, M)
    a = product(flat, cos).reshape(folded.shape)
    b = product(flat, sin).reshape(folded.shape)
    return a, -b if neg_b else b


def reference64(rows, h2, cos, sin, taps):
    """The function in float64 from the same float32 inputs and planes."""
    folded = fold(rows.astype(np.float64), h2.astype(np.float64), taps)
    return folded @ cos.astype(np.float64), folded @ sin.astype(np.float64)


def planes(which: str, taps: int):
    """(h2, cos, sin) float32: the Channelizer's prototype and planes, its
    planes x 0.5, or seeded standard-normal planes."""
    ch = jpfb.Channelizer(m=M, taps=taps)
    h2, cos, sin = (np.array(v, np.float32) for v in (ch._h2, ch._cos, ch._sin))
    if which == "x0.5":
        cos, sin = (0.5 * cos).astype(np.float32), (0.5 * sin).astype(np.float32)
    elif which == "random":
        rng = np.random.default_rng(41)
        cos, sin = (rng.standard_normal((M, M)).astype(np.float32) for _ in range(2))
    return h2, cos, sin


def rows_for(steps: int, taps: int, seed: int = 40, batch: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed + steps + taps)
    return rng.standard_normal((batch, steps + taps - 1, M)).astype(np.float32)


@pytest.mark.parametrize("steps,taps", SHAPES)
def test_model_fold_equals_fold_rows_bitwise(steps, taps):
    """The model's fold is the plain version's (``fold_rows``) bit for bit:
    the kernel's fp32 fold takes the same operations in the same order."""
    rows = rows_for(steps, taps)
    h2, _, _ = planes("channelizer", taps)
    want = pfb_kernel.fold_rows(torch.as_tensor(rows), torch.as_tensor(h2), taps).numpy()
    got = fold(rows, h2, taps)
    assert got.dtype == np.float32 and np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("neg_b", [False, True], ids=["b", "neg_b"])
@pytest.mark.parametrize("which", ["channelizer", "x0.5", "random"])
@pytest.mark.parametrize("steps,taps", SHAPES)
def test_model_matches_jax_interpret(steps, taps, which, neg_b):
    """The model against ``tpu_sdr``'s ``pfb_fold_dft`` in Pallas interpret
    mode at precision "highest": (A, B) within 1e-5 of max |A|."""
    rows = rows_for(steps, taps)
    h2, cos, sin = planes(which, taps)
    ja, jb = jkern.pfb_fold_dft(*(jnp.asarray(v) for v in (rows, h2, cos, sin)), taps, M,
                                interpret=True, precision="highest", neg_b=neg_b)
    a, b = model(rows, h2, cos, sin, taps, neg_b)
    scale = np.abs(np.asarray(ja)).max()
    assert a.shape == ja.shape and b.shape == jb.shape
    assert np.abs(a - np.asarray(ja)).max() <= PFB_REL * scale
    assert np.abs(b - np.asarray(jb)).max() <= PFB_REL * scale


@pytest.mark.parametrize("which", ["channelizer", "random"])
def test_model_is_as_accurate_as_plain_fp32(which):
    """Against the float64 function, the model reaches at least the port's
    plain fp32 version's SNR minus 1 dB (the bar the kernel meets on the
    card), and the one-piece bf16 product falls far below it."""
    steps, taps = 300, 8
    rows = rows_for(steps, taps, batch=4)
    h2, cos, sin = planes(which, taps)
    ref_a, ref_b = reference64(rows, h2, cos, sin, taps)
    pa, pb = pfb_kernel.pfb_fold_dft_plain(*(torch.as_tensor(v) for v in (rows, h2, cos, sin)),
                                           taps, M)
    a, b = model(rows, h2, cos, sin, taps)
    for ref, plain, got in ((ref_a, pa.numpy(), a), (ref_b, pb.numpy(), b)):
        plain_db = snr_db(ref, plain)
        assert snr_db(ref, got) >= plain_db - 1.0
    one_piece = split3(fold(rows, h2, taps).reshape(-1, M), 1)[0] @ split3(cos, 1)[0]
    assert snr_db(ref_a.reshape(-1, M), one_piece) < snr_db(ref_a, pa.numpy()) - 60.0


@pytest.mark.parametrize("scale", [2.0**-40, 2.0**40], ids=["2^-40", "2^40"])
def test_model_keeps_its_accuracy_at_extreme_scales(scale):
    """Rows scaled by 2^+-40: every piece stays a normal bf16 (no third
    piece flushed), so the model's SNR against float64 is the unscaled one,
    and at least the plain version's minus 1 dB."""
    steps, taps = 64, 8
    rows = rows_for(steps, taps)
    h2, cos, sin = planes("random", taps)
    ref, _ = reference64(rows, h2, cos, sin, taps)
    base = snr_db(ref, model(rows, h2, cos, sin, taps)[0])
    scaled = (rows * np.float32(scale)).astype(np.float32)
    ref_s, _ = reference64(scaled, h2, cos, sin, taps)
    got = model(scaled, h2, cos, sin, taps)[0]
    plain = pfb_kernel.pfb_fold_dft_plain(*(torch.as_tensor(v) for v in (scaled, h2, cos, sin)),
                                          taps, M)[0].numpy()
    assert abs(snr_db(ref_s, got) - base) < 0.5
    assert snr_db(ref_s, got) >= snr_db(ref_s, plain) - 1.0
