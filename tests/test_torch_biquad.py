"""PyTorch port of the composite IIR vs the JAX package and SciPy.

The host math, the device constants and the filtered output of
``tpu_sdr_torch.kernels.biquad`` are held against
``tpu_sdr.kernels.biquad`` on the same NumPy inputs, and the port's own
bitwise contracts (chunked == one-shot, shape-independent frame chain) are
checked within the port.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from tpu_sdr.kernels import biquad as jbq
from tpu_sdr.runtime import banks as jbanks
from tpu_sdr_torch.kernels import biquad
from tpu_sdr_torch.runtime import banks

torch.set_num_threads(1)

N = 16384
DESIGNS = {
    "butter12_lp": sps.butter(12, 0.2, output="sos"),
    "cheby1_bp": sps.cheby1(6, 1, [0.1, 0.4], btype="bandpass", output="sos"),
    "ellip_hp": sps.ellip(8, 0.5, 60, 0.35, btype="highpass", output="sos"),
}


def _padded(name):
    return biquad.pad_sos(DESIGNS[name], 6)


@pytest.mark.parametrize("name", list(DESIGNS))
def test_host_parts_equal_jax(name):
    sos = _padded(name)
    for ours, ref in zip(
        biquad.sos_to_composite_statespace(sos), jbq.sos_to_composite_statespace(sos)
    ):
        assert np.array_equal(ours, ref)
    for ours, ref in zip(
        biquad._composite_host_parts(sos, 128, 128),
        jbq._composite_host_parts(sos, 128, 128),
    ):
        assert np.array_equal(ours, ref)


@pytest.fixture(scope="module")
def ops():
    sos = _padded("butter12_lp")
    return jbq.precompute_composite(sos), biquad.precompute_composite(sos, device="cpu")


@pytest.mark.parametrize(
    "leaf", [f.name for f in dataclasses.fields(biquad.BlockedSOSComposite)]
)
def test_precompute_composite_leaf_equals_jax_bitwise(ops, leaf):
    jop, op = ops
    ref = np.asarray(getattr(jop, leaf))
    got = getattr(op, leaf).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("frames", [1, 3], ids=["single-frame", "3-frames"])
@pytest.mark.parametrize("name", list(DESIGNS))
def test_composite_matches_scipy_and_jax(name, frames):
    sos = _padded(name)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(frames * N).astype(np.float32)
    zi = (0.1 * rng.standard_normal((6, 2))).astype(np.float32)
    y_ref, zf_ref = sps.sosfilt(sos, x.astype(np.float64), zi=zi.astype(np.float64))
    op = biquad.precompute_composite(sos, device="cpu")
    y, zf = biquad.sosfilt_blocked_composite(op, torch.as_tensor(x), torch.as_tensor(zi))
    scale = np.max(np.abs(y_ref))
    assert y.shape == x.shape and zf.shape == (6, 2)
    assert np.max(np.abs(y.double().numpy() - y_ref)) / scale < 1e-4
    assert np.max(np.abs(zf.double().numpy() - zf_ref)) / scale < 1e-4
    jy, jzf = jbq.sosfilt_blocked_composite(
        jbq.precompute_composite(sos), jnp.asarray(x), jnp.asarray(zi),
        precision="highest",
    )
    jy = np.asarray(jy, np.float64)
    assert np.max(np.abs(y.double().numpy() - jy)) / scale < 1e-5
    assert np.max(np.abs(zf.double().numpy() - np.asarray(jzf))) / scale < 1e-5


@pytest.mark.parametrize(
    "channels,frames,chunks",
    [(1, 4, 4), (1, 8, 4), (2, 4, 4), (2, 8, 2), (3, 6, 3)],
    ids=["1ch-1frame-chunks", "1ch", "2ch-1frame-chunks", "2ch", "3ch"],
)
def test_composite_chunked_equals_oneshot_bitwise(channels, frames, chunks):
    op = biquad.precompute_composite(sps.ellip(12, 0.5, 70, 0.3, output="sos"), device="cpu")
    x = torch.as_tensor(
        np.random.default_rng(1).standard_normal((channels, frames * N)).astype(np.float32)
    )
    zi = torch.zeros((channels, 6, 2))
    y_whole, zf_whole = biquad.sosfilt_blocked_composite(op, x, zi)
    z = zi
    pieces = []
    for chunk in x.chunk(chunks, dim=-1):
        y, z = biquad.sosfilt_blocked_composite(op, chunk, z)
        pieces.append(y)
    assert torch.equal(torch.cat(pieces, dim=-1), y_whole)
    assert torch.equal(z, zf_whole)


def test_composite_channels_independent():
    op = biquad.precompute_composite(_padded("cheby1_bp"), device="cpu")
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((3, 2 * N)).astype(np.float32))
    y, zf = biquad.sosfilt_blocked_composite(op, x, torch.zeros((3, 6, 2)))
    for c in range(3):
        yc, zc = biquad.sosfilt_blocked_composite(op, x[c], torch.zeros((6, 2)))
        np.testing.assert_allclose(yc.numpy(), y[c].numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(zc.numpy(), zf[c].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rows", [1, 5, 16, 300])
def test_canonical_matmul_is_row_count_independent(rows):
    """Each row's bits are those of the same row in any other dispatch."""
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.standard_normal((300, 1536)).astype(np.float32))
    bt = torch.as_tensor(rng.standard_normal((1536, 1536)).astype(np.float32))
    whole = biquad._canonical_matmul(a, bt, 128)
    assert torch.equal(biquad._canonical_matmul(a[-rows:], bt, 128), whole[-rows:])
    np.testing.assert_allclose(whole.numpy(), (a @ bt).numpy(), rtol=1e-4, atol=1e-3)


def test_alb_step_exact_and_shape_independent(ops):
    _, op = ops
    rng = np.random.default_rng(4)
    z = torch.as_tensor(rng.standard_normal((7, 12)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((7, 12)).astype(np.float32))
    batch = biquad.alb_step(op, z, w)
    for i in range(7):
        assert torch.equal(biquad.alb_step(op, z[i], w[i]), batch[i])
    ref = op.ALB.double().numpy() @ z.double().numpy().T + w.double().numpy().T
    np.testing.assert_allclose(batch.double().numpy(), ref.T, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "sos",
    [
        sps.butter(4, 0.3, output="sos"),
        sps.butter(12, 0.3, output="sos"),
        np.zeros((0, 6)),
    ],
    ids=["short", "full", "empty"],
)
def test_pad_and_prepare_match_jax(sos):
    assert np.array_equal(biquad.pad_sos(sos, 6), jbq.pad_sos(sos, 6))
    assert np.array_equal(banks.prepare_sos(sos, 6), jbanks.prepare_sos(sos, 6))
    assert np.array_equal(biquad.sos_identity(3), jbq.sos_identity(3))


@pytest.mark.parametrize(
    "sos,match",
    [
        (np.array([[1.0, 0, 0, 1.0, -2.5, 1.5]]), "unstable"),
        (np.array([[1.0, 0, 0, 0.0, 0.1, 0.1]]), "a0 == 0"),
        (sps.butter(14, 0.3, output="sos"), "at most"),
    ],
    ids=["unstable", "a0-zero", "too-many-sections"],
)
def test_prepare_rejects_like_jax(sos, match):
    with pytest.raises(ValueError, match=match):
        banks.prepare_sos(sos, 6)
    with pytest.raises(ValueError, match=match):
        jbanks.prepare_sos(sos, 6)
