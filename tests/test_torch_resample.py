"""The port's rational resampler (``tpu_sdr_torch.kernels.resample``)
against tpu_sdr's and a float64 scipy golden, on the CPU."""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from tpu_sdr.kernels import resample as jres
from tpu_sdr_torch import convert
from tpu_sdr_torch.kernels import resample

torch.set_num_threads(1)

RATIOS = [(1, 1), (3, 2), (2, 3), (6, 25), (160, 147)]
# Port vs JAX: the same float32 taps and slices, multiplied and summed in
# the same j order; a different compiler may still contract or reorder, so
# allow an ulp or two of the unit-scale outputs (gain up to L).
RES_ATOL = 1e-6


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("up,down", RATIOS + [(12, 8)])
def test_fir_design_equals_jax(up, down):
    got = resample.design_resample_fir(up, down)
    assert got.dtype == np.float64 and np.array_equal(got, jres.design_resample_fir(up, down))
    r = resample.Resampler(up, down, device="cpu")
    j = jres.Resampler(up, down)
    assert (r.up, r.down, r.p) == (j.up, j.down, j.p) and np.array_equal(r.fir, j.fir)


@pytest.mark.parametrize("up,down", RATIOS)
@pytest.mark.parametrize("batch", [(), (2, 3)], ids=["1d", "2x3"])
def test_matches_jax(up, down, batch):
    x = _x(batch + (down * 40,), seed=up + down)
    j = jres.Resampler(up, down)
    jo, jst = j.process(x, j.initial_state(batch))
    r = resample.Resampler(up, down, device="cpu")
    o, st = r.process(x, r.initial_state(batch))
    assert tuple(o.shape) == np.shape(jo)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=RES_ATOL)
    assert np.array_equal(st.tail.numpy(), np.asarray(jst.tail)) and st.offset == jst.offset


@pytest.mark.parametrize("up,down", [(3, 2), (6, 25)])
def test_matches_upfirdn_golden(up, down):
    r = resample.Resampler(up, down, device="cpu")
    x = _x(down * 64, seed=3)
    o, _ = r.process(x, r.initial_state())
    ref = sps.upfirdn(r.fir, x.astype(np.float64), up, down)[: o.shape[-1]]
    np.testing.assert_allclose(o.double().numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("up,down", [(3, 2), (6, 25), (160, 147)])
def test_chunked_equals_oneshot_bitwise(up, down):
    r = resample.Resampler(up, down, device="cpu")
    x = _x((2, down * 30), seed=4)
    one, st_one = r.process(x, r.initial_state((2,)))
    st, parts, pos = r.initial_state((2,)), [], 0
    for n in (down, down * 7, down * 2, down * 20):
        o, st = r.process(x[..., pos : pos + n], st)
        parts.append(o)
        pos += n
    assert torch.equal(torch.cat(parts, dim=-1), one)
    assert torch.equal(st.tail, st_one.tail)


def test_batch_row_equals_row_alone():
    r = resample.Resampler(6, 25, device="cpu")
    x = _x((3, 25 * 16), seed=5)
    o, _ = r.process(x, r.initial_state((3,)))
    alone, _ = r.process(x[2], r.initial_state())
    assert torch.equal(o[2], alone)


def test_state_layout_equal_jax_and_convert():
    x = _x(25 * 8, seed=6)
    j = jres.Resampler(6, 25)
    _, jst = j.process(x, j.initial_state())
    jd = jst.to_numpy()
    r = resample.Resampler(6, 25, fir=convert.fir(j.fir), device="cpu")
    st = convert.resampler_state(jd, device="cpu")
    d = st.to_numpy()
    assert set(d) == set(jd)
    for k in jd:
        assert np.array_equal(d[k], jd[k]) and np.asarray(d[k]).dtype == np.asarray(jd[k]).dtype
    o, _ = r.process(x, st)
    jo, _ = j.process(x, jst)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=RES_ATOL)


def test_validation():
    r = resample.Resampler(3, 2, device="cpu")
    with pytest.raises(ValueError, match="not a multiple"):
        r.process(np.zeros(5, np.float32), r.initial_state())
    with pytest.raises(ValueError, match="state shape"):
        r.process(np.zeros((2, 4), np.float32), r.initial_state())
    with pytest.raises(ValueError, match="up/down"):
        resample.Resampler(0, 1, device="cpu")
    assert r.rate_out(48_000.0) == 72_000.0 and r.out_len(8) == 12
