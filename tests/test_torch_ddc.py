"""The port's digital down-converter (``tpu_sdr_torch.kernels.ddc``) against
tpu_sdr's, on the CPU.

Inputs come from seeded NumPy generators and go to both packages. The FIR
designs, tuning words and the NCO's 32-bit phases must equal the JAX
package's exactly; the mixed and decimated outputs agree within
``DDC_ATOL``. Within the port, chunked == one-shot, each batch row == that
row alone and ``DDCBank`` == K independent ``DDC`` instances, bit for bit.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpu_sdr.kernels import ddc as jddc
from tpu_sdr_torch import convert
from tpu_sdr_torch.kernels import ddc

torch.set_num_threads(1)

FS = 1_000_000.0
# Port vs JAX on unit-scale inputs: both round the same float32 carrier
# angle, but XLA's and PyTorch's float32 cos/sin differ by up to 2 ulps
# (2.4e-7 at 1.0); each output sums P*R (<= 96 here) products of such
# carriers with unit-scale samples and FIR taps of unit total gain, so the
# outputs differ by a few ulps of their magnitude. Measured worst: 6e-8.
DDC_ATOL = 1e-6
# The carrier alone: 2 ulps at 1.0.
NCO_ATOL = 2.4e-7


def _real(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_ddc(kw, x, iq, state=None):
    d = jddc.DDC(**kw)
    st = d.initial_state(x.shape[1:-1] if iq else x.shape[:-1]) if state is None else state
    run = d.process_planes if iq else d.process
    out, st = run(x, st)
    return np.asarray(out["re"]), np.asarray(out["im"]), st


@pytest.mark.parametrize("r,taps", [(2, 8), (5, 12), (8, 8), (80, 12)])
def test_fir_design_equals_jax(r, taps):
    got = ddc.design_decimation_fir(r, taps)
    want = jddc.design_decimation_fir(r, taps)
    assert got.dtype == np.float64 and np.array_equal(got, want)
    assert np.array_equal(ddc.DDC(decimation=r, taps_per_phase=taps, device="cpu").fir,
                          jddc.DDC(decimation=r, taps_per_phase=taps).fir)


@pytest.mark.parametrize("center", [100e3, -123_456.7, 499_999.9, 3e6, -2.75e6, 0.0])
def test_tuning_word_and_alias_equal_jax(center):
    w = ddc._tuning_word(FS, center)
    assert w == jddc._tuning_word(FS, center)
    assert ddc._principal_alias_hz(FS, w) == jddc._principal_alias_hz(FS, w)
    assert (ddc.DDC(FS, center, device="cpu").realized_center_hz
            == jddc.DDC(FS, center).realized_center_hz)


@pytest.mark.parametrize("offset", [0, 12_345, 10**10, 2**40 + 3])
@pytest.mark.parametrize("center", [100e3, -123_456.7, 3e6])
def test_nco_phase_equals_jax_uint32(offset, center):
    """The int64 accumulator equals JAX's wrapping uint32 one bit for bit
    before the float conversion, for long offsets that wrap 2^32 many times
    and negative tunes, and so does the float32 phase after it."""
    t = 4096
    word = jddc._tuning_word(FS, center)
    phase0 = (offset * word) % (1 << 32)
    n = jnp.arange(t, dtype=jnp.uint32)
    want = np.asarray(jnp.uint32(phase0) + n * jnp.uint32(word))
    got = ddc._nco_phase(ddc._u32(phase0, "cpu"), ddc._u32(word, "cpu"), t)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert np.array_equal(got.to(torch.float32).numpy(), want.astype(np.float32))
    jc, js = jddc._nco_cos_sin(jnp.uint32(phase0), jnp.uint32(word), t)
    c, s = ddc._nco_cos_sin(ddc._u32(phase0, "cpu"), ddc._u32(word, "cpu"), t)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=NCO_ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=NCO_ATOL)


@pytest.mark.parametrize("iq", [False, True], ids=["real", "iq"])
@pytest.mark.parametrize("batch", [(), (3,)], ids=["1d", "3ch"])
@pytest.mark.parametrize("center,r", [(123_456.7, 8), (-200e3, 5), (250e3, 1)])
def test_ddc_matches_jax(iq, batch, center, r):
    kw = dict(fs=FS, center_hz=center, decimation=r)
    x = _real(((2,) if iq else ()) + batch + (r * 512,), seed=1)
    jre, jim, jst = _jax_ddc(kw, x, iq)
    d = ddc.DDC(**kw, device="cpu")
    out, st = (d.process_planes if iq else d.process)(x, d.initial_state(batch))
    assert out["re"].shape == jre.shape and out["re"].dtype == torch.float32
    np.testing.assert_allclose(out["re"].numpy(), jre, rtol=0, atol=DDC_ATOL)
    np.testing.assert_allclose(out["im"].numpy(), jim, rtol=0, atol=DDC_ATOL)
    np.testing.assert_allclose(st.tail_re.numpy(), np.asarray(jst.tail_re), rtol=0,
                               atol=DDC_ATOL)
    assert st.offset == jst.offset


def test_ddc_against_float64_golden():
    """lfilter(h, 1, x * exp(-j w n))[R-1::R] in float64."""
    import scipy.signal as sps

    r, fc = 8, 123_456.7
    x = _real(4096, seed=2)
    d = ddc.DDC(FS, fc, r, device="cpu")
    out, _ = d.process(x, d.initial_state())
    fc_q = d.realized_center_hz
    y = x * np.exp(-2j * np.pi * fc_q / FS * np.arange(x.size))
    ref = sps.lfilter(d.fir, 1.0, y)[r - 1 :: r]
    got = out["re"].numpy() + 1j * out["im"].numpy()
    assert np.abs(got - ref).max() < 1e-5


@pytest.mark.parametrize("iq", [False, True], ids=["real", "iq"])
def test_chunked_equals_oneshot_bitwise(iq):
    """Uneven chunks, one shorter than the carried history."""
    r = 8
    d = ddc.DDC(FS, 187_500.3, r, device="cpu")
    x = _real(((2,) if iq else ()) + (2, r * 300), seed=3)
    run = d.process_planes if iq else d.process
    one, st_one = run(x, d.initial_state((2,)))
    st, parts, pos = d.initial_state((2,)), [], 0
    for n in (r * 3, r * 100, r * 1, r * 196):
        out, st = run(x[..., pos : pos + n], st)
        parts.append(out)
        pos += n
    for k in ("re", "im"):
        assert torch.equal(torch.cat([p[k] for p in parts], dim=-1), one[k])
    assert torch.equal(st.tail_re, st_one.tail_re) and torch.equal(st.tail_im, st_one.tail_im)
    assert st.offset == st_one.offset == r * 300


def test_batch_row_equals_row_alone():
    d = ddc.DDC(FS, -77_000.0, 5, device="cpu")
    x = _real((3, 5 * 256), seed=4)
    out, _ = d.process(x, d.initial_state((3,)))
    alone, _ = d.process(x[1], d.initial_state())
    assert torch.equal(out["re"][1], alone["re"]) and torch.equal(out["im"][1], alone["im"])


@pytest.mark.parametrize("iq", [False, True], ids=["real", "iq"])
def test_ddcbank_equals_independent_ddcs(iq):
    centers = (100e3, -250_000.5, 333_333.0, 3e6)
    bank = ddc.DDCBank(FS, centers, decimation=8, device="cpu")
    x = _real(((2,) if iq else ()) + (2, 8 * 200), seed=5)
    run = bank.process_planes if iq else bank.process
    st = bank.initial_state((2,))
    outs = []
    for chunk in (x[..., : 8 * 50], x[..., 8 * 50 :]):
        o, st = run(chunk, st)
        outs.append(o)
    for k, c in enumerate(centers):
        d = ddc.DDC(FS, c, 8, device="cpu")
        drun = d.process_planes if iq else d.process
        ds = d.initial_state((2,))
        for chunk, o in zip((x[..., : 8 * 50], x[..., 8 * 50 :]), outs):
            do, ds = drun(chunk, ds)
            assert torch.equal(o["re"][k], do["re"]) and torch.equal(o["im"][k], do["im"])
    assert bank.realized_centers_hz == jddc.DDCBank(FS, centers, 8).realized_centers_hz


def test_ddcbank_matches_jax():
    centers = (100e3, -250_000.5)
    x = _real((2, 8 * 128), seed=6)
    jb = jddc.DDCBank(FS, centers, decimation=8)
    jo, _ = jb.process(x, jb.initial_state((2,)))
    b = ddc.DDCBank(FS, centers, decimation=8, device="cpu")
    o, _ = b.process(x, b.initial_state((2,)))
    np.testing.assert_allclose(o["re"].numpy(), np.asarray(jo["re"]), rtol=0, atol=DDC_ATOL)
    np.testing.assert_allclose(o["im"].numpy(), np.asarray(jo["im"]), rtol=0, atol=DDC_ATOL)


@pytest.mark.parametrize("center", [-123_456.7, 310e3])
def test_long_offset_state_from_jax(center):
    """A JAX state at a sample offset past 2^32 resumes in the port, whose
    chunk then matches JAX's."""
    x = _real((2, 8 * 64), seed=7)
    jd = jddc.DDC(FS, center, 8)
    jst = jddc.DDCState.from_numpy({**jd.initial_state((2,)).to_numpy(),
                                    "offset": np.int64(10**10 + 8)})
    jre, jim, _ = _jax_ddc(dict(fs=FS, center_hz=center, decimation=8), x, False, jst)
    d = ddc.DDC(FS, center, 8, device="cpu")
    out, st = d.process(x, convert.ddc_state(jst.to_numpy(), device="cpu"))
    np.testing.assert_allclose(out["re"].numpy(), jre, rtol=0, atol=DDC_ATOL)
    np.testing.assert_allclose(out["im"].numpy(), jim, rtol=0, atol=DDC_ATOL)
    assert st.offset == 10**10 + 8 + x.shape[-1]


def test_state_layout_equals_jax():
    x = _real(8 * 64, seed=8)
    _, _, jst = _jax_ddc(dict(fs=FS, center_hz=1e5, decimation=8), x, False)
    d = ddc.DDC(FS, 1e5, 8, device="cpu")
    _, st = d.process(x, d.initial_state())
    jd_, pd_ = jst.to_numpy(), st.to_numpy()
    assert set(jd_) == set(pd_)
    for k in jd_:
        assert np.asarray(pd_[k]).dtype == np.asarray(jd_[k]).dtype, k
        assert np.shape(pd_[k]) == np.shape(jd_[k]), k
    back = jddc.DDCState.from_numpy(pd_)
    assert back.offset == st.offset


def test_validation_and_default_device(monkeypatch):
    d = ddc.DDC(decimation=8, device="cpu")
    with pytest.raises(ValueError, match="not a multiple"):
        d.process(np.zeros(100, np.float32), d.initial_state())
    with pytest.raises(ValueError, match="state shape"):
        d.process(np.zeros((2, 64), np.float32), d.initial_state())
    with pytest.raises(ValueError, match="decimation"):
        ddc.DDC(decimation=0, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        ddc.DDCBank(centers_hz=(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ddc.DDC()


def test_fixed_sum_is_shape_independent():
    x = torch.tensor(_real((5, 7, 83), seed=9))
    whole = ddc.fixed_sum(x)
    assert torch.equal(ddc.fixed_sum(x[2:3, 4:6]), whole[2:3, 4:6])
    np.testing.assert_allclose(whole.numpy(), x.double().sum(-1).numpy(), rtol=0, atol=1e-5)
