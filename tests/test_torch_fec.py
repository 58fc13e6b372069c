"""The port's convolutional code and Viterbi decoder
(``tpu_sdr_torch.kernels.fec``; K3's plain version on the CPU) against
tpu_sdr's.

The same seeded NumPy inputs go to both packages. Encoded bits and
decoded bits must be equal (hard, soft and punctured, k = 3, 7 and 12),
and so must the full trellis decisions of ``viterbi_plain`` and the
reference's ``_viterbi`` on the same depunctured observations: both sum
the branch metrics of +-1 signs (exact products) in index order for two
streams, so the path metrics, and with them every tie, are the same. LLRs
within 1e-6 (fp32 squares and differences of the same values).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpu_sdr.kernels import digital as jdigital
from tpu_sdr.kernels import fec as jfec
from tpu_sdr_torch.kernels import digital, fec
from tpu_sdr_torch.kernels.cuda import launch

from test_digital import _channel

torch.set_num_threads(1)

CODES = {3: (0o7, 0o5), 7: (0o133, 0o171), 12: (0o4335, 0o5723)}


def _pair(k, puncture=None):
    return (jfec.ConvCode(k, CODES[k], puncture=puncture),
            fec.ConvCode(k, CODES[k], puncture=puncture, device="cpu"))


@pytest.mark.parametrize("k", sorted(CODES))
@pytest.mark.parametrize("puncture", [None, "2/3", "3/4"])
def test_encoder_and_tables_match(k, puncture):
    jc, tc = _pair(k, puncture)
    bits = np.random.default_rng(k).integers(2, size=(3, 50)).astype(np.uint8)
    np.testing.assert_array_equal(tc.encode(bits), jc.encode(bits))
    assert tc.coded_len(50) == jc.coded_len(50) and tc.rate == jc.rate
    for name in ("_sign0", "_sign1", "_prev0", "_prev1"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name), err_msg=name)


@pytest.mark.parametrize("k", sorted(CODES))
@pytest.mark.parametrize("puncture", [None, "3/4"])
@pytest.mark.parametrize("kind", ["soft", "hard"])
def test_decode_matches_jax(k, puncture, kind):
    rng = np.random.default_rng(100 * k + (puncture is None) + 7 * (kind == "hard"))
    jc, tc = _pair(k, puncture)
    n_bits = 60 if k == 12 else 120
    bits = rng.integers(2, size=(2, n_bits)).astype(np.uint8)
    coded = jc.encode(bits)
    if kind == "soft":
        soft = ((1.0 - 2.0 * coded) + 0.7 * rng.standard_normal(coded.shape)).astype(np.float32)
        got, ref = tc.decode(soft, n_bits), np.asarray(jc.decode(soft, n_bits))
    else:
        flipped = coded ^ (rng.random(coded.shape) < 0.04).astype(np.uint8)
        got, ref = tc.decode_hard(flipped, n_bits), np.asarray(jc.decode_hard(flipped, n_bits))
    assert got.dtype == np.uint8 and got.shape == (2, n_bits)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("k", sorted(CODES))
def test_plain_trellis_equals_jax_scan(k):
    """All T decisions, tail included, on hard (tie-rich) and soft inputs."""
    jc, tc = _pair(k)
    rng = np.random.default_rng(k + 50)
    t = 40 + k
    for x in (np.sign(rng.standard_normal((3, t, 2))).astype(np.float32),
              rng.standard_normal((3, t, 2)).astype(np.float32)):
        ref = np.asarray(jfec._viterbi(
            jnp.asarray(x), jnp.asarray(jc._prev0), jnp.asarray(jc._prev1),
            jnp.asarray(jc._sign0), jnp.asarray(jc._sign1), k=k))
        got = fec.viterbi_plain(torch.as_tensor(x), tc._tables["sign0"],
                                tc._tables["sign1"], k)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_three_output_streams():
    rng = np.random.default_rng(3)
    polys = (0o133, 0o145, 0o175)
    jc = jfec.ConvCode(7, polys)
    tc = fec.ConvCode(7, polys, device="cpu")
    bits = rng.integers(2, size=80).astype(np.uint8)
    coded = jc.encode(bits)
    np.testing.assert_array_equal(tc.encode(bits), coded)
    soft = ((1.0 - 2.0 * coded) + 0.8 * rng.standard_normal(coded.shape)).astype(np.float32)
    np.testing.assert_array_equal(tc.decode(soft, 80), np.asarray(jc.decode(soft, 80)))


def test_batched_equals_single_and_counts_plain_calls():
    rng = np.random.default_rng(0xFEC)
    tc = fec.ConvCode(7, CODES[7], puncture="2/3", device="cpu")
    bits = rng.integers(2, size=(5, 120)).astype(np.uint8)
    coded = tc.encode(bits)
    noisy = (1.0 - 2.0 * coded) + 0.4 * rng.standard_normal(coded.shape)
    launch.reset_counts()
    batched = tc.decode(noisy, 120)
    assert launch.counts["plain"]["viterbi"] == 1 and launch.counts["kernel"]["viterbi"] == 0
    singles = np.stack([tc.decode(noisy[i], 120) for i in range(5)])
    np.testing.assert_array_equal(batched, singles)
    np.testing.assert_array_equal(batched, bits)


def test_llrs_and_modem_soft_path_match_jax():
    rng = np.random.default_rng(5)
    code_j, code_t = _pair(7)
    jm = jdigital.BurstModem("qpsk", sps=4, differential=False)
    tm = digital.BurstModem("qpsk", sps=4, differential=False, device="cpu")
    n_info = 150
    info = rng.integers(2, size=n_info).astype(np.uint8)
    coded = code_j.encode(info)
    re, im = jm.modulate(coded, pad_syms=4 + jm.max_lag_syms + jm.span)
    re, im = _channel(re, im, delay_samples=0.3, phase=0.5, snr_db=14.0, rng=rng)
    jout = jm.demodulate(re, im, coded.shape[-1])
    tout = tm.demodulate(re, im, coded.shape[-1])
    jl = np.asarray(jfec.modem_soft_bits(jm, *jout["symbols"]))
    tl = fec.modem_soft_bits(tm, *tout["symbols"])
    assert tl.device.type == "cpu" and tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-4)
    decoded = code_t.decode(tl, n_info)
    np.testing.assert_array_equal(decoded, np.asarray(code_j.decode(jl, n_info)))
    assert digital.bit_error_rate(info, decoded) == 0.0
    pts = np.array([1.0 + 0j, -1.0 + 0j])
    lut = np.array([[0], [1]], np.uint8)
    args = (np.array([0.9, -1.1], np.float32), np.array([0.0, 0.0], np.float32), pts, lut)
    np.testing.assert_allclose(fec.max_log_llrs(*args, device="cpu").numpy(),
                               np.asarray(jfec.max_log_llrs(*args)), rtol=0, atol=1e-6)


def test_validation():
    with pytest.raises(ValueError):
        fec.ConvCode(7, (0o133,), device="cpu")
    with pytest.raises(ValueError):
        fec.ConvCode(3, (0o17, 0o5), device="cpu")
    with pytest.raises(ValueError):
        fec.ConvCode(13, (0o133, 0o171), device="cpu")
    with pytest.raises(ValueError):
        fec.ConvCode(7, (0o133, 0o171), puncture="5/6", device="cpu")
    with pytest.raises(ValueError):
        fec.ConvCode(7, CODES[7], device="cpu").decode(np.zeros(13), 10)
    with pytest.raises(ValueError):
        fec.modem_soft_bits(digital.BurstModem("qpsk", differential=True, device="cpu"),
                            np.zeros(4), np.zeros(4))
