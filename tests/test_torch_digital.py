"""The port's burst modem (``tpu_sdr_torch.kernels.digital``) against
tpu_sdr's, on the CPU.

The same seeded NumPy bursts go to ``BurstModem``/``FSKModem`` of both
packages. Tolerances: bits, indices, frame lags and FSK offsets equal;
timing, CFO and phase within 1e-5 (fp32 estimates from sums taken in
another order: XLA's convolution and reductions against the port's
shifted multiply-adds and fixed-order sums, a few ulps of values near 1);
payload symbols within 1e-4 of max |symbol| (the same, carried through
the cubic resample and the tracker's rotations).
"""

import numpy as np
import pytest
import torch

from tpu_sdr.kernels import digital as jdigital
from tpu_sdr_torch.kernels import digital

from test_digital import _channel

torch.set_num_threads(1)

EST_ATOL = 1e-5
SYM_REL = 1e-4


def _pair(scheme, **kw):
    return (jdigital.BurstModem(scheme, **kw),
            digital.BurstModem(scheme, device="cpu", **kw))


def _compare(jout, tout, n_bits):
    np.testing.assert_array_equal(tout["bits"], np.asarray(jout["bits"]))
    assert tout["bits"].shape[-1] == n_bits
    np.testing.assert_array_equal(tout["frame_lag"].numpy(), np.asarray(jout["frame_lag"]))
    for key in ("timing", "cfo", "phase"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   rtol=0, atol=EST_ATOL, err_msg=key)
    for got, ref in zip(tout["symbols"], jout["symbols"]):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=SYM_REL * np.abs(ref).max())


def test_host_parts_equal():
    for sps, beta in [(4, 0.25), (8, 0.35), (8, 1.0)]:
        np.testing.assert_array_equal(digital.rrc_taps(sps, 16, beta),
                                      jdigital.rrc_taps(sps, 16, beta))
    bits = np.random.default_rng(1).integers(2, size=64).astype(np.uint8)
    for scheme in ("bpsk", "qpsk", "qam16"):
        jm, tm = _pair(scheme)
        np.testing.assert_array_equal(tm.points, jm.points)
        np.testing.assert_array_equal(tm.bit_lut, jm.bit_lut)
        for a, b in zip(tm.modulate(bits, pad_syms=3), jm.modulate(bits, pad_syms=3)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(digital.bits_to_indices(bits, 2),
                                  jdigital.bits_to_indices(bits, 2))
    assert digital.bit_error_rate(bits, bits[::-1]) == jdigital.bit_error_rate(bits, bits[::-1])


@pytest.mark.parametrize("scheme,differential,snr", [
    ("bpsk", True, 14.0), ("qpsk", True, 14.0), ("qpsk", False, 16.0),
    ("qam16", False, 24.0), ("bpsk", False, 14.0)])
def test_burst_demod_matches_jax(scheme, differential, snr):
    rng = np.random.default_rng(hash((scheme, differential)) % 2**32)
    jm, tm = _pair(scheme, sps=4, differential=differential)
    n_bits = 96 * jm.bps
    bits = rng.integers(2, size=n_bits).astype(np.uint8)
    re, im = jm.modulate(bits, pad_syms=jm.max_lag_syms + jm.span)
    re, im = _channel(re, im, delay_samples=1.3, cfo_cps=2e-4 if scheme != "qam16" else 0.0,
                      phase=0.6, snr_db=snr, rng=rng)
    jout = jm.demodulate(re, im, n_bits)
    tout = tm.demodulate(re, im, n_bits)
    _compare(jout, tout, n_bits)
    assert digital.bit_error_rate(bits, tout["bits"]) < 0.05


def test_batched_bursts_match_jax():
    rng = np.random.default_rng(7)
    jm, tm = _pair("qpsk", sps=8, differential=False)
    n_bits = 128
    rows = []
    for d in (0.2, 2.7, 5.1):
        bits = rng.integers(2, size=n_bits).astype(np.uint8)
        re, im = jm.modulate(bits, pad_syms=jm.max_lag_syms + jm.span)
        rows.append(_channel(re, im, delay_samples=d, phase=-1.1, snr_db=15.0, rng=rng))
    re = np.stack([r for r, _ in rows])
    im = np.stack([i for _, i in rows])
    jout = jm.demodulate(re, im, n_bits)
    tout = tm.demodulate(re, im, n_bits)
    assert tout["bits"].shape == (3, n_bits) and tout["timing"].shape == (3,)
    _compare(jout, tout, n_bits)


@pytest.mark.parametrize("differential", [True, False])
def test_frame_lag_at_the_clamp_edge(differential):
    """A burst that starts max_lag_syms symbols into the capture: the
    preamble lag is the last one searched, and the frame slice ends at
    the last resampled symbol."""
    rng = np.random.default_rng(11)
    jm, tm = _pair("qpsk", sps=4, differential=differential)
    n_bits = 64
    bits = rng.integers(2, size=n_bits).astype(np.uint8)
    re, im = jm.modulate(bits, pad_syms=jm.span)
    lead = np.zeros(jm.max_lag_syms * jm.sps, np.float32)
    re, im = np.concatenate([lead, re]), np.concatenate([lead, im])
    re, im = _channel(re, im, phase=0.3, snr_db=30.0, rng=rng)
    n_need = (32 + n_bits // 2 + jm.max_lag_syms + jm.span) * jm.sps
    re, im = re[:n_need], im[:n_need]
    jout = jm.demodulate(re, im, n_bits)
    tout = tm.demodulate(re, im, n_bits)
    assert int(tout["frame_lag"]) == jm.max_lag_syms
    _compare(jout, tout, n_bits)


def test_take_rows_clamps_like_dynamic_slice():
    x = torch.arange(20, dtype=torch.float32).reshape(2, 10)
    got = digital._take_rows(x, torch.tensor([-3, 9]), 4)
    np.testing.assert_array_equal(got.numpy(), [[0, 1, 2, 3], [16, 17, 18, 19]])


@pytest.mark.parametrize("levels,lead_zeros", [(2, 11), (4, 7), (2, 0)])
def test_fsk_matches_jax(levels, lead_zeros):
    rng = np.random.default_rng(levels * 100 + lead_zeros)
    kw = dict(fs=1e6, symbol_rate=125e3, deviation_hz=250e3, levels=levels)
    jm = jdigital.FSKModem(**kw)
    tm = digital.FSKModem(device="cpu", **kw)
    n_bits = 80 * jm.bps
    bits = rng.integers(2, size=n_bits).astype(np.uint8)
    re, im = jm.modulate(bits, pad_syms=2)
    z = np.concatenate([np.zeros(lead_zeros), re + 1j * im])
    z = z + 0.05 * (rng.standard_normal(z.size) + 1j * rng.standard_normal(z.size))
    re, im = z.real.astype(np.float32), z.imag.astype(np.float32)
    jout = jm.demodulate(re, im, n_bits)
    tout = tm.demodulate(re, im, n_bits)
    np.testing.assert_array_equal(tout["bits"], np.asarray(jout["bits"]))
    assert int(tout["offset"]) == int(jout["offset"])
    ref = np.asarray(jout["freqs"])
    np.testing.assert_allclose(tout["freqs"].numpy(), ref, rtol=0, atol=SYM_REL * np.abs(ref).max())
    assert digital.bit_error_rate(bits, tout["bits"]) == 0.0


def test_fsk_no_crossing_takes_the_first_sample():
    """An all-zero capture: no sample passes the threshold, and the onset
    is sample 0, as jnp.argmax of an all-False mask gives."""
    jm = jdigital.FSKModem(1e6, 125e3, 250e3)
    tm = digital.FSKModem(1e6, 125e3, 250e3, device="cpu")
    z = np.zeros(8 * 20, np.float32)
    assert int(tm.demodulate(z, z, 16)["offset"]) == int(jm.demodulate(z, z, 16)["offset"])


def test_validation():
    with pytest.raises(ValueError):
        digital.BurstModem("qam16", differential=True, device="cpu")
    with pytest.raises(ValueError):
        digital.BurstModem("8psk", device="cpu")
    tm = digital.BurstModem("qpsk", device="cpu")
    with pytest.raises(ValueError):
        tm.demodulate(np.zeros(100, np.float32), np.zeros(100, np.float32), 64)
    with pytest.raises(ValueError):
        digital.FSKModem(1e6, 300e3, 10e3, device="cpu")
