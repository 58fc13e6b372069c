"""The port's RDS encoder and decoder (``tpu_sdr_torch.kernels.rds``)
against tpu_sdr's, on the CPU.

The encoder is host NumPy in both packages: bit streams, waveforms and
multiplexes equal. The decoder's device steps sum in other orders than
XLA's; its results must be equal: PI, PTY, TP, PS, RadioText, the group
counts and the validated block count, on the same captures (clean, and
with a pilot offset and noise).
"""

import numpy as np
import pytest
import torch

from tpu_sdr.kernels import rds as jrds
from tpu_sdr_torch.kernels import rds

torch.set_num_threads(1)

FS = 200e3


def _mpx(n, pilot_hz=19000.0, snr_db=None, seed=0):
    t = np.arange(n) / FS
    left = 0.6 * np.sin(2 * np.pi * 1000 * t)
    right = 0.6 * np.sin(2 * np.pi * 2500 * t)
    kw = dict(pi=0xC0DE, pty=4, ps="TPU SDR ", radiotext="PORTED RADIOTEXT 10")
    jenc, tenc = jrds.RDSEncoder(**kw), rds.RDSEncoder(**kw)
    np.testing.assert_array_equal(tenc.bit_stream(24), jenc.bit_stream(24))
    np.testing.assert_array_equal(tenc.waveform(3), jenc.waveform(3))
    jm = jrds.make_mpx_rds(left, right, FS, jenc, n_groups=32, pilot_hz=pilot_hz)
    tm = rds.make_mpx_rds(left, right, FS, tenc, n_groups=32, pilot_hz=pilot_hz)
    np.testing.assert_array_equal(tm, jm)
    if snr_db is not None:
        tm = tm + 10 ** (-snr_db / 20) * np.random.default_rng(seed).standard_normal(n)
    return tm


def _same(a, b):
    for key in ("pi", "pty", "tp", "ps_name", "radiotext", "groups", "n_blocks"):
        assert getattr(a, key) == getattr(b, key), key
    assert a.block_error_rate == pytest.approx(b.block_error_rate, abs=0)


@pytest.mark.parametrize("pilot_hz,snr_db", [(19000.0, None), (19002.0, 26.0)])
def test_decode_matches_jax(pilot_hz, snr_db):
    m = _mpx(1 << 19, pilot_hz, snr_db, seed=7)
    got = rds.RDSDecoder(FS, device="cpu").decode(m)
    ref = jrds.RDSDecoder(FS).decode(m)
    _same(got, ref)
    assert got.pi == 0xC0DE and got.ps_name == "TPU SDR "
    if snr_db is None:
        assert got.radiotext == "PORTED RADIOTEXT 10" and got.pty == 4
        assert got.groups.get("0A", 0) > 0 and got.groups.get("2A", 0) > 0


def test_device_steps_match_jax():
    """The two device helpers on the same baseband, against the
    reference's jitted ones: the coarse CFO and block sums within 1e-5 of
    their scale, the hypotheses' soft values within 1e-5 of theirs. The
    baseband is what the decoder sees there, biphase BPSK at 16 samples a
    bit on a carrier 2 Hz from DC, with noise (on a random carrier, a
    1-ulp difference of the CFO turns the ramp's phase at sample 4,000 by
    ~1e-4 rad)."""
    rng = np.random.default_rng(2)
    t = 190 * 20 + 37
    n = np.arange(t)
    sym = np.repeat(rng.choice([-1.0, 1.0], size=t // 16 + 1), 16)[:t]
    z = sym * np.exp(2j * np.pi * 2.0 / 19e3 * n + 0.4j)
    z = z + 0.3 * (rng.standard_normal(t) + 1j * rng.standard_normal(t))
    zre, zim = z.real.astype(np.float32), z.imag.astype(np.float32)
    jc, jbr, jbi = jrds._rds_carrier_recover(zre, zim)
    tc, tbr, tbi = rds._rds_carrier_recover(torch.as_tensor(zre), torch.as_tensor(zim))
    assert abs(float(tc) - float(jc)) < 1e-5
    for got, ref in ((tbr, jbr), (tbi, jbi)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() < 1e-5 * np.abs(ref).max()
    ph = rng.uniform(-3, 3, t).astype(np.float32)
    h = np.float32(rds.rrc_taps(8, span=6, beta=1.0))
    js, jmet = jrds._rds_apply_phase(zre, zim, ph, h)
    ts, tmet = rds._rds_apply_phase(torch.as_tensor(zre), torch.as_tensor(zim),
                                    torch.as_tensor(ph), h)
    js = np.asarray(js)
    assert ts.shape == js.shape
    assert np.abs(ts.numpy() - js).max() < 1e-5 * np.abs(js).max()
    np.testing.assert_allclose(tmet.numpy(), np.asarray(jmet), rtol=1e-5)


def test_codec_and_parse_match_jax():
    rng = np.random.default_rng(0x2D5)
    for off in rds.OFFSET_WORDS:
        info = int(rng.integers(1 << 16))
        np.testing.assert_array_equal(rds.encode_block(info, off), jrds.encode_block(info, off))
    bits = rng.integers(2, size=2000).astype(np.uint8)
    np.testing.assert_array_equal(rds._syndromes(bits), jrds._syndromes(bits))
    raw = rds.RDSEncoder(radiotext="X").bit_stream(30)
    plain = np.concatenate([[0], raw[1:] ^ raw[:-1]]).astype(np.uint8)
    _same(rds._parse_bits(plain), jrds._parse_bits(plain))


def test_decoder_validation():
    with pytest.raises(ValueError):
        rds.RDSDecoder(fs=123456.0, device="cpu")
    dec = rds.RDSDecoder(FS, device="cpu")
    res = dec.decode(np.zeros(4096, np.float32))
    assert res.pi is None and res.n_blocks == 0
    assert dec.min_samples(12) == jrds.RDSDecoder(FS).min_samples(12)
