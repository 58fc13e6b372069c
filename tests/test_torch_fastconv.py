"""The port's overlap-save FIR (``tpu_sdr_torch.kernels.fastconv``) against
tpu_sdr's, on the CPU.

Tolerance: within 1e-5 of max |y| of the reference at ``f32max`` (both
are fp32 four-step DFT round trips of the same frames, whose sums run in
other orders, each about 1e-6 of the scale from float64
``scipy.signal.lfilter``), and the port within the reference's own bound
of lfilter. Chunked == one-shot bit for bit in the port, with one MKL
thread (ROADMAP C3).
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from tpu_sdr.kernels import fastconv as jfastconv
from tpu_sdr_torch import convert
from tpu_sdr_torch.kernels import fastconv

torch.set_num_threads(1)

REL = 1e-5


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) or 1.0)


def _pair(h, **kw):
    return jfastconv.FastFIR(h, **kw), fastconv.FastFIR(h, device="cpu", **kw)


@pytest.mark.parametrize("n_taps", [33, 129, 1025])
def test_real_taps_match_jax_and_lfilter(n_taps):
    rng = np.random.default_rng(n_taps)
    h = sps.firwin(n_taps, 0.21)
    jf, tf = _pair(h)
    assert (tf.nfft, tf.block, tf.history) == (jf.nfft, jf.block, jf.history)
    x = rng.standard_normal((2, 3 * tf.chunk_granularity)).astype(np.float32)
    jout, jst = jf.process(x, jf.initial_state((2,)))
    tout, tst = tf.process(x, tf.initial_state((2,)))
    assert _rel_err(tout, np.asarray(jout)) < REL
    assert _rel_err(tout, sps.lfilter(h, 1.0, x.astype(np.float64), axis=-1)) < 2e-6
    np.testing.assert_array_equal(tst.tail.numpy(), np.asarray(jst.tail))
    assert tst.offset == jst.offset


def test_complex_taps_and_planes_match_jax():
    rng = np.random.default_rng(4)
    h = sps.firwin(257, 0.2) * np.exp(2j * np.pi * 0.1 * np.arange(257))
    jf, tf = _pair(h)
    g = tf.chunk_granularity
    planes = rng.standard_normal((2, 2 * g)).astype(np.float32)
    jout, _ = jf.process_planes(planes, jf.initial_state())
    tout, _ = tf.process_planes(planes, tf.initial_state())
    assert _rel_err(tout, np.asarray(jout)) < REL
    z = planes[0].astype(np.float64) + 1j * planes[1]
    want = sps.lfilter(h, 1.0, z)
    got = tout[0].numpy() + 1j * tout[1].numpy()
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-6
    # real taps on planes filter each plane
    jr, tr = _pair(sps.firwin(65, 0.3))
    p = rng.standard_normal((2, 3, 2 * tr.chunk_granularity)).astype(np.float32)
    jo, _ = jr.process_planes(p, jr.initial_state((3,), iq=True))
    to, _ = tr.process_planes(p, tr.initial_state((3,), iq=True))
    assert _rel_err(to, np.asarray(jo)) < REL


def test_chunked_equals_oneshot_bitwise():
    rng = np.random.default_rng(9)
    tf = fastconv.FastFIR(sps.firwin(129, 0.4), device="cpu")
    g = tf.chunk_granularity
    x = rng.standard_normal((3, 8 * g)).astype(np.float32)
    one, _ = tf.process(x, tf.initial_state((3,)))
    for split in [(4, 4), (1, 2, 5), (2, 1, 1, 4)]:
        st = tf.initial_state((3,))
        outs, pos = [], 0
        for nblk in split:
            o, st = tf.process(x[:, pos : pos + nblk * g], st)
            outs.append(o)
            pos += nblk * g
        assert torch.equal(torch.cat(outs, dim=-1), one), split


def test_complex_chunked_bitwise_and_checkpoint():
    rng = np.random.default_rng(10)
    h = sps.firwin(97, 0.25) * np.exp(2j * np.pi * -0.05 * np.arange(97))
    jf, tf = _pair(h, nfft=1024)
    g = tf.chunk_granularity
    planes = rng.standard_normal((2, 5 * g)).astype(np.float32)
    one, _ = tf.process_planes(planes, tf.initial_state())
    a, st = tf.process_planes(planes[:, : 2 * g], tf.initial_state())
    b, _ = tf.process_planes(planes[:, 2 * g :], st)
    assert torch.equal(torch.cat([a, b], dim=-1), one)
    # a JAX checkpoint restored mid-stream continues the port bit for bit
    _, jst = jf.process_planes(planes[:, : 2 * g], jf.initial_state())
    restored = convert.fastfir_state(jst.to_numpy(), device="cpu")
    np.testing.assert_array_equal(restored.tail.numpy(), st.tail.numpy())
    assert restored.offset == st.offset == 2 * g
    c, _ = tf.process_planes(planes[:, 2 * g :], restored)
    assert torch.equal(c, b)


def test_auto_nfft_and_block_rules():
    for n in (2, 33, 257, 1025, 4097, 8191, 40000):
        assert fastconv._auto_nfft(n) == jfastconv._auto_nfft(n)
    assert fastconv._NFFT_PLANS == jfastconv._NFFT_PLANS
    tf = fastconv.FastFIR(sps.firwin(129, 0.3), nfft=2048, block=1000, device="cpu")
    assert tf.chunk_granularity == 1000 and tf.history == 1048


def test_validation():
    with pytest.raises(ValueError):
        fastconv.FastFIR([1.0], device="cpu")
    with pytest.raises(ValueError):
        fastconv.FastFIR(np.ones(33), nfft=3000, device="cpu")
    with pytest.raises(ValueError):
        fastconv.FastFIR(np.ones(2000), nfft=1024, device="cpu")
    tf = fastconv.FastFIR(np.ones(33), device="cpu")
    with pytest.raises(ValueError):
        tf.process(np.zeros(tf.block + 1, np.float32), tf.initial_state())
    with pytest.raises(ValueError):
        fastconv.FastFIR(np.ones(33) * 1j, device="cpu").process(
            np.zeros(1000, np.float32), None)
