"""The port's blind IQ corrector (``tpu_sdr_torch.kernels.iqcorr``) against
tpu_sdr's, on the CPU.

Tolerance: within 1e-5 relative (of max |w|, and of each state moment's
scale): the block moments are sums of 128 products taken in another order
(XLA's reduction against ``ddc.fixed_sum``), a few ulps, carried by the
same EMA chain. Chunked == one-shot bit for bit in the port.
"""

import numpy as np
import pytest
import torch

from tpu_sdr.kernels import iqcorr as jiqcorr
from tpu_sdr_torch import convert
from tpu_sdr_torch.kernels import iqcorr

torch.set_num_threads(1)

REL = 1e-5
FS = 100_000.0


def _image_ratio_db(z, f, fs):
    n = z.size
    spec = np.abs(np.fft.fft(z * np.hanning(n))) ** 2
    k = int(round(f / fs * n))
    return 10 * np.log10(spec[n - k - 1 : n - k + 2].sum() / spec[max(k - 1, 0) : k + 2].sum())


def _close(got, ref):
    ref = np.asarray(ref, np.float64)
    err = np.max(np.abs(np.asarray(got, np.float64) - ref))
    assert err <= REL * max(np.max(np.abs(ref)), 1e-30), err


@pytest.mark.parametrize("leak,shape", [(0.95, ()), (0.99, (3,)), (0.0, (2, 2))])
def test_matches_jax(leak, shape):
    rng = np.random.default_rng(int(leak * 100) + len(shape))
    t = 4096
    z = (rng.standard_normal(shape + (t,)) + 1j * rng.standard_normal(shape + (t,))) / 2
    zi = jiqcorr.apply_imbalance(z, 1.5, -4.0)
    np.testing.assert_array_equal(iqcorr.apply_imbalance(z, 1.5, -4.0), zi)
    re, im = zi.real.astype(np.float32), zi.imag.astype(np.float32)
    jc = jiqcorr.IQCorrector(leak=leak)
    tc = iqcorr.IQCorrector(leak=leak, device="cpu")
    jr, ji, jst = jc.process(re, im, jc.initial_state(shape))
    tr, ti, tst = tc.process(re, im, tc.initial_state(shape))
    _close(tr, jr)
    _close(ti, ji)
    for key in ("m2re", "m2im", "power"):
        _close(getattr(tst, key), getattr(jst, key))
    assert tst.offset == jst.offset == t
    np.testing.assert_allclose(tst.estimate(), jst.estimate(), rtol=1e-4, atol=1e-7)


def test_image_rejection_improves():
    t_len = 1 << 16
    f = 12_300.0
    z = np.exp(2j * np.pi * f * np.arange(t_len) / FS)
    zi = iqcorr.apply_imbalance(z, gain_db=1.0, phase_deg=5.0)
    before = _image_ratio_db(zi[-16384:], f, FS)
    corr = iqcorr.IQCorrector(leak=0.95, device="cpu")
    wre, wim, _ = corr.process(zi.real.astype(np.float32), zi.imag.astype(np.float32),
                               corr.initial_state())
    after = _image_ratio_db(wre.numpy()[-16384:] + 1j * wim.numpy()[-16384:], f, FS)
    assert before > -30 and after < before - 25


def test_chunked_equals_oneshot_bitwise_and_checkpoint():
    rng = np.random.default_rng(3)
    t = 4096
    re = rng.standard_normal((2, t)).astype(np.float32)
    im = rng.standard_normal((2, t)).astype(np.float32)
    tc = iqcorr.IQCorrector(device="cpu")
    r1, i1, _ = tc.process(re, im, tc.initial_state((2,)))
    st = tc.initial_state((2,))
    outs_r, outs_i = [], []
    for k, n in ((0, 512), (512, 128), (640, 3456)):
        r, i, st = tc.process(re[:, k : k + n], im[:, k : k + n], st)
        outs_r.append(r)
        outs_i.append(i)
    assert torch.equal(torch.cat(outs_r, -1), r1) and torch.equal(torch.cat(outs_i, -1), i1)
    # a JAX checkpoint carried across continues within the tolerance
    jc = jiqcorr.IQCorrector()
    _, _, jst = jc.process(re[:, :1024], im[:, :1024], jc.initial_state((2,)))
    restored = convert.iqcorr_state(jst.to_numpy(), device="cpu")
    assert restored.offset == 1024 and restored.power.dtype == torch.float32
    jr, _, _ = jc.process(re[:, 1024:], im[:, 1024:], jst)
    tr, _, _ = tc.process(re[:, 1024:], im[:, 1024:], restored)
    _close(tr, jr)


def test_validation():
    with pytest.raises(ValueError):
        iqcorr.IQCorrector(leak=1.0, device="cpu")
    tc = iqcorr.IQCorrector(device="cpu")
    with pytest.raises(ValueError):
        tc.process(np.zeros(100, np.float32), np.zeros(100, np.float32), tc.initial_state())
    with pytest.raises(ValueError):
        tc.process(np.zeros(128, np.float32), np.zeros(128, np.float32), tc.initial_state((2,)))
