"""The port's demodulators (``tpu_sdr_torch.kernels.demod``) and the FM
kernel's plain version (``kernels/cuda/affine_scan.fm_demod_plain``)
against tpu_sdr's, on the CPU.

The JAX FM kernel runs as its own tests run it on the CPU, in Pallas
interpret mode (``fm_demod_pallas(..., interpret=True)``, or
``FMDemodulator(use_pallas=True)``, which interprets on the CPU). Inputs
come from seeded NumPy generators and go to both packages.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpu_sdr.kernels import demod as jdemod
from tpu_sdr.kernels.pallas import affine_scan as jscan
from tpu_sdr_torch import convert
from tpu_sdr_torch.kernels import demod
from tpu_sdr_torch.kernels.cuda import affine_scan, launch

torch.set_num_threads(1)

FS = 100_000.0
DEV = 5_000.0
# The FM kernel's plain version vs the JAX kernel in interpret mode: the
# same polynomial atan2 and tree, but interpret mode runs through XLA, whose
# constant folds move results by about an ulp (tests/test_pallas_kernel.py).
KERNEL_ATOL = 1e-6
# FM paths across the packages and between the port's two paths: atan2
# implementations that differ by up to ~3e-7 rad (the polynomial, XLA's
# arctan2 and the port's torch.atan-based atan2_ieee), scaled by
# fs / (2 pi dev) = 3.2 here (tests/test_demod.py's bound).
FM_ATOL = 2e-6
# AM, SSB, AGC: float32 cos/sin (SSB's BFO) differ by up to 2 ulps between
# XLA and PyTorch; the envelope and loops add a few ulps of unit-scale
# values. Measured worst: 2.4e-7.
STAGE_ATOL = 2e-6


def _fm_signal(t, f=700.0, fs=FS, dev=DEV):
    msg = np.sin(2 * np.pi * f * np.arange(t) / fs)
    phase = 2 * np.pi * dev / fs * np.cumsum(msg)
    return np.cos(phase).astype(np.float32), np.sin(phase).astype(np.float32)


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _peak_hz(x, fs):
    spec = np.abs(np.fft.rfft(x * np.hanning(x.size)))
    return np.argmax(spec) * fs / x.size


# ------------------------------------------------------ the FM kernel


@pytest.mark.parametrize("pole", [None, 0.9997])
def test_fm_plain_matches_jax_kernel_interpret(pole):
    """Mirrors tests/test_pallas_kernel.py TestFMDemodPallas."""
    c, t = 4, 2 * 64 * 128
    re, im = _planes((c, t), 0)
    rng = np.random.default_rng(1)
    pr, pi = (0.5 * rng.standard_normal((c, 1))).astype(np.float32), np.zeros((c, 1), np.float32)
    y0 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    kw = dict(fs=2e5, dev=75e3, pole=pole)
    want = jscan.fm_demod_pallas(*(jnp.asarray(a) for a in (re, im, pr, pi, y0)),
                                 interpret=True, **kw)
    got = affine_scan.fm_demod_pallas(*(torch.tensor(a) for a in (re, im, pr, pi, y0)), **kw)
    for g, w, name in zip(got, want, ("audio", "prev_re", "prev_im", "filt")):
        assert tuple(g.shape) == np.shape(w), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=KERNEL_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("pole", [None, 0.9997])
def test_fm_plain_carried_state_chunking_bitwise(pole):
    c, t = 3, 8 * 128
    re, im = (torch.tensor(a) for a in _planes((c, t), 2))
    z = torch.zeros((c, 1))
    y0 = torch.zeros(c)
    kw = dict(fs=2e5, dev=75e3, pole=pole)
    full = affine_scan.fm_demod_plain(re, im, z, z, y0, **kw)
    h = 3 * 128
    a1 = affine_scan.fm_demod_plain(re[:, :h], im[:, :h], z, z, y0, **kw)
    a2 = affine_scan.fm_demod_plain(re[:, h:], im[:, h:], *a1[1:], **kw)
    assert torch.equal(torch.cat([a1[0], a2[0]], dim=1), full[0])
    for g, w in zip(a2[1:], full[1:]):
        assert torch.equal(g, w)


# The CUDA kernel's edge shapes, (channels, blocks of 128, the reference's
# rows_per_tile): one block; one stage of the kernel's chain
# (csrc/affine_chain.cuh, 1024 blocks) less one and plus one; many channels
# of one block. tests/test_torch_cuda.py holds the kernel to the plain
# version at these shapes, bit for bit.
FM_EDGE_SHAPES = [(3, 1, 1), (2, 1023, 31), (2, 1025, 41), (300, 1, 1)]


@pytest.mark.parametrize("c,blocks,rows", FM_EDGE_SHAPES)
def test_fm_plain_edge_shapes_match_jax_and_chunk(c, blocks, rows):
    """The plain version with de-emphasis at the kernel's edge shapes:
    within the kernel bound of the JAX kernel in interpret mode, and two
    chunks of ``blocks`` blocks == one call of twice as many, bit for bit."""
    t = blocks * 128
    re, im = (torch.tensor(a) for a in _planes((c, 2 * t), 5))
    rng = np.random.default_rng(6)
    pr, pi = (torch.tensor((0.5 * rng.standard_normal((c, 1))).astype(np.float32))
              for _ in range(2))
    y0 = torch.tensor((0.1 * rng.standard_normal(c)).astype(np.float32))
    kw = dict(fs=2e5, dev=75e3, pole=0.9997)
    head = (re[:, :t], im[:, :t], pr, pi, y0)
    want = jscan.fm_demod_pallas(*(jnp.asarray(a.numpy()) for a in head), rows_per_tile=rows,
                                 interpret=True, **kw)
    got = affine_scan.fm_demod_pallas(*head, rows_per_tile=rows, **kw)
    for g, w, name in zip(got, want, ("audio", "prev_re", "prev_im", "filt")):
        assert tuple(g.shape) == np.shape(w), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=KERNEL_ATOL,
                                   err_msg=name)
    full = affine_scan.fm_demod_plain(re, im, pr, pi, y0, **kw)
    tail = affine_scan.fm_demod_plain(re[:, t:], im[:, t:], *got[1:], **kw)
    assert torch.equal(torch.cat([got[0], tail[0]], dim=1), full[0])
    for g, w in zip(tail[1:], full[1:]):
        assert torch.equal(g, w)


def test_fm_kernel_validation_and_counts():
    re, im = (torch.tensor(a) for a in _planes((2, 64 * 128), 3))
    z, y0 = torch.zeros((2, 1)), torch.zeros(2)
    with pytest.raises(ValueError, match="tile width"):
        affine_scan.fm_demod_pallas(re[:, :100], im[:, :100], z, z, y0,
                                    fs=2e5, dev=75e3, pole=None)
    launch.reset_counts()
    affine_scan.fm_demod_pallas(re, im, z, z, y0, fs=2e5, dev=75e3, pole=0.99,
                                interpret=True)
    assert launch.counts["plain"]["fm_demod"] == 1
    assert not any(launch.counts["kernel"].values())


def test_atan2_poly_matches_jax_and_ieee_zeros():
    rng = np.random.default_rng(3)
    y = rng.standard_normal(50_000).astype(np.float32)
    x = rng.standard_normal(50_000).astype(np.float32)
    got = affine_scan._atan2_poly(torch.tensor(y), torch.tensor(x)).numpy()
    want = np.asarray(jscan._atan2_poly(jnp.asarray(y), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
    zeros = [(0.0, 0.0), (-0.0, 0.0), (0.0, -0.0), (-0.0, -0.0), (1.0, -0.0), (-0.0, -1.0)]
    yz = torch.tensor([a for a, _ in zeros])
    xz = torch.tensor([b for _, b in zeros])
    ref = np.arctan2(yz.numpy(), xz.numpy())
    for fn in (affine_scan._atan2_poly, demod.atan2_ieee):
        out = fn(yz, xz).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=3e-7)
        assert np.array_equal(np.signbit(out), np.signbit(ref))


def test_atan2_ieee_accuracy_and_position_invariance():
    """atan2_ieee (the default FM path's atan2) is within 3e-7 rad of the
    float64 atan2, and a sample's bits do not depend on where it sits in
    the array (torch.atan2's CPU kernel fails this)."""
    rng = np.random.default_rng(4)
    y = torch.tensor(rng.standard_normal(20_003).astype(np.float32))
    x = torch.tensor(rng.standard_normal(20_003).astype(np.float32))
    whole = demod.atan2_ieee(y, x)
    ref = np.arctan2(y.double().numpy(), x.double().numpy())
    assert np.abs(whole.double().numpy() - ref).max() < 3e-7
    for s, n in ((0, 1), (3, 17), (5, 45), (1000, 33), (7, 20_000)):
        assert torch.equal(demod.atan2_ieee(y[s : s + n], x[s : s + n]), whole[s : s + n])


# ---------------------------------------------------- FMDemodulator paths


def _fm_pair(tau, use_pallas):
    j = jdemod.FMDemodulator(FS, deviation_hz=DEV, deemphasis_tau=tau, use_pallas=use_pallas)
    p = demod.FMDemodulator(FS, deviation_hz=DEV, deemphasis_tau=tau, use_pallas=use_pallas,
                            device="cpu")
    return j, p


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "kernel"])
@pytest.mark.parametrize("tau", [None, 75e-6])
def test_fm_matches_jax(tau, use_pallas):
    re, im = _fm_signal(4096)
    j, p = _fm_pair(tau, use_pallas)
    ja, jst = j.process(re, im, j.initial_state())
    pa, st = p.process(re, im, p.initial_state())
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=0, atol=FM_ATOL)
    np.testing.assert_allclose(st.filt.numpy(), np.asarray(jst.filt), rtol=0, atol=FM_ATOL)
    assert torch.equal(st.prev_re, torch.tensor(np.asarray(jst.prev_re)))


@pytest.mark.parametrize("tau", [None, 75e-6])
def test_fm_kernel_path_matches_xla_path(tau):
    """Mirrors tests/test_demod.py test_fm_pallas_path_matches_xla."""
    re, im = _fm_signal(4096)
    xla = demod.FMDemodulator(FS, deviation_hz=DEV, deemphasis_tau=tau, device="cpu")
    ker = demod.FMDemodulator(FS, deviation_hz=DEV, deemphasis_tau=tau, use_pallas=True,
                              device="cpu")
    a_x, _ = xla.process(re, im, xla.initial_state())
    a_k, _ = ker.process(re, im, ker.initial_state())
    np.testing.assert_allclose(a_k.numpy(), a_x.numpy(), rtol=0, atol=FM_ATOL)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "kernel"])
def test_fm_chunked_bitwise_mixed_chunks(use_pallas):
    """Mixed chunk lengths, each a different tile width for the kernel."""
    re, im = _fm_signal(8192)
    fm = demod.FMDemodulator(FS, deviation_hz=DEV, use_pallas=use_pallas, device="cpu")
    one, st_one = fm.process(re, im, fm.initial_state())
    st, outs, pos = fm.initial_state(), [], 0
    for n in (128, 384, 1536, 2048, 4096):
        o, st = fm.process(re[pos : pos + n], im[pos : pos + n], st)
        outs.append(o)
        pos += n
    assert torch.equal(torch.cat(outs), one)
    assert torch.equal(st.filt, st_one.filt) and st.offset == st_one.offset


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "kernel"])
def test_fm_batch_row_equals_row_alone(use_pallas):
    re, im = _planes((3, 2048), 5)
    fm = demod.FMDemodulator(FS, deviation_hz=DEV, use_pallas=use_pallas, device="cpu")
    a, st = fm.process(re, im, fm.initial_state((3,)))
    assert a.shape == (3, 2048) and st.filt.shape == (3,)
    alone, _ = fm.process(re[1], im[1], fm.initial_state())
    assert torch.equal(a[1], alone)


def test_fm_recovers_tone_on_both_paths():
    re, im = _fm_signal(8192, f=1000.0)
    for use_pallas in (False, True):
        fm = demod.FMDemodulator(FS, deviation_hz=DEV, deemphasis_tau=None,
                                 use_pallas=use_pallas, device="cpu")
        a, _ = fm.process(re, im, fm.initial_state())
        a = a.double().numpy()[256:]
        assert _peak_hz(a, FS) == pytest.approx(1000.0, abs=2 * FS / a.size)
        assert 0.9 < np.abs(a).max() < 1.1


def test_fm_discriminator_matches_float64():
    re, im = _planes(4096, 6)
    prev = torch.zeros(1)
    out = demod.fm_discriminate(torch.tensor(re), torch.tensor(im), prev, prev, FS)
    z = re.astype(np.float64) + 1j * im.astype(np.float64)
    zp = np.concatenate([[0.0], z[:-1]])
    ref = np.angle(z * np.conj(zp)) * FS / (2 * np.pi)
    np.testing.assert_allclose(out.double().numpy(), ref, atol=FS * 3e-7)


# ------------------------------------------------ AM, SSB, AGC, squelch


def _run_stage(name, pkg, x_re, x_im, chunks):
    """Run a stage of ``pkg`` (tpu_sdr's demod module or the port's) over
    the chunks; returns (output chunks as NumPy, final state)."""
    dev = {} if pkg is jdemod else {"device": "cpu"}
    if name == "am":
        obj = pkg.AMDemodulator(FS, **dev)
        run = lambda a, b, s: obj.process(a, b, s)
    elif name == "ssb":
        obj = pkg.SSBDemodulator(FS, bfo_hz=-1_234.5, **dev)
        run = lambda a, b, s: obj.process(a, b, s)
    elif name == "agc":
        obj = pkg.AGC(mu=2e-3, ref=0.5, **dev)
        run = lambda a, b, s: _agc(obj, a, b, s)
    elif name == "agc_real":
        obj = pkg.AGC(mu=2e-3, ref=0.5, **dev)
        run = lambda a, b, s: obj.process_real(a, s)
    else:
        obj = pkg.Squelch(0.05, **dev)
        run = lambda a, b, s: obj.gates(a, b, s)
    st = obj.initial_state(x_re.shape[:-1])
    outs, pos = [], 0
    for n in chunks:
        o, st = run(x_re[..., pos : pos + n], x_im[..., pos : pos + n], st)
        outs.append(np.asarray(o) if pkg is jdemod else o.numpy())
        pos += n
    return outs, st


def _agc(obj, a, b, s):
    yre, yim, st = obj.process(a, b, s)
    return (jnp.stack([yre, yim]) if isinstance(yre, jnp.ndarray)
            else torch.stack([yre, yim])), st


STAGES = ["am", "ssb", "agc", "agc_real", "squelch"]


def _stage_input(name):
    re, im = _planes((2, 2048), 7)
    if name == "squelch":
        # a quiet first half, a loud second half: the gate opens mid-way
        re[:, :1024] *= 0.1
        im[:, :1024] *= 0.1
    return re, im


@pytest.mark.parametrize("name", STAGES)
def test_stage_matches_jax(name):
    re, im = _stage_input(name)
    jo, jst = _run_stage(name, jdemod, re, im, [2048])
    po, st = _run_stage(name, demod, re, im, [2048])
    assert po[0].shape == jo[0].shape
    np.testing.assert_allclose(po[0], jo[0], rtol=0, atol=STAGE_ATOL)
    assert st.offset == jst.offset


@pytest.mark.parametrize("name", STAGES)
def test_stage_chunked_equals_oneshot_bitwise(name):
    re, im = _stage_input(name)
    one, st_one = _run_stage(name, demod, re, im, [2048])
    parts, st = _run_stage(name, demod, re, im, [128, 640, 256, 1024])
    assert np.array_equal(np.concatenate(parts, axis=-1), one[0])
    leaves = {"am": "filt", "ssb": "prev_re", "agc": "gain", "agc_real": "gain",
              "squelch": "power"}
    assert torch.equal(getattr(st, leaves[name]), getattr(st_one, leaves[name]))


def test_squelch_opens_on_loud_blocks():
    re, im = _stage_input("squelch")
    (gate,), _ = _run_stage("squelch", demod, re, im, [2048])
    assert gate[:, :1024].max() == 0.0 and gate[:, -128:].min() == 1.0


def test_filter_designs_equal_jax():
    assert np.array_equal(demod.deemphasis_sos(FS, 75e-6), jdemod.deemphasis_sos(FS, 75e-6))
    assert np.array_equal(demod.dc_block_sos(0.995), jdemod.dc_block_sos(0.995))


def test_states_layout_equal_jax_and_convert():
    re, im = _fm_signal(1024)
    j, p = _fm_pair(75e-6, False)
    _, jst = j.process(re, im, j.initial_state())
    _, st = p.process(re, im, p.initial_state())
    for jd_, pd_ in ((jst.to_numpy(), st.to_numpy()),):
        assert set(jd_) == set(pd_)
        for k in jd_:
            assert np.asarray(pd_[k]).dtype == np.asarray(jd_[k]).dtype, k
            assert np.shape(pd_[k]) == np.shape(jd_[k]), k
    # a JAX FM state resumes in the port
    resumed = convert.demod_state(jst.to_numpy(), device="cpu")
    a1, _ = p.process(re, im, resumed)
    a2, _ = j.process(re, im, jst)
    np.testing.assert_allclose(a1.numpy(), np.asarray(a2), rtol=0, atol=FM_ATOL)
    _, jag = _run_stage("agc_real", jdemod, re, im, [1024])
    _, jsq = _run_stage("squelch", jdemod, re, im, [1024])
    for d, conv in ((jag.to_numpy(), convert.agc_state), (jsq.to_numpy(), convert.squelch_state)):
        back = conv(d, device="cpu").to_numpy()
        assert set(back) == set(d)
        for k in d:
            assert np.array_equal(back[k], d[k]) and back[k].dtype == np.asarray(d[k]).dtype


def test_validation_errors():
    agc = demod.AGC(mu=1e-2, device="cpu")
    with pytest.raises(ValueError, match="not a multiple"):
        agc.process_real(np.zeros(100, np.float32), agc.initial_state())
    with pytest.raises(ValueError, match="state shape"):
        agc.process_real(np.zeros((2, 256), np.float32), agc.initial_state())
    with pytest.raises(ValueError, match="mu"):
        demod.AGC(mu=2.0, device="cpu")
    fm = demod.FMDemodulator(FS, device="cpu")
    with pytest.raises(ValueError, match="not a multiple"):
        fm.process(np.zeros(100, np.float32), np.zeros(100, np.float32), fm.initial_state())
    with pytest.raises(ValueError, match="block=128"):
        demod.FMDemodulator(FS, block=64, use_pallas=True, device="cpu")
