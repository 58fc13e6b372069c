"""The port's receiver chain (``tpu_sdr_torch.runtime.receiver``: DDC ->
demodulator -> AGC -> resampler, and the stereo decoder) against tpu_sdr's,
on the CPU.

Inputs come from NumPy (a modulated carrier plus seeded noise) and go to
both packages. Audio agrees with JAX within ``RX_REL`` of its peak; within
the port, chunked == one-shot and ``ReceiverBank`` == K receivers, bit for
bit. A JAX checkpoint resumes in the port.
"""

import wave

import numpy as np
import pytest
import torch

from tpu_sdr.kernels import stereo as jstereo
from tpu_sdr.runtime import receiver as jrx
from tpu_sdr_torch import convert
from tpu_sdr_torch.kernels import stereo
from tpu_sdr_torch.runtime import receiver

torch.set_num_threads(1)

FS = 1_000_000.0
# Port vs JAX audio, relative to its peak. Both packages round the same
# float32 NCO angles, but XLA's and PyTorch's float32 cos/sin differ by up
# to 2 ulps (2.4e-7); the DDC sums P*R = 60-2000 such products, the FM
# discriminator scales phase errors by fs/(2 pi dev), and the AGC loop
# integrates them. Measured worst over these cases: 1.1e-6 of the peak.
RX_REL = 1e-5

# (mode, stereo, audio rate, carrier): audio rates that keep the chunk
# granularity small (a resampler ratio with a small denominator).
CASES = {
    "wbfm": ("wbfm", False, 16e3, 250e3),
    "wbfm-stereo": ("wbfm", True, 16e3, 250e3),
    "nbfm": ("nbfm", False, 6250.0, 455e3),
    "am": ("am", False, 5000.0, 300e3),
    "usb": ("usb", False, FS / 166 / 2, 400e3),
    "lsb": ("lsb", False, FS / 166 / 2, 400e3),
}


def _signal(case: str, t_len: int, seed: int = 0) -> np.ndarray:
    mode, stereo_on, _, fc = CASES[case]
    n = np.arange(t_len)
    noise = 0.01 * np.random.default_rng(seed).standard_normal(t_len)
    if mode in ("wbfm", "nbfm"):
        dev = 75e3 if mode == "wbfm" else 2.5e3
        if stereo_on:
            msg = jstereo.make_mpx(np.sin(2 * np.pi * 1e3 * n / FS),
                                   np.sin(2 * np.pi * 3e3 * n / FS), FS)
        else:
            msg = np.sin(2 * np.pi * (1e3 if mode == "wbfm" else 300.0) * n / FS)
        x = 0.8 * np.cos(2 * np.pi * fc * n / FS + 2 * np.pi * dev / FS * np.cumsum(msg))
    elif mode == "am":
        x = (1 + 0.5 * np.sin(2 * np.pi * 800.0 * n / FS)) * 0.5 * np.cos(2 * np.pi * fc * n / FS)
    else:
        sign = 1.0 if mode == "usb" else -1.0
        x = 0.5 * np.cos(2 * np.pi * (fc + sign * 700.0) * n / FS)
    return (x + noise).astype(np.float32)


def _pair(case: str, **kw):
    mode, stereo_on, rate, fc = CASES[case]
    args = dict(fs=FS, center_hz=fc, mode=mode, audio_rate=rate, stereo=stereo_on, **kw)
    return jrx.Receiver(**args), receiver.Receiver(**args, device="cpu")


def _tone_hz(audio, rate):
    a = np.asarray(audio, np.float64)
    a = a - a.mean()
    spec = np.abs(np.fft.rfft(a * np.hanning(a.size)))
    return np.argmax(spec) * rate / a.size


@pytest.mark.parametrize("case", list(CASES))
def test_mode_matches_jax(case):
    j, p = _pair(case)
    assert p.chunk_granularity == j.chunk_granularity
    assert p.realized_audio_rate == j.realized_audio_rate
    x = _signal(case, 4 * p.chunk_granularity)
    ja, jst = j.process(x, j.initial_state())
    pa, st = p.process(x, p.initial_state())
    ja = np.asarray(ja)
    assert tuple(pa.shape) == ja.shape and pa.dtype == torch.float32
    assert np.abs(pa.numpy() - ja).max() <= RX_REL * np.abs(ja).max()
    assert st.ddc.offset == jst.ddc.offset and st.resamp.offset == jst.resamp.offset


@pytest.mark.parametrize("case", list(CASES))
def test_mode_chunked_equals_oneshot_bitwise(case):
    _, p = _pair(case)
    g = p.chunk_granularity
    x = _signal(case, 4 * g, seed=1)
    one, st_one = p.process(x, p.initial_state())
    st, parts, pos = p.initial_state(), [], 0
    for n in (g, 3 * g):
        o, st = p.process(x[pos : pos + n], st)
        parts.append(o)
        pos += n
    assert torch.equal(torch.cat(parts, dim=-1), one)
    d1, d2 = st.to_numpy(), st_one.to_numpy()
    for stage in d2:
        for k in d2[stage]:
            assert np.array_equal(d1[stage][k], d2[stage][k]), (stage, k)


def test_wbfm_recovers_tone_real_and_iq():
    _, p = _pair("wbfm")
    x = _signal("wbfm", 8 * p.chunk_granularity)
    audio, _ = p.process(x, p.initial_state())
    rate = float(p.realized_audio_rate)
    tail = audio.double().numpy()[int(0.01 * rate):]
    assert _tone_hz(tail, rate) == pytest.approx(1000.0, abs=2 * rate / tail.size)
    assert 0.5 < np.abs(tail).max() < 1.2
    # IQ planes of a tone at -100 kHz
    rx = receiver.Receiver(fs=FS, center_hz=-100e3, mode="wbfm", audio_rate=16e3, device="cpu")
    n = np.arange(4 * rx.chunk_granularity)
    msg = np.sin(2 * np.pi * 400.0 * n / FS)
    phase = -2 * np.pi * 100e3 * n / FS + 2 * np.pi * 75e3 / FS * np.cumsum(msg)
    planes = np.stack([np.cos(phase), np.sin(phase)]).astype(np.float32)
    audio, _ = rx.process_planes(planes, rx.initial_state())
    j = jrx.Receiver(fs=FS, center_hz=-100e3, mode="wbfm", audio_rate=16e3)
    ja, _ = j.process_planes(planes, j.initial_state())
    ja = np.asarray(ja)
    assert np.abs(audio.numpy() - ja).max() <= RX_REL * np.abs(ja).max()
    a = audio.double().numpy()[int(0.01 * 16e3):]
    assert _tone_hz(a, 16e3) == pytest.approx(400.0, abs=2 * 16e3 / a.size)


def test_stereo_separates_channels():
    _, p = _pair("wbfm-stereo")
    x = _signal("wbfm-stereo", 16 * p.chunk_granularity)
    lr, st = p.process(x, p.initial_state())
    rate = float(p.realized_audio_rate)
    left, right = (lr[k].double().numpy()[int(0.1 * rate):] for k in (0, 1))
    assert _tone_hz(left, rate) == pytest.approx(1e3, abs=2 * rate / left.size)
    assert _tone_hz(right, rate) == pytest.approx(3e3, abs=2 * rate / right.size)
    assert st.stereo.pilot_level() > 0.05


@pytest.mark.parametrize("case", ["wbfm", "usb", "wbfm-stereo"])
def test_receiver_bank_equals_independent_receivers(case):
    mode, stereo_on, rate, fc = CASES[case]
    centers = (fc, fc - 120e3, fc + 90e3)
    bank = receiver.ReceiverBank(FS, centers, mode=mode, audio_rate=rate, stereo=stereo_on,
                                 device="cpu")
    x = _signal(case, 2 * bank.chunk_granularity, seed=2)
    g = bank.chunk_granularity
    st = bank.initial_state()
    outs = []
    for chunk in (x[:g], x[g:]):
        o, st = bank.process(chunk, st)
        outs.append(o)
    for k, c in enumerate(centers):
        rx = receiver.Receiver(FS, c, mode=mode, audio_rate=rate, stereo=stereo_on, device="cpu")
        rs = rx.initial_state()
        for chunk, o in zip((x[:g], x[g:]), outs):
            ro, rs = rx.process(chunk, rs)
            assert torch.equal(o[k], ro), (k, c)


@pytest.mark.parametrize("case", ["wbfm", "am", "wbfm-stereo"])
def test_checkpoint_from_jax_resumes_in_port(case):
    """Chunk 1 in JAX, its ReceiverState.to_numpy() carried into the port
    (convert.receiver_state), chunk 2 in the port: its audio is JAX's
    one-shot audio of chunk 2 within RX_REL."""
    j, p = _pair(case)
    g = p.chunk_granularity
    x = _signal(case, 4 * g, seed=3)
    j_one, _ = j.process(x, j.initial_state())
    _, jst = j.process(x[: 2 * g], j.initial_state())
    jd = jst.to_numpy()
    pst = convert.receiver_state(jd, device="cpu")
    pa, pst2 = p.process(x[2 * g :], pst)
    j_one = np.asarray(j_one)
    want = j_one[..., j_one.shape[-1] // 2 :]
    assert np.abs(pa.numpy() - want).max() <= RX_REL * np.abs(want).max()
    # the port's checkpoint has JAX's keys, dtypes and shapes, and loads in JAX
    _, p_st = p.process(x[: 2 * g], p.initial_state())
    pd = p_st.to_numpy()
    assert set(pd) == set(jd)
    for stage in jd:
        assert set(pd[stage]) == set(jd[stage]), stage
        for k in jd[stage]:
            a, b = np.asarray(pd[stage][k]), np.asarray(jd[stage][k])
            assert a.dtype == b.dtype and a.shape == b.shape, (stage, k)
    back = jrx.ReceiverState.from_numpy(pst2.to_numpy())
    assert back.ddc.offset == 4 * g


def test_squelch_matches_jax_and_chunks():
    j, p = _pair("am", squelch_db=-20.0)
    g = p.chunk_granularity  # one 128-sample block at baseband
    x = _signal("am", 48 * g)
    x[: 8 * g] *= 0.01  # closed at first; the power EMA opens it ~18 blocks later
    ja, _ = j.process(x, j.initial_state())
    pa, _ = p.process(x, p.initial_state())
    ja = np.asarray(ja)
    assert np.abs(pa.numpy() - ja).max() <= RX_REL * np.abs(ja).max()
    st, parts = p.initial_state(), []
    for chunk in (x[:g], x[g : 20 * g], x[20 * g :]):
        o, st = p.process(chunk, st)
        parts.append(o)
    assert torch.equal(torch.cat(parts), pa)
    assert pa[: pa.shape[0] // 6].abs().max() == 0.0 and pa[-100:].abs().max() > 0.01


def test_stereo_decoder_matches_jax():
    fs = 200e3
    n = np.arange(128 * 64)
    m = jstereo.make_mpx(np.sin(2 * np.pi * 1e3 * n / fs), np.zeros(n.size), fs)
    m = m.astype(np.float32)
    j = jstereo.StereoDecoder(fs, deemphasis_tau=75e-6)
    jo, jst = j.process(m, j.initial_state())
    d = stereo.StereoDecoder(fs, deemphasis_tau=75e-6, device="cpu")
    o, st = d.process(m, d.initial_state())
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    assert st.pilot_level() == pytest.approx(jst.pilot_level(), rel=1e-5)
    assert d.realized_pilot_hz == j.realized_pilot_hz
    jd, pd = jst.to_numpy(), st.to_numpy()
    assert set(jd) == set(pd)
    for k in jd:
        assert np.asarray(pd[k]).dtype == np.asarray(jd[k]).dtype, k
    back = convert.stereo_state(jd, device="cpu")
    assert np.array_equal(back.to_numpy()["a_re"], jd["a_re"])


def test_errors_and_devices(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="mode"):
        receiver.Receiver(mode="dsb", device="cpu")
    with pytest.raises(ValueError, match="stereo"):
        receiver.Receiver(mode="am", stereo=True, device="cpu")
    rx = receiver.Receiver(mode="wbfm", device="cpu")
    with pytest.raises(ValueError, match="chunk_granularity"):
        rx.process(np.zeros(1000, np.float32), rx.initial_state())
    with pytest.raises(ValueError, match="complex"):
        rx.process(np.zeros(rx.chunk_granularity, np.complex64), rx.initial_state())
    audio = torch.sin(torch.arange(4800.0) / 10)
    path = receiver.write_wav(tmp_path / "a.wav", torch.stack([audio, -audio]), 48e3)
    with wave.open(str(path)) as w:
        assert (w.getnchannels(), w.getframerate(), w.getnframes()) == (2, 48000, 4800)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        receiver.Receiver()
