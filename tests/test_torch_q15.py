"""The port's Q15 path against the JAX package and the NumPy oracles, on the
CPU: the scaled integer FFT, the saturating integer cascade, ``Q15Pipeline``
in both forms, ``Q15Stream`` and the native host filter. Every integer
output is compared bit for bit. The JAX side runs as ``tests/test_q15.py``
runs it."""

import threading

import numpy as np
import pytest
import scipy.signal as sps
import torch

from tpu_sdr.core.config import PipelineConfig as JPipelineConfig
from tpu_sdr.kernels import biquad as jbiquad
from tpu_sdr.kernels import fft_q15 as jfft_q15
from tpu_sdr.runtime.q15 import Q15Pipeline as JQ15Pipeline
from tpu_sdr_torch.control import golden
from tpu_sdr_torch.core import qformat as qf
from tpu_sdr_torch.core.config import PipelineConfig
from tpu_sdr_torch.kernels import biquad, fft_q15, native_q15, window
from tpu_sdr_torch.kernels.cuda import launch
from tpu_sdr_torch.runtime.q15 import Q15Pipeline, Q15Stream

N = 16384
# The pipelines' tests run at a small frame (the plain cascade walks its
# samples in Python); the FFT and the split path also run at N.
SMALL = dict(fft_size=2048, fft_n1=32, fft_n2=64)
SOS_Q = qf.quantize_coeff_x64(sps.butter(6, 0.3, output="sos"))


def _frames(shape, seed: int, scale: float = 6000.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.int16)


def _padded_sos() -> np.ndarray:
    padded = np.zeros((6, 6), np.int64)
    padded[:3] = SOS_Q
    padded[3:] = [64, 0, 0, 64, 0, 0]
    return padded


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance in units in the last place between two arrays of
    non-negative fp32 values."""
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max())


@pytest.mark.parametrize("bitrev", ["take", "transpose"])
@pytest.mark.parametrize("n", [256, N])
def test_fft_q15_matches_jax_and_numpy(n, bitrev):
    x_re = _frames((3, n), 1)
    x_im = _frames((3, n), 2)
    ref = jfft_q15.fft_q15_np(x_re, x_im)
    jax_out = jfft_q15.fft_q15(x_re, x_im, bitrev=bitrev)
    got = fft_q15.fft_q15(x_re, x_im, bitrev=bitrev)
    for g, j, r in zip(got, jax_out, ref):
        assert g.dtype == torch.int16
        assert np.array_equal(g.numpy(), r) and np.array_equal(np.asarray(j), r)
    # the port's NumPy copy is the reference's
    assert all(np.array_equal(a, b) for a, b in zip(fft_q15.fft_q15_np(x_re, x_im), ref))


def test_fft_q15_tables_schedule_and_scale_are_the_reference():
    for n in (16, 256, N):
        a, b = fft_q15.plan_q15(n), jfft_q15.plan_q15(n)
        assert np.array_equal(a["bitrev"], b["bitrev"])
        assert all(np.array_equal(x, y) for p, q in zip(a["ranks"], b["ranks"]) for x, y in zip(p, q))
        # rank t's entry j is rank 0's entry j << t (what the kernel reads)
        for t, (w_re, w_im) in enumerate(a["ranks"]):
            j = np.arange(len(w_re)) << t
            assert np.array_equal(w_re, a["ranks"][0][0][j]) and np.array_equal(w_im, a["ranks"][0][1][j])
    assert fft_q15.XFFT_WIRE_SCALE == jfft_q15.XFFT_WIRE_SCALE
    x = _frames((2, 1024), 3, 20000.0)
    sched = (2, 0, 1, 1, 2, 0, 1, 1, 1, 1)
    ref = jfft_q15.fft_q15_np(x, schedule=sched)
    got = fft_q15.fft_q15(torch.as_tensor(x), schedule=sched)
    assert all(np.array_equal(g.numpy(), r) for g, r in zip(got, ref))
    with pytest.raises(ValueError, match="schedule"):
        fft_q15.fft_q15(x, schedule=(1, 1))
    with pytest.raises(ValueError, match="bitrev"):
        fft_q15.fft_q15(x, bitrev="gather")


def test_full_scale_tone_wire_level():
    """A full-scale tone through the 1/N schedule lands at the wire scale."""
    n = N
    t = np.arange(n)
    x = np.clip(np.round(32767 * np.cos(2 * np.pi * 1000 * t / n)), -32768, 32767).astype(np.int16)
    re, im = fft_q15.fft_q15(x)
    assert np.array_equal(re.numpy(), jfft_q15.fft_q15_np(x)[0])
    # |X[1000]| = N/2 * 32767 / N on the wire (two bins share the tone)
    assert abs(int(re[1000]) - 32767 // 2) <= 8 and abs(int(im[1000])) <= 8


def test_window_fft_matches_window_then_fft():
    """The device stage's bypass form is window_q15 then fft_q15, and the
    magnitude is the GUI decode of the wire words."""
    x = _frames((4, 512), 4, 20000.0)
    rom = window.hann_q16_rom(512, device="cpu")
    re, im, mag = fft_q15.window_fft_q15(torch.as_tensor(x), rom=rom)
    ref_re, ref_im = jfft_q15.fft_q15_np(golden.rtl_window_q15(x.reshape(-1), n=512).reshape(4, 512))
    assert np.array_equal(re.numpy(), ref_re) and np.array_equal(im.numpy(), ref_im)
    fr, fi = ref_re.astype(np.float32), ref_im.astype(np.float32)
    # torch's CPU sqrt may round 1 ulp from the correctly rounded root (below)
    assert _ulps(mag.numpy(), np.sqrt(fr * fr + fi * fi)) <= 1


def test_plain_magnitude_is_within_an_ulp_of_the_correctly_rounded_sqrt():
    """The plain |X| against NumPy's fp32 sqrt on the same int16 words.
    NumPy's is the correctly rounded root (the float64 root of the exact fp32
    sum, rounded once); torch's CPU sqrt may round 1 ulp away from it, never
    more. The card's root is correctly rounded (``__fsqrt_rn``; the GPU tests
    hold it to NumPy's bit for bit), so the card and the CPU can differ by
    1 ulp in |X|, and only there."""
    words = np.random.default_rng(9).integers(-32768, 32768, (2, 1 << 18)).astype(np.int16)
    fr, fi = words.astype(np.float32)
    s = fr * fr + fi * fi
    exact = np.sqrt(s.astype(np.float64)).astype(np.float32)
    assert np.array_equal(np.sqrt(s), exact)
    mag = fft_q15._magnitude(torch.as_tensor(words[0]), torch.as_tensor(words[1])).numpy()
    assert _ulps(mag, exact) <= 1


def test_sosfilt_q15_scan_matches_jax_values_and_state():
    x = _frames((2, 1024), 5, 9000.0)
    zi = np.random.default_rng(6).integers(-4000, 4000, (2, 6, 2)).astype(np.int32)
    sos = _padded_sos()
    jy, jzf = jbiquad.sosfilt_q15_scan(sos, x, zi)
    y, zf = biquad.sosfilt_q15_scan(sos, torch.as_tensor(x), torch.as_tensor(zi))
    assert y.dtype == torch.int16 and zf.dtype == torch.int32
    assert np.array_equal(y.numpy(), np.asarray(jy)) and np.array_equal(zf.numpy(), np.asarray(jzf))
    for r in range(2):
        ry, rz = golden.sosfilt_q15_intended(sos, x[r], zi[r])
        assert np.array_equal(y[r].numpy(), ry) and np.array_equal(zf[r].numpy(), rz)


def test_sosfilt_q15_window_fuses_the_rtl_window():
    x = _frames((3, 1024), 7, 20000.0)
    rom = window.hann_q16_rom(256, device="cpu")
    zi = torch.zeros((3, 6, 2), dtype=torch.int32)
    sos = torch.as_tensor(_padded_sos(), dtype=torch.int32)
    y, xw, zf = biquad.sosfilt_q15_window(sos, torch.as_tensor(x), zi, rom=rom)
    ref_w = window.window_q15(torch.as_tensor(x).reshape(3, 4, 256), rom).reshape(3, 1024)
    assert torch.equal(xw, ref_w)
    y2, zf2 = biquad.sosfilt_q15_scan(sos, ref_w, zi)
    assert torch.equal(y, y2) and torch.equal(zf, zf2)


@pytest.fixture(scope="module")
def small_pipes():
    """(port, JAX) all-device pipelines at the small frame, coefficients up."""
    port = Q15Pipeline(PipelineConfig(channels=1, **SMALL), device="cpu")
    jax_pipe = JQ15Pipeline(JPipelineConfig(channels=1, **SMALL))
    for p in (port, jax_pipe):
        p.upload_sos_q(SOS_Q)
    return port, jax_pipe


LEAVES = ("windowed_q15", "filtered_q15", "spectrum_re_q15", "spectrum_im_q15")


def _same_leaves(got: dict, ref: dict):
    for k in LEAVES:
        g, r = _np(got[k]), np.asarray(ref[k])
        assert g.shape == r.shape and np.array_equal(g, r), k
    gm, rm = _np(got["magnitude"]).astype(np.float64), np.asarray(ref["magnitude"], np.float64)
    assert gm.shape == rm.shape
    assert np.all(np.abs(gm - rm) <= 1e-6 * np.maximum(np.abs(rm), 1.0))


def test_pipeline_all_device_matches_jax_with_carried_state(small_pipes):
    port, jax_pipe = small_pipes
    n = SMALL["fft_size"]
    x = _frames((2, n), 8)
    zi, jzi = None, None
    for chunk in x:  # two calls, the state carried
        out, zi = port.process(chunk, zi)
        jout, jzi = jax_pipe.process(chunk, jzi)
        _same_leaves(out, jout)
        assert zi.dtype == torch.int32 and np.array_equal(zi.numpy(), np.asarray(jzi))
    # the wire words are the selftest's oracle chain, bit for bit
    xw = golden.rtl_window_q15(x.reshape(-1), n=n)
    filt, _ = golden.sosfilt_q15_intended(_padded_sos(), xw)
    ref_re, ref_im = fft_q15.fft_q15_np(filt.reshape(2, n))
    one, _ = port.process(x.reshape(-1))
    assert np.array_equal(one["spectrum_re_q15"].numpy()[0], ref_re)
    assert np.array_equal(one["spectrum_im_q15"].numpy()[0], ref_im)


@pytest.mark.parametrize("bypass", [True, False], ids=["bypass", "filtered"])
def test_pipeline_split_matches_jax_with_carried_state(bypass):
    port = Q15Pipeline(PipelineConfig(channels=1), device_fft=True, device="cpu")
    jax_pipe = JQ15Pipeline(JPipelineConfig(channels=1), device_fft=True)
    for p in (port, jax_pipe):
        p.upload_sos_q(SOS_Q)
    x = _frames((2, N), 9)
    zi, jzi = None, None
    for chunk in x:
        out, zi = port.process(chunk, zi, bypass=bypass)
        jout, jzi = jax_pipe.process(chunk, jzi, bypass=bypass)
        for k in jout:
            g, r = _np(out[k]), np.asarray(jout[k])
            assert g.shape == r.shape, k
            if k == "magnitude":
                assert np.allclose(g, r, rtol=1e-6, atol=0), k
            else:
                assert np.array_equal(g, r), k
        assert zi.dtype == np.int64 and np.array_equal(zi, np.asarray(jzi))


def test_split_equals_all_device_bitwise(small_pipes):
    port, _ = small_pipes
    split = Q15Pipeline(PipelineConfig(channels=1, **SMALL), device_fft=True, device="cpu")
    split.upload_sos_q(SOS_Q)
    x = _frames(2 * SMALL["fft_size"], 10)
    ref, zf_ref = port.process(x)
    got, zf = split.process(x)
    for k in LEAVES + ("magnitude",):
        assert np.array_equal(_np(got[k]), _np(ref[k])), k
    assert np.array_equal(zf.reshape(-1), zf_ref.numpy().reshape(-1).astype(np.int64))


def test_rtl_misaligned_window_option():
    n = SMALL["fft_size"]
    x = _frames(n, 11, 20000.0)
    for misaligned in (False, True):
        port = Q15Pipeline(PipelineConfig(channels=1, **SMALL), rtl_misaligned_window=misaligned,
                           device_fft=True, device="cpu")
        out, _ = port.process(x, bypass=True)
        ref_re, _ = fft_q15.fft_q15_np(golden.rtl_window_q15(x, n=n, misaligned=misaligned))
        assert np.array_equal(out["spectrum_re_q15"].numpy().reshape(-1), ref_re)


@pytest.mark.parametrize("misaligned", [False, True])
def test_sos_q_and_rom_equal_jax(misaligned):
    port = Q15Pipeline(PipelineConfig(channels=1), rtl_misaligned_window=misaligned, device="cpu")
    jax_pipe = JQ15Pipeline(JPipelineConfig(channels=1), rtl_misaligned_window=misaligned)
    for sos in (SOS_Q, qf.quantize_coeff_x64(sps.cheby1(4, 1, 0.2, output="sos"))):
        port.upload_sos_q(sos)
        jax_pipe.upload_sos_q(sos)
        assert port.sos_q.dtype == jax_pipe.sos_q.dtype and np.array_equal(port.sos_q, jax_pipe.sos_q)
    assert port.rom_np.dtype == np.int16 and np.array_equal(port.rom_np, np.asarray(jax_pipe.rom_np))
    assert np.array_equal(port.rom.numpy(), port.rom_np)


def test_display_frame_is_the_last_frame():
    port = Q15Pipeline(PipelineConfig(channels=1, **SMALL), device_fft=True, device="cpu")
    port.upload_sos_q(SOS_Q)
    n = SMALL["fft_size"]
    x = _frames(3 * n, 12)
    for bypass in (False, True):
        out, _ = port.process(x, bypass=bypass, display=True)
        disp = out["display_frame"].numpy()
        assert disp.shape == (1, 3, n) and disp.dtype == np.float32
        assert np.array_equal(disp[0, 0].astype(np.int16), out["spectrum_re_q15"].numpy()[0, -1])
        assert np.array_equal(disp[0, 1].astype(np.int16), out["spectrum_im_q15"].numpy()[0, -1])
        assert np.array_equal(disp[0, 2], out["magnitude"].numpy()[0, -1])


def test_upload_sos_q_rejects_a0_and_unready_pipeline():
    port = Q15Pipeline(PipelineConfig(channels=1, **SMALL), device="cpu")
    with pytest.raises(ValueError, match="upload_sos_q"):
        port.process(_frames(SMALL["fft_size"], 13))
    bad = np.array([[64, 0, 0, 32, 0, 0]])
    with pytest.raises(ValueError, match="a0 must be 64"):
        port.upload_sos_q(bad)
    with pytest.raises(ValueError, match="a0"):
        golden.sosfilt_q15_intended(bad, np.zeros(4, np.int16))
    with pytest.raises(ValueError, match="a0"):
        native_q15.sosfilt_q15_rows(bad, np.zeros((1, 8), np.int16), np.zeros((1, 1, 2)))


def test_native_filter_matches_the_oracle():
    sos = _padded_sos()
    x = _frames((3, 2048), 14, 12000.0)
    zi = np.random.default_rng(15).integers(-3000, 3000, (3, 6, 2))
    y, zf = native_q15.sosfilt_q15_rows(sos, x, zi)
    rom = golden.hann_q16_rom(512)
    yf, xw, zff = native_q15.sosfilt_q15_window_rows(sos, x, rom, zi)
    for r in range(3):
        ry, rz = golden.sosfilt_q15_intended(sos, x[r], zi[r])
        assert np.array_equal(y[r], ry) and np.array_equal(zf[r], rz)
        rw = qf.window_multiply_q15(x[r].reshape(-1, 512), rom).reshape(-1)
        assert np.array_equal(xw[r], rw)
        ry, rz = golden.sosfilt_q15_intended(sos, rw, zi[r])
        assert np.array_equal(yf[r], ry) and np.array_equal(zff[r], rz)
    assert native_q15.library_path().is_file() and native_q15.available()
    assert "build" in native_q15.library_path().parts


def _stream_refs(pipe, chunks):
    zi, refs = None, []
    for c in chunks:
        o, zi = pipe.process(c, zi, bypass=False)
        refs.append({k: _np(v) for k, v in o.items()})
    return refs


@pytest.mark.parametrize("depth", [1, 3])
def test_q15_stream_equals_sequential_calls(depth):
    split = Q15Pipeline(PipelineConfig(channels=1, **SMALL), device_fft=True, device="cpu")
    split.upload_sos_q(SOS_Q)
    chunks = [_frames(SMALL["fft_size"], 20 + i) for i in range(5)]
    refs = _stream_refs(split, chunks)
    stream = Q15Stream(split, fetch=("magnitude", "spectrum_re_q15", "spectrum_im_q15"),
                       depth=depth)
    got = [r for c in chunks if (r := stream.push(c)) is not None]
    while (r := stream.flush()) is not None:
        got.append(r)
    stream.close()
    assert len(got) == len(refs)
    for (o, _), ref in zip(got, refs):
        for k in ("magnitude", "spectrum_re_q15", "spectrum_im_q15", "filtered_q15",
                  "windowed_q15"):
            assert isinstance(o[k], np.ndarray) and np.array_equal(o[k], ref[k]), k


def test_q15_stream_error_poisoning_and_reset():
    split = Q15Pipeline(PipelineConfig(channels=1, **SMALL), device_fft=True, device="cpu")
    stream = Q15Stream(split)
    x = _frames(SMALL["fft_size"], 30)
    with pytest.raises(ValueError, match="multiple of"):
        stream.push(np.zeros(100, np.int16))
    # no coefficients: the worker fails, and the next call raises it
    assert stream.push(x) is None
    with pytest.raises(ValueError, match="upload_sos_q"):
        stream.push(x)
    with pytest.raises(ValueError, match="upload_sos_q"):
        stream.flush()  # the chain stays poisoned
    stream.reset()
    split.upload_sos_q(SOS_Q)
    assert stream.push(x) is None
    out, _ = stream.flush()
    ref, _ = split.process(x)
    assert np.array_equal(out["magnitude"], ref["magnitude"].numpy())
    stream.close()
    with pytest.raises(ValueError, match="device_fft"):
        Q15Stream(Q15Pipeline(PipelineConfig(channels=1, **SMALL), device="cpu"))


def test_q15_stream_reset_midflight_resumes_deterministically():
    split = Q15Pipeline(PipelineConfig(channels=1, **SMALL), device_fft=True, device="cpu")
    split.upload_sos_q(SOS_Q)
    a, b, c, d = (_frames(SMALL["fft_size"], 40 + i) for i in range(4))
    started, gate = threading.Event(), threading.Event()

    class GatedPipe:
        def __getattr__(self, name):
            return getattr(split, name)

        def _split_host(self, x, zi):  # the worker's part of a chunk
            started.set()
            assert gate.wait(30), "gate never opened"
            return split._split_host(x, zi)

    stream = Q15Stream(GatedPipe(), fetch=("magnitude",), depth=3)
    assert stream.push(a) is None and stream.push(b) is None and stream.push(c) is None
    assert started.wait(30)
    threading.Timer(0.2, gate.set).start()
    stream.reset()  # waits a out, cancels b and c
    assert stream.push(d) is None
    out, _ = stream.flush()
    stream.close()
    _, za = split.process(a)
    ref, _ = split.process(d, za)
    assert np.array_equal(out["magnitude"], ref["magnitude"].numpy())


def test_cpu_pipeline_never_touches_cuda(monkeypatch):
    """device="cpu" builds the ROM and runs every stage on the CPU: no CUDA
    call is made and no kernel is launched."""
    def refuse(*args, **kwargs):
        raise AssertionError("CUDA was touched")

    for name in ("is_available", "current_stream", "device", "synchronize", "_lazy_init",
                 "Stream", "Event"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    with pytest.raises(TypeError):
        window.hann_q16_rom(256)  # no default device
    launch.reset_counts()
    n = SMALL["fft_size"]
    x = _frames(n, 50)
    all_device = Q15Pipeline(PipelineConfig(channels=1, **SMALL), device="cpu")
    split = Q15Pipeline(PipelineConfig(channels=1, **SMALL), device_fft=True, device="cpu")
    for p in (all_device, split):
        assert p.rom.device.type == "cpu"
        p.upload_sos_q(SOS_Q)
    all_device.process(x)
    split.process(x, bypass=True)
    split.process(x)
    stream = Q15Stream(split)
    assert stream.push(x) is None and stream.flush() is not None
    stream.close()
    assert not any(launch.counts["kernel"].values())
    assert launch.counts["plain"]["q15_fft"] == 4 and launch.counts["plain"]["sosfilt_q15"] == 1


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Q15Pipeline(PipelineConfig(channels=1))


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros((1, 256), dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fft_q15.window_fft_q15_cuda(x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        biquad.sosfilt_q15_cuda(torch.as_tensor(_padded_sos(), dtype=torch.int32), x,
                                torch.zeros((1, 6, 2), dtype=torch.int32))
