"""The port's host runtime and the A20 names against the JAX package, on the
CPU: sample sources, measurements, the recorder, the display reduction and
waterfall, the stream feeder, ``HostConfig``/``default_config``, the golden
oracles, the per-section blocked IIR, ``magnitude_db`` and
``fft_golden_check``. The same seeded NumPy inputs go to both packages."""

import dataclasses
import json
import threading
import time

import jax
import numpy as np
import pytest
import scipy.signal as sps
import torch

import tpu_sdr
from tpu_sdr.control import golden as jgolden
from tpu_sdr.core import config as jconfig
from tpu_sdr.kernels import biquad as jbiquad
from tpu_sdr.kernels import fft as jfft
from tpu_sdr.kernels import magnitude as jmagnitude
from tpu_sdr.runtime import measure as jmeasure
from tpu_sdr.runtime import recorder as jrecorder
from tpu_sdr.runtime import source as jsource
from tpu_sdr.runtime import waterfall as jwaterfall
import tpu_sdr_torch
from tpu_sdr_torch import FilterMode, PipelineConfig, SpectrumPipeline
from tpu_sdr_torch.control import golden
from tpu_sdr_torch.core import config
from tpu_sdr_torch.kernels import biquad, fft, magnitude
from tpu_sdr_torch.runtime import StreamFeeder, measure, recorder, source, waterfall

FS = 1e6


# ---------------------------------------------------------------- config


def test_host_config_and_default_config_equal():
    assert dataclasses.asdict(config.HostConfig()) == dataclasses.asdict(jconfig.HostConfig())
    assert [f.name for f in dataclasses.fields(config.HostConfig)] == [
        f.name for f in dataclasses.fields(jconfig.HostConfig)]
    for kw in ({}, {"channels": 4, "dtype": "bf16"}):
        a, b = tpu_sdr_torch.default_config(**kw), tpu_sdr.default_config(**kw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


# ---------------------------------------------------------------- sources


@pytest.mark.parametrize("kw", [
    dict(tones_hz=((100e3, 0.5), (-30e3, 0.2)), noise=0.05, channels=2, adc_bits=12, seed=3),
    dict(tones_hz=((250e3, 0.7),), noise=0.0, adc_bits=None),
    dict(tones_hz=((-200e3, 0.5),), noise=0.1, iq=True, seed=4),
], ids=["real adc", "real float", "iq"])
def test_synthetic_source_matches_jax(kw):
    a, b = source.SyntheticSource(**kw), jsource.SyntheticSource(**kw)
    for n in (1000, 4096, 333):  # phase continuity across reads
        x, y = a.read(n), b.read(n)
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_file_and_callback_sources_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    data = rng.standard_normal((2, 300)).astype(np.float32)
    np.save(tmp_path / "cap.npy", data)
    (tmp_path / "cap.json").write_text(json.dumps({"fs": 2e6}))
    raw = (rng.standard_normal(500) * 8000).astype(np.int16)
    raw.tofile(tmp_path / "cap.i16")
    iq = (rng.standard_normal(200) + 1j * rng.standard_normal(200)).astype(np.complex64)
    iq.tofile(tmp_path / "cap.cf32")
    for path, kw in ((tmp_path / "cap.npy", {}), (tmp_path / "cap.i16", {"channels": 3}),
                     (tmp_path / "cap.cf32", {})):
        a = source.FileSource(str(path), **kw)
        b = jsource.FileSource(str(path), **kw)
        assert a.fs == b.fs and a.channels == b.channels
        for n in (128, 700):
            assert np.array_equal(a.read(n), b.read(n))
    with pytest.raises(ValueError, match="channels"):
        source.FileSource(str(tmp_path / "cap.npy"), channels=3)
    cb = lambda n: np.arange(n, dtype=np.float64)[None] * 0.5
    assert np.array_equal(source.CallbackSource(cb).read(64), jsource.CallbackSource(cb).read(64))


# ---------------------------------------------------------------- measure


def test_measurements_match_jax():
    rng = np.random.default_rng(6)
    freqs = np.fft.fftshift(np.fft.fftfreq(1024, 1 / FS))
    pxx = np.abs(rng.standard_normal(1024)) * 1e-6
    pxx[600:640] += 1e-3
    for f_lo, f_hi in ((-1e5, 1e5), (80e3, 130e3)):
        assert measure.channel_power(pxx, freqs, f_lo, f_hi) == jmeasure.channel_power(
            pxx, freqs, f_lo, f_hi)
    assert measure.occupied_bandwidth(pxx, freqs, 0.9) == jmeasure.occupied_bandwidth(
        pxx, freqs, 0.9)
    mag = np.abs(np.fft.fft(np.sin(2 * np.pi * 0.1234 * np.arange(2048)) * np.hanning(2048)))
    mag = mag[:1024] + 1e-3
    f1 = np.arange(1024) * FS / 2048
    assert measure.peak_search(mag, f1, k=3) == jmeasure.peak_search(mag, f1, k=3)
    assert measure.refine_peak(mag, 252) == jmeasure.refine_peak(mag, 252)
    z = np.exp(2j * np.pi * 12.5e3 * np.arange(4096) / FS) + 0.01 * rng.standard_normal(4096)
    assert measure.frequency_offset(z.real, z.imag, FS) == jmeasure.frequency_offset(
        z.real, z.imag, FS)
    with pytest.raises(ValueError, match="fraction"):
        measure.occupied_bandwidth(pxx, freqs, 1.5)


# ---------------------------------------------------------------- recorder


@pytest.mark.parametrize("max_samples", [None, 700])
def test_recorder_writes_what_jax_writes(tmp_path, max_samples):
    rng = np.random.default_rng(7)
    chunks = [rng.standard_normal((2, n)).astype(np.float32) for n in (300, 500, 256)]
    metas = []
    for mod, name in ((recorder, "port"), (jrecorder, "jax")):
        rec = mod.SampleRecorder(str(tmp_path / f"{name}.npy"), fs=2e6, max_samples=max_samples)
        for c in chunks:
            rec.append(c)
        metas.append(rec.close())
    assert metas[0] == metas[1]
    assert np.array_equal(np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy"))
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())
    # the capture plays back through FileSource with its sidecar's rate
    src = source.FileSource(str(tmp_path / "port.npy"))
    assert src.fs == 2e6 and src.channels == 2


def test_recording_source_tees_reads(tmp_path):
    rec = recorder.SampleRecorder(str(tmp_path / "tee.npy"))
    src = recorder.RecordingSource(source.SyntheticSource(iq=True, seed=1), rec)
    reads = [src.read(100) for _ in range(3)]
    meta = rec.close()
    assert meta["complex"] and meta["samples"] == 300
    assert np.array_equal(np.load(tmp_path / "tee.npy"), np.concatenate(reads, axis=-1))
    with pytest.raises(ValueError, match="closed"):
        rec.append(reads[0])
    assert tpu_sdr_torch.RecordingSource is recorder.RecordingSource
    assert tpu_sdr_torch.SampleRecorder is recorder.SampleRecorder


# ---------------------------------------------------------------- waterfall


@pytest.mark.parametrize("detector", waterfall.DETECTORS)
@pytest.mark.parametrize("db", [True, False], ids=["db", "linear"])
def test_decimate_db_matches_jax(detector, db):
    """The pooled values are exact for peak, minpeak and sample (a selection)
    and within fp32 rounding for avg and rms (sums in another order); the
    dB conversion within 1e-5 dB above the floor, and within an ulp at it
    (the two libraries' log10 differ there by one ulp)."""
    rng = np.random.default_rng(8)
    mag = np.abs(rng.standard_normal((3, 4096))).astype(np.float32) * 100
    mag[1, 1000] = 1e5
    mag[2, :64] = 0.0  # below the floor
    got = waterfall.decimate_db(torch.as_tensor(mag), points=256, db=db, detector=detector).numpy()
    ref = np.asarray(jwaterfall.decimate_db(mag, points=256, db=db, detector=detector))
    assert got.shape == ref.shape == (3, 256) and got.dtype == np.float32
    if not db and detector in ("peak", "minpeak", "sample"):
        assert np.array_equal(got, ref)
    elif not db:
        assert np.allclose(got, ref, rtol=1e-6, atol=0)
    else:
        floor = ref < -170
        assert floor.any() and np.abs(got - ref)[~floor].max() <= 1e-5
        assert np.abs(got - ref)[floor].max() <= np.spacing(np.float32(180))


def test_decimate_and_bucketed_validation():
    mag = torch.ones(1000)
    with pytest.raises(ValueError, match="divisible"):
        waterfall.decimate_db(mag, points=64)
    with pytest.raises(ValueError, match="detector"):
        waterfall.decimate_db(torch.ones(1024), points=64, detector="bogus")
    x = np.random.default_rng(9).standard_normal(50)
    for edges in (np.array([0, 3, 3, 10, 50]), np.array([0, 2, 4, 4])):
        for det in waterfall.DETECTORS:
            assert np.array_equal(waterfall.detect_bucketed(x, edges, det),
                                  jwaterfall.detect_bucketed(x, edges, det))


def test_waterfall_push_image_peak_match_jax():
    a, b = waterfall.Waterfall(points=64, depth=5, avg_alpha=0.2), jwaterfall.Waterfall(
        points=64, depth=5, avg_alpha=0.2)
    rng = np.random.default_rng(10)
    for k in range(4):
        rows = rng.standard_normal((k + 1, 64)).astype(np.float32) * 20 - 60
        a.push(torch.as_tensor(rows))  # a tensor row batch
        b.push(rows)
    assert np.array_equal(a.image(), b.image()) and np.array_equal(a.latest(), b.latest())
    assert np.array_equal(a.peak_hold, b.peak_hold) and np.array_equal(a.average, b.average)
    assert a.row_count == b.row_count == 10
    a.reset_peak()
    assert (a.peak_hold == -200.0).all()
    a.clear()
    assert a.row_count == 0 and (a.image() == -200.0).all()


# ---------------------------------------------------------------- feeder


def test_feeder_stages_chunks_in_order_on_the_cpu():
    src = source.SyntheticSource(tones_hz=((100e3, 0.5),), adc_bits=None)
    ref = source.SyntheticSource(tones_hz=((100e3, 0.5),), adc_bits=None)
    f = StreamFeeder(src, chunk_samples=4096, depth=2, device="cpu").start()
    try:
        chunks = [f.get() for _ in range(4)]
    finally:
        f.stop()
    assert all(isinstance(c, torch.Tensor) and c.dtype == torch.float32 for c in chunks)
    got = torch.cat([c[0] for c in chunks]).numpy()
    assert np.array_equal(got, ref.read(4 * 4096)[0])
    assert f.chunks_staged >= 4


def test_feeder_backpressure_bounds_the_reads():
    reads = []

    def counted(n):
        reads.append(n)
        return np.zeros((1, n), np.float32)

    f = StreamFeeder(source.CallbackSource(counted), chunk_samples=64, depth=2,
                     device="cpu").start()
    try:
        deadline = time.monotonic() + 10
        while len(reads) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.3)  # a fourth read would need a free slot
        # depth staged + one read blocked on the full queue
        assert f.chunks_staged == 2 and len(reads) == 3
        f.get()
        deadline = time.monotonic() + 5
        while f.chunks_staged < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert f.chunks_staged == 3
    finally:
        f.stop()


def test_feeder_surfaces_errors_after_staged_chunks_and_restarts():
    calls = {"n": 0}

    def flaky(n):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("source died")
        return np.full((1, n), float(calls["n"]), np.float32)

    f = StreamFeeder(source.CallbackSource(flaky), chunk_samples=32, depth=4, device="cpu")
    f.start()
    try:
        assert f.get(timeout=5).flatten()[0] == 1.0  # staged before the failure
        assert f.get(timeout=5).flatten()[0] == 2.0
        with pytest.raises(RuntimeError, match="source died"):
            f.get(timeout=5)
        f.stop()
        f.start()  # a restart starts clean
        assert f.get(timeout=5).flatten()[0] == 4.0
    finally:
        f.stop()
    # sharding= (a 1 x 1 mesh outside torch.distributed): the whole chunk
    # is this rank's block, handed over as a ShardedArray on the mesh's device
    from tpu_sdr_torch.shard import make_sdr_mesh

    mesh = make_sdr_mesh(devices="cpu")
    with pytest.raises(ValueError, match="mesh's device"):
        StreamFeeder(source.CallbackSource(flaky), 32, sharding=mesh, device="cuda")
    block = lambda n: np.arange(2 * n, dtype=np.float32).reshape(2, n)
    f = StreamFeeder(source.CallbackSource(block), 32, sharding=mesh).start()
    try:
        got = f.get(timeout=5)
    finally:
        f.stop()
    assert f.device == mesh.device and got.shape == (2, 32)
    assert torch.equal(got.local, torch.as_tensor(block(32)))


def test_feeder_iq_planes_feed_process_planes():
    n = 16384
    src = source.SyntheticSource(tones_hz=((-250e3, 0.5),), iq=True)
    f = StreamFeeder(src, chunk_samples=n, device="cpu").start()
    try:
        chunk = f.get(timeout=10)
    finally:
        f.stop()
    assert chunk.shape == (2, 1, n) and chunk.dtype == torch.float32
    pipe = SpectrumPipeline(PipelineConfig(channels=1), device="cpu")
    out, _ = pipe.process_planes(chunk, pipe.initial_state(batch_shape=(2,)), FilterMode.BYPASS)
    k = round(250e3 * n / FS)
    assert int(torch.argmax(out["magnitude"][0, 0])) == n - k


def test_feeder_stop_waits_out_a_blocked_producer_before_restart():
    gate = threading.Event()

    def slow(n):
        gate.wait(10)
        return np.zeros((1, n), np.float32)

    f = StreamFeeder(source.CallbackSource(slow), chunk_samples=8, device="cpu").start()
    time.sleep(0.1)
    f._stop.set()
    threading.Timer(0.3, gate.set).start()
    f.start()  # joins the blocked producer first: never two over one source
    try:
        assert f.get(timeout=5).shape == (1, 8)
    finally:
        f.stop()


def _ring_source(slots=3, channels=2, t=16, **kw):
    src = source.PinnedRingSource(slots, (channels, t), pin=False, **kw)
    for i, slot in enumerate(src.slots):
        slot.fill_(float(i))
    return src


class _Copy:
    """Stands in for a copy's CUDA event: finished once ``finish()``."""

    def __init__(self):
        self.done = threading.Event()

    def finish(self):
        self.done.set()

    def query(self):
        return self.done.is_set()

    def synchronize(self):
        assert self.done.wait(10)


def test_pinned_ring_source_keeps_its_order_across_a_wrap_and_resets():
    src = _ring_source()
    got = [src.read(16) for _ in range(7)]
    assert [int(x[0, 0]) for x in got] == [0, 1, 2, 0, 1, 2, 0]
    assert all(x is src.slots[k % 3] for k, x in enumerate(got))  # the slot, not a copy
    src.reset()
    assert src.read(16) is src.slots[0] and src.read(16) is src.slots[1]
    with pytest.raises(ValueError, match="16 samples"):
        src.read(8)
    mine = [torch.full((1, 4), 5.0), torch.full((1, 4), 6.0)]
    adopted = source.PinnedRingSource(mine)
    assert [adopted.read(4) for _ in range(3)] == [mine[0], mine[1], mine[0]]
    with pytest.raises(ValueError, match="equal float32"):
        source.PinnedRingSource([torch.zeros(1, 4), torch.zeros(1, 5)])


def test_pinned_ring_source_hands_a_slot_out_again_only_after_its_release():
    seen = []
    in_flight = _Copy()
    src = _ring_source(slots=2,
                       refill=lambda slot: seen.append((slot.data_ptr(), in_flight.query())))
    first = src.read(16)
    src.release(first, in_flight)
    src.release(src.read(16), None)
    got = []
    reader = threading.Thread(target=lambda: got.append(src.read(16)))
    reader.start()
    time.sleep(0.2)
    assert reader.is_alive() and not got  # slot 0's copy has not finished
    in_flight.finish()
    reader.join(5)
    assert got == [first] and src.release_waits == 1
    # the front end refilled slot 0 the second time only after its copy
    assert seen[2] == (first.data_ptr(), True)


def test_feeder_takes_ring_slots_without_a_host_copy():
    chunk_bytes = 2 * 16 * 4
    src = _ring_source()
    f = StreamFeeder(src, chunk_samples=16, depth=2, device="cpu").start()
    try:
        chunks = [f.get(timeout=5) for _ in range(7)]  # over two wraps of the ring
    finally:
        f.stop()
    assert [int(c[0, 0]) for c in chunks] == [0, 1, 2, 0, 1, 2, 0]
    assert all(c.dtype == torch.float32 and c.shape == (2, 16) for c in chunks)
    # each chunk crossed on its own: no chunk shares the slot's memory
    assert not {c.data_ptr() for c in chunks} & {s.data_ptr() for s in src.slots}
    assert f.stats["host_copies"] == 0 and f.chunks_staged >= 7
    assert f.stats["bytes_staged"] == f.chunks_staged * chunk_bytes
    src.reset()
    f.start()
    try:
        assert int(f.get(timeout=5)[0, 0]) == 0
    finally:
        f.stop()


def test_feeder_staging_path_still_counts_its_host_copies():
    f = StreamFeeder(source.SyntheticSource(channels=2), chunk_samples=64, depth=2,
                     device="cpu").start()
    try:
        for _ in range(4):
            f.get(timeout=5)
    finally:
        f.stop()
    assert f.chunks_staged >= 4 and f.stats["host_copies"] == f.chunks_staged
    assert f.stats["bytes_staged"] == f.chunks_staged * 2 * 64 * 4
    assert f.stats["release_waits"] == 0


def test_feeder_stages_a_sources_tensors_that_take_no_release():
    """A source that hands out float32 tensors but takes no copy's event
    back keeps the staging path: it may rewrite its tensor at once, so each
    chunk is copied on the host first."""
    block = torch.zeros(2, 16)
    k = iter(range(100))

    def refilled(n):
        block.fill_(float(next(k)))  # the same tensor, rewritten each read
        return block

    f = StreamFeeder(source.CallbackSource(refilled), chunk_samples=16, depth=2,
                     device="cpu").start()
    try:
        chunks = [f.get(timeout=5) for _ in range(4)]
    finally:
        f.stop()
    assert [float(c[0, 0]) for c in chunks] == [0.0, 1.0, 2.0, 3.0]
    assert f.stats["host_copies"] == f.chunks_staged >= 4
    assert f.stats["bytes_staged"] == f.chunks_staged * 2 * 16 * 4


def test_feeder_counts_the_gets_that_wait():
    gate = threading.Event()

    def held(n):
        gate.wait(10)
        return np.zeros((1, n), np.float32)

    f = StreamFeeder(source.CallbackSource(held), chunk_samples=8, device="cpu").start()
    try:
        threading.Timer(0.2, gate.set).start()
        f.get(timeout=5)  # nothing staged until the gate opens
        assert f.stats["consumer_waits"] == 1
    finally:
        f.stop()


def test_feeder_spans_appear_under_the_profiler():
    """The consumer's ``get()`` under any profiler; the producer thread's
    stage span under one that records every thread."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    def keys(config=None):
        kw = {} if config is None else {"experimental_config": config}
        with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
            f = StreamFeeder(_ring_source(), chunk_samples=16, device="cpu").start()
            try:
                for _ in range(3):
                    f.get(timeout=5)
            finally:
                f.stop()
        return {e.key: e.count for e in prof.key_averages()}

    every = keys(_ExperimentalConfig(profile_all_threads=True))
    assert every["tpu_sdr.feeder.get"] == 3 and every["tpu_sdr.feeder.stage"] >= 3
    assert keys()["tpu_sdr.feeder.get"] == 3


# ---------------------------------------------------------------- A20 names


def test_golden_oracles_match_jax():
    x = jgolden.synth_tone(123e3, 4096, noise=0.1, seed=2)
    assert np.array_equal(golden.synth_tone(123e3, 4096, noise=0.1, seed=2), x)
    sos = sps.butter(4, 0.2, output="sos")
    for a, b in zip(golden.sosfilt_golden(sos, x), jgolden.sosfilt_golden(sos, x)):
        assert np.array_equal(a, b)
    assert np.array_equal(golden.fft_golden(x), jgolden.fft_golden(x))
    assert np.array_equal(golden.magnitude_golden(golden.fft_golden(x)),
                          jgolden.magnitude_golden(jgolden.fft_golden(x)))
    for window in ("hann", "rtl", None):
        a = golden.golden_pipeline(x, sos, window=window, n=1024)
        b = jgolden.golden_pipeline(x, sos, window=window, n=1024)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    q = (np.random.default_rng(3).standard_normal(512) * 9000).astype(np.int16)
    c = np.array([10, 3, -7, 64, 2, 1, -5, 4, 9, 64, -3, 2], np.int64)
    assert np.array_equal(golden.rtl_biquad12_quirky(c, q), jgolden.rtl_biquad12_quirky(c, q))
    sq = np.array([[20, 40, 20, 64, -30, 12], [64, 0, 0, 64, 0, 0]])
    zi = np.array([[5, -3], [100, 7]])
    for a, b in zip(golden.sosfilt_q15_intended(sq, q, zi), jgolden.sosfilt_q15_intended(sq, q, zi)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("frame_blocks", [None, 4])
def test_sosfilt_blocked_matches_jax_and_scipy(frame_blocks):
    torch.set_num_threads(1)
    sos = sps.butter(6, 0.2, output="sos")
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 16 * 128)).astype(np.float32)
    zi = (0.1 * rng.standard_normal((2, 3, 2))).astype(np.float32)
    op = biquad.precompute(sos, 128, device="cpu")
    jop = jbiquad.precompute(sos, 128)
    for k in ("T", "M", "P", "AL"):
        assert np.array_equal(getattr(op, k).numpy(), np.asarray(getattr(jop, k))), k
    assert op.n_sections == 3 and op.block == 128
    y, zf = biquad.sosfilt_blocked(op, torch.as_tensor(x), torch.as_tensor(zi), frame_blocks)
    jy, jzf = jax.jit(jbiquad.sosfilt_blocked, static_argnames=("frame_blocks",))(
        jop, x, zi, frame_blocks=frame_blocks)
    ref = np.stack([sps.sosfilt(sos, x[r].astype(np.float64), zi=zi[r].astype(np.float64))[0]
                    for r in range(2)])
    scale = np.abs(ref).max()
    assert np.abs(y.numpy() - np.asarray(jy)).max() <= 1e-5 * scale
    assert np.abs(y.numpy() - ref).max() <= 1e-5 * scale
    assert np.abs(zf.numpy() - np.asarray(jzf)).max() <= 1e-5 * np.abs(np.asarray(jzf)).max()
    if frame_blocks:
        # chunked at frame granularity == one-shot, bit for bit
        y1, z1 = biquad.sosfilt_blocked(op, torch.as_tensor(x[:, :1024]), torch.as_tensor(zi), 4)
        y2, z2 = biquad.sosfilt_blocked(op, torch.as_tensor(x[:, 1024:]), z1, 4)
        assert torch.equal(torch.cat([y1, y2], dim=-1), y) and torch.equal(z2, zf)


def test_sosfilt_scan_ref_matches_jax():
    sos = sps.cheby1(4, 1, 0.3, output="sos")
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 300)).astype(np.float32)
    zi = (0.1 * rng.standard_normal((2, 2, 2))).astype(np.float32)
    y, zf = biquad.sosfilt_scan_ref(sos, torch.as_tensor(x), torch.as_tensor(zi))
    jy, jzf = jbiquad.sosfilt_scan_ref(sos, x, zi)
    assert np.allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    assert np.allclose(zf.numpy(), np.asarray(jzf), rtol=0, atol=1e-5)


def test_magnitude_db_and_fft_golden_check_match_jax():
    rng = np.random.default_rng(13)
    re = rng.standard_normal(1000).astype(np.float32)
    im = rng.standard_normal(1000).astype(np.float32)
    re[:5] = im[:5] = 0.0  # below the floor
    got = magnitude.magnitude_db(torch.as_tensor(re), torch.as_tensor(im)).numpy()
    ref = np.asarray(jmagnitude.magnitude_db(re, im))
    assert np.abs(got - ref).max() <= 1e-5 and (got[:5] == -120.0).all()
    for xi in (None, im):
        for a, b in zip(fft.fft_golden_check(re, xi), jfft.fft_golden_check(re, xi)):
            assert np.array_equal(a, b)
