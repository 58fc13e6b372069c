"""The port's GUI backend and stdlib server (``tpu_sdr_torch.gui``) on the
CPU: the 34 tests of ``tests/test_gui.py`` with ``device="cpu"`` and every
wait bounded by 10 s, then each deterministic output held to the JAX
package's ``GuiBackend`` on the same input."""

import json
import time
import urllib.request

import numpy as np
import pytest

from tpu_sdr_torch.control import SpectrumAnalyzer
from tpu_sdr_torch.core.config import FilterMode, PipelineConfig
from tpu_sdr_torch.gui.backend import GuiBackend
from tpu_sdr_torch.gui.server import serve
from tpu_sdr_torch.runtime.source import SyntheticSource


@pytest.fixture(scope="module")
def server():
    backend = GuiBackend(
        analyzer=SpectrumAnalyzer(PipelineConfig(channels=1), device="cpu"),
        source=SyntheticSource(tones_hz=((100_000.0, 0.5),), noise=0.005),
        display_fps=1000.0,
    )
    srv, backend = serve(backend, port=0, bind="127.0.0.1", block=False)
    yield srv, backend
    backend.stop_receiver()
    srv.shutdown()


def _post(srv, route, body=None):
    port = srv.server_address[1]
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/{route}",
        data=json.dumps(body or {}).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=5) as r:
        return json.loads(r.read())


def _get(srv, path):
    port = srv.server_address[1]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.read()


def test_index_served(server):
    srv, _ = server
    html = _get(srv, "/").decode()
    assert "Real-Time FFT Analyzer" in html
    assert "EventSource" in html  # live transport wired


def test_state_endpoint(server):
    srv, _ = server
    st = json.loads(_get(srv, "/api/state"))
    assert st["config"]["fft_size"] == 16384
    assert st["config"]["hz_per_bin"] == pytest.approx(61.035, rel=1e-3)


def test_frame_events_flow(server):
    srv, backend = server
    q = backend.subscribe()
    deadline = time.time() + 10
    frame = None
    while time.time() < deadline:
        try:
            ev, payload = q.get(timeout=1.0)
        except Exception:
            continue
        if ev == "frame_data":
            frame = json.loads(payload)
            break
    backend.unsubscribe(q)
    assert frame is not None, "no frame_data event"
    assert abs(frame["peak_freq_khz"] - 100.0) < 1.0
    # sub-bin interpolated marker: ~61 Hz/bin display, peak good to <30 Hz
    assert abs(frame["peak_freq_interp_khz"] - 100.0) < 0.03
    assert len(frame["magnitude"]) <= 2048


def test_designer_preview_and_apply(server):
    srv, backend = server
    _post(srv, "update_filter_config", {"kind": "elliptic", "order": 6,
                                        "cutoff_hz": 150000.0})
    p = _post(srv, "generate_filter_preview")
    assert p["ok"]
    assert len(p["mag_db"]) == len(p["freqs_hz"])
    assert len(p["sos"]) == 3  # order 6 -> 3 sections
    r = _post(srv, "apply_filter_to_fpga")
    assert r["ok"]
    assert backend.sa.filter_mode == FilterMode.CUSTOM
    # response preview should show a lowpass: DC near 0 dB, deep stopband
    mags = np.array(p["mag_db"])
    assert mags[0] > -6 and mags[-1] < -40


def test_designer_preview_png(server):
    """Rendered base64-PNG preview — the reference's
    generate_filter_response_plot contract (fft_analyzer_gui.py:190-230)."""
    pytest.importorskip("matplotlib")
    srv, _ = server
    _post(srv, "update_filter_config", {"kind": "butterworth", "order": 4,
                                        "cutoff_hz": 100000.0})
    p = _post(srv, "generate_filter_preview_png")
    assert p["ok"]
    prefix = "data:image/png;base64,"
    assert p["image"].startswith(prefix)
    import base64

    raw = base64.b64decode(p["image"][len(prefix):])
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"  # PNG magic
    assert len(raw) > 5000  # an actual rendered plot, not a stub


def test_designer_invalid_cutoff_clean_error(server):
    srv, _ = server
    _post(srv, "update_filter_config", {"cutoff_hz": 900000.0, "kind": "butterworth", "order": 4})
    p = _post(srv, "generate_filter_preview")
    assert not p["ok"]
    assert "cutoff" in p["error"]


def test_mode_and_range_endpoints(server):
    srv, backend = server
    _post(srv, "set_filter_type", {"mode": "bypass"})
    assert backend.sa.filter_mode == FilterMode.BYPASS
    _post(srv, "apply_frequency_range", {"lo_khz": 50, "hi_khz": 200})
    assert backend.freq_range_khz == (50.0, 200.0)
    _post(srv, "fpga_reset")
    assert backend.sa.stats.resets >= 1
    # restart for other tests
    _post(srv, "start_receiver")


def test_bad_json_400(server):
    srv, _ = server
    port = srv.server_address[1]
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/set_mode",
        data=b"not json",
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=5)
    assert e.value.code == 400


def test_display_modes(server):
    srv, backend = server
    _post(srv, "start_receiver", {})
    _post(srv, "set_display_mode", {"mode": "real"})
    assert backend.display_mode == "real"
    # a frame in 'real' mode arrives and decodes
    import json as _json, time as _time
    q = backend.subscribe()
    deadline = _time.time() + 10
    got = None
    while _time.time() < deadline:
        try:
            ev, payload = q.get(timeout=1.0)
        except Exception:
            continue
        d = _json.loads(payload)
        if ev == "frame_data" and d.get("display_mode") == "real":
            got = d
            break
    backend.unsubscribe(q)
    assert got is not None
    _post(srv, "set_display_mode", {"mode": "magnitude"})
    # probe: invalid mode -> 400
    import urllib.request, urllib.error, pytest as _pytest
    port = srv.server_address[1]
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/set_display_mode",
        data=b'{"mode": "phase-of-the-moon"}',
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with _pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=5)
    assert e.value.code == 400


def test_waterfall_events(server):
    srv, backend = server
    import json as _json, time as _time
    _post(srv, "start_receiver", {})
    q = backend.subscribe()
    deadline = _time.time() + 10
    got = None
    while _time.time() < deadline:
        try:
            ev, payload = q.get(timeout=1.0)
        except Exception:
            continue
        if ev == "waterfall_row":
            got = _json.loads(payload)
            break
    backend.unsubscribe(q)
    assert got is not None
    assert len(got["row_db"]) == backend.waterfall.points
    assert len(got["peak_hold_db"]) == backend.waterfall.points
    assert got["rows"] >= 1


def test_command_console(server):
    srv, backend = server
    r = _post(srv, "send_command", {"hex": "b1 55"})
    assert r["ok"] and r["events"] == ["MODE_BYPASS", "START"]
    assert backend.sa.running
    # coefficient upload through the console, split across two sends
    r = _post(srv, "send_command", {"hex": "f1 40 00 00 40 00 00"})
    assert r["ok"] and any("awaiting" in e for e in r["events"])
    r = _post(srv, "send_command", {"hex": "40 00 00 40 00 00"})
    assert r["ok"] and r["events"] == ["COEFFICIENTS[12]"]
    # probe: garbage hex -> clean error
    r = _post(srv, "send_command", {"hex": "zz"})
    assert not r["ok"]


def test_update_config_and_reset_plot(server):
    """Reference SocketIO events 'update_config' and 'reset_plot'
    (SURVEY.md §2.5): runtime display config + display/stats reset."""
    srv, backend = server
    # Quiesce the acquisition thread: reset_plot zeroes live counters, so
    # asserting exact zeros requires no concurrent producer.
    _post(srv, "stop_receiver")
    try:
        assert _post(
            srv, "update_config", {"display_fps": 10, "display_points": 256}
        )["ok"]
        assert backend.display_fps == 10.0
        assert backend.display_points == 256
        # unknown keys are ignored (with a status toast), not applied
        assert _post(srv, "update_config", {"bogus_field": 1})["ok"]
        assert not hasattr(backend, "bogus_field")
        # a malformed field must not half-apply the update
        try:
            _post(srv, "update_config", {"display_fps": 33, "display_points": "x"})
        except Exception:
            pass
        assert backend.display_fps == 10.0  # unchanged: atomic rejection

        backend.waterfall.push(np.full(backend.waterfall.points, -10.0))
        backend.sa.stats.frames_produced = 99
        assert _post(srv, "reset_plot")["ok"]
        assert backend.waterfall.row_count == 0
        assert float(backend.waterfall.peak_hold.max()) == -200.0
        assert backend.sa.stats.frames_produced == 0
    finally:
        # restore fixture state (update_config clamps fps to 120, so assign)
        backend.display_fps = 1000.0
        backend.display_points = 2048
        _post(srv, "start_receiver")


def test_detector_config(server):
    """The waterfall display detector is selectable via update_config and
    reported in /api/state."""
    srv, backend = server
    # Quiesce the acquisition thread: latest() must reflect OUR pushes.
    _post(srv, "stop_receiver")
    try:
        assert _post(srv, "update_config", {"detector": "rms"})["ok"]
        assert backend.detector == "rms"
        assert json.loads(_get(srv, "/api/state"))["detector"] == "rms"
        # invalid detector rejected, config unchanged
        try:
            _post(srv, "update_config", {"detector": "bogus"})
        except Exception:
            pass
        assert backend.detector == "rms"
        # the emit path applies the detector: avg of a flat-with-spike row
        # is below its peak
        row = np.ones(backend.sa.cfg.fft_size, np.float32)
        row[100] = 100.0
        backend.detector = "peak"
        backend._emit_waterfall_row(row)
        peak_db = float(backend.waterfall.latest().max())
        backend.detector = "avg"
        backend._emit_waterfall_row(row)
        avg_db = float(backend.waterfall.latest().max())
        assert peak_db == pytest.approx(40.0, abs=0.1)
        assert avg_db < peak_db - 10
    finally:
        backend.detector = "peak"
        _post(srv, "start_receiver")


def test_audio_demod_endpoints(server, tmp_path, monkeypatch):
    """The live-audio receiver: enable via set_audio, feed FM chunks
    through the loop tap, save a WAV via save_audio."""
    import wave

    srv, backend = server
    _post(srv, "stop_receiver")
    monkeypatch.chdir(tmp_path)  # captures/ lands in tmp
    try:
        r = _post(srv, "set_audio",
                  {"enabled": True, "center_khz": 250.0, "mode": "wbfm"})
        assert r["ok"] and backend.audio_cfg["enabled"]
        # Feed synthesized WBFM chunks exactly like the acquisition loop.
        fs = backend.sa.cfg.sample_rate
        g = backend._audio_rt["rx"].chunk_granularity
        n = np.arange(8 * g)
        msg = np.sin(2 * np.pi * 1000.0 * n / fs)
        ph = 2 * np.pi * 250e3 * n / fs + 2 * np.pi * 75e3 / fs * np.cumsum(msg)
        x = (0.5 * np.cos(ph)).astype(np.float32)
        for i in range(0, x.size, 2 * g):
            backend._audio_step(x[i : i + 2 * g])
        st = json.loads(_get(srv, "/api/state"))["audio"]
        assert st["enabled"] and st["buffered_seconds"] > 0
        out = _post(srv, "save_audio")
        assert out["ok"] and out["seconds"] > 0
        with wave.open(out["path"], "rb") as w:
            rate = w.getframerate()
            pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        a = pcm.astype(np.float64)[int(0.01 * rate):]
        spec = np.abs(np.fft.rfft(a * np.hanning(a.size)))
        f_peak = np.argmax(spec) * rate / a.size
        assert f_peak == pytest.approx(1000.0, abs=3 * rate / a.size)
        # invalid mode rejected with a 400
        import urllib.error

        with pytest.raises(urllib.error.HTTPError):
            _post(srv, "set_audio", {"mode": "fm"})
    finally:
        _post(srv, "set_audio", {"enabled": False})
        _post(srv, "start_receiver")


def test_iq_correction_path():
    """update_config {'iq_correction': true} runs the blind corrector
    over complex chunks in the acquisition path (carried state)."""
    from tpu_sdr_torch.kernels.iqcorr import apply_imbalance

    b = GuiBackend(source=None, device="cpu")
    b.update_config({"iq_correction": True})
    assert b.iq_correction and b.get_state()["iq_correction"]
    fs = 1e6
    n = np.arange(65536)
    z = np.exp(2j * np.pi * 150e3 * n / fs)
    zi = apply_imbalance(z, gain_db=1.0, phase_deg=5.0).astype(np.complex64)

    def image_db(w):
        m = w.size
        spec = np.abs(np.fft.fft(w * np.hanning(m))) ** 2
        k = int(round(150e3 / fs * m))
        return 10 * np.log10(spec[m - k] / spec[k])

    w1 = b._iq_correct(zi)  # converging
    w2 = b._iq_correct(zi)  # converged
    assert image_db(np.asarray(w2, np.complex128)) < image_db(zi) - 20
    b.update_config({"iq_correction": False})
    assert b._iqcorr_rt is None


def test_scan_endpoint(server):
    """POST /api/scan sweeps the raw-sample ring and reports occupancy
    (the demo source's tones land in their channels)."""
    srv, backend = server
    deadline = time.time() + 10
    while backend._scan_ring.size < 100_000 and time.time() < deadline:
        time.sleep(0.2)  # the acquisition loop fills the ring
    assert backend._scan_ring.size >= 100_000
    r = _post(srv, "scan", {"start_khz": 0, "stop_khz": 500, "bw_khz": 25})
    assert r["ok"] and r["n_channels"] == 20
    hits_khz = [h["center_khz"] for h in r["hits"]]
    # the GUI fixture's synthetic source carries a 100 kHz tone (channel
    # edge: it may land in either adjacent channel)
    assert any(abs(c - 100.0) <= 13 for c in hits_khz), hits_khz
    assert len(r["power_db"]) == 20


def test_demod_burst_endpoint(server):
    """POST /api/demod_burst recovers the exact bits of a QPSK burst
    planted in the raw-sample ring (carrier mix-down included)."""
    srv, backend = server
    from tpu_sdr_torch.kernels.digital import BurstModem

    backend.stop_receiver()  # the live loop must not overwrite the ring
    try:
        rng = np.random.default_rng(0xB0B)
        mod = BurstModem("qpsk", sps=8, device="cpu")
        bits = rng.integers(2, size=512).astype(np.uint8)
        re, im = mod.modulate(bits, pad_syms=mod.max_lag_syms + mod.span)
        fs = backend.sa.cfg.sample_rate
        fc = 150e3
        z = (re + 1j * im) * np.exp(
            2j * np.pi * fc / fs * np.arange(re.size) + 0.4j)
        backend._scan_ring = np.concatenate(
            [np.zeros(40), z]).astype(np.complex64)
        r = _post(srv, "demod_burst",
                  {"scheme": "qpsk", "bits": 512, "center_khz": fc / 1e3})
        assert r["ok"] and r["n_bits"] == 512
        padn = (-512) % 8
        want = np.packbits(
            np.concatenate([bits, np.zeros(padn, np.uint8)])).tobytes().hex()
        assert r["bits_hex"] == want
        assert r["frame_lag_syms"] == 5
        pts = r["constellation"]
        assert len(pts["re"]) == len(pts["im"]) >= 256
        # unit-ring QPSK points after sync
        rad = np.hypot(np.asarray(pts["re"]), np.asarray(pts["im"]))
        assert np.all(np.abs(rad - 1.0) < 0.2)
    finally:
        backend.start_receiver()  # module-scoped fixture: restore the loop


def test_demod_burst_validation(server):
    srv, backend = server
    import urllib.error

    backend.stop_receiver()  # keep the planted empty ring empty
    try:
        backend._scan_ring = np.zeros(0, np.float32)
        for body in ({"scheme": "qpsk"},              # missing bits
                     {"scheme": "qpsk", "bits": 64}):  # empty ring
            try:
                _post(srv, "demod_burst", body)
                assert False, "expected HTTP 400"
            except urllib.error.HTTPError as e:
                assert e.code == 400
    finally:
        backend.start_receiver()


def test_trace_overlays(server):
    """Peak-hold / average detector traces ride frame_data when enabled."""
    srv, backend = server
    q = backend.subscribe()
    try:
        assert _post(srv, "update_config", {"traces_enabled": True})["ok"]
        frames = []
        deadline = time.time() + 10
        while time.time() < deadline and len(frames) < 4:
            try:
                ev, payload = q.get(timeout=1.0)
            except Exception:
                continue
            d = json.loads(payload) if ev == "frame_data" else None
            if d and "trace_peak" in d:
                frames.append(d)
        assert len(frames) >= 2, "no frames with traces"
        last = frames[-1]
        mag = np.array(last["magnitude"])
        pk = np.array(last["trace_peak"])
        av = np.array(last["trace_avg"])
        assert pk.shape == mag.shape == av.shape
        # peak-hold dominates the live trace (up to emit rounding)
        assert (pk >= mag - 1e-3).all()
        # peak-hold is monotone non-decreasing across frames
        p0 = np.array(frames[0]["trace_peak"])
        assert (pk >= p0 - 1e-3).all()
        # disabling drops the fields and clears state
        assert _post(srv, "update_config", {"traces_enabled": False})["ok"]
        assert backend._trace_peak is None
    finally:
        backend.unsubscribe(q)
        _post(srv, "update_config", {"traces_enabled": False})


def test_roofline_endpoint(server):
    """SURVEY.md §5.1: roofline counters surfaced through the stats channel."""
    srv, backend = server
    port = srv.server_address[1]
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/api/roofline", timeout=5
    ) as r:
        rep = json.loads(r.read())
    assert rep["chip"] == "h100" and rep["bound"] in ("compute", "memory")
    assert rep["ceiling_samples_per_sec"] > 1e9
    assert "fft_4step" in rep["stages"]


def test_iq_gui_backend_full_baseband():
    """An IQ source drives the GUI: fftshifted full-baseband display with
    negative-frequency axis, waterfall rows, correct peak."""
    backend = GuiBackend(
        analyzer=SpectrumAnalyzer(PipelineConfig(channels=1), device="cpu"),
        source=SyntheticSource(
            tones_hz=((150_000.0, 0.5), (-300_000.0, 0.4)), iq=True, noise=0.003
        ),
        display_fps=1000.0,
    )
    q = backend.subscribe()
    backend.start_receiver()
    try:
        deadline = time.time() + 10
        frame = None
        while time.time() < deadline:
            try:
                ev, payload = q.get(timeout=1.0)
            except Exception:
                continue
            if ev == "frame_data":
                frame = json.loads(payload)
                break
        assert frame is not None
        freqs = np.array(frame["freqs_khz"])
        assert freqs[0] < -400.0 and freqs[-1] > 400.0  # full baseband axis
        mags = np.array(frame["magnitude"])
        # strongest display bucket near +150 kHz; -300 kHz tone visible
        assert abs(freqs[np.argmax(mags)] - 150.0) < 2.0
        near_m300 = mags[np.abs(freqs + 300.0) < 3.0].max()
        floor = np.median(mags)
        assert near_m300 > 20 * floor
    finally:
        backend.unsubscribe(q)
        backend.stop_receiver()


def test_zoom_mode_events():
    """Zoom: PFB subchannel -> zoom FFT in the live loop; the zoom_frame
    peak recovers a tone's frequency to sub-bin (<8 Hz) accuracy that the
    main 61 Hz/bin display cannot express."""
    fs, m, k = 1e6, 128, 32
    f_tone = k * fs / m + 1037.0  # 250 kHz subchannel center + 1037 Hz
    backend = GuiBackend(
        analyzer=SpectrumAnalyzer(PipelineConfig(channels=1), device="cpu"),
        source=SyntheticSource(tones_hz=((f_tone, 0.5),), noise=0.001),
        display_fps=1000.0,
    )
    q = backend.subscribe()
    r = backend.set_zoom({"enabled": True, "channel": k})
    assert r["ok"] and backend.zoom_cfg["enabled"]
    backend.start_receiver()
    try:
        deadline = time.time() + 10
        zooms = []
        while time.time() < deadline and len(zooms) < 2:
            try:
                event, payload = q.get(timeout=1.0)
            except Exception:
                continue
            if event == "zoom_frame":
                zooms.append(json.loads(payload))
    finally:
        backend.stop_receiver()
        backend.unsubscribe(q)
    assert len(zooms) >= 2, "no zoom frames produced"
    z = zooms[-1]  # settled
    assert z["channel"] == k
    assert z["center_khz"] == pytest.approx(250.0)
    assert z["hz_per_bin"] == pytest.approx(fs / m / 1024)
    est_hz = z["center_khz"] * 1e3 + z["peak_offset_hz"]
    assert abs(est_hz - f_tone) < z["hz_per_bin"], (est_hz, f_tone)


def _drain_frames(q, seconds):
    frames = []
    deadline = time.time() + seconds
    while time.time() < deadline:
        try:
            ev, payload = q.get(timeout=0.25)
        except Exception:
            continue
        if ev == "frame_data":
            frames.append(json.loads(payload))
    return frames


def _first_frame(q, seconds):
    """The first frame_data payload within ``seconds``, or None."""
    deadline = time.time() + seconds
    while time.time() < deadline:
        try:
            ev, payload = q.get(timeout=0.25)
        except Exception:
            continue
        if ev == "frame_data":
            return json.loads(payload)
    return None


def test_trigger_modes():
    """Band-power trigger: 'normal' gates frames on threshold; 'single'
    freezes after one crossing until re-armed."""
    backend = GuiBackend(
        analyzer=SpectrumAnalyzer(PipelineConfig(channels=1), device="cpu"),
        source=SyntheticSource(tones_hz=((100_000.0, 0.5),), noise=0.005),
        display_fps=1000.0,
    )
    q = backend.subscribe()
    backend.start_receiver()
    try:
        assert _first_frame(q, 10), "no frames in free run"
        # normal mode, threshold far above the tone: display holds
        r = backend.set_trigger(
            {"enabled": True, "mode": "normal", "threshold_db": 200.0,
             "f_lo_khz": 90.0, "f_hi_khz": 110.0}
        )
        assert r["ok"] and r["armed"]
        _drain_frames(q, 1)  # flush in-flight frames
        assert not _drain_frames(q, 1.5), "frames leaked above threshold"
        # drop the threshold below the tone: frames flow, marked triggered
        backend.set_trigger({"threshold_db": -60.0})
        flowing = _drain_frames(q, 2)
        assert flowing and all(f["triggered"] for f in flowing)
        # single mode: exactly one frame per arm
        backend.set_trigger({"mode": "single", "rearm": True})
        _drain_frames(q, 1)
        assert not backend._trigger_armed  # fired
        assert not _drain_frames(q, 1.5), "frames after single-shot froze"
        backend.set_trigger({"rearm": True})
        assert len(_drain_frames(q, 2)) == 1, "re-arm must yield ONE frame"
        # validation
        with pytest.raises(ValueError, match="trigger mode"):
            backend.set_trigger({"mode": "auto"})
        with pytest.raises(ValueError, match="f_lo"):
            backend.set_trigger({"f_lo_khz": 200.0, "f_hi_khz": 100.0})
        st = backend.get_state()
        assert st["trigger"]["mode"] == "single" and not st["trigger"]["armed"]
    finally:
        backend.set_trigger({"enabled": False})
        backend.stop_receiver()
        backend.unsubscribe(q)


def test_record_endpoints(tmp_path, monkeypatch):
    """Rec: raw samples captured from the live loop into captures/."""
    monkeypatch.chdir(tmp_path)
    backend = GuiBackend(
        analyzer=SpectrumAnalyzer(PipelineConfig(channels=1), device="cpu"),
        source=SyntheticSource(tones_hz=((100_000.0, 0.5),), noise=0.0),
        display_fps=1000.0,
    )
    backend.start_receiver()
    try:
        with pytest.raises(ValueError, match="not recording"):
            backend.stop_record()
        r = backend.start_record(max_seconds=2.0)
        assert r["ok"] and r["path"].startswith("captures/")
        with pytest.raises(ValueError, match="already recording"):
            backend.start_record()
        deadline = time.time() + 10
        while time.time() < deadline and backend._recorder is not None and (
            backend._recorder.samples_written < 16384
        ):
            time.sleep(0.2)
        meta = backend.stop_record()
        assert meta["ok"] and meta["samples"] >= 16384
        # the capture replays: tone at 100 kHz
        from tpu_sdr_torch.runtime.source import FileSource

        src = FileSource(meta["path"])
        assert src.fs == backend.sa.cfg.sample_rate
        x = src.read(16384)[0]
        spec = np.abs(np.fft.rfft(x * np.hanning(x.size)))
        f = np.fft.rfftfreq(x.size, 1 / src.fs)
        assert abs(f[np.argmax(spec)] - 100e3) < 200
    finally:
        backend.stop_receiver()


def test_trigger_band_and_rearm_semantics():
    """Regressions: IQ band honors f_lo (DC must not fire a 90-110 kHz
    trigger); repeated enabled=true must NOT re-arm a fired single-shot."""
    backend = GuiBackend(
        analyzer=SpectrumAnalyzer(PipelineConfig(channels=1), device="cpu"),
        source=SyntheticSource(tones_hz=((100_000.0, 0.5),)),
    )
    n = backend.sa.cfg.fft_size
    trig = {"f_lo_khz": 90.0, "f_hi_khz": 110.0}
    # IQ: strong DC bin + in-band bin at -100 kHz
    backend._iq = True
    mag = np.full(n, 1e-6)
    mag[0] = 1e3  # DC (bin 0 pre-shift)
    assert backend._band_level_db(mag, trig) < -100  # DC excluded
    mag2 = np.full(n, 1e-6)
    mag2[-int(100e3 * n / 1e6)] = 1e3  # -100 kHz (negative sideband)
    assert backend._band_level_db(mag2, trig) > 50
    backend._iq = False
    mag3 = np.full(n, 1e-6)
    mag3[int(50e3 * n / 1e6)] = 1e3  # 50 kHz, below f_lo
    assert backend._band_level_db(mag3, trig) < -100
    # re-arm only on explicit rearm or off->on transition
    backend.set_trigger({"enabled": True, "mode": "single"})
    assert backend._trigger_armed
    backend._trigger_armed = False  # simulate a fired capture
    backend.set_trigger({"enabled": True, "threshold_db": -10.0})
    assert not backend._trigger_armed, "field tweak must not re-arm"
    backend.set_trigger({"rearm": True})
    assert backend._trigger_armed
    backend._trigger_armed = False
    backend.set_trigger({"enabled": False})
    backend.set_trigger({"enabled": True})
    assert backend._trigger_armed, "off->on transition re-arms"


def test_zoom_ddc_mode_events():
    """DDC zoom: arbitrary (off-grid) center frequency; the zoom_frame
    peak recovers the tone offset from the tuned center."""
    fs = 1e6
    center_khz = 217.7  # not on the 7.8125 kHz PFB subchannel grid
    f_tone = center_khz * 1e3 + 512.0
    backend = GuiBackend(
        analyzer=SpectrumAnalyzer(PipelineConfig(channels=1), device="cpu"),
        source=SyntheticSource(tones_hz=((f_tone, 0.5),), noise=0.001),
        display_fps=1000.0,
    )
    q = backend.subscribe()
    r = backend.set_zoom(
        {"enabled": True, "mode": "ddc", "center_khz": center_khz,
         "decimation": 128}
    )
    assert r["ok"] and r["zoom"]["mode"] == "ddc"
    backend.start_receiver()
    try:
        deadline = time.time() + 10
        zooms = []
        while time.time() < deadline and len(zooms) < 2:
            try:
                event, payload = q.get(timeout=1.0)
            except Exception:
                continue
            if event == "zoom_frame":
                zooms.append(json.loads(payload))
    finally:
        backend.stop_receiver()
        backend.unsubscribe(q)
    assert len(zooms) >= 2, "no ddc zoom frames produced"
    z = zooms[-1]
    assert z["mode"] == "ddc"
    assert z["center_khz"] == pytest.approx(center_khz)
    assert z["span_hz"] == pytest.approx(fs / 128)
    est_hz = z["center_khz"] * 1e3 + z["peak_offset_hz"]
    assert abs(est_hz - f_tone) < z["hz_per_bin"], (est_hz, f_tone)


def test_zoom_ddc_mode_iq_source():
    """Regression: DDC zoom with an IQ source (the DDC state excludes the
    plane axis, unlike the Channelizer) — must produce frames, and a
    negative center must resolve the tone."""
    fs = 1e6
    center_khz = -150.3
    f_tone = center_khz * 1e3 + 700.0
    backend = GuiBackend(
        analyzer=SpectrumAnalyzer(PipelineConfig(channels=1), device="cpu"),
        source=SyntheticSource(tones_hz=((f_tone, 0.5),), noise=0.001, iq=True),
        display_fps=1000.0,
    )
    q = backend.subscribe()
    backend.set_zoom(
        {"enabled": True, "mode": "ddc", "center_khz": center_khz,
         "decimation": 128}
    )
    backend.start_receiver()
    try:
        deadline = time.time() + 10
        zooms = []
        while time.time() < deadline and len(zooms) < 2:
            try:
                event, payload = q.get(timeout=1.0)
            except Exception:
                continue
            if event == "zoom_frame":
                zooms.append(json.loads(payload))
    finally:
        backend.stop_receiver()
        backend.unsubscribe(q)
    assert backend.zoom_cfg["enabled"], "zoom self-disabled on IQ source"
    assert len(zooms) >= 2, "no ddc zoom frames from IQ source"
    z = zooms[-1]
    est_hz = z["center_khz"] * 1e3 + z["peak_offset_hz"]
    assert abs(est_hz - f_tone) < z["hz_per_bin"], (est_hz, f_tone)


def test_zoom_validation_and_state():
    backend = GuiBackend(
        analyzer=SpectrumAnalyzer(PipelineConfig(channels=1), device="cpu"),
        source=SyntheticSource(tones_hz=((100e3, 0.5),)),
    )
    with pytest.raises(ValueError, match="zoom channel"):
        backend.set_zoom({"channel": 128})
    with pytest.raises(ValueError, match="zoom mode"):
        backend.set_zoom({"mode": "nope"})
    with pytest.raises(ValueError, match="zoom center"):
        backend.set_zoom({"mode": "ddc", "center_khz": 900.0})
    with pytest.raises(ValueError, match="zoom decimation"):
        backend.set_zoom({"mode": "ddc", "decimation": 1})
    # a rejected update must not half-apply (atomic)
    assert backend.zoom_cfg["mode"] == "pfb"
    r = backend.set_zoom({"enabled": True, "channel": 5})
    assert r["zoom"]["channel"] == 5
    st = backend.get_state()
    assert st["zoom"]["enabled"] and st["zoom"]["m"] == 128
    backend.set_zoom({"enabled": False})
    assert not backend.zoom_cfg["enabled"]


def test_audio_stereo_endpoint(server, tmp_path, monkeypatch):
    """set_audio {'stereo': True} decodes the pilot multiplex: the saved
    WAV is 2-channel with the L tone in channel 0 and the R tone in 1."""
    import wave

    from tpu_sdr_torch.kernels.stereo import make_mpx

    srv, backend = server
    _post(srv, "stop_receiver")
    monkeypatch.chdir(tmp_path)
    try:
        r = _post(srv, "set_audio", {"enabled": True, "center_khz": 250.0,
                                     "mode": "wbfm", "stereo": True})
        assert r["ok"] and backend.audio_cfg["stereo"]
        fs = backend.sa.cfg.sample_rate
        g = backend._audio_rt["rx"].chunk_granularity
        n = np.arange(16 * g)
        t = n / fs
        mpx = make_mpx(0.6 * np.sin(2 * np.pi * 800 * t),
                       0.6 * np.sin(2 * np.pi * 2000 * t), fs)
        ph = 2 * np.pi * np.cumsum(250e3 + 75e3 * mpx) / fs
        x = (0.5 * np.cos(ph)).astype(np.float32)
        for i in range(0, x.size, 4 * g):
            backend._audio_step(x[i: i + 4 * g])
        out = _post(srv, "save_audio")
        assert out["ok"]
        with wave.open(out["path"], "rb") as w:
            assert w.getnchannels() == 2
            rate = w.getframerate()
            pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        a = pcm.astype(np.float64).reshape(-1, 2).T
        a = a[:, a.shape[1] // 2:]  # post pilot lock
        win = np.hanning(a.shape[1])

        def tone(ch, f):
            k = int(round(f * a.shape[1] / rate))
            spec = np.abs(np.fft.rfft(a[ch] * win)) ** 2
            return spec[k - 2: k + 3].max()

        assert 10 * np.log10(tone(0, 800) / tone(0, 2000)) > 15
        assert 10 * np.log10(tone(1, 2000) / tone(1, 800)) > 15
        # stereo demands wbfm
        import urllib.error

        with pytest.raises(urllib.error.HTTPError):
            _post(srv, "set_audio", {"mode": "am", "stereo": True})
    finally:
        _post(srv, "set_audio", {"enabled": False, "stereo": False,
                                 "mode": "wbfm"})
        _post(srv, "start_receiver")


def test_rds_endpoint(server):
    """POST /api/rds decodes PI/PS from an FM+RDS signal planted in the
    raw-sample ring."""
    from tpu_sdr_torch.kernels.rds import RDSEncoder, make_mpx_rds

    srv, backend = server
    backend.stop_receiver()
    try:
        fs = backend.sa.cfg.sample_rate
        n = int(2.0 * fs)
        t = np.arange(n) / fs
        enc = RDSEncoder(pi=0xF00D, pty=7, ps="GUI TEST")
        mpx = make_mpx_rds(0.4 * np.sin(2 * np.pi * 900 * t),
                           0.4 * np.sin(2 * np.pi * 1700 * t), fs, enc,
                           n_groups=32)
        ph = 2 * np.pi * np.cumsum(200e3 + 75e3 * mpx) / fs
        backend._scan_ring = (0.5 * np.cos(ph)).astype(np.float32)
        r = _post(srv, "rds", {"center_khz": 200.0})
        assert r["ok"]
        assert r["pi"] == "F00D"
        assert r["pty"] == 7
        assert r["ps"] == "GUI TEST"
        assert r["block_error_rate"] < 0.3
    finally:
        backend.start_receiver()


def test_zoom_wire_calibration_units():
    """The zoom view reports magnitudes in the SAME wire-LSB units as the
    main plot: each pipeline applies its own schedule-derived 2^15/N scale,
    so a unit-amplitude carrier reads the same level in both views (under
    the xfft 1/N schedule a tone's bin amplitude is N-independent). Guards
    the review finding that zoom emitted raw floats while the main display
    applied wire_calibration — a silent ~6 dB unit mismatch."""
    from tpu_sdr_torch.core.qformat import xfft_wire_scale

    b = GuiBackend(source=None, device="cpu")
    q = b.subscribe()
    try:
        nz = 1024
        rt = {
            "cfg": {"mode": "pfb", "channel": 3, "m": 128, "fft_size": nz},
            "sub_rate": 1e6 / 128,
            "center_hz": 3 * 1e6 / 128,
        }
        mag = np.zeros(nz, np.float32)
        mag[0] = 100.0  # DC bin -> survives fftshift at nz//2
        b._emit_zoom_frame(rt, mag)
        ev, payload = q.get(timeout=1.0)
        assert ev == "zoom_frame"
        z = json.loads(payload)
        # default calibration: zoom applies ITS OWN 2^15/nz (= 32 at 1024),
        # not the main path's 16K-derived 2.0
        expect = 100.0 * xfft_wire_scale(nz)
        assert z["peak_mag"] == pytest.approx(expect)
        assert expect == pytest.approx(100.0 * 32.0)
        # the user's trim scales the zoom view proportionally
        b.wire_calibration = 1.0
        b._emit_zoom_frame(rt, mag)
        z2 = json.loads(q.get(timeout=1.0)[1])
        assert z2["peak_mag"] == pytest.approx(expect / 2.0)
    finally:
        b.unsubscribe(q)


def test_q15_faithful_mode_and_wire_frame(server):
    """q15_faithful: the display becomes the GUI decode of the ACTUAL
    int16 wire words; /api/q15_frame serves the byte-exact 65,536-byte
    frame, verified against the NumPy xfft-schedule oracle end-to-end
    (window quirk included: a pure tone splits into ADJACENT bins)."""
    import base64

    from tpu_sdr_torch.transport.framing import decode_frame

    srv, backend = server
    _post(srv, "set_filter_type", {"mode": "bypass"})
    _post(srv, "update_config", {"q15_faithful": True})
    assert json.loads(_get(srv, "/api/state"))["q15_faithful"] is True
    _post(srv, "start_receiver")
    q = backend.subscribe()
    # the faithful tap runs in a worker thread (one-chunk lag)
    deadline = time.time() + 10
    frame = None
    while time.time() < deadline and backend._q15_last_wire is None:
        try:
            ev, payload = q.get(timeout=1.0)
        except Exception:
            continue
        if ev == "frame_data":
            frame = json.loads(payload)
    backend.unsubscribe(q)
    assert backend._q15_last_wire is not None, "no faithful frame produced"
    # freeze the tap BEFORE comparing: the worker thread keeps committing
    # newer wire frames while the receiver runs, so reading /api/q15_frame
    # and then backend._q15_last_wire unfenced can straddle a commit and
    # compare two different frames (observed flake). Disabling bumps the
    # generation (no further commits); the last frame stays served.
    _post(srv, "update_config", {"q15_faithful": False})
    assert backend._q15_rt is None
    time.sleep(0.3)  # let a worker mid-commit at the bump finish
    r = json.loads(_get(srv, "/api/q15_frame"))
    raw = base64.b64decode(r["frame_b64"])
    assert len(raw) == 65536
    re_q, im_q, mag = decode_frame(raw)
    # the wire ints really are the integer pipeline's: recompute the whole
    # chain on the recorded wire words' magnitudes vs the display payload
    np.testing.assert_array_equal(
        np.asarray(re_q, np.int16), backend._q15_last_wire[0])
    # RTL offset-window quirk: the 100 kHz tone (bin 1638.4) splits into
    # sidebands; the faithful peak must sit within ~2 bins of the tone
    peak = int(np.argmax(mag[:8192]))
    assert abs(peak - 1638) <= 3


def test_q15_faithful_degraded_fetch_falls_back(server):
    """Stall resilience: when the faithful tap's device fetch stalls, the
    acquisition loop must keep producing float display frames — never
    blocking on the fetch — and the watchdog must disable the mode with a
    status event, mirroring the reference GUI's stall-detector recovery
    (fft_analyzer_gui.py:639-644). A stale worker completing AFTER the
    watchdog fired must not commit its frame."""
    import threading as _threading

    srv, backend = server
    _post(srv, "set_filter_type", {"mode": "bypass"})
    _post(srv, "start_receiver")

    release = _threading.Event()
    fetch_entered = _threading.Event()
    calls = {"n": 0}

    def stuck_fetch(arr):
        # first chunk (the pipeline's build budget) completes normally;
        # every later fetch wedges mid-session
        calls["n"] += 1
        if calls["n"] > 1:
            fetch_entered.set()
            release.wait(timeout=10)
        return np.asarray(arr)

    backend._q15_fetch = stuck_fetch
    backend.q15_stall_after = 0.3
    try:
        _post(srv, "update_config", {"q15_faithful": True})
        q = backend.subscribe()
        try:
            assert fetch_entered.wait(timeout=10), "faithful tap never ran"
            # tap workers must be daemon threads: an orphaned worker wedged
            # in a degraded fetch must never block interpreter exit (a
            # ThreadPoolExecutor's non-daemon workers would be joined by
            # concurrent.futures' atexit hook — review finding)
            taps = [
                t for t in _threading.enumerate()
                if t.name.startswith("q15tap")
            ]
            assert taps and all(t.daemon for t in taps)
            wire_before = backend._q15_last_wire  # chunk 1's committed frame
            # While the fetch is wedged, acquisition must keep serving
            # frames from the float path.
            frames_during_stall = 0
            degraded_msg = None
            deadline = time.time() + 10
            while time.time() < deadline:
                try:
                    ev, payload = q.get(timeout=1.0)
                except Exception:
                    continue
                if ev == "frame_data":
                    frames_during_stall += 1
                elif ev == "receiver_status":
                    s = json.loads(payload)
                    if "degraded" in s["message"]:
                        degraded_msg = s
                        break
            assert frames_during_stall >= 2, (
                "acquisition stalled behind the wedged fetch"
            )
            assert degraded_msg is not None, "stall watchdog never fired"
            assert degraded_msg["ok"] is False
            assert backend.q15_faithful is False  # recovered to float path
        finally:
            backend.unsubscribe(q)
        # Let the abandoned worker finish: its generation is stale, so it
        # must NOT commit a wire frame over the pre-stall state.
        release.set()
        time.sleep(0.5)
        assert backend._q15_last_wire is wire_before

        # A fetch that FAILS outright must likewise disable cleanly
        # without killing acquisition.
        def broken_fetch(arr):
            raise OSError("fetch failed")

        backend._q15_fetch = broken_fetch
        q = backend.subscribe()
        try:
            _post(srv, "update_config", {"q15_faithful": True})
            saw_disable = False
            frames_after = 0
            deadline = time.time() + 10
            while time.time() < deadline:
                try:
                    ev, payload = q.get(timeout=1.0)
                except Exception:
                    continue
                if ev == "receiver_status":
                    s = json.loads(payload)
                    if "disabled after error" in s["message"]:
                        saw_disable = True
                elif ev == "frame_data" and saw_disable:
                    frames_after += 1
                    if frames_after >= 2:
                        break
            assert saw_disable, "failing fetch did not disable the mode"
            assert frames_after >= 2, "acquisition died with the fetch"
            assert backend.q15_faithful is False
        finally:
            backend.unsubscribe(q)
    finally:
        release.set()
        backend._q15_fetch = None
        backend.q15_stall_after = 1.0
        _post(srv, "update_config", {"q15_faithful": False})


def test_q15_rebuild_budget_tracks_pipeline_signature():
    """The stall watchdog grants the build-sized budget to ANY chunk that
    will (re)build the integer pipeline — the generation's first chunk AND
    a mid-session filter change — and the tight steady budget only when
    the cached pipeline's signature still matches. Driven directly through
    _q15_tap, no acquisition loop: fully deterministic."""
    backend = GuiBackend(
        analyzer=SpectrumAnalyzer(PipelineConfig(channels=1), device="cpu"),
        source=SyntheticSource(tones_hz=((100_000.0, 0.5),), noise=0.005),
    )
    backend.q15_faithful = True
    backend.set_filter_type("bypass")
    x = np.zeros(backend.sa.cfg.fft_size, np.float32)

    def wait_done(timeout=10.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            f = backend._q15_future
            if f is None or f[0].done():
                return
            time.sleep(0.02)
        raise AssertionError("tap worker never completed")

    # chunk 1: fresh generation -> build budget
    backend._q15_tap(x)
    assert backend._q15_future[2] == backend.q15_first_stall_after
    wait_done()
    # chunk 2: cached pipeline, signature unchanged -> steady budget
    backend._q15_tap(x)
    assert backend._q15_future[2] == backend.q15_stall_after
    wait_done()
    # filter change: signature mismatch -> the rebuild chunk gets the
    # build budget again
    backend.set_filter_type("fixed")
    backend._q15_tap(x)
    assert backend._q15_future[2] == backend.q15_first_stall_after
    wait_done()
    backend._q15_tap(x)
    assert backend._q15_future[2] == backend.q15_stall_after
    wait_done()
    # teardown leaves no non-daemon machinery behind
    backend._q15_teardown()
    assert backend._q15_future is None and backend._q15_rt is None


def test_backend_runs_on_cuda_by_default(monkeypatch):
    """GuiBackend() and serve()'s default backend run on CUDA and raise
    without a GPU; a given analyzer brings its device, and a device beside
    it is refused."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GuiBackend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(port=0, bind="127.0.0.1", block=False)
    sa = SpectrumAnalyzer(PipelineConfig(channels=1), device="cpu")
    assert GuiBackend(analyzer=sa).device == torch.device("cpu")
    for device in ("cuda", "cpu"):
        with pytest.raises(ValueError, match="not both"):
            GuiBackend(analyzer=sa, device=device)


# ---------------------------------------------------------------- against the JAX GuiBackend
#
# Both backends get the same input and run no acquisition thread: each
# output below is a function of that input alone.

from tpu_sdr.control import SpectrumAnalyzer as JSpectrumAnalyzer  # noqa: E402
from tpu_sdr.core.config import PipelineConfig as JPipelineConfig  # noqa: E402
from tpu_sdr.gui.backend import GuiBackend as JGuiBackend  # noqa: E402
from tpu_sdr.runtime.source import SyntheticSource as JSyntheticSource  # noqa: E402

# The zoom view's magnitudes (a 1024-point spectrum of a PFB subchannel or
# a DDC's output, fp32 in both packages, sums in other orders) against the
# JAX package's: max |difference| over the view's peak.
ZOOM_REL = 1e-6


def _pair(tones=((100_000.0, 0.5),)):
    """(JAX backend, port backend) on the same synthetic source."""
    jb = JGuiBackend(analyzer=JSpectrumAnalyzer(JPipelineConfig(channels=1)),
                     source=JSyntheticSource(tones_hz=tones, noise=0.005))
    pb = GuiBackend(analyzer=SpectrumAnalyzer(PipelineConfig(channels=1), device="cpu"),
                    source=SyntheticSource(tones_hz=tones, noise=0.005))
    return jb, pb


def _events(backend, fn, *args):
    """The events ``fn(*args)`` emits, as (name, payload dict)."""
    q = backend.subscribe()
    try:
        fn(*args)
        out = []
        while not q.empty():
            ev, payload = q.get_nowait()
            out.append((ev, json.loads(payload)))
        return out
    finally:
        backend.unsubscribe(q)


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in d.items()}


def test_state_keys_equal_the_jax_backends():
    jb, pb = _pair()
    assert _keys(pb.get_state()) == _keys(jb.get_state())
    js, ps = jb.get_state(), pb.get_state()
    assert {k: ps[k] for k in ("filter_mode", "comm_mode", "display_mode", "detector", "zoom",
                               "trigger", "audio", "config")} == {
        k: js[k] for k in ("filter_mode", "comm_mode", "display_mode", "detector", "zoom",
                           "trigger", "audio", "config")}


@pytest.mark.parametrize("iq", [False, True])
def test_display_decimation_and_detectors_equal_the_jax_backends(iq):
    """frame_data (peak-preserving decimation, peak marker, traces) and each
    detector's waterfall row, from the same magnitude vector."""
    from tpu_sdr_torch.runtime.waterfall import DETECTORS

    n = 16384
    mag = np.abs(np.random.default_rng(3).standard_normal(n)).astype(np.float32) + 1e-3
    mag[1638] = 50.0
    jb, pb = _pair()
    for b in (jb, pb):
        b._iq = iq
        b.traces_enabled = True
        b.display_points = 700
        b.apply_frequency_range(20.0, 300.0)
    for mode in ("magnitude", "real", "power"):
        want = _events(jb, jb._emit_frame, mag, mode)
        got = _events(pb, pb._emit_frame, mag, mode)
        assert got == want
    for det in DETECTORS:
        jb.detector = pb.detector = det
        assert _events(pb, pb._emit_waterfall_row, mag) == _events(jb, jb._emit_waterfall_row, mag)


def test_q15_wire_frame_equals_the_jax_backends_bitwise():
    """The faithful tap's wire words (split Q15 path: the native host filter
    and the scaled integer FFT) on the same chunk, in CUSTOM: bit for bit,
    and the 65,536-byte frame byte for byte."""
    import scipy.signal as sps

    jb, pb = _pair(((100_000.0, 0.5), (250_000.0, 0.2)))
    sos = sps.butter(4, 0.25, output="sos")
    for b in (jb, pb):
        b.sa.upload_filter(sos)
        b.set_filter_type("custom")
    x = SyntheticSource(tones_hz=((100_000.0, 0.5), (250_000.0, 0.2)), noise=0.01,
                        seed=4).read(2 * 16384)
    for _ in range(2):  # the second chunk carries the filter state
        want = jb._q15_step(x, jb._q15_gen)
        got = pb._q15_step(x, pb._q15_gen)
    for a, b in zip(pb._q15_last_wire, jb._q15_last_wire):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert pb.get_q15_frame() == jb.get_q15_frame()
    # |X| of the same wire words: torch's CPU sqrt is within 1 ulp of NumPy's
    np.testing.assert_array_max_ulp(np.asarray(got, np.float32), np.asarray(want, np.float32), 1)


def test_scan_hits_equal_the_jax_backends():
    fs = 1e6
    n = np.arange(int(0.5 * fs))
    rng = np.random.default_rng(7)
    x = 2e-4 * rng.standard_normal(n.size)
    for fc, a in ((87.5e3, 0.5), (212.5e3, 0.1), (337.5e3, 0.02)):
        x = x + a * np.cos(2 * np.pi * fc * n / fs)
    jb, pb = _pair()
    cfg = {"start_khz": 0, "stop_khz": 500, "bw_khz": 25, "threshold_db": 10}
    results = []
    for b in (jb, pb):
        b._scan_ring = x.astype(np.float32)
        results.append(b.scan_band(cfg))
    want, got = results
    assert [h["center_khz"] for h in got["hits"]] == [h["center_khz"] for h in want["hits"]]
    assert len(got["hits"]) == 3 and got["occupied"] == want["occupied"]
    # levels are rounded to 0.1 dB in both
    assert np.allclose(got["power_db"], want["power_db"], atol=0.1 + 1e-9)


@pytest.mark.parametrize("scheme, bits", [("qpsk", 512), ("qam16", 512), ("2fsk", 256)])
def test_burst_bits_equal_the_jax_backends(scheme, bits):
    from tpu_sdr_torch.kernels.digital import BurstModem, FSKModem

    rng = np.random.default_rng(0xB0B)
    payload = rng.integers(2, size=bits).astype(np.uint8)
    if scheme == "2fsk":
        mod = FSKModem(fs=1e6, symbol_rate=125e3, deviation_hz=250e3, levels=2, device="cpu")
        re, im = mod.modulate(payload, pad_syms=2)
        z = np.concatenate([np.zeros(11), re + 1j * im])
    else:
        mod = BurstModem(scheme, sps=8, device="cpu")
        re, im = mod.modulate(payload, pad_syms=mod.max_lag_syms + mod.span)
        z = np.concatenate([np.zeros(40), (re + 1j * im) * np.exp(
            2j * np.pi * 150e3 / 1e6 * np.arange(re.size) + 0.4j)])
    jb, pb = _pair()
    cfg = {"scheme": scheme, "bits": bits, "center_khz": 0.0 if scheme == "2fsk" else 150.0}
    results = []
    for b in (jb, pb):
        b._scan_ring = z.astype(np.complex64)
        results.append(b.demod_burst(cfg))
    want, got = results
    assert got["bits_hex"] == want["bits_hex"] == np.packbits(payload).tobytes().hex()
    for key in ("frame_lag_syms", "offset_samples"):
        assert got.get(key) == want.get(key)


def test_rds_fields_equal_the_jax_backends():
    from tpu_sdr_torch.kernels.rds import RDSEncoder, make_mpx_rds

    fs = 1e6
    t = np.arange(int(2.0 * fs)) / fs
    enc = RDSEncoder(pi=0xBEEF, pty=9, ps="PORT GUI", radiotext="SAME FIELDS")
    mpx = make_mpx_rds(0.4 * np.sin(2 * np.pi * 900 * t), 0.4 * np.sin(2 * np.pi * 1700 * t), fs,
                       enc, n_groups=32)
    x = (0.5 * np.cos(2 * np.pi * np.cumsum(200e3 + 75e3 * mpx) / fs)).astype(np.float32)
    jb, pb = _pair()
    results = []
    for b in (jb, pb):
        b._scan_ring = x
        results.append(b.rds_decode({"center_khz": 200.0}))
    want, got = results
    assert got["pi"] == want["pi"] == "BEEF" and got["ps"] == want["ps"] == "PORT GUI"
    for key in ("pty", "tp", "radiotext", "groups", "n_blocks", "block_error_rate"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("zoom", [{"channel": 32}, {"mode": "ddc", "center_khz": 217.7,
                                                     "decimation": 128}])
def test_zoom_spectrum_equals_the_jax_backends(zoom):
    """The same raw chunks through the zoom front end (PFB subchannel or
    DDC) and its 1024-point spectrum: the zoom frames' axes equal, their
    magnitudes within ZOOM_REL of the peak."""
    f_tone = 250e3 + 1037.0 if "channel" in zoom else 218.2e3
    jb, pb = _pair(((f_tone, 0.5),))
    chunks = [SyntheticSource(tones_hz=((f_tone, 0.5),), noise=0.001, seed=k).read(2 * 16384)
              for k in range(16)]
    frames = []
    for b in (jb, pb):
        b.set_zoom({"enabled": True, **zoom})
        frames.append([d for c in chunks for ev, d in _events(b, b._zoom_step, c)
                       if ev == "zoom_frame"])
    want, got = frames
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        for key in ("mode", "channel", "center_khz", "span_hz", "hz_per_bin", "offsets_hz",
                    "peak_offset_hz"):
            assert g[key] == w[key], key
        ref = np.asarray(w["magnitude"])
        assert np.abs(np.asarray(g["magnitude"]) - ref).max() <= ZOOM_REL * ref.max()
