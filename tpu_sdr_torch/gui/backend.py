"""GUI backend: analyzer + source + event fan-out (the Flask app's brain).

Replaces the reference's Flask/SocketIO + PyQt receiver plumbing
(``scripts/fft_analyzer_gui.py``) with a plain-threaded backend that any
front-end transport (our stdlib SSE server, or flask_socketio if installed)
can sit on. Event payloads keep the reference's vocabulary: ``frame_data``
carries magnitude + peak/FPS stats (``fft_analyzer_gui.py:439-455``),
``receiver_status`` carries command acknowledgements.

The counterpart of ``tpu_sdr.gui.backend``: every part it builds runs on
``device`` (None: CUDA, raising without a GPU; "cpu": the kernels' plain
versions), and each device output is copied to the host once.
"""

from __future__ import annotations

import json
import queue
import threading
import time

import numpy as np

from tpu_sdr_torch.control import SpectrumAnalyzer, designer as designer_mod
from tpu_sdr_torch.core.config import CommMode, FilterMode, PipelineConfig
from tpu_sdr_torch.gui.backend_audio import AudioScanMixin
from tpu_sdr_torch.gui.backend_capture import CaptureMixin
from tpu_sdr_torch.gui.backend_display import DisplayMixin
from tpu_sdr_torch.gui.backend_zoom import ZoomMixin
from tpu_sdr_torch.runtime.waterfall import host


class _DaemonTask:
    """Single-shot worker on a daemon thread with a tiny future surface.

    Replaces ``ThreadPoolExecutor`` for the faithful tap: executor workers
    are non-daemon and ``concurrent.futures`` joins every one of them at
    interpreter exit, so an orphaned worker wedged in a fetch that never
    returns would block GUI shutdown indefinitely (and each stall/re-enable
    cycle would strand another). A daemon thread just dies with the
    process; the tap's generation guard already keeps abandoned commits
    out, and the tap is depth-1 (one in-flight chunk), so per-chunk thread
    creation is noise next to the chunk's device dispatch.
    """

    def __init__(self, fn, *args):
        self._ev = threading.Event()
        self._result = None
        self._exc: BaseException | None = None
        threading.Thread(
            target=self._run, args=(fn, args), daemon=True, name="q15tap"
        ).start()

    def _run(self, fn, args):
        try:
            self._result = fn(*args)
        except BaseException as e:
            self._exc = e
        finally:
            self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self):
        self._ev.wait()
        if self._exc is not None:
            raise self._exc
        return self._result


class GuiBackend(CaptureMixin, DisplayMixin, ZoomMixin, AudioScanMixin):
    def __init__(
        self,
        analyzer: SpectrumAnalyzer | None = None,
        source=None,
        frames_per_dispatch: int = 2,
        display_fps: float = 30.0,
        display_points: int = 2048,
        pace: bool = False,
        device=None,
    ):
        """``device``: where the analyzer the backend builds runs (None:
        CUDA, raising without a GPU). A given ``analyzer`` brings its own,
        and ``device`` must then be None. Every other part the backend
        builds runs on the analyzer's device."""
        from tpu_sdr_torch.runtime.source import SyntheticSource

        if analyzer is not None and device is not None:
            raise ValueError("pass device= or analyzer=, not both: the analyzer has its device")
        self.sa = analyzer or SpectrumAnalyzer(PipelineConfig(channels=1), device=device)
        self.device = self.sa.pipe.device
        self.source = source or SyntheticSource(
            tones_hz=((100_000.0, 0.5), (250_000.0, 0.2)), noise=0.01
        )
        self.frames_per_dispatch = frames_per_dispatch
        self.display_fps = display_fps
        self.display_points = display_points
        self.pace = pace
        self.freq_range_khz = (0.0, self.sa.cfg.sample_rate / 2000.0)
        # display_mode: 'magnitude' | 'real' | 'imag' | 'power' — the
        # reference GUI's plot toggles (index.html:304-306)
        self.display_mode = "magnitude"
        # Display calibration: the FPGA GUI plots magnitudes of the int16
        # wire words, which carry the xfft default 1/N scaling
        # (ip/xfft_0/xfft_0.xci; the RTL never writes s_axis_config,
        # dsp_system_top.vhd:534-536). Our pipeline plots float spectra, so
        # we apply the schedule-derived 2^15/N scale OF THIS ANALYZER'S FFT
        # (2.0 at the reference's 16K; 32 for a 1K small-FFT config) to
        # display in the same wire-LSB units a GUI calibrated against the
        # FPGA would read. Set to 1.0 for raw float units.
        from tpu_sdr_torch.core.qformat import xfft_wire_scale

        self.wire_calibration = float(xfft_wire_scale(self.sa.cfg.fft_size))
        self.filter_config = {
            "kind": "butterworth",
            "btype": "lowpass",
            "order": 4,
            "cutoff_hz": 100_000.0,
            "cutoff2_hz": 200_000.0,
            "ripple_db": 1.0,
            "attenuation_db": 60.0,
        }
        from tpu_sdr_torch.runtime.waterfall import Waterfall

        self.waterfall = Waterfall(points=512, depth=160)
        self.waterfall_enabled = True
        # Display detector (bucketed decimation mode) for the waterfall row:
        # peak | minpeak | avg | rms | sample.
        self.detector = "peak"
        # Peak-hold / EMA-average trace overlays (classic analyzer detector
        # modes) computed over the decimated display vector; reset whenever
        # the display signature (mode/range/points) changes.
        self.traces_enabled = False
        self.trace_alpha = 0.2
        self._trace_sig = None
        self._trace_peak = None
        self._trace_avg = None
        # The acquisition thread updates the traces while an HTTP thread may
        # disable or clear them: both sides hold this lock.
        self._trace_lock = threading.Lock()
        # Band-power trigger (classic analyzer capture): 'normal' shows
        # only frames whose in-band peak level crosses the threshold;
        # 'single' freezes on the first crossing until re-armed.
        self.trigger_cfg = {
            "enabled": False,
            "mode": "single",  # 'single' | 'normal'
            "f_lo_khz": 0.0,
            "f_hi_khz": 500.0,
            "threshold_db": -20.0,
        }
        self._trigger_armed = True
        # raw-sample capture (runtime/recorder): armed from the HTTP
        # thread, appended from the acquisition loop
        self._recorder = None
        self._record_path = None
        # Hardware-faithful wire mode (Q15Pipeline(device_fft=True)): the
        # display magnitudes become the GUI decode of the ACTUAL int16
        # wire words the FPGA would drain (sequ2.vhd:153) — RTL window
        # quirks, x64 integer filter, xfft 1/N truncation schedule and
        # all. Opt-in via update_config({"q15_faithful": true}); the last
        # wire frame is served byte-exact at /api/q15_frame.
        self.q15_faithful = False
        self.q15_stall_after = 1.0  # stalled-fetch watchdog, seconds
        # the FIRST chunk of a generation builds the pipeline (and, on a
        # fresh checkout, the kernel library with nvcc) — its own budget
        self.q15_first_stall_after = 120.0
        self._q15_rt = None  # dict: pipe / zi (carried) / sig
        self._q15_last_wire = None  # (re, im int16, mode_name) of the last frame
        self._q15_future = None  # (task, submit monotonic time, stall budget)
        self._q15_disp = None  # newest completed faithful display vector
        self._q15_gen = 0  # generation: stale abandoned workers must not commit
        self._q15_lock = threading.Lock()  # submit vs teardown (HTTP thread)
        self._q15_fetch = None  # injectable fetch callable (tests/tools)
        # Live audio demod (runtime/receiver): a Receiver tees every raw
        # chunk; the demodulated audio accumulates in a bounded ring the
        # save_audio route writes to WAV.
        self.audio_cfg = {
            "enabled": False,
            "center_khz": 100.0,
            "mode": "wbfm",
            "max_seconds": 30.0,
            "stereo": False,
        }
        self._audio_rt = None
        # Raw-sample ring for on-demand band scans (POST /api/scan), burst
        # demodulation, and RDS decode: the acquisition loop keeps the last
        # ~2 s of channel-0 samples (RDS needs ~1 s per PS name cycle).
        # Stored as a chunk list (O(chunk) append in the acquisition loop —
        # a flat-array ring re-copied ~2 s of samples per chunk, measured
        # as hundreds of MB/s of memcpy); readers are rare user-triggered
        # APIs that materialize via the `_scan_ring` property.
        self._scan_chunks: list[np.ndarray] = []
        self._scan_buffered = 0
        self._scan_cache: np.ndarray | None = np.zeros(0, np.float32)
        self._scan_gen = 0  # bumped by every acquisition-thread append
        self._scan_ring_len = 0  # set from cfg on first append
        # Blind IQ imbalance correction on complex sources
        # (update_config {"iq_correction": true}); no-op for real input.
        self.iq_correction = False
        self._iqcorr_rt = None  # (IQCorrector, state)
        # Zoom mode: PFB-channelize the raw stream and run a small spectrum
        # pipeline on ONE subchannel (the zoom-FFT workflow, demo_zoom.py).
        # m/taps/fft_size are fixed per session; channel is live-switchable.
        self.zoom_cfg = {
            "enabled": False,
            "mode": "pfb",  # 'pfb' (subchannel grid) | 'ddc' (any center)
            "channel": 32,
            "center_hz": 250_000.0,
            "decimation": 128,
            "m": 128,
            "taps": 8,
            "fft_size": 1024,
        }
        self._zoom_gen = 0
        self._zoom_rt: dict | None = None
        self._subscribers: list[queue.Queue] = []
        self._sub_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_emit = 0.0
        self._fps_window: list[float] = []

    # ---------------- raw-sample ring ----------------

    @property
    def _scan_ring(self) -> np.ndarray:
        """Materialized view of the chunked raw-sample ring (newest
        ~2 s, channel 0). Cached until the acquisition loop appends; the
        chunk list itself is never mutated here (the acquisition thread
        owns it), so a concurrent append at worst yields a one-chunk-stale
        snapshot."""
        cache = self._scan_cache
        if cache is None:
            gen0 = self._scan_gen  # capture before the snapshot
            chunks = list(self._scan_chunks)  # snapshot under the GIL
            if chunks:
                cache = np.concatenate(chunks, axis=-1)
                if self._scan_ring_len:
                    cache = cache[-self._scan_ring_len:]
            else:
                cache = np.zeros(0, np.float32)
            # only re-validate the cache if no append landed since the
            # snapshot: storing unconditionally could overwrite the
            # appender's `_scan_cache = None` invalidation and serve a
            # stale snapshot until the NEXT append (review finding)
            if self._scan_gen == gen0:
                self._scan_cache = cache
        return cache

    @_scan_ring.setter
    def _scan_ring(self, value) -> None:
        v = np.asarray(value)
        self._scan_chunks = [v] if v.size else []
        self._scan_buffered = int(v.shape[-1]) if v.size else 0
        self._scan_cache = v

    # ---------------- event fan-out ----------------

    def subscribe(self) -> queue.Queue:
        q: queue.Queue = queue.Queue(maxsize=8)
        with self._sub_lock:
            self._subscribers.append(q)
        return q

    def unsubscribe(self, q: queue.Queue):
        with self._sub_lock:
            if q in self._subscribers:
                self._subscribers.remove(q)

    def emit(self, event: str, payload: dict):
        msg = (event, json.dumps(payload))
        with self._sub_lock:
            subs = list(self._subscribers)
        for q in subs:
            try:
                q.put_nowait(msg)
            except queue.Full:
                pass  # slow client: drop (display data is disposable)

    def status(self, message: str, ok: bool = True):
        self.emit("receiver_status", {"ok": ok, "message": message})

    # ---------------- acquisition loop ----------------

    def start_receiver(self):
        # (Re)arm acquisition even if the loop thread survived a reset —
        # 0xFF stops the analyzer but not the thread (the thread just idles),
        # and 0x55 must always restart acquisition.
        self.sa.start()
        if self._thread is not None and self._thread.is_alive():
            self.status("receiver already running")
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        self.status("receiver started")

    def stop_receiver(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=3.0)
            self._thread = None
        self.sa.stop()
        self.status("receiver stopped")

    def _loop(self):
        try:
            self._loop_inner()
        except Exception as e:  # surface, don't die silently
            self.status(f"receiver loop error: {type(e).__name__}: {e}", ok=False)
            raise

    def _loop_inner(self):
        n = self.sa.cfg.fft_size
        chunk = self.frames_per_dispatch * n
        while not self._stop.is_set():
            x = self.source.read(chunk, pace=self.pace)
            self._iq = bool(np.iscomplexobj(x))
            if self.iq_correction and self._iq:
                try:
                    x = self._iq_correct(x)
                except Exception as e:  # never kill acquisition
                    self.iq_correction = False
                    self._iqcorr_rt = None
                    self.status(
                        f"iq correction disabled after error: "
                        f"{type(e).__name__}: {e}", ok=False)
            rec = self._recorder  # snapshot: HTTP thread swaps it
            if rec is not None:
                try:
                    rec.append(np.atleast_2d(x))
                except ValueError as e:
                    # "recorder is closed" = the HTTP thread's stop_record
                    # won the race after our snapshot — a CLEAN stop, the
                    # chunk is deliberately excluded; anything else (e.g. a
                    # real<->IQ signature flip) is a genuine error.
                    if self._recorder is rec:
                        self._recorder = None
                    if "closed" not in str(e):
                        self.status(f"recording stopped: {e}", ok=False)
            # snapshot the mode once per iteration: it can be flipped from
            # the HTTP thread between the request and the decode otherwise
            # (the snapshot is threaded through _emit_frame too)
            mode = self.display_mode
            # request only what the mode needs (phase/re/im for modes that
            # never display them would be wasted device work per dispatch)
            want = {
                "magnitude": "magnitude",
                "power": "power",
                "real": "complex",
                "imag": "complex",
            }[mode]
            out = self.sa.process(x, outputs=want)
            if out is None:
                time.sleep(0.01)
                continue
            if mode == "magnitude":
                disp = np.asarray(out["magnitude"])[0, -1]
                wf_mag = disp
            elif mode == "power":
                disp = host(out["power"][0, -1])
                wf_mag = np.sqrt(disp)
            else:  # real / imag from the complex spectra
                re = host(out["re"][0, -1])
                im = host(out["im"][0, -1])
                disp = re if mode == "real" else im
                wf_mag = np.hypot(re, im)
            # hardware wire-LSB calibration (see __init__.wire_calibration)
            cal = self.wire_calibration
            if cal != 1.0:
                disp = disp * (cal * cal if mode == "power" else cal)
                wf_mag = wf_mag * cal
            # faithful wire tap: replace the display vector with the GUI
            # decode of the actual int16 wire words (already wire-LSB
            # units — the float-path calibration above is bypassed)
            if self.q15_faithful and mode == "magnitude" and not self._iq:
                q15_disp = self._q15_tap(x)  # non-blocking (worker thread)
                if q15_disp is not None:
                    disp = wf_mag = q15_disp
            now = time.monotonic()
            self._fps_window = [t for t in self._fps_window + [now] if now - t < 1.0]
            # zoom taps EVERY raw chunk (it accumulates subchannel samples
            # across iterations) — before the display rate limiter
            if self.zoom_cfg["enabled"]:
                try:
                    self._zoom_step(x)
                except Exception as e:  # zoom must never kill acquisition
                    self.zoom_cfg["enabled"] = False
                    self._zoom_rt = None
                    self.status(
                        f"zoom disabled after error: {type(e).__name__}: {e}",
                        ok=False,
                    )
            # scan ring: keep the newest ~2 s of raw channel-0 samples
            xr = np.asarray(x[0] if getattr(x, "ndim", 1) > 1 else x)
            if self._scan_chunks and self._scan_chunks[-1].dtype != xr.dtype:
                self._scan_chunks.clear()  # real<->IQ flip resets the ring
                self._scan_buffered = 0
            if not self._scan_ring_len:
                self._scan_ring_len = int(2.0 * self.sa.cfg.sample_rate)
            self._scan_chunks.append(xr)
            self._scan_buffered += xr.shape[-1]
            # drop whole stale chunks; the final [-len:] trim happens at
            # materialization time (rare, user-triggered)
            while (
                len(self._scan_chunks) > 1
                and self._scan_buffered - self._scan_chunks[0].shape[-1]
                >= self._scan_ring_len
            ):
                self._scan_buffered -= self._scan_chunks.pop(0).shape[-1]
            self._scan_gen += 1  # before the invalidation: readers that saw
            # the old gen will decline to re-validate their snapshot
            self._scan_cache = None
            # audio demod taps every raw chunk too (carried receiver state)
            if self.audio_cfg["enabled"]:
                try:
                    self._audio_step(x)
                except Exception as e:  # audio must never kill acquisition
                    self.audio_cfg["enabled"] = False
                    self._audio_rt = None
                    self.status(
                        f"audio disabled after error: {type(e).__name__}: {e}",
                        ok=False,
                    )
            # trigger gate: evaluated per dispatch, BEFORE the rate limiter
            trig = dict(self.trigger_cfg)  # snapshot (HTTP thread mutates)
            triggered = False
            force_emit = False  # only single-shot's ONE frame skips the limiter
            if trig["enabled"]:
                level = self._band_level_db(wf_mag, trig)
                fired = level >= trig["threshold_db"]
                if trig["mode"] == "single":
                    if not (self._trigger_armed and fired):
                        continue  # frozen (or waiting): hold the display
                    self._trigger_armed = False
                    triggered = force_emit = True
                    self.status(
                        f"triggered at {level:.1f} dB "
                        f"({trig['f_lo_khz']:g}-{trig['f_hi_khz']:g} kHz); "
                        "display frozen until re-arm"
                    )
                else:  # normal: only show crossing frames (rate-limited)
                    if not fired:
                        continue
                    triggered = True
            if not force_emit and now - self._last_emit < 1.0 / self.display_fps:
                continue
            self._last_emit = now
            try:
                self._emit_frame(disp, mode, triggered=triggered)
                if self.waterfall_enabled:
                    self._emit_waterfall_row(wf_mag)
            except Exception as e:  # display errors must not kill acquisition
                self.status(
                    f"display error: {type(e).__name__}: {e}", ok=False
                )

    # ---------------- command handlers (the SocketIO event surface) -------

    # -------------------------------------------- faithful wire (Q15) tap

    def _q15_tap(self, x) -> np.ndarray | None:
        """Non-blocking faithful overlay with a stalled-fetch watchdog.

        The integer pipeline (host stage + device dispatch + the ONE
        packed fetch) runs in a single worker thread, so a fetch that
        stalls can never stall the acquisition loop. Per chunk:

        - a completed worker result becomes the newest overlay (and the
          next chunk is submitted);
        - while a chunk is in flight, the loop serves the newest
          COMPLETED overlay (or the float display if none yet) — display
          decimation, not backpressure: in-between chunks skip the tap;
        - a fetch stuck longer than ``q15_stall_after`` disables the mode
          with a status event and falls back to the float display — the
          reference GUI's stall-detector recovery semantics
          (``fft_analyzer_gui.py:639-644``), applied to the export path.
          The abandoned chunk drains in the background; a generation
          counter keeps it from committing stale wire frames.
        """
        try:
            pending = self._q15_future
            if pending is not None:
                task, t0, budget = pending
                if task.done():
                    self._q15_future = None
                    got = task.result()  # re-raises the worker's exception
                    if got is not None:
                        self._q15_disp = got
                elif time.monotonic() - t0 > budget:
                    self._q15_disable(
                        f"q15 faithful mode degraded: device fetch stalled "
                        f">{budget:.1f}s; serving float display")
                    return None
                else:
                    return self._q15_disp  # in flight: newest completed
            # submit the next chunk. Budget: a chunk that will (re)build
            # the pipeline — a fresh generation OR a mid-session filter
            # change (review finding: not just the generation's first
            # chunk) — pays the pipeline's build (and a first kernel
            # build), so it gets the build-sized budget; steady chunks get
            # the tight stall watchdog.
            rt = self._q15_rt
            budget = (
                self.q15_stall_after
                if rt is not None and rt["sig"] == self._q15_sig()
                else self.q15_first_stall_after
            )
            xs = np.array(x, copy=True)  # loop may reuse its chunk buffer
            with self._q15_lock:
                # a config-off/teardown may have landed between the loop's
                # q15_faithful check and here: do not resurrect the tap
                # with a post-bump generation (review finding)
                if not self.q15_faithful:
                    return None
                self._q15_future = (
                    _DaemonTask(self._q15_step, xs, self._q15_gen),
                    time.monotonic(),
                    budget,
                )
            return self._q15_disp
        except Exception as e:  # never kill acquisition
            self._q15_disable(
                f"q15 faithful mode disabled after error: "
                f"{type(e).__name__}: {e}")
            return None

    def _q15_disable(self, message: str):
        """Tear down the faithful tap (error/stall/config-off): bump the
        generation so an abandoned in-flight worker cannot commit stale
        state, and let the next enable start fresh."""
        self.q15_faithful = False
        self._q15_teardown()
        self.status(message, ok=False)

    def _q15_teardown(self):
        # Serialized against the tap's submit block: a teardown landing
        # mid-submit still wins — the generation bump makes the just-
        # submitted worker's commits no-ops, and its daemon thread dies
        # with the process (never joined at exit, so a wedged degraded
        # fetch can never block shutdown — review finding).
        with self._q15_lock:
            self._q15_gen += 1
            self._q15_rt = None
            self._q15_future = None
            self._q15_disp = None

    def _q15_sig(self) -> tuple:
        """Cheap pipeline-rebuild signature — changes exactly when the
        analyzer's filter routing/coefficients (or the analyzer itself)
        change. id() of custom_sos suffices: upload_sos REPLACES the array
        (the hot loop must not re-quantize SciPy coefficients ~30x/s just
        to compare bytes — review finding). Every mode's signature carries
        the analyzer identity + fft_size (review finding): if self.sa (or
        its fft_size) is ever replaced at runtime, a cached Q15Pipeline
        with the stale size would silently mis-frame any chunk length that
        happens to divide the old size."""
        mode = self.sa.filter_mode
        base = (id(self.sa), self.sa.cfg.fft_size)
        if mode == FilterMode.CUSTOM:
            return ("custom", id(self.sa.custom_sos), *base)
        if mode == FilterMode.FIXED:
            return ("fixed", *base)
        return ("bypass", *base)

    def _q15_step(self, x, gen: int | None = None) -> np.ndarray | None:
        """One chunk through the split integer pipeline; returns the last
        frame's wire-word magnitudes (or None while unlockable, e.g. a
        CUSTOM mode with no uploaded design)."""
        from tpu_sdr_torch.core import qformat as qf
        from tpu_sdr_torch.runtime.q15 import Q15Pipeline

        mode = self.sa.filter_mode
        if mode == FilterMode.CUSTOM and self.sa.custom_sos is None:
            return None
        sig = self._q15_sig()
        rt = self._q15_rt  # dict: pipe / zi (carried) / sig
        if rt is None or rt["sig"] != sig:
            if mode == FilterMode.CUSTOM:
                sos_q = qf.quantize_coeff_x64(self.sa.custom_sos)
            elif mode == FilterMode.FIXED:
                from tpu_sdr_torch.control import golden

                sos_q = qf.quantize_coeff_x64(golden.fixed_filter_sos())
            else:
                sos_q = None
            pipe = Q15Pipeline(
                PipelineConfig(channels=1, fft_size=self.sa.cfg.fft_size),
                device_fft=True,
                device=self.device,
            )
            if sos_q is not None:
                pipe.upload_sos_q(sos_q)
            rt = {"pipe": pipe, "zi": None, "sig": sig}
            if gen is None or gen == self._q15_gen:
                self._q15_rt = rt
        xr = np.asarray(x[0] if getattr(x, "ndim", 1) > 1 else x)
        # full-scale float -> Q15 (the synthetic/file sources are float in
        # [-1, 1]; an integer ADC source arrives already q15/q16-scaled)
        if np.issubdtype(xr.dtype, np.floating):
            xq = np.clip(np.rint(xr * 32767.0), -32768, 32767).astype(np.int16)
        else:
            xq = xr.astype(np.int16)
        out, rt["zi"] = rt["pipe"].process(
            xq, rt["zi"], bypass=sig[0] == "bypass", display=True)
        n = rt["pipe"].cfg.fft_size
        # ONE fetch of the packed (3, N) display frame: the display only
        # needs the last frame. re/im are int16-exact in f32, so the wire
        # words survive the roundtrip bit-exactly.
        fetch = self._q15_fetch or host  # injectable: stall tests
        disp = np.asarray(fetch(out["display_frame"])).reshape(3, n)
        re_q = disp[0].astype(np.int16)
        im_q = disp[1].astype(np.int16)
        if gen is not None and gen != self._q15_gen:
            # abandoned chunk from a degraded/disabled generation: its
            # fetch completed long after the watchdog fired — do not
            # commit a stale wire frame over whatever came since
            return None
        # the mode is captured WITH the frame: get_q15_frame must label
        # the frame with the mode that produced it, not whatever the
        # analyzer switched to afterwards (review finding)
        self._q15_last_wire = (re_q, im_q, mode.name)
        return disp[2]

    def get_q15_frame(self) -> dict:
        """The last faithful-mode spectrum as the byte-exact 65,536-byte
        wire frame (base64) — what the FPGA's UART/Ethernet drain would
        carry for the same samples."""
        import base64

        if self._q15_last_wire is None:
            raise ValueError(
                "no faithful frame yet: enable q15_faithful and wait one "
                "display frame")
        from tpu_sdr_torch.transport.framing import frame_bytes_from_q15

        re_q, im_q, mode_name = self._q15_last_wire
        frame = frame_bytes_from_q15(re_q, im_q)
        return {
            "frame_b64": base64.b64encode(frame).decode(),
            "bytes": len(frame),
            "filter_mode": mode_name,  # the mode that PRODUCED this frame
        }

    def set_mode(self, mode: str):
        """'ethernet' | 'uart' — mirrors the GUI's set_mode full-reset dance
        (``fft_analyzer_gui.py:1003-1053``)."""
        m = CommMode.ETHERNET if mode.lower().startswith("eth") else CommMode.UART
        self.sa.reset()
        self.sa.set_comm_mode(m)
        self.sa.start()
        self.status(f"comm mode -> {m.name}")

    def fpga_reset(self):
        self.sa.reset()
        self.status("analyzer reset")

    def set_filter_type(self, mode: str):
        fm = {
            "fixed": FilterMode.FIXED,
            "custom": FilterMode.CUSTOM,
            "bypass": FilterMode.BYPASS,
        }[mode.lower()]
        self.sa.set_filter_mode(fm)
        self.status(f"filter mode -> {fm.name}")

    def set_display_mode(self, mode: str):
        if mode not in ("magnitude", "real", "imag", "power"):
            raise ValueError(f"unknown display mode {mode!r}")
        self.display_mode = mode
        self.status(f"display -> {mode}")

    def send_command_bytes(self, hex_str: str) -> dict:
        """Raw command console: hex bytes straight into the wire decoder
        (the reference GUI's command console, e.g. '55', 'b1 55', 'f1 40...')."""
        try:
            data = bytes.fromhex(hex_str.replace("0x", "").replace(",", " "))
        except ValueError as e:
            self.status(f"bad hex: {e}", ok=False)
            return {"ok": False, "error": str(e)}
        events = self.sa.handle_bytes(data)
        desc = []
        for ev in events:
            if ev.kind == "command":
                desc.append(ev.command.name)
            elif ev.kind == "coefficients":
                desc.append(f"COEFFICIENTS[{len(ev.coefficients)}]")
            else:
                desc.append(f"ignored(0x{ev.raw:02X})")
        if self.sa.decoder.busy:
            desc.append("(awaiting coefficient bytes...)")
        self.status(f"cmd {hex_str} -> {', '.join(desc) or 'no event'}")
        return {"ok": True, "events": desc}

    def apply_frequency_range(self, lo_khz: float, hi_khz: float):
        nyq_khz = self.sa.cfg.sample_rate / 2000.0
        lo = float(np.clip(lo_khz, 0.0, nyq_khz - 1))
        hi = float(np.clip(hi_khz, lo + 1, nyq_khz))
        self.freq_range_khz = (lo, hi)
        self.status(f"frequency range {lo:.0f}-{hi:.0f} kHz")

    def update_filter_config(self, cfg: dict):
        known = set(self.filter_config)
        unknown = sorted(set(cfg) - known)
        self.filter_config.update({k: v for k, v in cfg.items() if k in known})
        if unknown:
            self.status(f"ignored unknown filter fields: {unknown}", ok=False)
        else:
            self.status("filter config updated")

    def _design(self):
        c = self.filter_config
        cutoff = (
            (float(c["cutoff_hz"]), float(c["cutoff2_hz"]))
            if c["btype"] in ("bandpass", "bandstop")
            else float(c["cutoff_hz"])
        )
        return designer_mod.design_iir_filter(
            kind=c["kind"],
            btype=c["btype"],
            order=int(c["order"]),
            fs=self.sa.cfg.sample_rate,
            cutoff_hz=cutoff,
            ripple_db=float(c["ripple_db"]),
            attenuation_db=float(c["attenuation_db"]),
        )

    def generate_filter_preview(self) -> dict:
        """Design + response arrays (client renders; no matplotlib needed)."""
        try:
            d = self._design()
        except ValueError as e:
            self.status(f"design error: {e}", ok=False)
            return {"ok": False, "error": str(e)}
        w, mag_db = d.frequency_response()
        wq, mag_q_db = d.quantized_response()
        preview = {
            "ok": True,
            "freqs_hz": np.round(w, 1).tolist(),
            "mag_db": np.round(mag_db, 2).tolist(),
            "mag_db_quantized": np.round(mag_q_db, 2).tolist(),
            "sos": np.round(d.sos, 6).tolist(),
            "sos_q": d.sos_q.tolist(),
        }
        self.emit("filter_preview", preview)
        return preview

    def generate_filter_preview_png(self) -> dict:
        """Rendered preview as a base64 PNG data URL — the reference's
        ``generate_filter_response_plot`` contract
        (``fft_analyzer_gui.py:190-230``): magnitude (dB) + phase (deg)
        stacked subplots over 0..fs/2, returned as
        ``data:image/png;base64,...``. Optional path (needs matplotlib,
        Agg backend); the array preview above is the primary, client-
        rendered path."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return {"ok": False, "error": "matplotlib not installed"}
        try:
            d = self._design()
        except ValueError as e:
            self.status(f"design error: {e}", ok=False)
            return {"ok": False, "error": str(e)}
        import base64
        from io import BytesIO

        import scipy.signal as sps

        fs_khz = self.sa.cfg.sample_rate / 1e3
        w, h = sps.sosfreqz(d.sos, worN=2048, fs=fs_khz)
        fig, (ax_mag, ax_ph) = plt.subplots(2, 1, figsize=(10, 8))
        try:
            ax_mag.plot(w, 20 * np.log10(np.maximum(np.abs(h), 1e-10)))
            ax_mag.set_title("Filter Frequency Response")
            ax_mag.set_ylabel("Magnitude (dB)")
            ax_mag.grid(True, alpha=0.3)
            ax_mag.set_xlim(0, fs_khz / 2)
            ax_ph.plot(w, np.angle(h, deg=True))
            ax_ph.set_xlabel("Frequency (kHz)")
            ax_ph.set_ylabel("Phase (degrees)")
            ax_ph.grid(True, alpha=0.3)
            ax_ph.set_xlim(0, fs_khz / 2)
            fig.tight_layout()
            buf = BytesIO()
            fig.savefig(buf, format="png", dpi=100)
        finally:
            plt.close(fig)
        url = "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
        return {"ok": True, "image": url}

    def apply_filter(self) -> dict:
        try:
            d = self._design()
            self.sa.upload_filter(d.sos)
            self.sa.set_filter_mode(FilterMode.CUSTOM)
        except ValueError as e:
            self.status(f"filter apply failed: {e}", ok=False)
            return {"ok": False, "error": str(e)}
        self.status(
            f"applied {d.kind} {d.btype} order {d.order} "
            f"(upload #{self.sa.stats.coefficient_uploads})"
        )
        return {"ok": True}

    def reset_plot(self):
        """Reference 'reset_plot' event: clear display state + stats
        (``fft_analyzer_gui.py`` SocketIO API, SURVEY.md §2.5). Clients also
        clear their canvases on the emitted event."""
        self.waterfall.clear()
        self.sa.stats.reset()
        self._fps_window.clear()
        with self._trace_lock:
            self._trace_sig = self._trace_peak = self._trace_avg = None
        self.emit("plot_reset", {})
        self.status("plot reset")

    def update_config(self, cfg: dict):
        """Reference 'update_config' event: mutate the runtime display
        config (the ``web_config`` dict analog — display rate/points and
        waterfall toggle; never traced shapes)."""
        known = {
            "display_fps",
            "display_points",
            "waterfall_enabled",
            "traces_enabled",
            "trace_alpha",
            "detector",
            "iq_correction",
            "q15_faithful",
        }
        unknown = sorted(set(cfg) - known)
        # Parse everything BEFORE mutating anything: a malformed field must
        # not leave the config half-applied.
        updates = {}
        if "display_fps" in cfg:
            updates["display_fps"] = float(
                np.clip(float(cfg["display_fps"]), 1, 120)
            )
        if "display_points" in cfg:
            updates["display_points"] = int(
                np.clip(int(cfg["display_points"]), 64, 16384)
            )
        if "waterfall_enabled" in cfg:
            updates["waterfall_enabled"] = bool(cfg["waterfall_enabled"])
        if "traces_enabled" in cfg:
            updates["traces_enabled"] = bool(cfg["traces_enabled"])
        if "trace_alpha" in cfg:
            updates["trace_alpha"] = float(
                np.clip(float(cfg["trace_alpha"]), 0.01, 1.0)
            )
        if "detector" in cfg:
            from tpu_sdr_torch.runtime.waterfall import DETECTORS

            det = str(cfg["detector"]).lower()
            if det not in DETECTORS:
                raise ValueError(
                    f"detector must be one of {DETECTORS}; got {det!r}")
            updates["detector"] = det
        if "iq_correction" in cfg:
            updates["iq_correction"] = bool(cfg["iq_correction"])
        if "q15_faithful" in cfg:
            updates["q15_faithful"] = bool(cfg["q15_faithful"])
        with self._trace_lock:
            for k, v in updates.items():
                setattr(self, k, v)
            if updates.get("traces_enabled") is False:
                self._trace_sig = self._trace_peak = self._trace_avg = None
        if updates.get("iq_correction") is False:
            self._iqcorr_rt = None  # re-converge fresh on re-enable
        if updates.get("q15_faithful") is False:
            # fresh integer state on re-enable; the generation bump keeps
            # an abandoned in-flight worker from committing stale frames
            self._q15_teardown()
        if unknown:
            self.status(f"ignored unknown config fields: {unknown}", ok=False)
        else:
            self.status("config updated")

    def get_roofline(self) -> dict:
        """Roofline cost model (the H100's) + live measured rate (SURVEY.md
        §5.1: the per-kernel counters surfaced through the stats channel)."""
        from tpu_sdr_torch.bench.roofline import roofline_report

        measured = None
        started = self.sa.stats.started_at
        if started and self.sa.stats.samples_consumed:
            elapsed = max(time.time() - started, 1e-9)
            measured = self.sa.stats.samples_consumed / elapsed
        return roofline_report(
            self.sa.cfg, measured_samples_per_sec=measured
        )

    def get_state(self) -> dict:
        art = self._audio_rt  # snapshot: HTTP/acquisition threads swap it
        return {
            "running": self.sa.running,
            "filter_mode": self.sa.filter_mode.name,
            "comm_mode": self.sa.comm_mode.name,
            "freq_range_khz": self.freq_range_khz,
            "filter_config": self.filter_config,
            "display_mode": self.display_mode,
            "detector": self.detector,
            "q15_faithful": self.q15_faithful,
            "iq_correction": self.iq_correction,
            "zoom": dict(self.zoom_cfg),
            "trigger": {**self.trigger_cfg, "armed": self._trigger_armed},
            "recording": (
                None if self._recorder is None else self._record_path
            ),
            "audio": {
                **self.audio_cfg,
                "buffered_seconds": (
                    0.0 if art is None
                    else round(art["audio"].shape[-1] / art["rate"], 2)
                ),
            },
            "stats": self.sa.stats.as_dict(),
            "config": {
                "fft_size": self.sa.cfg.fft_size,
                "sample_rate": self.sa.cfg.sample_rate,
                "hz_per_bin": self.sa.cfg.hz_per_bin,
                "channels": self.sa.cfg.channels,
            },
        }
