"""Display emission: spectrum frame_data events + waterfall rows."""

from __future__ import annotations

import numpy as np

from tpu_sdr_torch.runtime.measure import refine_peak


class DisplayMixin:
    def _emit_frame(
        self, mag: np.ndarray, mode: str | None = None, triggered: bool = False
    ):
        if mode is None:
            mode = self.display_mode
        n = self.sa.cfg.fft_size
        fs = self.sa.cfg.sample_rate
        lo_khz, hi_khz = self.freq_range_khz
        if getattr(self, "_iq", False):
            # IQ stream: single-sided spectrum is meaningless; show the full
            # fftshifted baseband (-fs/2..fs/2), freq range applied as +/-.
            view = np.fft.fftshift(
                np.abs(mag) if mode in ("real", "imag") else mag
            )
            base = -n // 2  # bin offset of view[0]
            lo = int(np.clip((n // 2) - hi_khz * 1000 * n / fs, 0, n - 2))
            hi = int(np.clip((n // 2) + hi_khz * 1000 * n / fs, lo + 1, n))
        else:
            view = (
                np.abs(mag[: n // 2])
                if mode in ("real", "imag")
                else mag[: n // 2]
            )
            base = 0
            lo = int(np.clip(lo_khz * 1000 * n / fs, 0, n // 2 - 1))
            hi = int(np.clip(hi_khz * 1000 * n / fs, lo + 1, n // 2))
        window = view[lo:hi]
        # Peak-preserving decimation for display (max-pool buckets).
        pts = min(self.display_points, hi - lo)
        edges = np.linspace(0, hi - lo, pts + 1).astype(int)
        dec = np.maximum.reduceat(window, edges[:-1])
        freqs_khz = (base + lo + edges[:-1] * 1.0) * fs / n / 1000.0
        peak = int(np.argmax(window))
        # sub-bin refinement of the peak marker (parabolic in dB) — the
        # reference GUI reports only the raw bin (fft_analyzer_gui.py:444)
        d, _ = refine_peak(window, peak)
        peak_interp_khz = float(base + lo + peak + d) * fs / n / 1000.0
        traces = {}
        if self.traces_enabled:
            # snapshot to locals: the HTTP thread may null these concurrently
            # (update_config/reset_plot); compute on locals, assign back once
            sig = (mode, getattr(self, "_iq", False), base, lo, hi, pts)
            pk, av = self._trace_peak, self._trace_avg
            if sig != self._trace_sig or pk is None or av is None:
                pk = dec.astype(np.float64)
                av = dec.astype(np.float64)
            else:
                pk = np.maximum(pk, dec)
                av = av + self.trace_alpha * (dec - av)
            self._trace_sig, self._trace_peak, self._trace_avg = sig, pk, av
            traces = {
                "trace_peak": np.round(pk, 4).tolist(),
                "trace_avg": np.round(av, 4).tolist(),
            }
        # one _fps_window stamp per dispatch; each dispatch carries
        # frames_per_dispatch frames
        incoming_fps = len(self._fps_window) * float(self.frames_per_dispatch)
        self.emit(
            "frame_data",
            {
                "freqs_khz": np.round(freqs_khz, 3).tolist(),
                "magnitude": np.round(dec.astype(np.float64), 4).tolist(),
                **traces,
                "peak_bin": (base + lo + peak) % n,
                "peak_freq_khz": (base + lo + peak) * fs / n / 1000.0,
                "peak_freq_interp_khz": round(peak_interp_khz, 4),
                "triggered": triggered,
                "peak_mag": float(window[peak]),
                "frames_received": self.sa.stats.frames_produced,
                "incoming_fps": round(self.sa.stats.frames_produced and incoming_fps, 2),
                "filter_mode": int(self.sa.filter_mode),
                "comm_mode": int(self.sa.comm_mode),
                "display_mode": mode,
            },
        )

    def _emit_waterfall_row(self, mag: np.ndarray):
        n = self.sa.cfg.fft_size
        if getattr(self, "_iq", False):
            half = np.fft.fftshift(mag)  # full baseband for IQ
        else:
            half = mag[: n // 2]
        from tpu_sdr_torch.runtime.waterfall import detect_bucketed

        pts = self.waterfall.points
        edges = np.linspace(0, half.shape[0], pts + 1).astype(int)
        dec = detect_bucketed(half, edges, self.detector)
        row_db = 20.0 * np.log10(np.maximum(dec, 1e-9))
        self.waterfall.push(row_db)
        self.emit(
            "waterfall_row",
            {
                "row_db": np.round(row_db.astype(np.float64), 1).tolist(),
                "peak_hold_db": np.round(
                    self.waterfall.peak_hold.astype(np.float64), 1
                ).tolist(),
                "rows": self.waterfall.row_count,
            },
        )
