"""Capture features: band-power trigger + raw-sample recorder.

Feature mixin for ``GuiBackend`` (split from backend.py, VERDICT r1 item 8):
state is initialized in ``GuiBackend.__init__``; these methods only read and
mutate it. Not a standalone class.
"""

from __future__ import annotations


import numpy as np


class CaptureMixin:
    def _band_level_db(self, mag: np.ndarray, trig: dict) -> float:
        """Peak in-band level (dB of the magnitude row) for the trigger —
        the same dB axis the display shows. The band is [f_lo, f_hi] kHz;
        IQ streams evaluate BOTH sidebands (|f| in the band), unlike the
        display crop which is deliberately symmetric-from-DC."""
        n = self.sa.cfg.fft_size
        fs = self.sa.cfg.sample_rate
        lo_b = trig["f_lo_khz"] * 1e3 * n / fs
        hi_b = trig["f_hi_khz"] * 1e3 * n / fs
        if lo_b >= n // 2:
            # the configured band lies wholly beyond the stream's
            # representable span (|f| > fs/2): report -inf so the trigger
            # can never fire on it — the old clip collapsed the band onto
            # the top in-range bin and fired on a frequency the user never
            # configured (review finding)
            return float(20.0 * np.log10(1e-30))
        if getattr(self, "_iq", False):
            view = np.fft.fftshift(mag)
            c = n // 2
            level = 0.0
            for a, b in (
                (c + lo_b, c + hi_b),  # positive sideband
                (c - hi_b, c - lo_b),  # negative sideband
            ):
                a = int(np.clip(a, 0, n - 2))
                b = int(np.clip(b, a + 1, n))
                level = max(level, float(np.max(view[a:b])))
        else:
            lo = int(np.clip(lo_b, 0, n // 2 - 1))
            hi = int(np.clip(hi_b, lo + 1, n // 2))
            level = float(np.max(mag[lo:hi]))
        return float(20.0 * np.log10(max(level, 1e-30)))

    def start_record(self, max_seconds: float = 60.0) -> dict:
        """Arm raw-sample capture into ./captures/ (ring-bounded)."""
        import os
        import time as _t

        from tpu_sdr_torch.runtime.recorder import SampleRecorder

        if self._recorder is not None:
            raise ValueError("already recording; stop_record first")
        fs = self.sa.cfg.sample_rate
        max_seconds = float(np.clip(float(max_seconds), 0.1, 600.0))
        os.makedirs("captures", exist_ok=True)
        path = os.path.join(
            "captures", _t.strftime("capture_%Y%m%d_%H%M%S.npy")
        )
        self._record_path = path
        self._recorder = SampleRecorder(
            path, fs=fs, max_samples=int(max_seconds * fs)
        )
        self.status(f"recording to {path} (last {max_seconds:g}s kept)")
        return {"ok": True, "path": path}

    def stop_record(self) -> dict:
        """Finalize the capture file; returns its metadata."""
        rec, self._recorder = self._recorder, None
        if rec is None:
            raise ValueError("not recording")
        try:
            meta = rec.close()
        except ValueError as e:  # nothing recorded yet
            self.status(f"recording discarded: {e}", ok=False)
            return {"ok": False, "error": str(e)}
        self.status(
            f"capture saved: {self._record_path} "
            f"({meta['samples']} samples @ {meta['fs']:g} Hz)"
        )
        return {"ok": True, "path": self._record_path, **meta}

    def set_trigger(self, cfg: dict) -> dict:
        """Configure the band-power trigger; {'rearm': true} re-arms a
        fired single-shot trigger. Validates atomically."""
        known = {"enabled", "mode", "f_lo_khz", "f_hi_khz", "threshold_db",
                 "rearm"}
        unknown = sorted(set(cfg) - known)
        if unknown:
            self.status(f"ignored unknown trigger fields: {unknown}", ok=False)
        updates = {}
        if "mode" in cfg:
            m = str(cfg["mode"]).lower()
            if m not in ("single", "normal"):
                raise ValueError(f"trigger mode must be single|normal; got {m!r}")
            updates["mode"] = m
        if "f_lo_khz" in cfg or "f_hi_khz" in cfg:
            lo = float(cfg.get("f_lo_khz", self.trigger_cfg["f_lo_khz"]))
            hi = float(cfg.get("f_hi_khz", self.trigger_cfg["f_hi_khz"]))
            if not (0 <= lo < hi):
                raise ValueError(f"need 0 <= f_lo < f_hi; got [{lo}, {hi}] kHz")
            nyq_khz = self.sa.cfg.sample_rate / 2e3
            if lo >= nyq_khz:
                # a band wholly beyond |fs/2| can never contain signal on
                # this stream (review finding: it used to clip onto the
                # top in-range bin and trigger on it)
                raise ValueError(
                    f"f_lo {lo:g} kHz is beyond Nyquist ({nyq_khz:g} kHz)"
                )
            updates["f_lo_khz"], updates["f_hi_khz"] = lo, hi
        if "threshold_db" in cfg:
            updates["threshold_db"] = float(cfg["threshold_db"])
        if "enabled" in cfg:
            updates["enabled"] = bool(cfg["enabled"])
        was_enabled = self.trigger_cfg["enabled"]
        self.trigger_cfg.update(updates)
        # re-arm on explicit request or an off->on TRANSITION only — the UI
        # resends enabled=true on every field tweak, which must not quietly
        # overwrite a frozen single-shot capture
        if cfg.get("rearm") or (updates.get("enabled") and not was_enabled):
            self._trigger_armed = True
        state = "armed" if self._trigger_armed else "fired"
        if self.trigger_cfg["enabled"]:
            self.status(
                f"trigger {self.trigger_cfg['mode']} {state}: "
                f"{self.trigger_cfg['f_lo_khz']:g}-"
                f"{self.trigger_cfg['f_hi_khz']:g} kHz "
                f">= {self.trigger_cfg['threshold_db']:g} dB"
            )
        else:
            self.status("trigger off")
        return {
            "ok": True,
            "trigger": dict(self.trigger_cfg),
            "armed": self._trigger_armed,
        }
