"""Zoom mode (PFB subchannel / DDC zoom-FFT) + blind IQ correction.

Feature mixin for ``GuiBackend`` (split from backend.py, VERDICT r1 item 8):
state is initialized in ``GuiBackend.__init__``; these methods only read and
mutate it. Not a standalone class.
"""

from __future__ import annotations


import numpy as np

from tpu_sdr_torch.core.config import PipelineConfig
from tpu_sdr_torch.runtime.waterfall import host


class ZoomMixin:
    # ---------------- zoom mode (PFB subchannel -> zoom FFT) ----------

    def _zoom_runtime(self, iq: bool) -> dict:
        """Build (or rebuild after set_zoom/source-type change) the zoom
        chain: channelizer-or-DDC + small spectrum pipeline + states."""
        rt = self._zoom_rt
        if rt is not None and rt["gen"] == self._zoom_gen and rt["iq"] == iq:
            return rt
        from tpu_sdr_torch.runtime import SpectrumPipeline

        zc = dict(self.zoom_cfg)  # snapshot: set_zoom can mutate mid-step
        nz = zc["fft_size"]
        fs = self.sa.cfg.sample_rate
        if zc["mode"] == "ddc":
            from tpu_sdr_torch.kernels.ddc import DDC

            front = DDC(
                fs=fs, center_hz=zc["center_hz"], decimation=zc["decimation"],
                device=self.device,
            )
            # DDC batch excludes the plane axis (planes (2, T) <-> state (hist,))
            front_state = front.initial_state(())
            sub_rate = front.output_rate
            center_hz = zc["center_hz"]
        else:
            from tpu_sdr_torch.kernels.pfb import Channelizer

            front = Channelizer(m=zc["m"], taps=zc["taps"], sample_rate=fs,
                                device=self.device)
            front_state = front.initial_state((2,) if iq else ())
            sub_rate = fs / zc["m"]
            k = int(zc["channel"]) % zc["m"]
            center_hz = k * sub_rate
            if center_hz > fs / 2:
                # subchannels k > m/2 are centered at NEGATIVE frequencies
                # for real input too (they hold the conjugate mirror of
                # |f| = fs - k*fs/m) — labeling them k*fs/m put the center
                # above Nyquist, a frequency a real stream cannot contain
                # (review finding)
                center_hz -= fs
        # 1024-pt zoom FFT = 32x32 four-step at the decimated rate
        pipe = SpectrumPipeline(
            PipelineConfig(
                fft_size=nz, fft_n1=32, fft_n2=32, channels=1,
                sample_rate=sub_rate,
            ),
            device=self.device,
        )
        self._zoom_rt = {
            "gen": self._zoom_gen,
            "iq": iq,
            "cfg": zc,  # the config this runtime was BUILT for
            "sub_rate": sub_rate,
            "center_hz": center_hz,
            "front": front,
            "pipe": pipe,
            "front_state": front_state,
            "pipe_state": pipe.initial_state(batch_shape=(2,)),
            "buf": np.zeros(0, np.complex64),
            "raw": np.zeros(0, np.complex64 if iq else np.float32),
        }
        return self._zoom_rt

    @staticmethod
    def _run_front(rt: dict, arr: np.ndarray, iq: bool) -> dict:
        """Dispatch one chunk to the front-end (real vs IQ planes)."""
        if iq:
            planes = np.stack([arr.real, arr.imag]).astype(np.float32)
            out, rt["front_state"] = rt["front"].process_planes(
                planes, rt["front_state"]
            )
        else:
            out, rt["front_state"] = rt["front"].process(
                arr.astype(np.float32), rt["front_state"]
            )
        return out

    def _zoom_front(self, rt: dict, xn: np.ndarray, iq: bool) -> np.ndarray:
        """Run one raw chunk through the zoom front-end (PFB subchannel or
        DDC); returns the new complex baseband samples. Uses rt's BUILT
        config, never the live zoom_cfg (a set_zoom between runtime build
        and this call must not mismatch front object and branch)."""
        zc = rt["cfg"]
        if zc["mode"] == "ddc":
            # DDC consumes multiples of R; carry the remainder host-side
            r = zc["decimation"]
            buf = np.concatenate([rt["raw"], xn])
            take = (buf.shape[0] // r) * r
            rt["raw"] = buf[take:]
            if not take:
                return np.zeros(0, np.complex64)
            out = self._run_front(rt, buf[:take], iq)
            return (host(out["re"]) + 1j * host(out["im"])).astype(np.complex64)
        k = int(zc["channel"]) % zc["m"]
        out = self._run_front(rt, xn, iq)
        return (host(out["re"][..., k]) + 1j * host(out["im"][..., k])).astype(np.complex64)

    def _zoom_step(self, x):
        """Channelize one raw chunk, accumulate the selected subchannel,
        and emit a ``zoom_frame`` per full zoom-FFT frame."""
        from tpu_sdr_torch.core.config import FilterMode as FM

        # Channel-0 tap (like the scan ring and audio taps): reshape(-1)
        # on a (C, T) chunk would splice the channel streams end-to-end
        # into the carried DDC/PFB state with a phase seam per chunk.
        xa = np.asarray(x)
        xn = (xa[0] if xa.ndim > 1 else xa).reshape(-1)
        iq = bool(np.iscomplexobj(xn))
        rt = self._zoom_runtime(iq)
        sub = self._zoom_front(rt, xn, iq)
        rt["buf"] = np.concatenate([rt["buf"], sub])
        nz = rt["cfg"]["fft_size"]
        while rt["buf"].shape[0] >= nz:
            frame, rt["buf"] = rt["buf"][:nz], rt["buf"][nz:]
            zout, rt["pipe_state"] = rt["pipe"].process(
                frame[None, :], rt["pipe_state"], FM.BYPASS
            )
            self._emit_zoom_frame(rt, host(zout["magnitude"][0, -1]))

    def _emit_zoom_frame(self, rt: dict, mag: np.ndarray):
        zc = rt["cfg"]
        nz = zc["fft_size"]
        sub_rate, center_hz = rt["sub_rate"], rt["center_hz"]
        # Same display units as the main plot: each pipeline applies ITS OWN
        # schedule-derived wire scale (2^15/N). Under the xfft 1/N schedule a
        # carrier's bin amplitude is N-independent, so the same tone reads
        # the same wire-LSB level in the 16K main view and the N-point zoom
        # view. The user's wire_calibration trim scales both proportionally
        # (1.0 on the main path => raw-float main, zoom still re-ratioed to
        # its own N so relative levels stay comparable).
        from tpu_sdr_torch.core.qformat import xfft_wire_scale

        cal = self.wire_calibration * (
            xfft_wire_scale(nz) / xfft_wire_scale(self.sa.cfg.fft_size)
        )
        if cal != 1.0:
            mag = mag * cal
        view = np.fft.fftshift(mag)  # subchannel stream is complex baseband
        offs = (np.arange(nz) - nz // 2) * (sub_rate / nz)
        peak = int(np.argmax(view))
        self.emit(
            "zoom_frame",
            {
                "mode": zc["mode"],
                "channel": int(zc["channel"]) % zc["m"],
                "center_khz": round(center_hz / 1e3, 3),
                "span_hz": sub_rate,
                "hz_per_bin": sub_rate / nz,
                "offsets_hz": np.round(offs, 2).tolist(),
                "magnitude": np.round(view.astype(np.float64), 4).tolist(),
                "peak_offset_hz": round(float(offs[peak]), 2),
                "peak_freq_khz": round((center_hz + offs[peak]) / 1e3, 4),
                "peak_mag": float(view[peak]),
            },
        )

    def _iq_correct(self, x: np.ndarray) -> np.ndarray:
        """Run the blind image-rejection corrector over a complex chunk
        (carried state; lazily built for the chunk's batch shape)."""
        from tpu_sdr_torch.kernels.iqcorr import IQCorrector

        xn = np.asarray(x)
        batch = xn.shape[:-1]
        if self._iqcorr_rt is None or (
            tuple(np.shape(self._iqcorr_rt[1].power)) != batch
        ):
            corr = IQCorrector(device=self.device)
            self._iqcorr_rt = (corr, corr.initial_state(batch))
        corr, st = self._iqcorr_rt
        t = xn.shape[-1] - xn.shape[-1] % corr.block
        if not t:
            return x
        wre, wim, st = corr.process(
            xn.real[..., :t].astype(np.float32),
            xn.imag[..., :t].astype(np.float32), st)
        self._iqcorr_rt = (corr, st)
        out = host(wre) + 1j * host(wim)
        if t < xn.shape[-1]:  # pass the sub-block tail through uncorrected
            out = np.concatenate([out, xn[..., t:]], axis=-1)
        return out.astype(np.complex64)

    def set_zoom(self, cfg: dict) -> dict:
        """Enable/disable zoom, pick the front-end ('pfb' subchannel grid
        or 'ddc' arbitrary center), and its tuning; ``m``/``taps``/
        ``fft_size`` are session-fixed (traced shapes)."""
        known = {"enabled", "mode", "channel", "center_khz", "decimation"}
        unknown = sorted(set(cfg) - known)
        if unknown:
            self.status(f"ignored unknown zoom fields: {unknown}", ok=False)
        fs = self.sa.cfg.sample_rate
        # Validate everything BEFORE mutating (atomic, like update_config).
        updates = {}
        if "mode" in cfg:
            mode = str(cfg["mode"]).lower()
            if mode not in ("pfb", "ddc"):
                raise ValueError(f"zoom mode must be 'pfb' or 'ddc'; got {mode!r}")
            updates["mode"] = mode
        if "channel" in cfg:
            ch = int(cfg["channel"])
            if not (0 <= ch < self.zoom_cfg["m"]):
                raise ValueError(
                    f"zoom channel must be in [0, {self.zoom_cfg['m']})"
                )
            updates["channel"] = ch
        if "center_khz" in cfg:
            c = float(cfg["center_khz"]) * 1e3
            if not (-fs / 2 <= c <= fs / 2):
                raise ValueError(
                    f"zoom center must be within +/-{fs / 2e3:.0f} kHz"
                )
            updates["center_hz"] = c
        if "decimation" in cfg:
            r = int(cfg["decimation"])
            if not (2 <= r <= self.zoom_cfg["fft_size"] * 16):
                raise ValueError(f"zoom decimation out of range: {r}")
            updates["decimation"] = r
        if "enabled" in cfg:
            updates["enabled"] = bool(cfg["enabled"])
        self.zoom_cfg.update(updates)
        self._zoom_gen += 1  # rebuild states: any retune restarts clean
        zc = self.zoom_cfg
        if zc["enabled"]:
            if zc["mode"] == "ddc":
                sub_rate = fs / zc["decimation"]
                self.status(
                    f"zoom on (ddc): {zc['center_hz'] / 1e3:.1f} kHz, "
                    f"span {sub_rate / 1e3:.2f} kHz, "
                    f"{sub_rate / zc['fft_size']:.2f} Hz/bin"
                )
            else:
                sub_rate = fs / zc["m"]
                self.status(
                    f"zoom on: channel {zc['channel']} "
                    f"({zc['channel'] * sub_rate / 1e3:.1f} kHz, "
                    f"span {sub_rate / 1e3:.2f} kHz, "
                    f"{sub_rate / zc['fft_size']:.2f} Hz/bin)"
                )
        else:
            self.status("zoom off")
        return {"ok": True, "zoom": dict(self.zoom_cfg)}
