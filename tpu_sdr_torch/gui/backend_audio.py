"""Listen features: band scan, burst demod, RDS decode, live audio.

Feature mixin for ``GuiBackend`` (split from backend.py, VERDICT r1 item 8):
state is initialized in ``GuiBackend.__init__``; these methods only read and
mutate it. Not a standalone class.
"""

from __future__ import annotations


import numpy as np

from tpu_sdr_torch.runtime.waterfall import host


class AudioScanMixin:
    # ---------------- on-demand band scan ---------------------------------

    def scan_band(self, cfg: dict) -> dict:
        """Run a SpectrumScanner sweep over the raw-sample ring:
        {'start_khz', 'stop_khz', 'bw_khz', 'threshold_db'}. Returns the
        hits (strongest first) + the full per-channel table."""
        from tpu_sdr_torch.runtime.scanner import SpectrumScanner

        fs = self.sa.cfg.sample_rate
        # snapshot (the acquisition thread swaps the ring); the newest
        # 0.5 s is plenty for occupancy and bounds the sweep's cost now
        # that the ring holds ~2 s for RDS
        ring = self._scan_ring[-int(0.5 * fs):]
        if ring.size < int(0.05 * fs):
            raise ValueError(
                "scan ring has too few samples; start the receiver and retry")
        iq = bool(np.iscomplexobj(ring))
        lo = float(cfg.get("start_khz", -fs / 2e3 if iq else 0.0)) * 1e3
        hi = float(cfg.get("stop_khz", fs / 2e3)) * 1e3
        bw = float(cfg.get("bw_khz", 25.0)) * 1e3
        thr = float(cfg.get("threshold_db", 10.0))
        sc = SpectrumScanner(fs, lo, hi, channel_bw=bw, threshold_db=thr,
                             device=self.device)
        if iq:
            planes = np.stack([ring.real, ring.imag]).astype(np.float32)
            res = sc.scan_planes(planes)
        else:
            res = sc.scan(ring.astype(np.float32))
        self.status(
            f"scan: {len(res.hits)} of {sc.n_channels} channels occupied "
            f"(floor {res.noise_floor_db:.1f} dB)")
        return {
            "ok": True,
            "n_channels": sc.n_channels,
            "channel_bw_khz": bw / 1e3,
            "noise_floor_db": round(res.noise_floor_db, 1),
            "centers_khz": np.round(res.centers_hz / 1e3, 1).tolist(),
            "power_db": np.round(res.power_db, 1).tolist(),
            "occupied": res.occupied.tolist(),
            "hits": [
                {
                    "center_khz": round(h["center_hz"] / 1e3, 1),
                    "power_db": round(h["power_db"], 1),
                    "snr_db": round(h["snr_db"], 1),
                }
                for h in res.hits
            ],
        }

    def demod_burst(self, cfg: dict) -> dict:
        """Demodulate a digital burst from the live raw-sample ring or a
        ``.npy`` capture: {'scheme' (bpsk|qpsk|qam16|2fsk|4fsk), 'bits',
        'sps', 'center_khz', 'path', 'max_lag_syms', 'symbol_rate_khz',
        'deviation_khz'}. Returns the recovered payload bits as hex, the
        sync estimates, and (linear schemes) decimated payload
        constellation points for plotting."""
        from tpu_sdr_torch.kernels.digital import BurstModem, FSKModem

        scheme = str(cfg.get("scheme", "qpsk"))
        n_bits = int(cfg.get("bits", 0))
        if n_bits < 1:
            raise ValueError("bits must be a positive payload bit count")
        fs = self.sa.cfg.sample_rate
        path = cfg.get("path")
        if path:
            from tpu_sdr_torch.runtime.source import FileSource

            src = FileSource(str(path), fs=fs)
            x = np.asarray(src.data[0])
            fs = src.fs
        else:
            # snapshot the newest second (bounds the demod's cost now
            # that the ring holds ~2 s for RDS)
            x = self._scan_ring[-int(fs):]
            if x.size < 1024:
                raise ValueError(
                    "raw-sample ring has too few samples; start the "
                    "receiver and retry (or pass a capture 'path')")
        z = x if np.iscomplexobj(x) else x.astype(np.complex128)
        center = float(cfg.get("center_khz", 0.0)) * 1e3
        if center:
            z = z * np.exp(-2j * np.pi * center / fs * np.arange(z.size))
        re = z.real.astype(np.float32)
        im = z.imag.astype(np.float32)
        extra: dict = {}
        if scheme in ("2fsk", "4fsk"):
            modem = FSKModem(
                fs=fs,
                symbol_rate=float(cfg.get("symbol_rate_khz", 125.0)) * 1e3,
                deviation_hz=float(cfg.get("deviation_khz", 250.0)) * 1e3,
                levels=2 if scheme == "2fsk" else 4, device=self.device)
            out = modem.demodulate(re, im, n_bits)
            extra["offset_samples"] = int(out["offset"])
        else:
            modem = BurstModem(
                scheme, sps=int(cfg.get("sps", 8)),
                max_lag_syms=int(cfg.get("max_lag_syms", 16)), device=self.device)
            out = modem.demodulate(re, im, n_bits)
            extra.update(
                frame_lag_syms=int(out["frame_lag"]),
                timing_samples=round(float(out["timing"]), 3),
                cfo_cyc_per_sym=float(out["cfo"]),
                phase_rad=round(float(out["phase"]), 3))
            sr = host(out["symbols"][0]).reshape(-1)
            si = host(out["symbols"][1]).reshape(-1)
            k = max(1, sr.size // 512)
            extra["constellation"] = {
                "re": np.round(sr[::k], 4).tolist(),
                "im": np.round(si[::k], 4).tolist()}
        bits = host(out["bits"]).reshape(-1)
        padn = (-bits.size) % 8
        hexstr = np.packbits(
            np.concatenate([bits, np.zeros(padn, np.uint8)])).tobytes().hex()
        self.status(f"burst: {scheme} {n_bits} bits demodulated")
        return {"ok": True, "scheme": scheme, "n_bits": n_bits,
                "bits_hex": hexstr, **extra}

    def rds_decode(self, cfg: dict) -> dict:
        """Decode RDS from the live raw-sample ring or a ``.npy``
        capture: {'center_khz' (FM carrier), 'path', 'deviation_khz'}.
        Chain: DDC to the carrier -> quadrature discriminator (raw MPX)
        -> `kernels.rds.RDSDecoder`. Returns PI/PS/RadioText and block
        statistics; partial fields show as '_' until enough groups
        arrive (the ring holds ~2 s)."""
        from tpu_sdr_torch.kernels.ddc import DDC
        from tpu_sdr_torch.kernels.demod import FMDemodulator
        from tpu_sdr_torch.kernels.rds import RDSDecoder

        fs = self.sa.cfg.sample_rate
        path = cfg.get("path")
        if path:
            from tpu_sdr_torch.runtime.source import FileSource

            src = FileSource(str(path), fs=fs)
            x = np.asarray(src.data[0])
            fs = src.fs
        else:
            x = self._scan_ring  # snapshot: acquisition thread swaps it
            if x.size < int(0.2 * fs):
                raise ValueError(
                    "raw-sample ring has too few samples; start the "
                    "receiver and retry (or pass a capture 'path')")
        # pick an MPX rate that reaches the 19 kHz bit grid (>= 114 kHz
        # so the 57 kHz subcarrier survives) with the CHEAPEST rational
        # resample — phase count drives the resampler's trace size
        dec = None
        for r in range(int(fs // 114_000), 0, -1):
            try:
                cand = RDSDecoder(fs / r, device=self.device)
            except ValueError:
                continue
            up = 1 if cand.resamp is None else cand.resamp.up
            if dec is None or up < best_up:
                dec, best_up = cand, up
        if dec is None:
            raise ValueError(f"no RDS-capable decimation from fs={fs}")
        center = float(cfg.get("center_khz", 100.0)) * 1e3
        ddc = DDC(fs, center_hz=center, decimation=int(round(fs / dec.fs)),
                  taps_per_phase=12, device=self.device)
        iq = bool(np.iscomplexobj(x))
        t = (x.shape[-1] // (ddc.r * 128)) * (ddc.r * 128)
        if iq:
            planes = np.stack([x.real, x.imag])[:, :t].astype(np.float32)
            bb, _ = ddc.process_planes(planes, ddc.initial_state())
        else:
            bb, _ = ddc.process(x[:t].astype(np.float32),
                                ddc.initial_state())
        fm = FMDemodulator(
            dec.fs, deviation_hz=float(cfg.get("deviation_khz", 75.0)) * 1e3,
            deemphasis_tau=None, device=self.device)
        mpx, _ = fm.process(bb["re"], bb["im"], fm.initial_state())
        res = dec.decode(mpx)
        if res.pi is None:
            self.status("rds: no groups decoded", ok=False)
        else:
            self.status(f"rds: PI={res.pi:04X} PS={res.ps_name!r}")
        return {
            "ok": True,
            "pi": None if res.pi is None else f"{res.pi:04X}",
            "pty": res.pty,
            "tp": res.tp,
            "ps": res.ps_name,
            "radiotext": res.radiotext,
            "groups": res.groups,
            "n_blocks": res.n_blocks,
            "block_error_rate": round(res.block_error_rate, 4),
        }

    # ---------------- live audio demod (the 'listen' feature) -------------

    def _audio_step(self, x):
        """Tee one raw chunk into the receiver; accumulate demodulated
        audio in the bounded ring (newest kept)."""
        rt = self._audio_rt
        if rt is None:
            return
        xn = np.asarray(x)
        if xn.ndim > 1:
            xn = xn[0]  # listen to channel 0 of multi-channel sources
        iq = bool(np.iscomplexobj(xn))
        if rt["iq"] is None:
            # adopt the stream kind from the FIRST chunk: set_audio may run
            # before the receiver has produced any chunk, when self._iq is
            # not yet known — snapshotting it there silently auto-disabled
            # audio on IQ sources enabled early (review finding)
            rt["iq"] = iq
            rt["raw"] = np.zeros(0, np.complex64 if iq else np.float32)
        elif iq != rt["iq"]:
            raise ValueError("source real/IQ type changed; re-enable audio")
        buf = np.concatenate([rt["raw"], xn])
        g = rt["rx"].chunk_granularity
        take = (buf.shape[0] // g) * g
        rt["raw"] = buf[take:]
        if not take:
            return
        seg = buf[:take]
        if iq:
            planes = np.stack([seg.real, seg.imag]).astype(np.float32)
            audio, rt["state"] = rt["rx"].process_planes(planes, rt["state"])
        else:
            audio, rt["state"] = rt["rx"].process(
                seg.astype(np.float32), rt["state"])
        ring = np.concatenate(
            [rt["audio"], host(audio).astype(np.float32)], axis=-1)
        rt["audio"] = ring[..., -rt["max_samples"]:]

    def set_audio(self, cfg: dict) -> dict:
        """Enable/disable the live receiver: {'enabled', 'center_khz',
        'mode' (wbfm|nbfm|am|usb|lsb), 'max_seconds'}. Enabling (re)builds
        the receiver and clears the audio ring."""
        from tpu_sdr_torch.runtime.receiver import MODES, Receiver

        known = {"enabled", "center_khz", "mode", "max_seconds", "stereo"}
        unknown = sorted(set(cfg) - known)
        ac = dict(self.audio_cfg)
        if "center_khz" in cfg:
            c = float(cfg["center_khz"])
            fs = self.sa.cfg.sample_rate
            if abs(c) * 1e3 > fs / 2:
                # same bound set_zoom enforces: beyond Nyquist the 32-bit
                # NCO wraps mod fs and would silently demodulate an
                # unrelated alias (review finding)
                raise ValueError(
                    f"audio center must be within +/-{fs / 2e3:.0f} kHz"
                )
            ac["center_khz"] = c
        if "mode" in cfg:
            mode = str(cfg["mode"]).lower()
            if mode not in MODES:
                raise ValueError(f"mode must be one of {MODES}; got {mode!r}")
            ac["mode"] = mode
        if "max_seconds" in cfg:
            ac["max_seconds"] = float(np.clip(float(cfg["max_seconds"]), 1, 600))
        if "stereo" in cfg:
            ac["stereo"] = bool(cfg["stereo"])
        if "enabled" in cfg:
            ac["enabled"] = bool(cfg["enabled"])
        if ac["stereo"] and ac["mode"] != "wbfm":
            raise ValueError("stereo decoding is a wbfm feature")
        self.audio_cfg = ac
        if ac["enabled"]:
            rx = Receiver(
                fs=self.sa.cfg.sample_rate,
                center_hz=ac["center_khz"] * 1e3,
                mode=ac["mode"],
                stereo=ac["stereo"],
                device=self.device,
            )
            rate = float(rx.realized_audio_rate)
            self._audio_rt = {
                "rx": rx,
                "state": rx.initial_state(),
                # None = adopt from the first chunk (see _audio_step)
                "iq": None,
                "raw": np.zeros(0, np.float32),
                "audio": np.zeros((2, 0) if ac["stereo"] else 0, np.float32),
                "rate": rate,
                "max_samples": int(ac["max_seconds"] * rate),
            }
            self.status(
                f"audio on: {ac['mode']}{' stereo' if ac['stereo'] else ''} "
                f"at {ac['center_khz']:g} kHz -> {rate:.0f} Hz audio")
        else:
            self._audio_rt = None
            self.status("audio off")
        if unknown:
            self.status(f"ignored unknown audio fields: {unknown}", ok=False)
        return {"ok": True, "audio": dict(self.audio_cfg)}

    def save_audio(self) -> dict:
        """Write the buffered audio ring to captures/audio_<ts>.wav."""
        import os
        import time as _t

        from tpu_sdr_torch.runtime.receiver import write_wav

        rt = self._audio_rt
        if rt is None or rt["audio"].size == 0:
            raise ValueError("no audio buffered; enable audio first")
        os.makedirs("captures", exist_ok=True)
        path = os.path.join(
            "captures", _t.strftime("audio_%Y%m%d_%H%M%S.wav"))
        write_wav(path, rt["audio"], rt["rate"])
        seconds = rt["audio"].shape[-1] / rt["rate"]
        self.status(f"audio saved: {path} ({seconds:.1f} s)")
        return {"ok": True, "path": path, "seconds": round(seconds, 2),
                "rate": rt["rate"]}
