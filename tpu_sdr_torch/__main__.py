"""Command-line entry point: ``python -m tpu_sdr_torch <command>``.

The reference's user surface is "run the GUI script" plus a handful of
host-side chores (design a filter, sanity-check the link,
``scripts/fft_analyzer_gui.py``); this CLI is the equivalent front door:

    python -m tpu_sdr_torch gui [--port 5000] [--iq] [--no-pace]   live web GUI
    python -m tpu_sdr_torch demo                        two-tone find/filter demo
    python -m tpu_sdr_torch design butterworth lowpass 12 --cutoff 300e3
    python -m tpu_sdr_torch selftest                    end-to-end health check
    python -m tpu_sdr_torch bench [--frames 64] [--reps 3]   quick throughput probe
    python -m tpu_sdr_torch trace [--quality f32]       device-trace op attribution
    python -m tpu_sdr_torch scan [--input cap.npy] [--bw 25e3]   band-occupancy sweep
    python -m tpu_sdr_torch rx --center 150e3 --mode wbfm       demodulate to WAV
    python -m tpu_sdr_torch burst [--scheme qpsk]       digital burst demodulation

Every command but ``design`` runs on the GPU (``--device cuda``, the
default, raising without one) or, with ``--device cpu``, on the CPU with the
kernels' plain versions. The port is imported inside each command, so
``--help`` and ``design`` never touch a device.
"""

from __future__ import annotations

import argparse
import json
import sys


def _host(x):
    """A command's device output as a host array."""
    from tpu_sdr_torch.runtime.waterfall import host

    return host(x)


def _cmd_gui(args) -> int:
    from tpu_sdr_torch.gui.backend import GuiBackend
    from tpu_sdr_torch.gui.server import serve

    backend = GuiBackend(pace=not args.no_pace, device=args.device)
    if args.iq:
        from tpu_sdr_torch.runtime.source import SyntheticSource

        backend.source = SyntheticSource(
            tones_hz=((150_000.0, 0.5), (-300_000.0, 0.25)), noise=0.01, iq=True
        )
    print(f"tpu_sdr_torch GUI on http://localhost:{args.port} ({backend.device})", flush=True)
    serve(backend, port=args.port, bind=args.bind)
    return 0


def _cmd_demo(args) -> int:
    import numpy as np

    from tpu_sdr_torch import FilterMode, PipelineConfig
    from tpu_sdr_torch.control import SpectrumAnalyzer, design_iir_filter
    from tpu_sdr_torch.runtime.source import SyntheticSource

    fs = 1_000_000.0
    sa = SpectrumAnalyzer(PipelineConfig(channels=1), device=args.device)
    sa.start()
    src = SyntheticSource(
        tones_hz=((250_000.0, 0.4), (400_000.0, 0.4)), noise=0.01, fs=fs
    )
    x = src.read(4 * sa.cfg.fft_size)
    out = sa.process(x)
    mag = np.asarray(out["magnitude"])[0, -1]
    peaks = sorted(np.argsort(mag[:8192])[-2:] * sa.cfg.hz_per_bin / 1000)
    print(f"bypass: peaks near {[round(float(p), 1) for p in peaks]} kHz")

    d = design_iir_filter("butterworth", "lowpass", 12, fs, 300_000.0)
    sa.upload_filter(d.sos)
    sa.set_filter_mode(FilterMode.CUSTOM)
    out2 = sa.process(x)
    mag2 = np.asarray(out2["magnitude"])[0, -1]
    b400 = int(400_000 * sa.cfg.fft_size / fs)
    print(
        "after 300 kHz lowpass: 400 kHz suppressed "
        f"{20 * np.log10((mag2[b400] + 1e-9) / mag[b400]):.1f} dB"
    )
    return 0


def _cmd_design(args) -> int:
    import numpy as np

    from tpu_sdr_torch.control.designer import design_iir_filter

    if args.btype in ("bandpass", "bandstop"):
        if args.cutoff_hi is None:
            print(
                f"error: {args.btype} requires --cutoff-hi (upper band edge)",
                file=sys.stderr,
            )
            return 2
        cutoff = (args.cutoff, args.cutoff_hi)
    else:
        cutoff = args.cutoff
    d = design_iir_filter(
        args.kind,
        args.btype,
        args.order,
        args.fs,
        cutoff,
        ripple_db=args.ripple,
        attenuation_db=args.attenuation,
    )
    np.set_printoptions(precision=6, suppress=True)
    print(f"SOS ({d.sos.shape[0]} sections):")
    print(d.sos)
    print(f"quantized x64 int8:\n{d.sos_q}")
    print(f"wire bytes (0xF1 payload): {d.to_wire_bytes().hex(' ')}")
    w, h = d.frequency_response(16)
    wq, hq = d.quantized_response(16)
    print("response (dB, float vs quantized):")
    for f, a, b in zip(w, h, hq):
        print(f"  {f / 1e3:8.1f} kHz  {a:8.2f}  {b:8.2f}")
    return 0


def _cmd_selftest(args) -> int:
    import numpy as np
    import scipy.signal as sps

    from tpu_sdr_torch import FilterMode, PipelineConfig
    from tpu_sdr_torch.runtime import SpectrumPipeline

    fs, n = 1e6, 16384
    dev = args.device
    pipe = SpectrumPipeline(PipelineConfig(), device=dev)
    t = np.arange(4 * n) / fs
    x = (
        0.4 * np.sin(2 * np.pi * 250e3 * t) + 0.4 * np.sin(2 * np.pi * 400e3 * t)
    ).astype(np.float32)
    out, st = pipe.process(x, pipe.initial_state(), FilterMode.BYPASS)
    mag = _host(out["magnitude"])[0, -1][: int(n // 2)]
    peaks = set(np.argsort(mag)[-2:].tolist())
    ok_peaks = peaks == {4096, 6554}
    pipe.upload_sos(sps.butter(12, 300e3 / (fs / 2), output="sos"))
    out2, _ = pipe.process(x, st, FilterMode.CUSTOM)
    mag2 = _host(out2["magnitude"])[0, -1][: int(n // 2)]
    supp = 20 * np.log10(mag[6554] / max(mag2[6554], 1e-12))
    ok_supp = supp > 60.0
    # chunked == one-shot determinism
    o1, _ = pipe.process(x, pipe.initial_state(), FilterMode.CUSTOM)
    s = pipe.initial_state()
    chunks = []
    for i in range(4):
        oc, s = pipe.process(x[i * int(n) : (i + 1) * int(n)], s, FilterMode.CUSTOM)
        chunks.append(_host(oc["magnitude"]))
    ok_det = np.array_equal(np.concatenate(chunks, axis=1), _host(o1["magnitude"]))
    # channelizer: the 250 kHz tone lands in subchannel 32
    from tpu_sdr_torch.kernels.pfb import Channelizer

    ch = Channelizer(m=128, taps=8, device=dev)
    co, _ = ch.process(x[None, : 64 * 128], ch.initial_state((1,)))
    cpw = (_host(co["re"]) ** 2 + _host(co["im"]) ** 2)[0].mean(0)
    top3 = set(np.argsort(cpw)[-3:].tolist())
    # 250 kHz -> subchannel 32 exactly; 400 kHz straddles 51.2
    ok_pfb = 32 in top3 and bool(top3 & {51, 52})
    # DDC + Welch PSD: tune to 400 kHz, tone appears at baseband DC
    # (detrend would remove a DC-centered tone, so it's off here)
    from tpu_sdr_torch.kernels.ddc import DDC
    from tpu_sdr_torch.runtime import WelchPSD

    ddc = DDC(fs=fs, center_hz=400e3, decimation=16, device=dev)
    do, _ = ddc.process(x, ddc.initial_state(()))
    est = WelchPSD(fs=ddc.output_rate, nperseg=1024, detrend=False, device=dev)
    psd = _host(est.compute_iq(do["re"][128:], do["im"][128:]))
    fbins = est.frequencies(onesided=False)
    ok_ddc = abs(fbins[int(np.argmax(psd))]) <= ddc.output_rate / 1024
    # faithful Q15 split path: the filtered wire words must equal the
    # NumPy oracle bit for bit (the hardware-exact mode's core promise)
    from tpu_sdr_torch.control import golden
    from tpu_sdr_torch.core import qformat as qf
    from tpu_sdr_torch.kernels import fft_q15 as fq
    from tpu_sdr_torch.runtime.q15 import Q15Pipeline

    qp = Q15Pipeline(PipelineConfig(channels=1), device_fft=True, device=dev)
    qp.upload_sos_q(qf.quantize_coeff_x64(sps.butter(4, 0.25, output="sos")))
    xq = np.clip(np.rint(x[:n] * 32767), -32768, 32767).astype(np.int16)
    qo, _ = qp.process(xq, bypass=False)
    xw0 = golden.rtl_window_q15(xq)
    y0, _ = golden.sosfilt_q15_intended(
        np.asarray(qp.sos_q, np.int64), xw0,
        np.zeros((qp.cfg.n_sections, 2), np.int64),
    )
    rr, ri = fq.fft_q15_np(y0[None])
    ok_q15 = bool(
        np.array_equal(
            _host(qo["spectrum_re_q15"]).reshape(-1, n)[0], rr[0]
        )
        and np.array_equal(
            _host(qo["spectrum_im_q15"]).reshape(-1, n)[0], ri[0]
        )
    )
    for name, ok in [
        (f"tone peaks at bins {sorted(peaks)}", ok_peaks),
        (f"400 kHz suppression {supp:.1f} dB", ok_supp),
        ("chunked == one-shot (bitwise)", ok_det),
        ("channelizer: 250 kHz -> subchannel 32", ok_pfb),
        ("DDC @400 kHz + Welch PSD: tone at baseband DC", ok_ddc),
        ("faithful Q15 wire words == integer oracle (bitwise)", ok_q15),
    ]:
        print(f"  [{'PASS' if ok else 'FAIL'}] {name}")
    ok = ok_peaks and ok_supp and ok_det and ok_pfb and ok_ddc and ok_q15
    print("selftest:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def _cmd_trace(args) -> int:
    """Device-trace one production dispatch and print the op table.

    On the GPU it prints the kernels of the last traced dispatch; with
    ``--device cpu`` the trace has no device events and the command reports
    that. SURVEY §5.1: the on-device observability the reference's debug
    LEDs could never provide.
    """
    import numpy as np
    import scipy.signal as sps

    from tpu_sdr_torch import FilterMode, PipelineConfig
    from tpu_sdr_torch.bench.trace import capture_op_table
    from tpu_sdr_torch.runtime import SpectrumPipeline

    import torch

    cfg = PipelineConfig(channels=args.channels, dtype=args.quality)
    pipe = SpectrumPipeline(cfg, device=args.device)
    pipe.upload_sos(sps.butter(12, 0.25, output="sos"))
    n = cfg.fft_size
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (args.channels, args.frames * n)
    ).astype(np.float32), device=pipe.device)
    state = {"st": pipe.initial_state()}
    out, state["st"] = pipe.process(x, state["st"], FilterMode.CUSTOM)
    float(out["magnitude"].reshape(-1)[0])  # warm up, and wait for it

    def step():
        o, state["st"] = pipe.process(x, state["st"], FilterMode.CUSTOM)
        return o["magnitude"]

    print(json.dumps(capture_op_table(step, reps=args.reps)))
    return 0


def _cmd_bench(args) -> int:
    import time

    import numpy as np

    from tpu_sdr_torch import FilterMode, PipelineConfig
    from tpu_sdr_torch.runtime import SpectrumPipeline

    import scipy.signal as sps

    import torch

    cfg = PipelineConfig(channels=args.channels, dtype=args.quality)
    pipe = SpectrumPipeline(cfg, device=args.device)
    pipe.upload_sos(sps.butter(12, 0.25, output="sos"))
    n = cfg.fft_size
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (args.channels, args.frames * n)
    ).astype(np.float32), device=pipe.device)
    state = pipe.initial_state()
    out, _ = pipe.process(x, state, FilterMode.CUSTOM)
    float(out["magnitude"].reshape(-1)[0])  # warm up + settle

    def run_k(k):
        st = state
        t0 = time.perf_counter()
        for _ in range(k):
            out, st = pipe.process(x, st, FilterMode.CUSTOM)
        float(out["magnitude"].reshape(-1)[0])  # waits for the device
        return time.perf_counter() - t0

    run_k(2)
    per = []
    for _ in range(args.reps):
        t2, t12 = min(run_k(2) for _ in range(2)), min(run_k(12) for _ in range(2))
        per.append((t12 - t2) / 10)
    per.sort()
    dt = per[len(per) // 2]
    rate = args.channels * args.frames * n / dt
    print(
        json.dumps(
            {
                "metric": "samples_per_sec",
                "quality": args.quality,
                "device": (torch.cuda.get_device_name(pipe.device)
                           if pipe.device.type == "cuda" else "cpu"),
                "value": rate,
                "per_dispatch_ms": dt * 1e3,
                "vs_reference_1msps": rate / 1e6,
            }
        )
    )
    return 0


def _load_or_synth(args, fs: float, kind: str):
    """CLI input: a capture (.npy, FileSource semantics incl. sidecar fs)
    or a synthetic demo signal matched to the command."""
    import numpy as np

    if args.input:
        from tpu_sdr_torch.runtime.source import FileSource

        src = FileSource(args.input, fs=fs)
        data = src.data[0]  # channel 0
        return np.asarray(data), src.fs
    rng = np.random.default_rng(0)
    n = np.arange(int(args.seconds * fs))
    x = 2e-4 * rng.standard_normal(n.size)
    if kind == "scan":
        # Narrowband emitters of very different strengths on the 25 kHz
        # grid — a scanner's natural prey.
        for fc, a in ((87.5e3, 0.5), (212.5e3, 0.1), (337.5e3, 0.02)):
            x = x + a * np.cos(2 * np.pi * fc * n / fs)
        msg = np.sin(2 * np.pi * 300.0 * n / fs)
        x = x + 0.05 * np.cos(
            2 * np.pi * 437.5e3 * n / fs + 2 * np.pi * 2.5e3 / fs * np.cumsum(msg))
    else:  # rx: two WBFM stations + one AM carrier
        for fc, fa in ((150e3, 440.0), (380e3, 880.0)):
            msg = np.sin(2 * np.pi * fa * n / fs)
            x = x + 0.4 * np.cos(
                2 * np.pi * fc * n / fs
                + 2 * np.pi * 75e3 / fs * np.cumsum(msg))
        am = 1.0 + 0.5 * np.sin(2 * np.pi * 600.0 * n / fs)
        x = x + 0.2 * am * np.cos(2 * np.pi * 260e3 * n / fs)
    return x.astype(np.float32), fs


def _cmd_scan(args) -> int:
    from tpu_sdr_torch.runtime.scanner import SpectrumScanner

    x, fs = _load_or_synth(args, args.fs, "scan")
    sc = SpectrumScanner(
        fs, args.start, args.stop, channel_bw=args.bw,
        threshold_db=args.threshold, device=args.device)
    import numpy as np

    res = (sc.scan_planes(np.stack([x.real, x.imag]).astype(np.float32))
           if np.iscomplexobj(x) else sc.scan(x.astype(np.float32)))
    print(f"{sc.n_channels} channels of {sc.channel_bw/1e3:g} kHz, "
          f"noise floor {res.noise_floor_db:.1f} dB")
    for h in res.hits:
        print(f"  {h['center_hz']/1e3:9.1f} kHz  {h['power_db']:7.1f} dB  "
              f"snr {h['snr_db']:5.1f} dB")
    if not res.hits:
        print("  (no channels above threshold)")
    return 0


def _cmd_rx(args) -> int:
    import numpy as np

    from tpu_sdr_torch.runtime.receiver import Receiver, write_wav

    x, fs = _load_or_synth(args, args.fs, "rx")
    rx = Receiver(fs=fs, center_hz=args.center, mode=args.mode,
                  audio_rate=args.audio_rate, squelch_db=args.squelch_db,
                  device=args.device)
    g = rx.chunk_granularity
    t = (x.shape[-1] // g) * g
    if not t:
        print(f"need at least {g} samples; got {x.shape[-1]}",
              file=sys.stderr)
        return 1
    st = rx.initial_state()
    audio = []
    iq = np.iscomplexobj(x)
    for i in range(0, t, g):
        seg = x[i : i + g]
        if iq:
            planes = np.stack([seg.real, seg.imag]).astype(np.float32)
            a, st = rx.process_planes(planes, st)
        else:
            a, st = rx.process(seg.astype(np.float32), st)
        audio.append(_host(a))
    audio = np.concatenate(audio)
    rate = float(rx.realized_audio_rate)
    path = write_wav(args.output, audio, rate)
    print(f"{args.mode} at {args.center/1e3:g} kHz -> {path} "
          f"({audio.size} samples @ {rate:.0f} Hz, "
          f"{audio.size / rate:.2f} s)")
    return 0


def _cmd_burst(args) -> int:
    import numpy as np

    from tpu_sdr_torch.kernels.digital import BurstModem, FSKModem, bit_error_rate

    fsk = args.scheme in ("2fsk", "4fsk")
    if fsk:
        modem = FSKModem(fs=args.fs, symbol_rate=args.symbol_rate,
                         deviation_hz=args.deviation,
                         levels=2 if args.scheme == "2fsk" else 4,
                         device=args.device)
    else:
        modem = BurstModem(args.scheme, sps=args.sps, device=args.device)
    n_bits = args.bits or 512 * modem.bps

    if args.input:
        from tpu_sdr_torch.runtime.source import FileSource

        src = FileSource(args.input, fs=args.fs)
        x = np.asarray(src.data[0])
        if not np.iscomplexobj(x):
            x = x.astype(np.complex128)
        if args.center:
            x = x * np.exp(-2j * np.pi * args.center / src.fs
                           * np.arange(x.size))
        out = modem.demodulate(x.real.astype(np.float32),
                               x.imag.astype(np.float32), n_bits)
        bits = _host(out["bits"]).reshape(-1)
    else:
        # loopback demo: modulate random bits, impair, demodulate
        rng = np.random.default_rng(1)
        bits_tx = rng.integers(2, size=n_bits).astype(np.uint8)
        if fsk:
            re, im = modem.modulate(bits_tx, pad_syms=2)
            z = np.concatenate(
                [np.zeros(11), re.astype(np.float64) + 1j * im])
        else:
            re, im = modem.modulate(
                bits_tx, pad_syms=modem.max_lag_syms + modem.span)
            z = re.astype(np.float64) + 1j * im
            z = np.concatenate([np.zeros(3 * modem.sps), z])
            z *= np.exp(2j * np.pi * (1e-4 / modem.sps) * np.arange(z.size)
                        + 0.8j)
        n0 = 10.0 ** (-args.snr / 10.0)
        z = z + np.sqrt(n0 / 2.0) * (rng.standard_normal(z.size)
                                     + 1j * rng.standard_normal(z.size))
        out = modem.demodulate(z.real.astype(np.float32),
                               z.imag.astype(np.float32), n_bits)
        bits = _host(out["bits"]).reshape(-1)
        print(f"loopback BER: {bit_error_rate(bits_tx, bits):.2e} "
              f"({n_bits} bits @ {args.snr:g} dB SNR)")

    if fsk:
        print(f"{args.scheme}: timing offset {int(out['offset'])} samples")
    else:
        print(f"{args.scheme}: frame lag {int(out['frame_lag'])} syms, "
              f"timing {float(out['timing']):+.3f} samples, "
              f"cfo {float(out['cfo']):+.2e} cyc/sym, "
              f"phase {float(out['phase']):+.3f} rad")
    pad = (-len(bits)) % 8
    payload = np.packbits(np.concatenate([bits, np.zeros(pad, np.uint8)]))
    print(f"bits ({len(bits)}): {payload.tobytes().hex()}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_sdr_torch",
        description="Real-time FFT spectrum analyzer (PyTorch and CUDA)",
    )
    sub = p.add_subparsers(dest="command", required=True)
    # Where a command runs: "cuda" (the default; raises without a GPU) or
    # "cpu" (the kernels' plain versions).
    on_device = argparse.ArgumentParser(add_help=False)
    on_device.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    g = sub.add_parser("gui", help="serve the live web GUI", parents=[on_device])
    g.add_argument("--port", type=int, default=5000)
    g.add_argument("--bind", default="0.0.0.0")
    g.add_argument("--iq", action="store_true", help="complex-baseband demo source")
    g.add_argument(
        "--no-pace",
        action="store_true",
        help="run the synthetic source unpaced (throughput mode)",
    )
    g.set_defaults(fn=_cmd_gui)

    d = sub.add_parser("demo", help="two-tone find/filter demo", parents=[on_device])
    d.set_defaults(fn=_cmd_demo)

    f = sub.add_parser("design", help="design an IIR filter (GUI designer math)")
    f.add_argument("kind", choices=["butterworth", "chebyshev1", "chebyshev2", "elliptic", "bessel"])
    f.add_argument("btype", choices=["lowpass", "highpass", "bandpass", "bandstop"])
    f.add_argument("order", type=int)
    f.add_argument("--fs", type=float, default=1e6)
    f.add_argument("--cutoff", type=float, required=True)
    f.add_argument("--cutoff-hi", type=float, help="upper edge for band filters")
    f.add_argument("--ripple", type=float, default=1.0)
    f.add_argument("--attenuation", type=float, default=60.0)
    f.set_defaults(fn=_cmd_design)

    s = sub.add_parser("selftest", help="end-to-end health check", parents=[on_device])
    s.set_defaults(fn=_cmd_selftest)

    sc = sub.add_parser("scan", help="band-occupancy scan (DDC bank sweep)",
                        parents=[on_device])
    sc.add_argument("--input", help=".npy capture (real or IQ); default: demo signal")
    sc.add_argument("--fs", type=float, default=1e6)
    sc.add_argument("--seconds", type=float, default=0.25,
                    help="demo-signal length when no --input")
    sc.add_argument("--start", type=float, default=0.0)
    sc.add_argument("--stop", type=float, default=500e3)
    sc.add_argument("--bw", type=float, default=25e3, help="channel bandwidth Hz")
    sc.add_argument("--threshold", type=float, default=10.0,
                    help="dB over the median noise floor")
    sc.set_defaults(fn=_cmd_scan)

    r = sub.add_parser("rx", help="demodulate a station to a WAV file", parents=[on_device])
    r.add_argument("--input", help=".npy capture (real or IQ); default: demo signal")
    r.add_argument("--fs", type=float, default=1e6)
    r.add_argument("--seconds", type=float, default=1.0,
                   help="demo-signal length when no --input")
    r.add_argument("--center", type=float, default=150e3, help="carrier Hz")
    r.add_argument("--mode", default="wbfm",
                   choices=["wbfm", "nbfm", "am", "usb", "lsb"])
    r.add_argument("--audio-rate", type=float, default=48e3)
    r.add_argument("--squelch-db", type=float, default=None,
                   help="carrier-power squelch threshold (dB, mean|z|^2)")
    r.add_argument("--output", default="rx_audio.wav")
    r.set_defaults(fn=_cmd_rx)

    bu = sub.add_parser(
        "burst", help="digital burst demodulation (PSK/QAM/FSK)", parents=[on_device])
    bu.add_argument("--input",
                    help=".npy baseband capture; default: loopback demo")
    bu.add_argument("--scheme", default="qpsk",
                    choices=["bpsk", "qpsk", "qam16", "2fsk", "4fsk"])
    bu.add_argument("--fs", type=float, default=1e6)
    bu.add_argument("--sps", type=int, default=8,
                    help="samples/symbol (linear schemes)")
    bu.add_argument("--bits", type=int, default=0,
                    help="payload bits to recover (default 512 symbols)")
    bu.add_argument("--center", type=float, default=0.0,
                    help="mix the capture down from this carrier (Hz)")
    bu.add_argument("--symbol-rate", type=float, default=125e3,
                    help="FSK symbol rate (Hz)")
    bu.add_argument("--deviation", type=float, default=250e3,
                    help="FSK deviation (Hz)")
    bu.add_argument("--snr", type=float, default=25.0,
                    help="demo-loopback SNR (dB)")
    bu.set_defaults(fn=_cmd_burst)

    t = sub.add_parser(
        "trace", help="device-trace one dispatch (op-level attribution)",
        parents=[on_device],
    )
    t.add_argument("--channels", type=int, default=8)
    t.add_argument("--frames", type=int, default=64)
    t.add_argument("--reps", type=int, default=10)
    t.add_argument("--quality", default="f32",
                   choices=["f32", "f32max", "bf16"])
    t.set_defaults(fn=_cmd_trace)

    b = sub.add_parser("bench", help="quick throughput probe (slope-timed)",
                       parents=[on_device])
    b.add_argument("--channels", type=int, default=8)
    b.add_argument("--frames", type=int, default=64)
    b.add_argument("--reps", type=int, default=3)
    b.add_argument("--quality", default="f32", choices=["f32", "f32max", "bf16"])
    b.set_defaults(fn=_cmd_bench)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
