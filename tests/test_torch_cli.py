"""``python -m tpu_sdr_torch`` (``tpu_sdr_torch/__main__.py``) with
``--device cpu``: the ten CLI tests of ``tests/test_aux.py`` (``TestCli``),
and the commands whose output is deterministic held to the JAX CLI's:
``design`` byte for byte, ``scan``'s hits and ``burst``'s bits."""

import json
import re
import wave

import numpy as np
import pytest

from tpu_sdr.__main__ import main as jax_main
from tpu_sdr_torch.__main__ import main

CPU = ["--device", "cpu"]


def _run(capsys, fn, argv):
    rc = fn(argv)
    return rc, capsys.readouterr().out


def test_design_prints_wire_bytes(capsys):
    rc, out = _run(capsys, main, ["design", "butterworth", "lowpass", "4", "--cutoff", "100e3"])
    assert rc == 0
    assert "wire bytes" in out and "SOS (2 sections)" in out
    wire = [line for line in out.splitlines() if line.startswith("wire bytes")][0]
    assert len(wire.split(":")[1].split()) == 12


@pytest.mark.parametrize("argv", [
    ["design", "butterworth", "lowpass", "4", "--cutoff", "100e3"],
    ["design", "elliptic", "bandstop", "2", "--cutoff", "200e3", "--cutoff-hi", "260e3"],
    ["design", "chebyshev1", "highpass", "3", "--cutoff", "50e3", "--ripple", "0.5"],
])
def test_design_output_equals_the_jax_cli(capsys, argv):
    assert _run(capsys, main, argv) == _run(capsys, jax_main, argv)


def test_design_band_requires_hi_edge(capsys):
    rc = main(["design", "butterworth", "bandpass", "4", "--cutoff", "100e3"])
    assert rc == 2
    assert "--cutoff-hi" in capsys.readouterr().err


def test_selftest_passes(capsys):
    rc, out = _run(capsys, main, ["selftest", *CPU])
    assert rc == 0 and "selftest: PASS" in out
    assert out.count("[PASS]") == 6


def _hits(out: str) -> list:
    return [(float(c), float(p)) for c, p in re.findall(r"^\s+([\d.]+) kHz\s+(-?[\d.]+) dB", out, re.M)]


def test_scan_demo_finds_emitters_as_the_jax_cli(capsys):
    argv = ["scan", "--seconds", "0.13"]
    rc, out = _run(capsys, main, [*argv, *CPU])
    assert rc == 0
    assert "87.5 kHz" in out and "212.5 kHz" in out
    rc_j, out_j = _run(capsys, jax_main, argv)
    got, want = _hits(out), _hits(out_j)
    assert rc_j == 0 and len(got) == len(want) == 4
    # the same channels, strongest first; levels within 0.1 dB (printed to 0.1)
    assert [c for c, _ in got] == [c for c, _ in want]
    assert all(abs(p - q) <= 0.1 + 1e-9 for (_, p), (_, q) in zip(got, want))


def test_rx_demo_writes_wav(tmp_path, capsys):
    out = str(tmp_path / "a.wav")
    assert main(["rx", "--center", "150e3", "--seconds", "0.3", "--audio-rate", "16e3",
                 "--output", out, *CPU]) == 0
    with wave.open(out) as w:
        assert w.getframerate() == 16000
        assert w.getnframes() > 1000


def test_rx_from_capture_roundtrip(tmp_path, capsys):
    """SampleRecorder capture -> ``rx --input`` -> WAV."""
    from tpu_sdr_torch.runtime.recorder import SampleRecorder

    fs = 1_000_000.0
    n = np.arange(96_000)
    msg = np.sin(2 * np.pi * 700.0 * n / fs)
    ph = 2 * np.pi * 150e3 * n / fs + 2 * np.pi * 75e3 / fs * np.cumsum(msg)
    x = (0.5 * np.cos(ph)).astype(np.float32)
    cap = str(tmp_path / "cap.npy")
    rec = SampleRecorder(cap, fs=fs)
    rec.append(x[None, :])
    rec.close()
    out = str(tmp_path / "b.wav")
    assert main(["rx", "--input", cap, "--center", "150e3", "--audio-rate", "16e3",
                 "--output", out, *CPU]) == 0
    with wave.open(out) as w:
        rate = w.getframerate()
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    a = pcm.astype(np.float64)[rate // 100:]
    spec = np.abs(np.fft.rfft(a * np.hanning(a.size)))
    f_peak = np.argmax(spec) * rate / a.size
    assert f_peak == pytest.approx(700.0, abs=3 * rate / a.size)


def _bits_line(out: str) -> str:
    return [line for line in out.splitlines() if line.startswith("bits (")][0]


def test_burst_demo_loopback_as_the_jax_cli(capsys):
    argv = ["burst", "--scheme", "qpsk", "--bits", "256"]
    rc, out = _run(capsys, main, [*argv, *CPU])
    assert rc == 0
    assert "loopback BER: 0.00e+00" in out
    assert "frame lag 3 syms" in out
    assert "bits (256):" in out
    rc_j, out_j = _run(capsys, jax_main, argv)
    assert rc_j == 0 and _bits_line(out) == _bits_line(out_j)


def test_burst_fsk_demo_as_the_jax_cli(capsys):
    argv = ["burst", "--scheme", "4fsk", "--bits", "128", "--snr", "30"]
    rc, out = _run(capsys, main, [*argv, *CPU])
    assert rc == 0
    assert "loopback BER: 0.00e+00" in out
    assert "timing offset 11 samples" in out  # onset + sub-symbol
    rc_j, out_j = _run(capsys, jax_main, argv)
    assert rc_j == 0 and _bits_line(out) == _bits_line(out_j)


def test_burst_from_capture(tmp_path, capsys):
    """BurstModem TX -> SampleRecorder IQ capture -> ``burst --input`` with a
    carrier mix-down recovers the exact bits."""
    from tpu_sdr_torch.kernels.digital import BurstModem
    from tpu_sdr_torch.runtime.recorder import SampleRecorder

    rng = np.random.default_rng(3)
    mod = BurstModem("qam16", sps=8, device="cpu")
    bits = rng.integers(2, size=512).astype(np.uint8)
    re, im = mod.modulate(bits, pad_syms=mod.max_lag_syms + mod.span)
    fs = 1e6
    z = (re + 1j * im) * np.exp(2j * np.pi * 200e3 / fs * np.arange(re.size))
    cap = str(tmp_path / "burst.npy")
    rec = SampleRecorder(cap, fs=fs)
    rec.append(z.astype(np.complex64)[None, :])
    rec.close()
    assert main(["burst", "--input", cap, "--scheme", "qam16", "--bits", "512",
                 "--center", "200e3", *CPU]) == 0
    out = capsys.readouterr().out
    want = np.packbits(bits).tobytes().hex()
    assert want in out


def test_bench_small(capsys):
    assert main(["bench", "--channels", "1", "--frames", "2", "--reps", "1", *CPU]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["value"] > 0 and rec["quality"] == "f32" and rec["device"] == "cpu"


def test_trace_on_the_cpu_reports_no_device_trace(capsys):
    assert main(["trace", "--channels", "1", "--frames", "2", "--reps", "2", *CPU]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec == {"device_trace": False, "reason": "no CUDA kernel, memcpy or memset events"}


@pytest.mark.parametrize("command", ["gui", "selftest", "demo", "scan", "rx", "burst", "trace", "bench"])
def test_commands_run_on_cuda_by_default(command, monkeypatch):
    """Without --device a command runs on CUDA, and without a GPU it raises
    (there is none here)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([command])
