"""The port's transport (``tpu_sdr_torch.transport``) against
tpu_sdr's, on the CPU.

On the same inputs, every byte must be identical: wire frames, packets,
reassembly, CRCs, the IP stack's headers and Ethernet frames, and the UART
byte stream, through the port's native framer (``native/framer.cpp``,
built here with the host C++ compiler) and through its NumPy versions.
The UDP legs run over 127.0.0.1.
"""

import threading
import time

import numpy as np
import pytest

from tpu_sdr.transport import crc32 as jcrc32
from tpu_sdr.transport import framing as jframing
from tpu_sdr.transport import ipstack as jipstack
from tpu_sdr.transport import uart_stream as juart
from tpu_sdr_torch.transport import crc32, framing, ipstack, native, uart_stream
from tpu_sdr_torch.transport.serial_port import FdSerial, SerialTransport, make_raw_pty
from tpu_sdr_torch.transport.udp_stream import UdpSpectrumReceiver, UdpSpectrumSender


def _spectrum(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    re = (rng.standard_normal(16384) * 1000).astype(dtype)
    im = (rng.standard_normal(16384) * 1000).astype(dtype)
    return re, im


def test_native_library_builds_from_the_ports_source():
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent.name == "tpu_sdr_torch"
    assert "tpu_sdr_torch" in str(native.SOURCE) and native.SOURCE.name == "framer.cpp"


@pytest.mark.parametrize("scale", [None, 1.0, 7.5])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_frames_identical(scale, dtype):
    re, im = _spectrum(1, dtype)
    re[:4] = [1e9, -1e9, 0.5, -0.5]  # saturation and ties
    ref = jframing.spectrum_to_frame_bytes(re, im, scale)
    assert framing.spectrum_to_frame_bytes(re, im, scale) == ref
    assert native.spectrum_to_frame_bytes(re, im, scale) == ref
    for a, b in zip(framing.decode_frame(ref), jframing.decode_frame(ref)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(framing.quantize_spectrum_q15(re, im, scale),
                    jframing.quantize_spectrum_q15(re, im, scale)):
        np.testing.assert_array_equal(a, b)


def test_q15_frames_identical():
    rng = np.random.default_rng(2)
    re_q = rng.integers(-32768, 32768, 16384).astype(np.int16)
    im_q = rng.integers(-32768, 32768, 16384).astype(np.int16)
    assert framing.frame_bytes_from_q15(re_q, im_q) == jframing.frame_bytes_from_q15(re_q, im_q)
    assert framing.XFFT_WIRE_SCALE == jframing.XFFT_WIRE_SCALE


def test_packets_and_reassembly_identical():
    frame = jframing.spectrum_to_frame_bytes(*_spectrum(3))
    ref = jframing.frame_to_packets(frame)
    assert framing.frame_to_packets(frame) == ref
    assert native.frame_to_packets(frame) == ref
    assert native.frame_to_packets(frame[:32 * 512], 32, 512) == \
        [bytes([i]) + frame[i * 512 : (i + 1) * 512] for i in range(32)]
    shuffled = [ref[i] for i in np.random.default_rng(0).permutation(64)]
    assert framing.packets_to_frame(shuffled) == jframing.packets_to_frame(shuffled) == frame
    out, filled = native.assemble_payloads(shuffled)
    assert (out, filled) == (frame, 64)
    bad = [bytes([200]) + p[1:] for p in shuffled[:2]] + shuffled[2:]
    out2, filled2 = native.assemble_payloads(bad)
    holes = [p[0] for p in shuffled[:2]]
    asm = framing.MultiPacketAssembler()
    assert all(asm.add(p) is None for p in bad) and filled2 == 62
    for h in holes:
        assert out2[h * 1024 : (h + 1) * 1024] == b"\0" * 1024
    with pytest.raises(ValueError, match="frame must be"):
        native.frame_to_packets(b"\x00" * 1024)
    with pytest.raises(ValueError, match="equal-length"):
        native.spectrum_to_frame_bytes(np.zeros(16384, np.float32), np.zeros(100, np.float32))


def test_crc_identical():
    rng = np.random.default_rng(4)
    for n in (0, 1, 7, 64, 1025, 65536):
        data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        want = jcrc32.crc32_ethernet(data)
        assert crc32.crc32_ethernet(data) == native.crc32_ethernet(data) == want
        assert crc32.crc32_update_raw(data, 0x1234) == native.crc32_raw(data, 0x1234) \
            == jcrc32.crc32_update_raw(data, 0x1234)
        assert crc32.fcs_bytes(data) == jcrc32.fcs_bytes(data)
        assert crc32.check_frame(data + crc32.fcs_bytes(data))


def test_ipstack_identical():
    payload = bytes(range(256)) * 4 + b"\x07"
    for fid in (0, 1, 0xFFFF, 0x12345):
        assert ipstack.build_header(len(payload), fid) == jipstack.build_header(len(payload), fid)
        frame = ipstack.build_ethernet_frame(payload, fid)
        assert frame == jipstack.build_ethernet_frame(payload, fid)
        assert ipstack.parse_header(frame) == jipstack.parse_header(frame)
    assert ipstack.udp_checksum(payload) == jipstack.udp_checksum(payload)
    assert ipstack.ip_checksum(b"\x45\x00" * 10) == jipstack.ip_checksum(b"\x45\x00" * 10)


def test_uart_stream_identical():
    re, im = _spectrum(5)
    got, ref = [], []
    uart_stream.UartFramer(got.append).send_spectrum(re, im)
    juart.UartFramer(ref.append).send_spectrum(re, im)
    assert got == ref
    stream = b"\x13" * 100 + b"".join(ref) * 2 + b"\x00" * 10
    t = [0.0]
    ours = uart_stream.UartDeframer(clock=lambda: t[0])
    theirs = juart.UartDeframer(clock=lambda: t[0])
    for off in range(0, len(stream), 5000):
        piece = stream[off : off + 5000]
        assert ours.push(piece) == theirs.push(piece)
    assert ours.frames_received == theirs.frames_received


def test_serial_pty_frame_end_to_end():
    m, s = make_raw_pty()
    fpga = SerialTransport(FdSerial(m, timeout=0.05))
    host = SerialTransport(FdSerial(s, timeout=0.05))
    try:
        frame = jframing.spectrum_to_frame_bytes(*_spectrum(6), scale=1.0)
        tx = threading.Thread(target=fpga.send_frame_bytes, args=(frame,))
        tx.start()
        got = host.read_frames(1, timeout=10.0)
        tx.join(timeout=10.0)
        assert not tx.is_alive() and got == [frame]
    finally:
        fpga.close()
        host.close()


@pytest.mark.parametrize("ntx,nrx", [(True, True), (False, True), (True, False)])
def test_udp_loopback_both_paths(ntx, nrx):
    got = []
    rx = UdpSpectrumReceiver(port=0, bind_ip="127.0.0.1", fps_cap=1e9, use_native=nrx,
                             on_frame=lambda re, im, mag: got.append((re.copy(), im.copy())))
    assert (rx._nsock is not None) == nrx
    rx.start()
    tx = UdpSpectrumSender("127.0.0.1", rx.port, use_native=ntx)
    assert (tx._native is not None) == ntx
    re, im = _spectrum(8)
    try:
        for _ in range(3):
            tx.send_spectrum(re, im, scale=1.0)
        deadline = time.time() + 5.0
        while len(got) < 3 and time.time() < deadline:
            time.sleep(0.02)
    finally:
        rx.stop()
        tx.close()
    assert len(got) == 3 and rx.frames_received == 3
    np.testing.assert_array_equal(got[0][0], np.rint(re))
    np.testing.assert_array_equal(got[0][1], np.rint(im))


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No NumPy fallback: a source that does not compile raises."""
    bad = tmp_path / "framer.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="build failed"):
        native.build(force=True)
