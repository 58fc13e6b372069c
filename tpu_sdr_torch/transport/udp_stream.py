"""UDP spectrum streaming — the live host-edge transport.

Sender: emits each spectrum frame as 64 x 1025-byte datagrams (count byte +
1024 data), exactly the FPGA's wire behavior minus the raw-Ethernet
encapsulation (the OS provides IP/UDP; ``tpu_sdr_torch.transport.ipstack`` can
produce the byte-identical raw frames where a raw socket is available).
Receiver: binds the GUI's port, filters by expected source, reassembles with
stale-slot eviction and a display-rate limiter — the contract of
``fft_analyzer_gui.py:281-292,308-460``.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Callable

from tpu_sdr_torch.transport import native
from tpu_sdr_torch.transport.framing import (
    ETHERNET_PAYLOAD_SIZE,
    PACKET_DATA_SIZE,
    PACKETS_PER_FRAME,
    MultiPacketAssembler,
    decode_frame,
)


class UdpSpectrumSender:
    """Fire-and-forget spectrum transmitter (no retransmit, like the FPGA).

    Fast path: the C++ ``udp_send_frame`` ships a whole 64-packet frame with
    one ``sendmmsg`` syscall and zero-copy iovecs (the host-edge analog of
    ``imp/sequ2.vhd``'s back-to-back frame drain). ``use_native=False``
    sends per packet with ``sendto``: byte-identical wire output either way.
    The native library is built on first use; a failed build raises."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6006,
                 use_native: bool = True):
        self.addr = (host, port)
        self._native = None
        self.sock = None
        if use_native and native.udp_available():
            try:
                self._native = native.NativeUdpSender(host, port)
            except OSError:
                self._native = None
        if self._native is None:
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 20)
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
        self.frames_sent = 0

    def send_spectrum(self, re, im, scale: float | None = None):
        frame = native.spectrum_to_frame_bytes(re, im, scale)
        self.send_frame_bytes(frame)

    def send_frame_bytes(self, frame: bytes):
        if self._native is not None:
            self._native.send_frame(frame, PACKETS_PER_FRAME, PACKET_DATA_SIZE)
        else:
            for pkt in native.frame_to_packets(frame):
                self.sock.sendto(pkt, self.addr)
        self.frames_sent += 1

    def close(self):
        if self._native is not None:
            self._native.close()
        if self.sock is not None:
            self.sock.close()


class UdpSpectrumReceiver:
    """Threaded receiver: socket -> assembler -> rate-limited callback.

    ``on_frame(re, im, magnitude)`` fires at most ``fps_cap`` times/second
    with decoded float spectra; every assembled frame still counts in stats
    (``frames_received`` vs ``frames_displayed`` — the GUI's distinction).
    """

    def __init__(
        self,
        port: int = 6006,
        bind_ip: str = "0.0.0.0",
        expected_src: tuple[str, int] | None = None,
        fps_cap: float = 30.0,
        on_frame: Callable | None = None,
        use_native: bool = True,
    ):
        self._nsock = None
        self.sock = None
        if use_native and native.udp_available():
            try:
                self._nsock = native.NativeUdpSocket(port=port, bind_ip=bind_ip)
            except OSError:
                self._nsock = None
        if self._nsock is None:
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
            self.sock.bind((bind_ip, port))
            self.sock.settimeout(0.25)
        self.expected_src = expected_src
        self.fps_cap = fps_cap
        self.on_frame = on_frame
        self.assembler = MultiPacketAssembler()
        self.frames_received = 0
        self.frames_displayed = 0
        self.packets_filtered = 0
        self._last_emit = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # set when the worker dies on an unexpected socket error, so the
        # owner can see WHY frames_received stopped advancing instead of a
        # silently frozen receiver
        self.error: str | None = None

    @property
    def port(self) -> int:
        if self._nsock is not None:
            return self._nsock.port
        return self.sock.getsockname()[1]

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _survives(self, e: OSError) -> bool:
        """True if the worker should keep receiving after this error.
        Transient queue/buffer pressure is retried; a real socket failure
        records ``self.error`` and stops the worker VISIBLY (a silent
        `break` left the receiver looking alive with frames_received
        frozen forever)."""
        import errno

        if self._stop.is_set():
            return False  # stop() closed the socket under us: clean exit
        if e.errno in (errno.EINTR, errno.EAGAIN, errno.ENOBUFS, errno.ENOMEM):
            return True
        self.error = f"receiver socket error: {e}"
        self._stop.set()
        return False

    def _run(self):
        while not self._stop.is_set():
            if self._nsock is not None:
                # native path: drain the queue in one recvmmsg syscall
                try:
                    batch = self._nsock.recv_burst(timeout=0.25)
                except OSError as e:
                    if self._survives(e):
                        continue
                    break
            else:
                try:
                    batch = [self.sock.recvfrom(2048)]
                except socket.timeout:
                    continue
                except OSError as e:
                    if self._survives(e):
                        continue
                    break
            for data, src in batch:
                self._handle_packet(data, src)

    def _handle_packet(self, data: bytes, src: tuple[str, int]):
        if self.expected_src is not None and src != self.expected_src:
            self.packets_filtered += 1
            return
        # no size pre-check here: the assembler rejects wrong-size
        # datagrams itself AND counts them in packets_dropped — an early
        # return froze every stat at zero for a mis-sized sender (review
        # finding)
        frame = self.assembler.add(data)
        if frame is None:
            return
        self.frames_received += 1
        now = time.monotonic()
        if self.fps_cap > 0 and now - self._last_emit < 1.0 / self.fps_cap:
            return  # rate limit: frame counted, not displayed
        self._last_emit = now
        self.frames_displayed += 1
        if self.on_frame is not None:
            self.on_frame(*decode_frame(frame))

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self._nsock is not None:
            self._nsock.close()
        if self.sock is not None:
            self.sock.close()
