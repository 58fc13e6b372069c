"""Real-serial edge adapter: the UART host path over an actual device file.

The reference host drives the FPGA over a literal COM port
(``fft_analyzer_gui.py:464-553``: ``QSerialPort``-style open of
``DEFAULT_UART_PORT='COM5'`` at 230,400 8N1, command bytes out, continuous
65,536-byte frames back). This module maps that path onto:

- **pyserial**, when installed (optional dependency — imported lazily, never
  required), via ``open_serial("/dev/ttyUSB0")``;
- **any file-descriptor byte stream** via ``FdSerial`` — a pty pair
  (``os.openpty``) in tests, a USB CDC-ACM device node, or a socket fd —
  with the same ``read/write/close`` surface pyserial exposes.

``SerialTransport`` composes either port object with the existing
``UartFramer``/``UartDeframer`` (stall detection, overflow trim, baud
pacing), so the in-process UART layer and the real-device path share one
framing implementation.
"""

from __future__ import annotations

import os
import select
import threading
import time
from typing import Callable

from tpu_sdr_torch.transport.framing import FRAME_SIZE_BYTES
from tpu_sdr_torch.transport.uart_stream import UartDeframer, UartFramer


class FdSerial:
    """Minimal pyserial-compatible wrapper over a raw file descriptor.

    ``read(n)`` returns up to n bytes, waiting at most ``timeout`` seconds
    for the first byte (select-based, like pyserial's timeout semantics);
    ``write`` loops until all bytes are accepted (ptys have small kernel
    buffers, so partial writes are normal at frame sizes).
    """

    def __init__(self, fd: int, timeout: float = 0.1):
        self.fd = fd
        self.timeout = timeout
        self.eof = False
        os.set_blocking(fd, False)

    def read(self, n: int = 1) -> bytes:
        if self.eof:
            return b""
        r, _, _ = select.select([self.fd], [], [], self.timeout)
        if not r:
            return b""
        try:
            data = os.read(self.fd, n)
        except BlockingIOError:
            return b""  # spurious wakeup; not EOF
        except OSError:
            # EIO on a pty whose peer closed = hangup. Mark EOF so callers
            # (read_frames) fail fast instead of busy-spinning to deadline.
            self.eof = True
            return b""
        if not data:
            self.eof = True  # select-readable + empty read = EOF
        return data

    def write(self, data: bytes) -> int:
        view = memoryview(data)
        sent = 0
        while sent < len(view):
            _, w, _ = select.select([], [self.fd], [], 1.0)
            if not w:
                continue
            try:
                sent += os.write(self.fd, view[sent:])
            except BlockingIOError:
                continue
        return sent

    def close(self):
        try:
            os.close(self.fd)
        except OSError:
            pass


def make_raw_pty() -> tuple[int, int]:
    """An ``os.openpty`` pair with raw termios (no echo/CRLF mangling) —
    the test double for a real serial device file (``/dev/pts/N``)."""
    import tty

    master, slave = os.openpty()
    for fd in (master, slave):
        try:
            tty.setraw(fd)
        except OSError:
            pass
    return master, slave


def open_serial(port: str, baud: int = 230_400, timeout: float = 0.1):
    """Open a serial device: pyserial when available, raw fd otherwise.

    With pyserial installed this honors the hardware baud rate exactly like
    the reference host (``fft_analyzer_gui.py:523-531``); the raw-fd
    fallback opens the device node directly (termios left to the caller),
    which suffices for ptys and CDC-ACM devices that ignore baud.
    """
    try:
        import serial  # type: ignore[import-not-found]

        return serial.Serial(port, baudrate=baud, timeout=timeout)
    except ImportError:
        return FdSerial(os.open(port, os.O_RDWR | os.O_NOCTTY), timeout=timeout)


class SerialTransport:
    """Full-duplex UART host edge over a serial port object.

    Host side (the reference GUI's role): ``send_command_bytes`` writes the
    command protocol (0x55/0xA5/0xF1... — ``control/commands.py``),
    ``poll()`` drains received bytes through the ``UartDeframer`` and
    returns any completed 65,536-byte frames; ``request_frame()`` performs
    the reference's 0xA5-then-read transaction (``fft_analyzer_gui.py:562``).

    Device side (an FPGA simulator / loopback peer): ``send_spectrum`` /
    ``send_frame_bytes`` stream frames through the ``UartFramer``, paced to
    ``baud`` when given (230,400 => the reference's 2.84 s/frame cadence).
    """

    def __init__(
        self,
        ser,
        baud: int | None = None,
        stall_after: float = 1.0,
        read_chunk: int = 16384,
    ):
        self.ser = ser
        self.framer = UartFramer(self._write, baud=baud)
        self.deframer = UartDeframer(stall_after=stall_after)
        self.read_chunk = read_chunk
        self.frames_stale_dropped = 0  # backlog frames trimmed by read_frames
        self._last_read_bytes = 0

    def _write(self, data: bytes):
        self.ser.write(data)

    # -- host role ----------------------------------------------------------
    def send_command_bytes(self, data: bytes):
        self.ser.write(bytes(data))

    def poll(self) -> list[bytes]:
        """One non-blocking-ish drain: read whatever is pending, return any
        frames completed by it."""
        data = self.ser.read(self.read_chunk)
        self._last_read_bytes = len(data)
        if not data:
            return []
        return self.deframer.push(data)

    def read_frames(
        self,
        n: int = 1,
        timeout: float = 10.0,
        max_stale: int | None = 4,
    ) -> list[bytes]:
        """Block until ``n`` frames arrive (or timeout, or the port hits
        EOF — a closed pty peer must fail fast, not spin to the deadline);
        returns what came.

        ``max_stale``: staleness bound for backlog bursts — when a single
        call drains MORE than ``max(n, max_stale)`` frames (a consumer
        stall left minutes of wire data in the OS buffer), only the newest
        ones are returned and the older backlog is counted in
        ``frames_stale_dropped``. This is the reference GUI's trim policy
        (``fft_analyzer_gui.py:687-689``) applied at the transport edge —
        the deframer itself never drops completed frames (so mid-stream
        bursts lose nothing), the TRANSPORT bounds replay staleness.
        ``max_stale=None`` disables the bound.
        """
        frames: list[bytes] = []
        keep = n if max_stale is None else max(n, max_stale)
        deadline = time.monotonic() + timeout
        short_cap = min(self.read_chunk, FRAME_SIZE_BYTES)
        short_frameless = 0
        while time.monotonic() < deadline:
            got = self.poll()
            frames.extend(got)
            if getattr(self.ser, "eof", False):
                break
            if len(frames) >= n and not self._last_read_bytes:
                # n satisfied AND the wire is drained (the last read
                # returned no bytes): without the drain, a backlog would
                # replay one stale frame per call and the max_stale trim
                # below could never see it
                break
            if (
                len(frames) >= n
                and not got
                and self._last_read_bytes < short_cap
            ):
                # Drain bound (review finding): against a peer that streams
                # CONTINUOUSLY the wire never reads empty, so the drain
                # condition above would spin to the full timeout. Once n is
                # satisfied, stop on TWO CONSECUTIVE polls that complete no
                # new frame AND each read less than min(read_chunk, one
                # frame) bytes (advisor r4: a single short read is not
                # evidence — port layers like pyserial commonly deliver an
                # OS-buffered backlog in sub-chunk pieces, and one such
                # piece must not be mistaken for live rate). Two short
                # frameless polls in a row mean we are at the wire's live
                # trickle: there is no backlog for the max_stale trim to
                # see, and further draining only adds latency (e.g.
                # request_frame n=1 against a live streamer must return
                # near the first frame, not after ``keep`` of them). A
                # backlog mid-drain instead completes a frame every few
                # polls, resetting the counter. Residual ambiguity (a
                # backlog arriving in alternating tiny pieces) is bounded
                # by the next call's trim: stale frames left behind are
                # still counted and dropped when that call drains them.
                short_frameless += 1
                if short_frameless >= 2:
                    break
            else:
                short_frameless = 0
        if max_stale is not None:
            if len(frames) > keep:
                self.frames_stale_dropped += len(frames) - keep
                frames = frames[-keep:]
        return frames

    def request_frame(self, timeout: float = 10.0) -> bytes | None:
        """The reference's UART transaction: send 0xA5, read one frame."""
        self.send_command_bytes(b"\xa5")
        got = self.read_frames(1, timeout)
        return got[0] if got else None

    # -- device role --------------------------------------------------------
    def send_spectrum(self, re, im, scale: float | None = None):
        self.framer.send_spectrum(re, im, scale)

    def send_frame_bytes(self, frame: bytes):
        self.framer.send_frame_bytes(frame)

    def serve_frames(
        self,
        frame_source: Callable[[], bytes],
        stop: threading.Event,
        poll_interval: float = 0.01,
    ):
        """FPGA-sim loop: answer each 0xA5 with one frame (sequ2.vhd's
        U_IDLE2 -> U_READ transition); 0xFF and friends are ignored here
        (command handling belongs to ``control.api``)."""
        while not stop.is_set():
            data = self.ser.read(64)
            if not data:
                time.sleep(poll_interval)
                continue
            for b in data:
                if b == 0xA5:
                    self.send_frame_bytes(frame_source())

    def close(self):
        self.ser.close()
