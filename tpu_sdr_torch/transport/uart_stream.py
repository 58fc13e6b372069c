"""UART-mode transport: continuous byte-stream spectra + command channel.

The reference's UART path (``imp/uart_tx.vhd`` + ``imp/sequ2.vhd`` UART FSM +
GUI ``UartReceiver``, SURVEY.md §3.4): after 0x55/0xA5, the FPGA streams
65,536-byte frames back-to-back at 230,400 baud (~2.84 s/frame, 0.3 FPS);
the host accumulates bytes, detects stalls (1 s of silence -> buffer reset,
``fft_analyzer_gui.py:639-644``) and trims overflow.

Here the "wire" is any byte stream (socket pair, pty, file, or a real serial
port via a file descriptor): ``UartFramer`` turns spectra into the byte
stream with optional pacing to a baud rate; ``UartDeframer`` reassembles
frames with the reference's stall/overflow recovery semantics. Command bytes
flow the other way unchanged (``tpu_sdr_torch.control.commands``).
"""

from __future__ import annotations

import time
from typing import Callable

from tpu_sdr_torch.transport import native
from tpu_sdr_torch.transport.framing import FRAME_SIZE_BYTES, decode_frame


class UartFramer:
    """Spectrum frames -> continuous byte stream (optionally baud-paced).

    ``write``: callable consuming bytes (socket.send, os.write wrapper, ...).
    ``baud``: when set, throttles to baud/10 bytes/s (8N1 framing overhead,
    the reference's 230400 -> 23040 B/s => 2.84 s per frame).
    """

    def __init__(
        self,
        write: Callable[[bytes], None],
        baud: int | None = None,
        chunk: int = 4096,
    ):
        self.write = write
        self.baud = baud
        self.chunk = chunk
        self.frames_sent = 0

    def send_spectrum(self, re, im, scale: float | None = None):
        self.send_frame_bytes(native.spectrum_to_frame_bytes(re, im, scale))

    def send_frame_bytes(self, frame: bytes):
        if len(frame) != FRAME_SIZE_BYTES:
            raise ValueError(f"frame must be {FRAME_SIZE_BYTES} bytes")
        if self.baud is None:
            self.write(frame)
        else:
            bps = self.baud / 10.0  # 8N1: 10 wire bits per byte
            for off in range(0, len(frame), self.chunk):
                piece = frame[off : off + self.chunk]
                self.write(piece)
                time.sleep(len(piece) / bps)
        self.frames_sent += 1


class UartDeframer:
    """Byte stream -> frames, with the reference's recovery semantics.

    - stall detection: > ``stall_after`` seconds without bytes while a
      partial frame is buffered -> buffer reset (frame abandoned);
    - every COMPLETE frame is delivered — extraction runs before any
      trimming, so a push that completes frames never deletes them (the
      round-2 trim-first bug silently dropped valid spectra on burst
      reads). Consequence: the buffered remainder is always a sub-frame,
      so ``max_buffer`` (>= one frame, validated) can never be exceeded
      and the defensive trim below is unreachable. STALENESS of a large
      delivered backlog is the transport's policy, not the deframer's —
      ``SerialTransport.read_frames(max_stale=...)`` applies the
      reference GUI's newest-frames trim (:687-689) at that edge.

    Feed with ``push(data)``; complete frames come back as a list.
    """

    def __init__(
        self,
        stall_after: float = 1.0,
        max_buffer: int = 4 * FRAME_SIZE_BYTES,
        clock=time.monotonic,
    ):
        if max_buffer < FRAME_SIZE_BYTES:
            raise ValueError(
                f"max_buffer must hold at least one {FRAME_SIZE_BYTES}-byte "
                f"frame; got {max_buffer}"
            )
        self.stall_after = stall_after
        self.max_buffer = max_buffer
        self.clock = clock
        self._buf = bytearray()
        self._last_rx: float | None = None
        self.frames_received = 0
        self.stalls_detected = 0
        self.bytes_dropped = 0

    def push(self, data: bytes) -> list[bytes]:
        now = self.clock()
        if (
            self._buf
            and self._last_rx is not None
            and now - self._last_rx > self.stall_after
            and len(self._buf) % FRAME_SIZE_BYTES != 0
        ):
            # stale partial frame: resynchronize (the GUI's stall reset)
            dropped = len(self._buf)
            self._buf.clear()
            self.stalls_detected += 1
            self.bytes_dropped += dropped
        self._last_rx = now
        self._buf.extend(data)
        # Extract every complete frame BEFORE the overflow trim: a push that
        # completes frame A and appends frame B must deliver A, not delete it
        # (trim-first silently dropped valid spectra on burst reads after a
        # stall — the round-2 red test). After extraction the remainder is a
        # sub-frame, necessarily <= max_buffer (>= one frame by contract), so
        # delivered data can never be trimmed.
        frames = []
        while len(self._buf) >= FRAME_SIZE_BYTES:
            frames.append(bytes(self._buf[:FRAME_SIZE_BYTES]))
            del self._buf[:FRAME_SIZE_BYTES]
            self.frames_received += 1
        if len(self._buf) > self.max_buffer:  # pragma: no cover — unreachable
            # defensive only: whole-frame-aligned trim of a genuinely-excess
            # remainder, kept in case the invariant above is ever weakened
            excess = len(self._buf) - self.max_buffer
            excess = -(-excess // FRAME_SIZE_BYTES) * FRAME_SIZE_BYTES
            excess = min(
                excess, (len(self._buf) // FRAME_SIZE_BYTES) * FRAME_SIZE_BYTES
            )
            del self._buf[:excess]
            self.bytes_dropped += excess
        return frames

    def decode(self, frame: bytes):
        return decode_frame(frame)
