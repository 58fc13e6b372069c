"""Single-byte command protocol — typed control API with wire compatibility.

A copy of ``tpu_sdr.control.commands`` (standard library only).

The reference is controlled entirely by single UART bytes decoded in hardware
(``src/command_control.vhd:46-74``, ``imp/sequ2.vhd:82-96,214-218``, coefficient
path ``src/rx_filter_coeff.vhd:40-66``):

  0x55 START        begin acquisition (and arm the drain FSM)
  0xFF RESET        global reset (level; GUI enforces a 2 s cooldown)
  0xF1 COEFF_HDR    next 12 bytes are filter coefficients
  0x00 MODE_FIXED   route the fixed IIR12 bank to the FFT
  0xA1 MODE_CUSTOM  route the runtime-coefficient IIR12 bank
  0xB1 MODE_BYPASS  route the windowed signal directly (reset default)
  0xEF COMM_ETH     drain spectra over Ethernet/UDP (default)
  0xFE COMM_UART    drain spectra over the UART-style byte stream
  0xA5 DATA_REQ     UART mode: request continuous frame streaming

``CommandDecoder`` reproduces the hardware semantics exactly — including the
"busy" shield during coefficient acquisition (command decoding is suppressed
for the 12 bytes after 0xF1, ``dsp_system_top.vhd:644``) — so a host written
against the FPGA can drive this framework unchanged.
"""

from __future__ import annotations

import dataclasses
import enum


class Command(enum.IntEnum):
    START = 0x55
    RESET = 0xFF
    COEFF_HDR = 0xF1
    MODE_FIXED = 0x00
    MODE_CUSTOM = 0xA1
    MODE_BYPASS = 0xB1
    COMM_ETH = 0xEF
    COMM_UART = 0xFE
    DATA_REQ = 0xA5


N_COEFF_BYTES = 12  # 2 sections x 6 int8 (fft_analyzer_gui.py:591-613)


@dataclasses.dataclass
class DecodedEvent:
    """One protocol event produced by the decoder."""

    kind: str  # 'command' | 'coefficients' | 'ignored'
    command: Command | None = None
    coefficients: bytes | None = None
    raw: int | None = None


class CommandDecoder:
    """Byte-stream state machine mirroring the RTL decode.

    States: IDLE (decode commands) / ACQUIRE (collect 12 coefficient bytes,
    commands suppressed — the ``busy`` shield of ``rx_filter_coeff.vhd:40-66``).
    Unknown bytes in IDLE are ignored, as in the RTL (no default arm).
    """

    def __init__(self):
        self._acquiring = False
        self._buf = bytearray()

    @property
    def busy(self) -> bool:
        return self._acquiring

    def feed_byte(self, b: int) -> DecodedEvent | None:
        b &= 0xFF
        if self._acquiring:
            self._buf.append(b)
            if len(self._buf) == N_COEFF_BYTES:
                coeffs = bytes(self._buf)
                self._buf.clear()
                self._acquiring = False
                return DecodedEvent(kind="coefficients", coefficients=coeffs)
            return None
        if b == Command.COEFF_HDR:
            self._acquiring = True
            self._buf.clear()
            return None
        try:
            return DecodedEvent(kind="command", command=Command(b), raw=b)
        except ValueError:
            return DecodedEvent(kind="ignored", raw=b)

    def feed(self, data: bytes) -> list[DecodedEvent]:
        events = []
        for b in data:
            ev = self.feed_byte(b)
            if ev is not None:
                events.append(ev)
        return events

    def reset(self):
        self._acquiring = False
        self._buf.clear()


def encode_coefficient_upload(coeff_bytes: bytes) -> bytes:
    """Host-side encoding of a coefficient upload: 0xF1 + 12 bytes.

    Mirrors ``fft_analyzer_gui.py:591-613``.
    """
    if len(coeff_bytes) != N_COEFF_BYTES:
        raise ValueError(f"need exactly {N_COEFF_BYTES} coefficient bytes")
    return bytes([Command.COEFF_HDR]) + coeff_bytes


def encode_start_sequence() -> bytes:
    """START then DATA_REQ — the GUI's UART start handshake
    (``fft_analyzer_gui.py:529-553``; it waits 100 ms between them)."""
    return bytes([Command.START, Command.DATA_REQ])
