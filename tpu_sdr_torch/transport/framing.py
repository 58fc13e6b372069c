"""Spectrum frame wire format + packetization — the host-edge contract.

Wire format (SURVEY.md §2.6, BASELINE.md):

- one spectrum frame = 65,536 bytes = 16,384 bins x 32-bit words
  {im[31:16], re[15:0]}, serialized little-endian byte 0..3
  (``imp/sequ2.vhd:153,:234``; GUI decode ``fft_analyzer_gui.py:256-258``);
- Ethernet mode: 64 UDP packets x 1025 bytes = 1 count byte (packet index
  mod 64, ``imp/phy_rmii_if.vhd:322``) + 1024 data bytes;
- reassembly: 64 slots keyed by the count byte, stale-slot eviction after
  3-4 s (``fft_analyzer_gui.py:308-352``), no retransmit (fire-and-forget).

NOTE — default scale change (round 2): ``quantize_spectrum_q15``,
``spectrum_to_frame_bytes`` and every ``send_spectrum`` now default to
``scale=XFFT_WIRE_SCALE`` (2.0 at N=16K) instead of 1.0, so wire int16
amplitudes match an FPGA-calibrated GUI (VERDICT r1 item 1). Callers that
relied on raw pass-through quantization must pass ``scale=1.0`` explicitly;
float values above 2^15/scale now saturate where they previously fit.

A GUI written against the FPGA reassembles our frames unchanged. The
performance-critical inner loops (quantize+interleave, CRC) have a C++
implementation in ``tpu_sdr_torch.transport.native``; these NumPy versions
are its oracle. (The port's copy of ``tpu_sdr.transport.framing``.)
"""

from __future__ import annotations

import time

import numpy as np

FRAME_SIZE_BYTES = 65536
PACKETS_PER_FRAME = 64
PACKET_DATA_SIZE = 1024
ETHERNET_PAYLOAD_SIZE = 1025
N_BINS = 16384

# Hardware-faithful float->wire scale. The reference FFT core runs the xfft
# default scaling schedule (the RTL never writes s_axis_config,
# ``imports/new/dsp_system_top.vhd:534-536``; ``ip/xfft_0/xfft_0.xci``
# scaling_options=scaled, rounding_modes=truncation), an overall 1/N shift —
# so the int16 words on the wire are (1/N)*FFT(x_int16) = (2^15/N)*FFT(x_float)
# for Q15-normalized float samples. 2.0 at N = 16384. Single source of truth
# (jax-free): core/qformat.xfft_wire_scale; per-stage integer model:
# kernels/fft_q15.py.
from tpu_sdr_torch.core.qformat import xfft_wire_scale

XFFT_WIRE_SCALE = xfft_wire_scale(N_BINS)


def quantize_spectrum_q15(
    re: np.ndarray, im: np.ndarray, scale: float | None = None
):
    """Float spectra -> int16 re/im with saturation.

    The reference FFT IP emits scaled 16-bit fixed point directly; our engine
    computes float32, so the wire layer applies an explicit scale then
    saturates — keeping the GUI contract (int16 LE) while the in-framework
    consumer can always ask for float. The default scale is
    ``XFFT_WIRE_SCALE``, the level implied by the reference core's scaling
    schedule, so wire amplitudes match a GUI calibrated against the FPGA;
    pass ``scale=1.0`` for raw pass-through quantization.
    """
    if scale is None:
        scale = XFFT_WIRE_SCALE
    r = np.clip(np.rint(np.asarray(re) * scale), -32768, 32767).astype("<i2")
    i = np.clip(np.rint(np.asarray(im) * scale), -32768, 32767).astype("<i2")
    return r, i


def frame_bytes_from_q15(re_q: np.ndarray, im_q: np.ndarray) -> bytes:
    """Already-quantized int16 spectra (e.g. the Q15 pipeline's wire ints,
    ``runtime/q15.py``) -> the 65,536-byte wire frame, no rescaling."""
    re_q = np.asarray(re_q).astype("<i2")
    im_q = np.asarray(im_q).astype("<i2")
    if re_q.shape[-1] != N_BINS:
        raise ValueError(f"expected {N_BINS} bins, got {re_q.shape[-1]}")
    inter = np.empty(2 * N_BINS, dtype="<i2")
    inter[0::2] = re_q
    inter[1::2] = im_q
    return inter.tobytes()


def spectrum_to_frame_bytes(
    re: np.ndarray, im: np.ndarray, scale: float | None = None
) -> bytes:
    """One complex spectrum (N bins) -> the 65,536-byte wire frame.

    Composes the two primitives so the wire interleave (the byte-
    compatibility invariant) lives in exactly one place (review finding)."""
    return frame_bytes_from_q15(*quantize_spectrum_q15(re, im, scale))


def decode_frame(frame: bytes):
    """The GUI decode math (``fft_analyzer_gui.py:250-270``): interleaved LE
    int16 re/im -> (re, im, magnitude float32)."""
    if len(frame) != FRAME_SIZE_BYTES:
        raise ValueError(f"expected {FRAME_SIZE_BYTES} bytes, got {len(frame)}")
    inter = np.frombuffer(frame, dtype="<i2")
    re = inter[0::2].astype(np.float32)
    im = inter[1::2].astype(np.float32)
    return re, im, np.sqrt(re * re + im * im)


def frame_to_packets(frame: bytes, frame_index: int = 0) -> list[bytes]:
    """Split a wire frame into 64 x (1 count byte + 1024 data) UDP payloads.

    The count byte is the packet's index within the frame, mod 64 — exactly
    the ``mark_cnt`` byte of ``imp/phy_rmii_if.vhd:322,:435``. ``frame_index``
    is accepted for API symmetry (the RTL's IP-ID carries it; UDP payload
    does not).
    """
    if len(frame) != FRAME_SIZE_BYTES:
        raise ValueError(f"expected {FRAME_SIZE_BYTES} bytes, got {len(frame)}")
    return [
        bytes([k % PACKETS_PER_FRAME])
        + frame[k * PACKET_DATA_SIZE : (k + 1) * PACKET_DATA_SIZE]
        for k in range(PACKETS_PER_FRAME)
    ]


def packets_to_frame(packets: list[bytes]) -> bytes:
    """Reassemble 64 payloads (any order) into a frame; raises on gaps."""
    slots: list[bytes | None] = [None] * PACKETS_PER_FRAME
    for p in packets:
        if len(p) != ETHERNET_PAYLOAD_SIZE:
            raise ValueError(f"payload must be {ETHERNET_PAYLOAD_SIZE} bytes")
        if p[0] >= PACKETS_PER_FRAME:
            raise ValueError(f"invalid count byte {p[0]}")
        slots[p[0]] = p[1:]
    missing = [k for k, s in enumerate(slots) if s is None]
    if missing:
        raise ValueError(f"missing packets: {missing}")
    return b"".join(slots)  # type: ignore[arg-type]


class MultiPacketAssembler:
    """Streaming reassembler with stale-slot eviction.

    Mirrors the GUI's ``MultiPacketAssembler`` (``fft_analyzer_gui.py:308-352``):
    packets keyed by count byte; when all 64 slots fill, a frame is emitted;
    stale slots are evicted (loss recovery — there is no retransmit in this
    protocol).

    Two eviction policies (host-layer quirks register, PARITY.md):

    - default (``per_slot_eviction=False``): when the OLDEST buffered packet
      exceeds ``stale_after``, the whole partial frame is dropped — every
      emitted frame is then guaranteed single-generation (all 64 packets
      within one ``stale_after`` window);
    - reference-faithful (``per_slot_eviction=True``): each slot is evicted
      independently ``stale_after`` after ITS arrival, checked after every
      add (``fft_analyzer_gui.py:341-347``) — under sustained loss the
      reference can complete a frame from packets of different generations
      (mixed-generation frame), which this mode reproduces.
    """

    def __init__(
        self,
        stale_after: float = 3.5,
        clock=time.monotonic,
        per_slot_eviction: bool = False,
    ):
        self.stale_after = stale_after
        self.clock = clock
        self.per_slot_eviction = per_slot_eviction
        self._slots: dict[int, bytes] = {}
        self._stamps: dict[int, float] = {}
        self._first_at: float | None = None
        self.frames_assembled = 0
        self.packets_dropped = 0

    def add(self, payload: bytes) -> bytes | None:
        """Feed one UDP payload; returns a complete frame when ready."""
        if len(payload) != ETHERNET_PAYLOAD_SIZE:
            self.packets_dropped += 1
            return None
        now = self.clock()
        if self.per_slot_eviction:
            return self._add_per_slot(payload, now)
        if self._first_at is not None and now - self._first_at > self.stale_after:
            self.packets_dropped += len(self._slots)
            self._slots.clear()
            self._first_at = None
        idx = payload[0]
        if idx >= PACKETS_PER_FRAME:
            # Drop invalid count bytes like the reference: the UDP checksum
            # is 0 on this wire (PARITY quirk 7), so a corrupted count byte
            # arrives undetected — aliasing it into a valid slot (mod 64)
            # would silently overwrite a genuine packet's payload.
            self.packets_dropped += 1
            return None
        if not self._slots:
            self._first_at = now
        self._slots[idx] = payload[1:]
        if len(self._slots) == PACKETS_PER_FRAME:
            frame = b"".join(self._slots[k] for k in range(PACKETS_PER_FRAME))
            self._slots.clear()
            self._first_at = None
            self.frames_assembled += 1
            return frame
        return None

    def _add_per_slot(self, payload: bytes, now: float) -> bytes | None:
        """Reference eviction order (``fft_analyzer_gui.py:320-352``): store,
        check completion, THEN evict per-slot — so the completing packet is
        never evicted, and old slots may ride into the emitted frame."""
        idx = payload[0]
        if idx >= PACKETS_PER_FRAME:  # reference drops invalid indices
            self.packets_dropped += 1
            return None
        self._slots[idx] = payload[1:]
        self._stamps[idx] = now
        if len(self._slots) == PACKETS_PER_FRAME:
            frame = b"".join(self._slots[k] for k in range(PACKETS_PER_FRAME))
            self._slots.clear()
            self._stamps.clear()
            self.frames_assembled += 1
            return frame
        for k in [k for k, t in self._stamps.items() if now - t > self.stale_after]:
            del self._slots[k], self._stamps[k]
            self.packets_dropped += 1
        return None
