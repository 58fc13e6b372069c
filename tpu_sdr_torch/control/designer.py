"""Filter designer — the SciPy design + quantize + wire-format layer.

A copy of ``tpu_sdr.control.designer`` (NumPy and SciPy, with the port's
``core.qformat``).

Functionally equivalent to the reference GUI's designer
(``fft_analyzer_gui.py:108-230,1167-1199``): SciPy IIR design to SOS,
x64 int8 quantization, and the exact 12-byte wire format
([B0,B1,B2,A0,A1,A2] x 2 sections) consumed by the 0xF1 upload path.

The engine applies /64 (the designer's intended scale), so the realized
response equals the previewed response — unlike the RTL, which divides by
128 (quirks register item (d), SURVEY.md §2.6).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.signal as sps

from tpu_sdr_torch.core import qformat as qf

DESIGN_FUNCS = {
    "butterworth": lambda order, Wn, btype, rp, rs: sps.butter(
        order, Wn, btype=btype, output="sos"
    ),
    "chebyshev1": lambda order, Wn, btype, rp, rs: sps.cheby1(
        order, rp, Wn, btype=btype, output="sos"
    ),
    "chebyshev2": lambda order, Wn, btype, rp, rs: sps.cheby2(
        order, rs, Wn, btype=btype, output="sos"
    ),
    "elliptic": lambda order, Wn, btype, rp, rs: sps.ellip(
        order, rp, rs, Wn, btype=btype, output="sos"
    ),
    "bessel": lambda order, Wn, btype, rp, rs: sps.bessel(
        order, Wn, btype=btype, output="sos", norm="phase"
    ),
}

BTYPES = ("lowpass", "highpass", "bandpass", "bandstop")

WIRE_SECTIONS = 2  # the reference wire format carries exactly 2 sections
IDENTITY_WIRE_SECTION = np.array([64, 0, 0, 64, 0, 0], dtype=np.int8)


@dataclasses.dataclass
class FilterDesign:
    """A designed filter: float SOS + its quantized wire form."""

    sos: np.ndarray  # (S, 6) float64
    kind: str
    btype: str
    order: int
    fs: float
    cutoffs: tuple

    @property
    def sos_q(self) -> np.ndarray:
        return qf.quantize_coeff_x64(self.sos)

    def to_wire_bytes(self) -> bytes:
        return sos_to_wire_bytes(self.sos)

    def frequency_response(self, n_points: int = 512):
        """(freqs_hz, magnitude_db) of the float design — the preview math
        (``fft_analyzer_gui.py:190-230`` uses sosfreqz the same way)."""
        w, h = sps.sosfreqz(self.sos, worN=n_points, fs=self.fs)
        mag_db = 20.0 * np.log10(np.maximum(np.abs(h), 1e-12))
        return w, mag_db

    def quantized_response(self, n_points: int = 512):
        """Response of the x64-quantized coefficients actually shipped."""
        sos_deq = qf.dequantize_coeff_x64(self.sos_q)
        # guard a0 = 0 after quantization (degenerate design)
        sos_deq[:, 3] = np.where(sos_deq[:, 3] == 0, 1.0, sos_deq[:, 3])
        w, h = sps.sosfreqz(sos_deq, worN=n_points, fs=self.fs)
        return w, 20.0 * np.log10(np.maximum(np.abs(h), 1e-12))


def design_iir_filter(
    kind: str = "butterworth",
    btype: str = "lowpass",
    order: int = 4,
    fs: float = 1_000_000.0,
    cutoff_hz: float | tuple[float, float] = 100_000.0,
    ripple_db: float = 1.0,
    attenuation_db: float = 60.0,
) -> FilterDesign:
    """Design an IIR filter exactly as the GUI does
    (``fft_analyzer_gui.py:108-157``): normalized Wn = f / (fs/2), SOS output.
    """
    if kind not in DESIGN_FUNCS:
        raise ValueError(f"unknown filter kind {kind!r}; one of {list(DESIGN_FUNCS)}")
    if btype not in BTYPES:
        raise ValueError(f"unknown btype {btype!r}; one of {BTYPES}")
    nyq = fs / 2.0
    edges = np.atleast_1d(np.asarray(cutoff_hz, np.float64))
    if btype in ("bandpass", "bandstop"):
        if edges.size != 2:
            # validation-style error, not a raw unpack TypeError (review
            # finding: a scalar cutoff is the common GUI mistake here)
            raise ValueError(
                f"{btype} needs two cutoff frequencies (lo_hz, hi_hz); "
                f"got {cutoff_hz!r}"
            )
        lo, hi = float(edges[0]), float(edges[1])
        if not (0 < lo < hi < nyq):
            raise ValueError(f"band edges must satisfy 0 < {lo} < {hi} < {nyq}")
        Wn = (lo / nyq, hi / nyq)
    else:
        if edges.size != 1:
            raise ValueError(
                f"{btype} takes a single cutoff frequency; got {cutoff_hz!r}"
            )
        c = float(edges[0])
        if not (0 < c < nyq):
            raise ValueError(f"cutoff must be in (0, {nyq}) Hz")
        Wn = c / nyq
    sos = DESIGN_FUNCS[kind](order, Wn, btype, ripple_db, attenuation_db)
    return FilterDesign(
        sos=np.asarray(sos, np.float64),
        kind=kind,
        btype=btype,
        order=order,
        fs=fs,
        cutoffs=tuple(np.atleast_1d(cutoff_hz).tolist()),
    )


def sos_to_wire_bytes(sos: np.ndarray) -> bytes:
    """Quantize and pack an SOS cascade into the 12-byte wire format.

    Exactly 2 sections, each [B0,B1,B2,A0,A1,A2] int8 x64; shorter designs
    are padded with the identity section, longer ones are rejected (the GUI
    silently truncates, ``fft_analyzer_gui.py:1185-1192`` — we refuse instead,
    because truncation silently changes the response).
    """
    sos = np.atleast_2d(np.asarray(sos, np.float64))
    if sos.shape[0] > WIRE_SECTIONS:
        raise ValueError(
            f"wire format carries {WIRE_SECTIONS} sections (order "
            f"{2 * WIRE_SECTIONS}); got {sos.shape[0]} sections. Upload "
            f"higher-order designs via the array API (upload_sos)."
        )
    q = qf.quantize_coeff_x64(sos)
    rows = [q[i] for i in range(q.shape[0])]
    while len(rows) < WIRE_SECTIONS:
        rows.append(IDENTITY_WIRE_SECTION)
    return b"".join(bytes(r.astype(np.uint8).tobytes()) for r in rows)


def wire_bytes_to_sos(data: bytes) -> np.ndarray:
    """Decode 12 coefficient bytes into a float SOS cascade (engine scale /64).

    a0 quantized to 0 (a degenerate upload) is treated as 1 to avoid a
    divide-by-zero — the RTL has no such guard; it would simply misbehave.
    """
    if len(data) != 6 * WIRE_SECTIONS:
        raise ValueError(f"need {6 * WIRE_SECTIONS} bytes, got {len(data)}")
    q = np.frombuffer(data, dtype=np.int8).reshape(WIRE_SECTIONS, 6)
    sos = qf.dequantize_coeff_x64(q)
    sos[:, 3] = np.where(sos[:, 3] == 0, 1.0, sos[:, 3])
    return sos
