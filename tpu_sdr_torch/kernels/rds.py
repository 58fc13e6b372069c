"""RDS (Radio Data System) on the FM multiplex: encoder and decoder (the
counterpart of ``tpu_sdr.kernels.rds``).

The 57 kHz subcarrier (3x the 19 kHz pilot) carries 1187.5 bit/s
differentially-encoded biphase BPSK in 26-bit blocks (16 info + 10 check
bits + offset words), 104-bit groups (IEC 62106). Decoded: PI, PTY, TP,
the program service name (0A/0B) and RadioText (2A/2B).

The decoder's device steps: the port's ``DDC`` to ~20 kHz complex
baseband, its ``Resampler`` to exactly 19 kHz (16 samples a bit), the
coarse doubled-CFO estimate and per-190-sample block means of the
derotated z^2 (``_rds_carrier_recover``), then the derotation, the
root-raised-cosine matched filter (``jnp.convolve(mode="same")``'s
centring: a full convolution cut at (L-1)//2) and the 16 bit-phase
hypotheses (``_rds_apply_phase``). Its sums are fixed-order
(``ddc.fixed_sum``), its atan2 ``demod.atan2_ieee``, and its matched filter
a sum of shifted multiply-adds (no cuDNN). The phase unwrap, the block
sync by syndromes and the parse are host NumPy, as in the reference, and
so is the encoder.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from tpu_sdr_torch.kernels.ddc import DDC, fixed_sum, resolve_device
from tpu_sdr_torch.kernels.demod import atan2_ieee
from tpu_sdr_torch.kernels.digital import _fir_full, rrc_taps
from tpu_sdr_torch.kernels.resample import Resampler
from tpu_sdr_torch.kernels.stereo import PILOT_HZ, make_mpx

BIT_RATE = 1187.5           # = 57000 / 48
ELEMENT_RATE = 2 * BIT_RATE  # biphase half-elements
SYMBOL_FS = 19_000.0        # decode rate: exactly 16 samples/bit
G_POLY = 0x5B9              # x^10+x^8+x^7+x^5+x^4+x^3+1
OFFSET_WORDS = {"A": 0x0FC, "B": 0x198, "C": 0x168, "Cp": 0x350, "D": 0x1B4}


# ------------------------------------------------------------- block codec


def _crc10(info: int) -> int:
    """10 check bits of a 16-bit info word: (info * x^10) mod g(x)."""
    r = info << 10
    for i in range(25, 9, -1):
        if r >> i & 1:
            r ^= G_POLY << (i - 10)
    return r & 0x3FF


def encode_block(info: int, offset: str) -> np.ndarray:
    """16-bit info -> 26 wire bits (MSB first) with the offset word."""
    word = (info << 10) | (_crc10(info) ^ OFFSET_WORDS[offset])
    return np.array([(word >> (25 - i)) & 1 for i in range(26)], np.uint8)


def _syndromes(bits: np.ndarray) -> np.ndarray:
    """Syndrome (value mod g) of every sliding 26-bit window: (n-25,)
    uint16. For a valid block the syndrome equals its offset word."""
    n = len(bits) - 25
    # precompute x^k mod g for k = 0..25 (bit k from the LEFT is x^(25-k))
    pows = np.empty(26, np.uint16)
    for k in range(26):
        r = 1 << k
        for i in range(25, 9, -1):
            if r >> i & 1:
                r ^= G_POLY << (i - 10)
        pows[25 - k] = r
    win = np.lib.stride_tricks.sliding_window_view(bits, 26)[:n]
    # GF(2) dot product: XOR-accumulate selected power residues
    s = np.zeros(n, np.uint16)
    for k in range(26):
        s ^= np.where(win[:, k] == 1, pows[k], 0).astype(np.uint16)
    return s


# ----------------------------------------------------------------- encoder


class RDSEncoder:
    """Builds spec-framed RDS group streams and modulated waveforms.

    ``pi``: 16-bit program identification. ``ps``: program service name
    (8 chars). ``radiotext``: optional 2A RadioText (<= 64 chars).
    """

    def __init__(self, pi: int = 0x1234, pty: int = 0, tp: bool = False,
                 ps: str = "TPU SDR ", radiotext: str | None = None):
        self.pi = int(pi) & 0xFFFF
        self.pty = int(pty) & 0x1F
        self.tp = bool(tp)
        self.ps = f"{ps:<8.8}"
        self.radiotext = None
        if radiotext is not None:
            rt = radiotext[:63] + "\r" if len(radiotext) < 64 else radiotext[:64]
            self.radiotext = f"{rt:<64.64}"

    def _block2(self, gtype: int, version: int, low5: int) -> int:
        return ((gtype & 0xF) << 12 | (version & 1) << 11 | int(self.tp) << 10
                | self.pty << 5 | (low5 & 0x1F))

    def groups(self) -> list[list[tuple[int, str]]]:
        """One full PS + RadioText cycle as (info, offset) block lists."""
        out = []
        for addr in range(4):
            chars = self.ps[2 * addr: 2 * addr + 2].encode("latin-1")
            out.append([
                (self.pi, "A"),
                (self._block2(0, 0, addr), "B"),
                (0xE0E0, "C"),  # AF: two "no AF" codes
                (chars[0] << 8 | chars[1], "D"),
            ])
        if self.radiotext is not None:
            for addr in range(16):
                seg = self.radiotext[4 * addr: 4 * addr + 4].encode("latin-1")
                out.append([
                    (self.pi, "A"),
                    (self._block2(2, 0, addr), "B"),
                    (seg[0] << 8 | seg[1], "C"),
                    (seg[2] << 8 | seg[3], "D"),
                ])
        return out

    def bit_stream(self, n_groups: int) -> np.ndarray:
        """``n_groups`` wire groups (cycling PS/RT), differential-encoded
        26*4 bits each."""
        cycle = self.groups()
        bits = []
        for g in range(int(n_groups)):
            for info, off in cycle[g % len(cycle)]:
                bits.append(encode_block(info, off))
        raw = np.concatenate(bits)
        diff = np.zeros_like(raw)
        prev = 0
        for i, b in enumerate(raw):  # d[k] = b[k] xor d[k-1]
            prev = int(b) ^ prev
            diff[i] = prev
        return diff

    def waveform(self, n_groups: int, span: int = 6) -> np.ndarray:
        """Shaped biphase baseband at SYMBOL_FS (float64, ~unit peak)."""
        diff = self.bit_stream(n_groups)
        sym = np.zeros(2 * len(diff))
        sym[0::2] = 2.0 * diff - 1.0
        sym[1::2] = -(2.0 * diff - 1.0)
        sps = int(round(SYMBOL_FS / ELEMENT_RATE))  # 8
        up = np.zeros(len(sym) * sps)
        up[::sps] = sym
        h = rrc_taps(sps, span=span, beta=1.0)
        return np.convolve(up, h)


def make_mpx_rds(left, right, fs: float, encoder: RDSEncoder,
                 n_groups: int = 16, rds_level: float = 0.06,
                 pilot_amp: float = 0.09, pilot_hz: float = PILOT_HZ,
                 pilot_phase: float = 0.0, audio_gain: float = 0.9):
    """Stereo multiplex with a pilot-locked RDS subcarrier at 3x the
    pilot (host float64). The RDS waveform is rate-matched from
    SYMBOL_FS to ``fs`` with scipy's polyphase resampler."""
    import scipy.signal as sps

    m = make_mpx(left, right, fs, pilot_amp=pilot_amp, pilot_hz=pilot_hz,
                 pilot_phase=pilot_phase, audio_gain=audio_gain)
    n = m.shape[-1]
    wave = encoder.waveform(n_groups)
    frac = Fraction(fs / SYMBOL_FS).limit_denominator(4096)
    wave = sps.resample_poly(wave, frac.numerator, frac.denominator)
    if len(wave) < n:
        reps = int(np.ceil(n / len(wave)))
        wave = np.tile(wave, reps)
    theta = 2.0 * np.pi * pilot_hz * np.arange(n) / fs + pilot_phase
    return m + rds_level * wave[:n] * np.cos(3.0 * theta)


# ----------------------------------------------------------------- decoder


def _rds_carrier_recover(zre, zim):
    """z -> (cfo2 rad/sample (0-d), br (G,), bi (G,)): the coarse doubled-CFO
    estimate (the mean single-lag phase increment of z^2) and per-190-sample
    block sums of z^2 derotated by that ramp, for the host's unwrap."""
    w2re = zre * zre - zim * zim
    w2im = 2.0 * zre * zim
    dre = w2re[1:] * w2re[:-1] + w2im[1:] * w2im[:-1]
    dim = w2im[1:] * w2re[:-1] - w2re[1:] * w2im[:-1]
    cfo2 = atan2_ieee(fixed_sum(dim), fixed_sum(dre))  # rad/sample of z^2
    t = zre.shape[-1]
    ang = cfo2 * torch.arange(t, dtype=torch.float32, device=zre.device)
    c, s = torch.cos(ang), torch.sin(ang)
    rre = w2re * c + w2im * s
    rim = w2im * c - w2re * s
    g = t // 190
    br = fixed_sum(rre[: g * 190].reshape(g, 190))
    bi = fixed_sum(rim[: g * 190].reshape(g, 190))
    return cfo2, br, bi


def _rds_apply_phase(zre, zim, phases, h: np.ndarray):
    """Derotate z by the per-sample carrier phase, take the real part,
    matched-filter ('same'), and lay out all 16 timing hypotheses: returns
    soft (N16, 16), soft[k, psi] = y[16k+psi] - y[16k+8+psi], and the
    per-hypothesis energy (16,)."""
    t = zre.shape[-1]
    c, s = torch.cos(phases), torch.sin(phases)
    x = zre * c + zim * s  # Re{z * e^{-j phase}}
    lo = (h.shape[0] - 1) // 2
    x = _fir_full(x[None], h)[0, lo : lo + t]
    n16 = (t - 8) // 16
    a = x[: n16 * 16].reshape(n16, 16)
    b = x[8 : 8 + n16 * 16].reshape(n16, 16)
    soft = a - b
    metric = fixed_sum((soft * soft).T)
    return soft, metric


class RDSResult:
    """Decoded RDS state: ``pi``/``pty``/``tp`` (ints or None), ``ps``
    (8-char str), ``radiotext``, ``groups`` (count by type string),
    ``n_blocks`` validated, ``block_error_rate`` over the sync span."""

    def __init__(self):
        self.pi = None
        self.pty = None
        self.tp = None
        self.ps = [None] * 8
        self.rt = [None] * 64
        self.groups: dict[str, int] = {}
        self.n_blocks = 0
        self.block_error_rate = 1.0

    @property
    def ps_name(self) -> str:
        return "".join(c if c is not None else "_" for c in self.ps)

    @property
    def radiotext(self) -> str:
        txt = "".join(c if c is not None else "_" for c in self.rt)
        return txt.split("\r")[0].rstrip("_ ") if "\r" in txt else txt.rstrip("_ ")


class RDSDecoder:
    """One-shot RDS decoder on a captured FM multiplex at ``fs``.

    ``fs`` must reach the 19 kHz bit grid through an integer decimation
    and a small rational resample (200 kHz, the wbfm receiver's baseband
    rate, gives /10 then 19/20). ``decode(mpx)`` returns an `RDSResult`;
    ~0.5 s of capture carries one full PS cycle. ``device`` None means
    CUDA."""

    def __init__(self, fs: float, taps_per_phase: int = 12, device=None):
        self.device = resolve_device(device, "RDSDecoder")
        self.fs = float(fs)
        r = max(1, int(round(self.fs / 20_000.0)))
        fs_d = self.fs / r
        frac = Fraction(SYMBOL_FS / fs_d).limit_denominator(128)
        if not math.isclose(float(frac), SYMBOL_FS / fs_d, rel_tol=0, abs_tol=1e-12):
            raise ValueError(
                f"fs={fs} cannot reach the {SYMBOL_FS:.0f} Hz bit grid "
                f"with a small rational resample (decimated rate {fs_d})")
        self.ddc = DDC(self.fs, center_hz=3.0 * PILOT_HZ, decimation=r,
                       taps_per_phase=taps_per_phase, device=self.device)
        self.resamp = (None if frac == 1 else
                       Resampler(frac.numerator, frac.denominator,
                                 taps_per_phase=16, device=self.device))
        self._h = np.float32(rrc_taps(8, span=6, beta=1.0))

    def min_samples(self, n_groups: int = 12) -> int:
        """Capture length at fs for ~n_groups groups (+sync margin)."""
        secs = (n_groups + 2) * 104 / BIT_RATE
        g = self.ddc.r * (1 if self.resamp is None else self.resamp.down)
        return int(np.ceil(secs * self.fs / g)) * g

    def decode(self, mpx) -> RDSResult:
        """mpx (T,) at ``fs`` (NumPy or a tensor) -> `RDSResult`."""
        mpx = torch.as_tensor(mpx, dtype=torch.float32, device=self.device)
        g = self.ddc.r * (1 if self.resamp is None else self.resamp.down)
        t = (mpx.shape[-1] // g) * g
        bb, _ = self.ddc.process(mpx[..., :t], self.ddc.initial_state())
        z = torch.stack([bb["re"], bb["im"]])
        if self.resamp is not None:
            z, _ = self.resamp.process(z, self.resamp.initial_state((2,)))
        cfo2, br, bi = _rds_carrier_recover(z[0], z[1])
        # host: unwrap the per-block z^2 phases (tiny array), halve, add
        # the coarse ramp back, interpolate to per-sample carrier phase
        ph2 = np.unwrap(np.arctan2(bi.cpu().numpy(), br.cpu().numpy()))
        n = z.shape[-1]
        cfo2 = float(cfo2)
        centers = 190.0 * (np.arange(len(ph2)) + 0.5)
        ph = 0.5 * (np.interp(np.arange(n), centers, ph2) + cfo2 * np.arange(n))
        soft, metric = _rds_apply_phase(
            z[0], z[1], torch.as_tensor(np.float32(ph), device=self.device), self._h)
        psi = int(torch.argmax(metric))
        hard = (soft[:, psi] > 0).to(torch.uint8).cpu().numpy()
        bits = hard[1:] ^ hard[:-1]  # differential decode
        return _parse_bits(bits)


def _parse_bits(bits: np.ndarray) -> RDSResult:
    """Group sync + semantic parse of a differential-decoded bit stream."""
    res = RDSResult()
    if len(bits) < 104 + 26:
        return res
    syn = _syndromes(bits)
    offs = OFFSET_WORDS
    n = len(syn)
    # score the 104 group alignments by syndrome pattern matches
    best, best_score = 0, -1
    for p in range(104):
        idx = np.arange(p, n - 78, 104)
        if len(idx) == 0:
            continue
        score = int(np.sum(
            (syn[idx] == offs["A"]) & (syn[idx + 26] == offs["B"])
            & ((syn[idx + 52] == offs["C"]) | (syn[idx + 52] == offs["Cp"]))
            & (syn[idx + 78] == offs["D"])))
        if score > best_score:
            best, best_score = p, score
    total = 0
    good = 0
    for start in range(best, n - 78, 104):
        blocks = []
        ok = True
        for j, want in enumerate(("A", "B", "CCp", "D")):
            s = int(syn[start + 26 * j])
            if want == "CCp":
                if s == offs["C"]:
                    kind = "C"
                elif s == offs["Cp"]:
                    kind = "Cp"
                else:
                    ok = False
                    break
            elif s == offs[want]:
                kind = want
            else:
                ok = False
                break
            w = bits[start + 26 * j: start + 26 * j + 16]
            blocks.append((kind, int(w.dot(1 << np.arange(15, -1, -1)))))
        total += 4
        if not ok:
            continue
        good += 4
        _apply_group(res, blocks)
    res.n_blocks = good
    res.block_error_rate = 1.0 - good / total if total else 1.0
    return res


def _apply_group(res: RDSResult, blocks):
    pi = blocks[0][1]
    res.pi = pi
    b2 = blocks[1][1]
    gtype, version = b2 >> 12, (b2 >> 11) & 1
    res.tp = (b2 >> 10) & 1
    res.pty = (b2 >> 5) & 0x1F
    name = f"{gtype}{'B' if version else 'A'}"
    res.groups[name] = res.groups.get(name, 0) + 1
    if gtype == 0:
        addr = b2 & 3
        chars = blocks[3][1]
        res.ps[2 * addr] = chr(chars >> 8)
        res.ps[2 * addr + 1] = chr(chars & 0xFF)
    elif gtype == 2:
        addr = b2 & 0xF
        if version == 0:
            seg = (blocks[2][1] << 16) | blocks[3][1]
            for i in range(4):
                res.rt[4 * addr + i] = chr((seg >> (8 * (3 - i))) & 0xFF)
        else:
            seg = blocks[3][1]
            for i in range(2):
                res.rt[2 * addr + i] = chr((seg >> (8 * (1 - i))) & 0xFF)
