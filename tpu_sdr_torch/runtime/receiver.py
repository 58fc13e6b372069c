"""Receiver: the full tune-to-audio chain (DDC -> demod -> AGC -> resample).

The counterpart of ``tpu_sdr.runtime.receiver``:

    x @ fs ──DDC(center, R)──> baseband @ fs/R
           ──{FM | AM | SSB} demod──> audio @ fs/R
           ──AGC (AM/SSB)──> leveled audio
           ──Resampler(L/M)──> audio @ ~audio_rate

Every stage streams with carried state, so the whole receiver is chunked ==
one-shot BITWISE and checkpointable as one dict. The audio resampler ratio
is the rational approximation of ``audio_rate / (fs/R)``
(``realized_audio_rate``).

Mode presets (channel bandwidth -> decimation, deviation, de-emphasis):

- ``wbfm``: broadcast FM, 200 kHz channel, 75 kHz deviation, 75 us tau.
- ``nbfm``: narrowband FM, 12.5 kHz channel, 2.5 kHz deviation.
- ``am``:   envelope + DC block + AGC, 10 kHz channel.
- ``usb``/``lsb``: filter-method SSB, 3 kHz audio slice; the DDC center is
  offset +/- bw/2 so the wanted sideband sits in the FIR passband, and the
  BFO shifts it back to baseband pitch.

Like the reference, the FM modes run ``FMDemodulator``'s default path, not
the fused kernel (``use_pallas`` stays False). ``device`` None means CUDA:
construction raises without a GPU unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math
import wave
from fractions import Fraction

import numpy as np
import torch

from tpu_sdr_torch.kernels.ddc import DDC, DDCBank, DDCState, resolve_device
from tpu_sdr_torch.kernels.demod import (
    AGC,
    AGCState,
    AMDemodulator,
    DemodState,
    FMDemodulator,
    SSBDemodulator,
    Squelch,
    SquelchState,
)
from tpu_sdr_torch.kernels.resample import Resampler, ResamplerState
from tpu_sdr_torch.kernels.stereo import StereoDecoder, StereoDecoderState

MODES = ("wbfm", "nbfm", "am", "usb", "lsb")

_PRESETS = {
    # mode: (channel bandwidth Hz, fm deviation Hz or None, deemph tau)
    "wbfm": (200e3, 75e3, 75e-6),
    "nbfm": (12.5e3, 2.5e3, 75e-6),
    "am": (10e3, None, None),
    "usb": (6e3, None, None),
    "lsb": (6e3, None, None),
}


class ReceiverState:
    """Aggregate carried state of the receiver chain."""

    def __init__(self, ddc: DDCState, demod: DemodState,
                 agc: AGCState | None, resamp: ResamplerState,
                 squelch: SquelchState | None = None,
                 stereo: StereoDecoderState | None = None):
        self.ddc = ddc
        self.demod = demod
        self.agc = agc
        self.resamp = resamp
        self.squelch = squelch
        self.stereo = stereo

    def to_numpy(self) -> dict:
        d = {"ddc": self.ddc.to_numpy(), "demod": self.demod.to_numpy(),
             "resamp": self.resamp.to_numpy()}
        if self.agc is not None:
            d["agc"] = self.agc.to_numpy()
        if self.squelch is not None:
            d["squelch"] = self.squelch.to_numpy()
        if self.stereo is not None:
            d["stereo"] = self.stereo.to_numpy()
        return d

    @classmethod
    def from_numpy(cls, d: dict, *, device="cuda") -> "ReceiverState":
        kw = dict(device=device)
        return cls(
            DDCState.from_numpy(d["ddc"], **kw),
            DemodState.from_numpy(d["demod"], **kw),
            AGCState.from_numpy(d["agc"], **kw) if "agc" in d else None,
            ResamplerState.from_numpy(d["resamp"], **kw),
            SquelchState.from_numpy(d["squelch"], **kw) if "squelch" in d else None,
            StereoDecoderState.from_numpy(d["stereo"], **kw) if "stereo" in d else None,
        )


class Receiver:
    """Streaming single-channel receiver on a wideband stream at ``fs``.

    ``center_hz`` is the RF (input-spectrum) carrier; ``mode`` one of
    ``wbfm | nbfm | am | usb | lsb``. Input chunks must be multiples of
    ``chunk_granularity`` samples at fs. Real input via ``process``, IQ
    planes via ``process_planes``."""

    def __init__(self, fs: float = 1_000_000.0, center_hz: float = 100_000.0,
                 mode: str = "wbfm", audio_rate: float = 48_000.0,
                 agc_mu: float = 2e-3, taps_per_phase: int = 12,
                 max_resample_den: int = 512,
                 squelch_db: float | None = None,
                 stereo: bool = False, device=None):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}; got {mode!r}")
        if stereo and mode != "wbfm":
            raise ValueError(f"stereo decoding is a wbfm feature; got {mode!r}")
        self.device = dev = resolve_device(device, "Receiver")
        self.fs = float(fs)
        self.mode = mode
        bw, fm_dev, tau = _PRESETS[mode]
        # Decimation: largest R with fs/R still covering the channel.
        r = max(1, int(self.fs // bw))
        self.decimation = r
        self.baseband_rate = self.fs / r
        self._bfo = 0.0
        if mode in ("usb", "lsb"):
            # Filter method: park the DDC half a bandwidth into the wanted
            # sideband; the BFO undoes the shift at audio.
            sign = 1.0 if mode == "usb" else -1.0
            self._sideband_shift = sign * bw / 2.0
            self._bfo = -sign * bw / 2.0
        else:
            self._sideband_shift = 0.0
        self.ddc = DDC(fs=self.fs, center_hz=center_hz + self._sideband_shift,
                       decimation=r, taps_per_phase=taps_per_phase, device=dev)
        self.stereo_enabled = bool(stereo)
        self.stereo_dec = None
        if mode in ("wbfm", "nbfm"):
            # Stereo: the demodulator emits the RAW multiplex; the decoder
            # applies per-channel de-emphasis after the L/R matrix, and
            # compensates the one-lag discriminator's sinc droop at 38 kHz.
            self.demod = FMDemodulator(
                self.baseband_rate, deviation_hz=fm_dev,
                deemphasis_tau=None if self.stereo_enabled else tau, device=dev)
            self.agc = None
            if self.stereo_enabled:
                xsub = np.pi * 2.0 * 19_000.0 / self.baseband_rate
                self.stereo_dec = StereoDecoder(
                    self.baseband_rate, deemphasis_tau=tau,
                    subcarrier_gain=float(xsub / np.sin(xsub)), device=dev)
        elif mode == "am":
            self.demod = AMDemodulator(self.baseband_rate, device=dev)
            self.agc = AGC(mu=agc_mu, ref=0.5, device=dev)
        else:
            self.demod = SSBDemodulator(self.baseband_rate, bfo_hz=self._bfo, device=dev)
            self.agc = AGC(mu=agc_mu, ref=0.5, device=dev)
        frac = Fraction(audio_rate / self.baseband_rate).limit_denominator(
            max_resample_den)
        if frac <= 0:
            raise ValueError(
                f"audio_rate {audio_rate} not reachable from {self.baseband_rate}")
        self.resampler = Resampler(up=frac.numerator, down=frac.denominator, device=dev)
        self.realized_audio_rate = self.baseband_rate * frac
        # Carrier-power squelch on the baseband (mean|z|^2 in dB), gated
        # AFTER the AGC so a closed gate cannot wind the gain loop up.
        self.squelch = (None if squelch_db is None
                        else Squelch(10.0 ** (squelch_db / 10.0), device=dev))
        block = getattr(self.demod, "block", 1)
        if self.agc is not None:
            block = math.lcm(block, self.agc.block)
        if self.squelch is not None:
            block = math.lcm(block, self.squelch.block)
        if self.stereo_dec is not None:
            block = math.lcm(block, self.stereo_dec.block)
        self.chunk_granularity = self.decimation * math.lcm(block, self.resampler.down)

    def retune(self, center_hz: float):
        """Move the receiver to a new carrier (next chunk)."""
        self.ddc.retune(center_hz + self._sideband_shift)

    @property
    def center_hz(self) -> float:
        return self.ddc.center_hz - self._sideband_shift

    def initial_state(self, batch_shape: tuple = ()) -> ReceiverState:
        b = tuple(batch_shape)
        return ReceiverState(
            self.ddc.initial_state(b),
            self.demod.initial_state(b),
            None if self.agc is None else self.agc.initial_state(b),
            self.resampler.initial_state(b + (2,) if self.stereo_dec is not None else b),
            None if self.squelch is None else self.squelch.initial_state(b),
            None if self.stereo_dec is None else self.stereo_dec.initial_state(b),
        )

    def _run(self, bb, state: ReceiverState, ddc_state: DDCState):
        audio, dm = self.demod.process(bb["re"], bb["im"], state.demod)
        st_state = state.stereo
        if self.stereo_dec is not None:
            audio, st_state = self.stereo_dec.process(audio, state.stereo)
        agc_state = state.agc
        if self.agc is not None:
            audio, agc_state = self.agc.process_real(audio, state.agc)
        sq_state = state.squelch
        if self.squelch is not None:
            gate, sq_state = self.squelch.gates(bb["re"], bb["im"], state.squelch)
            if self.stereo_dec is not None:
                gate = gate[..., None, :]  # broadcast over the (L, R) axis
            audio = audio * gate
        audio, rs = self.resampler.process(audio, state.resamp)
        return audio, ReceiverState(ddc_state, dm, agc_state, rs, sq_state, st_state)

    def _check(self, t: int):
        if t % self.chunk_granularity:
            raise ValueError(
                f"chunk length {t} not a multiple of "
                f"chunk_granularity={self.chunk_granularity}")

    def process(self, x, state: ReceiverState):
        """Real wideband input (..., T) -> (audio (..., T'), state)."""
        if x.is_complex() if torch.is_tensor(x) else np.iscomplexobj(x):
            # a silent complex->float cast would demodulate the real plane
            # alone: no image rejection, wrong audio
            raise ValueError("complex (IQ) input: split re/im and use process_planes")
        self._check(x.shape[-1])
        bb, ds = self.ddc.process(x, state.ddc)
        return self._run(bb, state, ds)

    def process_planes(self, xs, state: ReceiverState):
        """IQ wideband planes (2, ..., T) -> (audio (..., T'), state)."""
        self._check(xs.shape[-1])
        bb, ds = self.ddc.process_planes(xs, state.ddc)
        return self._run(bb, state, ds)


class ReceiverBank:
    """K simultaneous receivers on ONE shared wideband stream.

    All stations share the mode/audio-rate presets; each has its own
    carrier. The mix rides a single ``DDCBank`` (the input is read once),
    and every later stage is batched over the leading station axis: output
    audio is ``(K, ..., T')``. Bitwise-identical to K independent
    ``Receiver`` instances."""

    def __init__(self, fs: float = 1_000_000.0,
                 centers_hz=(100_000.0,), mode: str = "wbfm",
                 audio_rate: float = 48_000.0, agc_mu: float = 2e-3,
                 taps_per_phase: int = 12, max_resample_den: int = 512,
                 stereo: bool = False, device=None):
        if len(centers_hz) < 1:
            raise ValueError("need at least one station")
        # A template Receiver supplies every preset + the shared stages.
        self._rx = Receiver(fs=fs, center_hz=float(centers_hz[0]), mode=mode,
                            audio_rate=audio_rate, agc_mu=agc_mu,
                            taps_per_phase=taps_per_phase,
                            max_resample_den=max_resample_den, stereo=stereo,
                            device=device)
        shift = self._rx._sideband_shift
        self.bank = DDCBank(
            fs=fs, centers_hz=[float(c) + shift for c in centers_hz],
            decimation=self._rx.decimation, fir=self._rx.ddc.fir,
            device=self._rx.device)
        self.centers_hz = [float(c) for c in centers_hz]

    @property
    def k(self) -> int:
        return len(self.centers_hz)

    @property
    def fs(self) -> float:
        return self._rx.fs

    @property
    def mode(self) -> str:
        return self._rx.mode

    @property
    def device(self) -> torch.device:
        return self._rx.device

    @property
    def realized_audio_rate(self) -> float:
        return self._rx.realized_audio_rate

    @property
    def chunk_granularity(self) -> int:
        return self._rx.chunk_granularity

    def retune(self, centers_hz):
        shift = self._rx._sideband_shift
        self.centers_hz = [float(c) for c in centers_hz]
        self.bank.retune([c + shift for c in self.centers_hz])

    def initial_state(self, batch_shape: tuple = ()) -> ReceiverState:
        b = (self.k,) + tuple(batch_shape)
        rx = self._rx
        return ReceiverState(
            self.bank.initial_state(tuple(batch_shape)),
            rx.demod.initial_state(b),
            None if rx.agc is None else rx.agc.initial_state(b),
            rx.resampler.initial_state(b + (2,) if rx.stereo_dec is not None else b),
            None if rx.squelch is None else rx.squelch.initial_state(b),
            None if rx.stereo_dec is None else rx.stereo_dec.initial_state(b),
        )

    def process(self, x, state: ReceiverState):
        """Real wideband (..., T) -> audio (K, ..., T')."""
        self._rx._check(x.shape[-1])
        bb, ds = self.bank.process(x, state.ddc)
        return self._rx._run(bb, state, ds)

    def process_planes(self, xs, state: ReceiverState):
        """IQ wideband planes (2, ..., T) -> audio (K, ..., T')."""
        self._rx._check(xs.shape[-1])
        bb, ds = self.bank.process_planes(xs, state.ddc)
        return self._rx._run(bb, state, ds)


def write_wav(path, audio, rate: float, peak: float = 0.9):
    """Write int16 WAV (stdlib ``wave``). Audio is normalized so its max
    |sample| maps to ``peak`` full scale. Shape (T,) writes mono; (C, T)
    with C in {1, 2} writes C channels (a stereo ``Receiver``'s (2, T')
    output interleaves as L/R)."""
    if torch.is_tensor(audio):
        audio = audio.detach().cpu().numpy()
    a = np.asarray(audio, np.float64)
    if a.ndim == 1:
        a = a[None, :]
    if a.ndim != 2 or a.shape[0] not in (1, 2):
        raise ValueError(f"audio must be (T,) or (C<=2, T); got {a.shape}")
    scale = peak / max(np.max(np.abs(a)), 1e-12)
    pcm = np.clip(a * scale * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(a.shape[0])
        w.setsampwidth(2)
        w.setframerate(int(round(rate)))
        w.writeframes(pcm.T.reshape(-1).tobytes())
    return path
