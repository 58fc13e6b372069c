"""Digital down-converter (DDC): NCO mixer + polyphase decimating FIR.

The counterpart of ``tpu_sdr.kernels.ddc``. The DDC translates a center
frequency to baseband and decimates by R:

    y[n]   = x[n] * exp(-2j*pi*fc/fs * n)          (mix)
    out[m] = (h (*) y)[(m+1)*R - 1]                (filter + decimate)

- **NCO = 32-bit phase accumulator.** The tuning word
  ``K = round(fc/fs * 2^32)`` makes the phase of sample n exactly
  ``(n*K mod 2^32) / 2^32``. PyTorch's uint32 has almost no arithmetic on
  CUDA, so the accumulator is int64 masked with ``& 0xFFFFFFFF`` after the
  multiply-add (n*K < 2^63 for any chunk shorter than 2^31 samples), then
  converted to float32, which rounds to nearest as the reference's uint32
  conversion does. Exact for any stream length, so any chunking mixes
  identically.
- **Polyphase fold**: P shifted multiply-accumulates over an (steps, R)
  layout, then a sum over R written as pairwise adds in a fixed order
  (``fixed_sum``), so a sample's bits do not depend on the chunk's shape.
- Streaming state carries the last (P-1)*R MIXED samples (re/im planes),
  so chunked processing is bit-identical to one-shot.

Real and IQ input both produce complex baseband planes at fs/R.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_TWO_PI = float(np.float32(2.0 * np.pi))


def resolve_device(device, what: str) -> torch.device:
    """``device`` None means CUDA; raise when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}: no CUDA device is available; pass device='cpu' to run "
            "on the CPU"
        )
    return dev


def fixed_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as pairwise elementwise adds in an order that
    depends only on its length: the first half plus the second, the odd
    element carried, until one is left. ``torch.sum`` picks its reduction
    strategy from the whole shape, so a short chunk could round differently
    from a long one."""
    while x.shape[-1] > 1:
        n = x.shape[-1]
        h = n // 2
        y = x[..., :h] + x[..., h : 2 * h]
        x = torch.cat([y, x[..., 2 * h :]], dim=-1) if n % 2 else y
    return x[..., 0]


def f32(v: float) -> float:
    """v rounded to the nearest float32, as a Python float."""
    return float(np.float32(v))


def design_decimation_fir(
    r: int, taps_per_phase: int = 8, window: str = "hamming"
) -> np.ndarray:
    """Lowpass anti-alias FIR for decimation by r: length taps_per_phase*r,
    cutoff fs/(2r), unit DC gain (float64)."""
    import scipy.signal as sps

    h = sps.firwin(taps_per_phase * r, cutoff=1.0 / r, window=window)
    return (h / h.sum()).astype(np.float64)


def _tuning_word(fs: float, center_hz: float) -> int:
    """32-bit NCO tuning word: round(fc/fs * 2^32) mod 2^32."""
    return int(round(center_hz / fs * 2.0**32)) % (1 << 32)


def _principal_alias_hz(fs: float, word: int) -> float:
    """The frequency a tuning word actually produces, in [-fs/2, fs/2)."""
    if word >= 1 << 31:
        word -= 1 << 32
    return word * fs / 2.0**32


def _nco_phase(phase0: torch.Tensor, word: torch.Tensor, t: int) -> torch.Tensor:
    """The uint32 NCO phases of t consecutive samples, as int64 in
    [0, 2^32): (phase0 + n * word) mod 2^32. phase0 and word are int64
    tensors of any broadcastable shape (..., 1); the result is (..., t)."""
    n = torch.arange(t, dtype=torch.int64, device=phase0.device)
    return (phase0 + n * word) & _MASK32


def _nco_cos_sin(phase0: torch.Tensor, word: torch.Tensor, t: int):
    """cos/sin of the NCO carrier for t consecutive samples (float32)."""
    ph = _nco_phase(phase0, word, t).to(torch.float32) * 2.0**-32
    ang = ph * _TWO_PI
    return torch.cos(ang), torch.sin(ang)


def _u32(v: int, device) -> torch.Tensor:
    """A uint32 NCO value (start phase or word) as an int64 (1,) tensor."""
    return torch.tensor([int(v) % (1 << 32)], dtype=torch.int64, device=device)


def _mix(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor, iq: bool):
    """Mix x with the NCO carrier exp(-j*2*pi*phase): real (..., T) or IQ
    planes (2, ..., T) -> (yre, yim)."""
    if iq:
        return x[0] * c + x[1] * s, x[1] * c - x[0] * s
    return x * c, -(x * s)


def _fold_decimate(cat: torch.Tensor, h2: torch.Tensor, p: int, r: int):
    """Polyphase fold over (..., (steps+p-1)*r) -> (..., steps): the causal
    FIR output at the last sample of each R-block."""
    rows = cat.reshape(cat.shape[:-1] + (-1, r))
    steps = rows.shape[-2] - (p - 1)
    acc = rows[..., 0:steps, :] * h2[0]
    for tp in range(1, p):
        acc = acc + rows[..., tp : tp + steps, :] * h2[tp]
    return fixed_sum(acc)


def _ddc_forward(x, tail_re, tail_im, c, s, h2, p: int, r: int, iq: bool):
    """Mix + fold-decimate one chunk.

    x: (..., T) real or (2, ..., T) IQ planes; tail_*: (..., (p-1)*r) mixed
    history; c, s: the carrier, broadcastable against the mixed planes.
    Returns (out_re, out_im, new_tail_re, new_tail_im)."""
    yre, yim = _mix(x, c, s, iq)
    hist = (p - 1) * r
    outs, tails = [], []
    for y, tail in ((yre, tail_re), (yim, tail_im)):
        cat = torch.cat([tail, y], dim=-1) if hist else y
        outs.append(_fold_decimate(cat, h2, p, r))
        # tail from CAT, not the chunk: a chunk shorter than hist must keep
        # the older history's remainder (chunked == one-shot)
        tails.append(cat[..., cat.shape[-1] - hist :].clone() if hist else tail)
    return outs[0], outs[1], tails[0], tails[1]


class DDCState:
    """Streaming state: mixed-sample tails (device) + absolute sample offset
    (host integer, exact for any stream length)."""

    def __init__(self, tail_re, tail_im, offset: int = 0):
        self.tail_re = tail_re
        self.tail_im = tail_im
        self.offset = int(offset)

    def to_numpy(self) -> dict:
        return {
            "tail_re": self.tail_re.detach().cpu().numpy(),
            "tail_im": self.tail_im.detach().cpu().numpy(),
            "offset": np.int64(self.offset),
        }

    @classmethod
    def from_numpy(cls, d: dict, *, device="cuda") -> "DDCState":
        as_t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        return cls(as_t(d["tail_re"]), as_t(d["tail_im"]), int(d["offset"]))


class DDC:
    """Streaming digital down-converter.

    Parameters: ``fs`` input rate, ``center_hz`` NCO frequency (any sign;
    retunable), ``decimation`` R, ``fir`` an explicit FIR (zero-padded to a
    multiple of R) or None for a ``design_decimation_fir`` lowpass with
    ``taps_per_phase`` taps per branch, ``device`` (None: CUDA). Output rate
    is fs/R.
    """

    def __init__(
        self,
        fs: float = 1_000_000.0,
        center_hz: float = 100_000.0,
        decimation: int = 8,
        fir: np.ndarray | None = None,
        taps_per_phase: int = 8,
        window: str = "hamming",
        device=None,
    ):
        if decimation < 1:
            raise ValueError(f"decimation must be >= 1; got {decimation}")
        self.device = resolve_device(device, "DDC")
        self.fs = float(fs)
        self.r = int(decimation)
        if fir is None:
            # R=1 has no aliasing to suppress: pure mixer (passthrough FIR)
            fir = (
                np.ones(1)
                if self.r == 1
                else design_decimation_fir(self.r, taps_per_phase, window)
            )
        h = np.asarray(fir, np.float64).reshape(-1)
        if h.size % self.r:
            h = np.pad(h, (0, self.r - h.size % self.r))
        self.fir = h
        self.p = h.size // self.r
        # h2[p, r] = h[(P-1-p)R + (R-1-r)]: the fold == causal convolution
        self._h2 = torch.tensor(
            h[::-1].reshape(self.p, self.r).astype(np.float32), device=self.device
        )
        self.retune(center_hz)

    @property
    def history_len(self) -> int:
        return (self.p - 1) * self.r

    @property
    def output_rate(self) -> float:
        return self.fs / self.r

    def retune(self, center_hz: float):
        """Change the NCO frequency (takes effect next chunk; the carrier
        phase restarts from the absolute-sample-index grid of the new
        frequency). The realized frequency is quantized to fs/2^32."""
        self.center_hz = float(center_hz)
        self._dphi = self.center_hz / self.fs
        self._tuning_word = _tuning_word(self.fs, self.center_hz)

    @property
    def realized_center_hz(self) -> float:
        """The NCO's actual frequency after 32-bit tuning quantization (a
        request beyond Nyquist returns its alias in [-fs/2, fs/2))."""
        return _principal_alias_hz(self.fs, self._tuning_word)

    def initial_state(self, batch_shape: tuple = ()) -> DDCState:
        z = torch.zeros(
            tuple(batch_shape) + (self.history_len,), dtype=torch.float32,
            device=self.device,
        )
        return DDCState(z, z, 0)

    def _carrier(self, offset: int, t: int, batch_ndim: int):
        phase0 = _u32(offset * self._tuning_word, self.device)
        word = _u32(self._tuning_word, self.device)
        c, s = _nco_cos_sin(phase0, word, t)
        shape = (1,) * batch_ndim + (t,)
        return c.reshape(shape), s.reshape(shape)

    def _process(self, x, state: DDCState, iq: bool):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        t = x.shape[-1]
        if t % self.r:
            raise ValueError(f"chunk length {t} not a multiple of R={self.r}")
        batch = x.shape[1:-1] if iq else x.shape[:-1]
        want = tuple(batch) + (self.history_len,)
        if tuple(state.tail_re.shape) != want:
            raise ValueError(f"state shape {tuple(state.tail_re.shape)} != {want}")
        c, s = self._carrier(state.offset, t, len(batch))
        ore, oim, tre, tim = _ddc_forward(
            x, state.tail_re, state.tail_im, c, s, self._h2, self.p, self.r, iq
        )
        return {"re": ore, "im": oim}, DDCState(tre, tim, state.offset + t)

    def process(self, x, state: DDCState):
        """Real input (..., T) -> complex baseband planes (..., T/R)."""
        return self._process(x, state, iq=False)

    def process_planes(self, xs, state: DDCState):
        """IQ planes (2, ..., T) -> complex baseband planes (..., T/R)."""
        return self._process(xs, state, iq=True)


class DDCBank:
    """K simultaneous down-converters on ONE shared input stream. All
    carriers share the decimation and anti-alias FIR; each has its own
    32-bit tuning word. The carrier axis is a leading K axis written out
    (the reference vmaps over it): per-carrier start phases and words
    broadcast over the input, which is read once. Output planes gain a
    leading carrier axis: (K, ..., T/R). Bitwise-identical to K independent
    ``DDC`` instances."""

    def __init__(
        self,
        fs: float = 1_000_000.0,
        centers_hz=(100_000.0,),
        decimation: int = 8,
        fir: np.ndarray | None = None,
        taps_per_phase: int = 8,
        window: str = "hamming",
        device=None,
    ):
        if len(centers_hz) < 1:
            raise ValueError("need at least one carrier")
        self._template = DDC(
            fs=fs,
            center_hz=float(centers_hz[0]),
            decimation=decimation,
            fir=fir,
            taps_per_phase=taps_per_phase,
            window=window,
            device=device,
        )
        self.device = self._template.device
        self.retune(centers_hz)

    def retune(self, centers_hz):
        """Replace the carrier set (next chunk)."""
        if len(centers_hz) < 1:
            raise ValueError("need at least one carrier")
        self.centers_hz = [float(c) for c in centers_hz]
        self._words = [_tuning_word(self.fs, c) for c in self.centers_hz]

    @property
    def k(self) -> int:
        return len(self.centers_hz)

    @property
    def fs(self) -> float:
        return self._template.fs

    @property
    def output_rate(self) -> float:
        return self._template.output_rate

    @property
    def history_len(self) -> int:
        return self._template.history_len

    @property
    def realized_centers_hz(self) -> list[float]:
        return [_principal_alias_hz(self.fs, w) for w in self._words]

    def initial_state(self, batch_shape: tuple = ()) -> DDCState:
        z = torch.zeros(
            (self.k,) + tuple(batch_shape) + (self._template.history_len,),
            dtype=torch.float32, device=self.device,
        )
        return DDCState(z, z, 0)

    def _process(self, x, state: DDCState, iq: bool):
        tmpl = self._template
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        t = x.shape[-1]
        if t % tmpl.r:
            raise ValueError(f"chunk length {t} not a multiple of R={tmpl.r}")
        batch = x.shape[1:-1] if iq else x.shape[:-1]
        want = (self.k,) + tuple(batch) + (tmpl.history_len,)
        if tuple(state.tail_re.shape) != want:
            raise ValueError(f"state shape {tuple(state.tail_re.shape)} != {want}")
        phase0 = torch.tensor(
            [[(state.offset * w) % (1 << 32)] for w in self._words],
            dtype=torch.int64, device=self.device,
        )
        words = torch.tensor([[w] for w in self._words], dtype=torch.int64,
                             device=self.device)
        c, s = _nco_cos_sin(phase0, words, t)  # (K, T)
        shape = (self.k,) + (1,) * len(batch) + (t,)
        xk = x[:, None] if iq else x[None]  # the carrier axis after IQ's planes
        ore, oim, tre, tim = _ddc_forward(
            xk, state.tail_re, state.tail_im, c.reshape(shape), s.reshape(shape),
            tmpl._h2, tmpl.p, tmpl.r, iq,
        )
        return {"re": ore, "im": oim}, DDCState(tre, tim, state.offset + t)

    def process(self, x, state: DDCState):
        """Real input (..., T) -> complex planes (K, ..., T/R)."""
        return self._process(x, state, iq=False)

    def process_planes(self, xs, state: DDCState):
        """IQ planes (2, ..., T) -> complex planes (K, ..., T/R)."""
        return self._process(xs, state, iq=True)
