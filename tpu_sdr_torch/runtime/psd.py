"""Welch averaged-periodogram PSD estimation (the counterpart of
``tpu_sdr.runtime.psd``).

``WelchPSD`` implements ``scipy.signal.welch`` semantics on the device:
overlapped segmentation, per-segment constant detrend, windowing, the DFT
through the four-step ``fft.fft_4step`` at ``_balanced_factors(nperseg)``,
|X|^2 averaging (mean, or the bias-corrected median) and density/spectrum
scaling with the one-sided fold. Every tier computes in IEEE fp32
(``torch.matmul`` at "highest" precision on the card), as the spectrum
pipeline does.

Real input returns the one-sided PSD (nperseg//2 + 1 bins); IQ input (re/im
planes) returns the two-sided PSD in unshifted FFT bin order, like
``scipy.signal.welch`` on a complex array.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sdr_torch.kernels import fft

TIERS = ("bf16", "f32", "f32max")


def _balanced_factors(n: int) -> tuple[int, int]:
    """n = n1*n2 with n1 <= n2 as square as possible."""
    n1 = int(np.sqrt(n))
    while n1 > 1 and n % n1:
        n1 -= 1
    return n1, n // n1


def _median_bias(n: int) -> float:
    """Bias of the median of n chi^2_2 periodograms (scipy's correction)."""
    ii_2 = 2.0 * np.arange(1.0, (n - 1) // 2 + 1)
    return float(1.0 + np.sum(1.0 / (ii_2 + 1.0) - 1.0 / ii_2))


def _median(p: torch.Tensor, dim: int) -> torch.Tensor:
    """The median along ``dim`` as ``jnp.median`` computes it: the middle
    value, or for an even count lower * 0.5 + upper * 0.5 (``torch.median``
    would return the lower one)."""
    s = torch.sort(p, dim=dim).values
    n = s.shape[dim]
    mid = s.narrow(dim, (n - 1) // 2, 1).squeeze(dim)
    if n % 2:
        return mid
    return mid * 0.5 + s.narrow(dim, n // 2, 1).squeeze(dim) * 0.5


def _is_complex(x) -> bool:
    return x.is_complex() if isinstance(x, torch.Tensor) else np.iscomplexobj(x)


class WelchPSD:
    """Welch PSD estimator with ``scipy.signal.welch`` semantics.

    Parameters mirror SciPy: ``window`` is any ``scipy.signal.get_window``
    name/tuple (periodic, like SciPy's default ``fftbins=True``),
    ``noverlap`` defaults to ``nperseg // 2``, ``detrend`` supports
    ``"constant"``/``False``, ``scaling`` is ``"density"`` (V^2/Hz) or
    ``"spectrum"`` (V^2), ``average`` is ``"mean"`` or ``"median"``
    (bias-corrected). ``dtype`` names the quality tier (bf16 / f32 /
    f32max); every tier computes in fp32 here. ``device=None`` means CUDA.
    """

    def __init__(
        self,
        fs: float = 1_000_000.0,
        nperseg: int = 16384,
        noverlap: int | None = None,
        window="hann",
        detrend="constant",
        scaling: str = "density",
        average: str = "mean",
        dtype: str = "f32max",
        device=None,
    ):
        import scipy.signal as sps

        if noverlap is None:
            noverlap = nperseg // 2
        if not 0 <= noverlap < nperseg:
            raise ValueError(f"need 0 <= noverlap < nperseg; got {noverlap}")
        if scaling not in ("density", "spectrum"):
            raise ValueError(f"unknown scaling {scaling!r}")
        if average not in ("mean", "median"):
            raise ValueError(f"unknown average {average!r}")
        if detrend not in ("constant", False, None):
            raise ValueError(
                "detrend supports 'constant' or False (scipy's default and "
                f"the windowed-streaming case); got {detrend!r}"
            )
        if dtype not in TIERS:
            raise ValueError(f"dtype must be one of {TIERS}; got {dtype!r}")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "WelchPSD: no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        self.fs = float(fs)
        self.nperseg = int(nperseg)
        self.noverlap = int(noverlap)
        self.step = self.nperseg - self.noverlap
        self.scaling = scaling
        self.average = average
        self.detrend = detrend == "constant"
        w = sps.get_window(window, nperseg, fftbins=True).astype(np.float64)
        self._w = torch.as_tensor(w, dtype=torch.float32, device=self.device)
        if scaling == "density":
            scale = 1.0 / (self.fs * float(np.sum(w * w)))
        else:
            scale = 1.0 / float(np.sum(w)) ** 2
        self._scale = float(np.float32(scale))  # applied in fp32, as the reference
        n1, n2 = _balanced_factors(nperseg)
        self._plan = fft.plan_constants(n1, n2, device=self.device)

    def segment_count(self, nsamples: int) -> int:
        if nsamples < self.nperseg:
            raise ValueError(
                f"need at least nperseg={self.nperseg} samples; got {nsamples}"
            )
        return (nsamples - self.noverlap) // self.step

    def frequencies(self, onesided: bool = True) -> np.ndarray:
        if onesided:
            return np.fft.rfftfreq(self.nperseg, 1.0 / self.fs)
        return np.fft.fftfreq(self.nperseg, 1.0 / self.fs)

    def _frames(self, p: torch.Tensor, nseg: int) -> torch.Tensor:
        f = p.unfold(-1, self.nperseg, self.step)[..., :nseg, :]  # (..., nseg, nperseg)
        if self.detrend:
            f = f - f.mean(dim=-1, keepdim=True)
        return f * self._w

    def _run(self, xr: torch.Tensor, xi, onesided: bool, average: str | None = None):
        """average: 'mean' | 'median' | 'none' (per segment, (..., nseg, nfreq))."""
        nseg = self.segment_count(xr.shape[-1])
        average = self.average if average is None else average
        fr = self._frames(xr, nseg)
        fi = None if xi is None else self._frames(xi, nseg)
        Xr, Xi = fft.fft_4step(fr, fi, self._plan)
        p2 = Xr * Xr + Xi * Xi
        if onesided:
            half = self.nperseg // 2 + 1
            p2 = p2[..., :half]
            # fold: double every bin except DC (and Nyquist when nperseg even)
            last = half - 1 if self.nperseg % 2 == 0 else half
            fold = torch.ones(half, dtype=p2.dtype, device=p2.device)
            fold[1:last] = 2.0
            p2 = p2 * fold
        if average == "median":
            est = _median(p2, dim=-2) / float(np.float32(_median_bias(nseg)))
        elif average == "none":
            est = p2
        else:
            est = p2.mean(dim=-2)
        return est * self._scale

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(torch.float32)

    def compute(self, x) -> torch.Tensor:
        """Real input (..., T) -> one-sided PSD (..., nperseg//2 + 1)."""
        if _is_complex(x):
            # a silent complex->float cast would fold negative-frequency
            # content onto the positive bins
            raise ValueError("complex (IQ) input: split re/im and use compute_iq")
        return self._run(self._tensor(x), None, onesided=True)

    def compute_iq(self, xr, xi) -> torch.Tensor:
        """IQ planes (..., T) each -> two-sided PSD (..., nperseg),
        unshifted FFT bin order (scipy's complex-input convention)."""
        return self._run(self._tensor(xr), self._tensor(xi), onesided=False)

    def segment_times(self, nsamples: int) -> np.ndarray:
        """Segment-center timestamps (scipy.signal.spectrogram's t)."""
        k = self.segment_count(nsamples)
        return (np.arange(k) * self.step + self.nperseg / 2.0) / self.fs

    def spectrogram(self, x, xi=None) -> torch.Tensor:
        """Per-segment PSD, ``scipy.signal.spectrogram(mode='psd')``
        semantics: (..., T) -> Sxx (..., nfreq, nseg), the frequency axis
        before time. Pair with ``frequencies()`` and ``segment_times()`` for
        the axes. ``xi`` switches to IQ planes (two-sided, unshifted)."""
        if _is_complex(x):
            raise ValueError("complex (IQ) input: split re/im and pass them as (x, xi)")
        sxx = self._run(
            self._tensor(x), None if xi is None else self._tensor(xi),
            onesided=xi is None, average="none",
        )
        return sxx.transpose(-1, -2)
