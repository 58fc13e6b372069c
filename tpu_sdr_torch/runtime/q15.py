"""Q15-faithful integer pipeline, the bit-exact validation path (the
counterpart of ``tpu_sdr.runtime.q15``).

It reproduces the reference's integer arithmetic where it is defined:

- window: the int16 ROM (= clip(round((hann - 0.5) * 2^16))) with the RTL's
  (x*w)>>15 + half-LSB rounding, bit-exact vs ``golden.rtl_window_q15``;
  ``rtl_misaligned_window=True`` also reproduces the RTL's 1-sample
  coefficient lag (ROM[k-1] applied to sample k). The ROM encodes hann-0.5,
  so the effective window is -cos: a pure tone splits into the two adjacent
  bins, exactly as on the FPGA;
- IIR: x64 int8 coefficients, >>6 round-half-away, int16 saturation (the
  intended /64 scale), bit-exact vs ``golden.sosfilt_q15_intended``;
- FFT: the scaled 16-bit fixed-point model of the xfft core's default
  configuration (``kernels/fft_q15.py``); ``spectrum_re_q15`` /
  ``spectrum_im_q15`` are the int16 words the FPGA drains onto the wire
  (``sequ2.vhd:153``);
- magnitude: the GUI decode math over those wire ints
  (``fft_analyzer_gui.py:256-260``).

Two forms. The all-device path (``device_fft=False``) runs the window and
the cascade in ``csrc/sosfilt_q15.cu`` (``biquad.sosfilt_q15_window``) and
the FFT in ``csrc/q15_fft.cu`` (``fft_q15.window_fft_q15``). The live split
(``device_fft=True``) runs the fused window + cascade on the host in the
native C++ loop (``native_q15``), or skips it in bypass mode, and the
window (bypass) + FFT in one launch of ``csrc/q15_fft.cu``. ``device=None``
means CUDA; ``device="cpu"`` runs the kernels' plain versions.
"""

from __future__ import annotations

import collections
import concurrent.futures

import numpy as np
import torch

from tpu_sdr_torch.core import qformat as qf
from tpu_sdr_torch.core.config import PipelineConfig
from tpu_sdr_torch.kernels import biquad, fft_q15, native_q15, window


class Q15Pipeline:
    """Bit-faithful integer chain: q15 samples -> q15 filtered -> spectra."""

    def __init__(
        self,
        cfg: PipelineConfig | None = None,
        rtl_misaligned_window: bool = False,
        device_fft: bool = False,
        device=None,
    ):
        self.cfg = cfg or PipelineConfig()
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Q15Pipeline: no CUDA device is available; pass device='cpu' to run "
                "the plain versions on the CPU"
            )
        rom = window.hann_q16_rom(self.cfg.fft_size, device=self.device)
        if rtl_misaligned_window:
            # The RTL applies ROM[k-1] to sample k (src/hann8192.vhd:36-43; in
            # steady streaming sample 0 meets ROM[N-1]), as
            # golden.rtl_window_q15(misaligned=True).
            rom = torch.roll(rom, 1)
        self.rom = rom
        self.rom_np = rom.cpu().numpy()
        self.sos_q: np.ndarray | None = None
        self._sos_dev: torch.Tensor | None = None
        # device_fft: the live split. The window and the integer FFT run as
        # one launch per chunk; only the per-sample saturating IIR stays on
        # the host (native C++), and bypass mode skips it. Same bits as the
        # all-device path and the NumPy oracle.
        self.device_fft = bool(device_fft)

    def upload_sos_q(self, sos_x64: np.ndarray):
        """Quantized coefficients, int8 x64 (the wire format's payload)."""
        sos_x64 = np.atleast_2d(np.asarray(sos_x64))
        sos_q = biquad.pad_sos(
            sos_x64.astype(np.float64) / qf.COEFF_SCALE, self.cfg.n_sections
        ) * qf.COEFF_SCALE
        sos_q = np.rint(sos_q).astype(np.int32)
        if np.any(sos_q[:, 3] != qf.COEFF_SCALE):
            # The integer recurrence assumes a0 == 64 (the designer always
            # emits it; the oracle and the native filter reject anything
            # else), so the all-device path checks here too.
            raise ValueError(
                f"a0 must be {qf.COEFF_SCALE} (x64 normalized) in every "
                f"section; got {sos_q[:, 3].tolist()}"
            )
        self.sos_q = sos_q
        self._sos_dev = torch.as_tensor(sos_q, device=self.device)

    def _process(self, x_q15: torch.Tensor, zi: torch.Tensor):
        n = self.cfg.fft_size
        S = self.cfg.n_sections
        lead, t = x_q15.shape[:-1], x_q15.shape[-1]
        y, xw, zf = biquad.sosfilt_q15_window(  # the RTL window, then the cascade
            self._sos_dev, x_q15.reshape(-1, t), zi.reshape(-1, S, 2), rom=self.rom
        )
        yq = y.reshape(*lead, -1, n)
        # the scaled fixed-point FFT: the int16 wire words (sequ2.vhd:153)
        fr_q, fi_q, mag = fft_q15.window_fft_q15(yq)
        return {
            "windowed_q15": xw.reshape(*lead, -1, n),
            "filtered_q15": yq,
            "spectrum_re_q15": fr_q,
            "spectrum_im_q15": fi_q,
            # GUI decode math over the wire ints (fft_analyzer_gui.py:256-260)
            "magnitude": mag,
        }, zf.reshape(*lead, S, 2)

    def _window_fft(self, y_frames: torch.Tensor, *, bypass: bool, display: bool = False):
        """Device stage of the split path: [window +] integer FFT + decode.

        ``bypass=True``: y_frames are raw q15 frames, windowed in the same
        launch. ``bypass=False``: y_frames are already windowed and filtered
        on the host.

        ``display=True`` adds a ``display_frame`` leaf: the last frame's
        [re, im, |X|] stacked into one (..., 3, N) fp32 tensor (re/im are
        int16-exact in fp32), so a live display fetches one small array.
        """
        fr_q, fi_q, mag = fft_q15.window_fft_q15(y_frames, rom=self.rom if bypass else None)
        out = {"spectrum_re_q15": fr_q, "spectrum_im_q15": fi_q, "magnitude": mag}
        if display:
            out["display_frame"] = torch.stack(
                [fr_q[..., -1, :].to(torch.float32), fi_q[..., -1, :].to(torch.float32),
                 mag[..., -1, :]], dim=-2
            )
        return out

    def _upload(self, frames: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)

    def _process_split(self, x, zi, bypass, display=False):
        """Host window + native C++ filter -> one device launch."""
        n = self.cfg.fft_size
        x = np.asarray(x, np.int16)
        if x.ndim == 1:
            x = x[None, :]
        lead = x.shape[:-1]
        if bypass:
            if zi is None:
                zi = np.zeros((*lead, self.cfg.n_sections, 2), np.int64)
            out = self._window_fft(self._upload(x.reshape(*lead, -1, n)), bypass=True,
                                   display=display)
            return out, np.asarray(zi)
        return self.process_async(x, zi, display=display)

    def _split_host(self, x_q15, zi):
        """The filtered split path's host half: the fused RTL window +
        saturating IIR in one native pass. Returns (ys, xw) as (..., F, N)
        int16 frames and zf (..., S, 2) int64."""
        if not self.device_fft:
            raise ValueError("process_async requires device_fft=True")
        if self.sos_q is None:
            raise ValueError("upload_sos_q first")
        n, sections = self.cfg.fft_size, self.cfg.n_sections
        x = np.asarray(x_q15, np.int16)
        if x.ndim == 1:
            x = x[None, :]
        lead = x.shape[:-1]
        if zi is None:
            zi = np.zeros((*lead, sections, 2), np.int64)
        ys, xw, zf = native_q15.sosfilt_q15_window_rows(
            np.asarray(self.sos_q, np.int64), x.reshape(-1, x.shape[-1]), self.rom_np,
            np.asarray(zi, np.int64).reshape(-1, sections, 2), want_windowed=True,
        )
        return ys.reshape(*lead, -1, n), xw.reshape(*lead, -1, n), zf.reshape(*lead, sections, 2)

    def _split_device(self, ys, xw, display: bool = False):
        """The filtered split path's device half: one upload and one launch on
        the current stream, the spectrum leaves left in flight; the host
        products ride along as NumPy."""
        out = self._window_fft(self._upload(ys), bypass=False, display=display)
        out["windowed_q15"] = xw
        out["filtered_q15"] = ys
        return out

    def process_async(self, x_q15, zi=None, display: bool = False):
        """Filtered split path, device stage left in flight.

        Runs the host stage (fused window + filter) synchronously, launches
        the device FFT, and returns ``(pending, zf)``: ``pending`` holds the
        spectrum leaves as tensors on the pipeline's device, possibly still
        being computed, and the host products ``windowed_q15`` /
        ``filtered_q15`` as NumPy. Fetch the tensors with ``.cpu()`` when
        ready; ``Q15Stream`` packages the pattern.
        """
        ys, xw, zf = self._split_host(x_q15, zi)
        return self._split_device(ys, xw, display), zf

    def process(self, x_q15, zi=None, bypass: bool = False, display: bool = False):
        """x_q15 (..., T) int16 (frame-aligned). Returns (out dict, zf).

        ``bypass``: window+FFT only (the reference's reset-default 0xB1
        mode), honoured only on the ``device_fft`` split path; the
        all-device path always filters. ``display``: split path only, adds
        the single-fetch ``display_frame`` leaf (see ``_window_fft``).
        The all-device path's state is int32 on the device, the split
        path's int64 on the host, as in the reference.
        """
        if self.device_fft:
            return self._process_split(x_q15, zi, bypass, display)
        if self.sos_q is None:
            raise ValueError("upload_sos_q first")
        x = torch.as_tensor(x_q15, device=self.device)
        if x.dtype != torch.int16:
            x = x.to(torch.int16)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[-1] % self.cfg.fft_size:
            raise ValueError(
                f"chunk length {x.shape[-1]} must be a multiple of fft_size={self.cfg.fft_size}"
            )
        if zi is None:
            zi = torch.zeros((*x.shape[:-1], self.cfg.n_sections, 2), dtype=torch.int32,
                             device=self.device)
        else:
            zi = torch.as_tensor(zi, device=self.device).to(torch.int32)
        return self._process(x, zi)


class Q15Stream:
    """Double-buffered live runner for the filtered faithful mode.

    The FPGA's filter never stalls its FFT (``imp/filter_iir12.vhd:38-137``,
    a free-running 1-sample pipeline). This runner splits the split path's
    two halves between two threads:

      * a single worker thread runs the host stage (the fused native window
        + filter: C code, the interpreter lock released) of the chunks in
        submission order;
      * the caller's thread takes the oldest chunk whose host stage is done,
        uploads it, launches the FFT on its current stream
        (``process_async``'s device half) and fetches the ``fetch`` leaves
        with ``.cpu().numpy()``, while the worker filters the next chunk;
      * filter state threads through the worker in submission order, so
        the output stream is bit-identical to sequential ``process()``
        calls;
      * ``push(chunk)`` returns the completed result for the oldest
        in-flight chunk (None until the pipeline holds ``depth`` chunks);
        ``flush()`` drains one tail chunk per call, oldest first;
      * ``depth`` (default 1): chunks in flight, at the price of depth x
        chunk latency.

    Whether the two halves overlap in time depends on the host: both threads
    run Python around their C and CUDA calls and share the interpreter lock
    and the cores (``PERF.md`` gives the H100 host's numbers).

    Error semantics: a chunk that fails (no coefficients, a device error)
    surfaces on the next ``push``/``flush`` (the call that would have
    returned its result) as the original exception; the chain is then
    poisoned and every later call re-raises until ``reset()``, which
    discards the failed tail and resumes from ``self.zf``, the state after
    the last chunk that completed its host stage. A length that is not a
    multiple of fft_size is rejected synchronously in ``push``.
    """

    def __init__(
        self, pipe: Q15Pipeline, fetch=("magnitude",), display: bool = False,
        depth: int = 1,
    ):
        if not pipe.device_fft:
            raise ValueError("Q15Stream requires Q15Pipeline(device_fft=True)")
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.pipe = pipe
        self.fetch = tuple(fetch)
        self.display = bool(display)
        self.depth = int(depth)
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending = collections.deque()  # futures of host stages, oldest first
        self._error: BaseException | None = None
        self.zf = None  # state after the newest successful host stage

    def _materialize(self, fut):
        if self._error is not None:
            raise self._error
        try:
            ys, xw, zf = fut.result()
            out = self.pipe._split_device(ys, xw, self.display)
            for k in self.fetch:
                v = out[k]
                out[k] = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        except Exception as e:
            self._error = e
            raise
        return out, zf

    def push(self, x_q15):
        """Feed one frame-aligned chunk; returns the completed (out, zf) of
        the oldest in-flight chunk, or None while the pipeline fills."""
        t = np.asarray(x_q15).shape[-1]
        if t % self.pipe.cfg.fft_size:
            raise ValueError(
                f"chunk length {t} must be a multiple of "
                f"fft_size={self.pipe.cfg.fft_size}"
            )
        if self._error is not None:
            raise self._error
        # A copy: the host stage runs later on the worker over this buffer, and
        # a caller that refills one chunk buffer in place would tear samples.
        x_q15 = np.array(x_q15, copy=True)
        zi = self.zf
        # The single worker runs submissions in order, so chaining through the
        # previous future threads the state and never deadlocks.
        prev = self._pending[-1] if self._pending else None

        def run(x=x_q15, prev_fut=prev, zi0=zi):
            z = prev_fut.result()[2] if prev_fut is not None else zi0
            res = self.pipe._split_host(x, z)
            # The resume point for reset() (an attribute store: atomic).
            self.zf = res[2]
            return res

        self._pending.append(self._pool.submit(run))
        if len(self._pending) <= self.depth:
            return None
        return self._materialize(self._pending.popleft())

    def flush(self):
        """Drain one in-flight chunk, oldest first (None when empty); call
        repeatedly to empty a depth > 1 pipeline."""
        if not self._pending:
            return None
        return self._materialize(self._pending.popleft())

    def reset(self):
        """Discard the in-flight tail and resynchronize deterministically.

        Chunks not yet started are cancelled (newest first, so the ordered
        worker never reaches them); a chunk already running is waited out,
        so its host stage still advances ``self.zf`` before this returns.
        The next ``push`` resumes from the state after the last chunk whose
        host stage ran."""
        while self._pending:
            fut = self._pending.pop()  # newest first: cancel before started
            if not fut.cancel():
                try:
                    fut.result()
                except Exception:  # the failed tail is what reset() discards
                    pass
        self._error = None

    def close(self):
        self._pool.shutdown(wait=True)
