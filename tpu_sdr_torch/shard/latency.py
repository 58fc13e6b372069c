"""Latency-mode pipeline: ONE 16K frame spread over the time axis of the
mesh (the counterpart of ``tpu_sdr.shard.latency``).

The throughput engine (``shard/pipeline.py``) shards whole frames, so a
frame's latency is one device's frame time. This engine puts every rank to
work on the SAME frame:

  1. the frame's (n2, n1) block view is ROW-sharded: each rank holds
     n2/D contiguous 128-sample blocks;
  2. window + the blocked IIR run locally; only the per-rank m-vector state
     summaries cross the axis (an all-gather of D*m floats), and every rank
     replays the same short chain (``biquad.frame_chain``);
  3. one all-to-all re-shards rows to columns (the four-step FFT's
     transpose as a collective);
  4. ``fft.fft_4step_sharded`` (step 1 and the twiddle local, the step-3
     partial products summed by a reduce-scatter over k1) leaves this
     rank's k1-contiguous block of the natural-order spectrum; the
     magnitude is local.

Not bitwise against the throughput engine: the reduce-scatter sums partial
products across ranks. The contract is a relative error of 1e-5.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sdr_torch.control import golden
from tpu_sdr_torch.core.config import FilterMode, PipelineConfig
from tpu_sdr_torch.kernels import biquad, fft, window
from tpu_sdr_torch.runtime import banks
from tpu_sdr_torch.runtime.stream import _MODE_TO_INDEX, check_matmul_precision
from tpu_sdr_torch.core import comm
from tpu_sdr_torch.shard.mesh import SdrMesh, make_sdr_mesh


class LatencyPipeline:
    """Single-frame, whole-axis engine. x: (fft_size,) real samples.

    ``mesh``: a (1, D) mesh (default: every rank on the time axis); the
    frame spreads over its D time ranks. State is just the composite IIR
    state (replicated): (n_sections, 2). ``process_frame`` returns this
    rank's block of the magnitude spectrum (fft_size/D bins, in order);
    ``gather`` assembles the whole.
    """

    def __init__(self, cfg: PipelineConfig | None = None, mesh: SdrMesh | None = None):
        self.cfg = cfg or PipelineConfig()
        if self.cfg.channels != 1:
            raise ValueError("latency mode is single-stream (channels=1)")
        if self.cfg.effective_hop != self.cfg.fft_size:
            raise ValueError("latency mode has no overlap (hop == fft_size)")
        if mesh is None:
            mesh = make_sdr_mesh(channel=1)
        if mesh.shape["channel"] != 1:
            raise ValueError("latency mode spreads one frame over the time axis: channel must be 1")
        self.mesh = mesh
        self.axis = mesh.time
        self.D = mesh.shape["time"]
        self.device = mesh.device
        n2, n1 = self.cfg.fft_n2, self.cfg.fft_n1
        if n2 % self.D or n1 % self.D:
            raise ValueError(f"mesh size {self.D} must divide n1={n1} and n2={n2}")
        if self.cfg.iir_block != n1:
            # The IIR blocks are the rows of the (n2, n1) view.
            raise ValueError(
                f"latency mode requires iir_block == fft_n1 (the IIR blocks are the "
                f"frame's rows); got iir_block={self.cfg.iir_block}, fft_n1={n1}"
            )
        self.b_loc = n2 // self.D  # contiguous blocks per rank
        self.hann2d = window.hann_coefficients(
            self.cfg.fft_size, self.cfg.rtl_faithful_window, device=self.device
        ).reshape(n2, n1)
        self.plan = fft.plan_constants(n1, n2, device=self.device)
        # Per-rank composite operator: b_loc blocks a "frame"; its ALB is the
        # per-rank state transition A^(b_loc*L).
        self.op_fixed = self._op(golden.fixed_filter_sos())
        self.op_custom = self._op(biquad.sos_identity(self.cfg.n_sections))

    def _op(self, sos):
        return biquad.precompute_composite(sos, self.cfg.iir_block, self.b_loc, device=self.device)

    def initial_state(self) -> torch.Tensor:
        return torch.zeros((self.cfg.n_sections, 2), dtype=torch.float32, device=self.device)

    def upload_sos(self, sos: np.ndarray):
        self.op_custom = self._op(banks.prepare_sos(sos, self.cfg.n_sections))

    def _body(self, x2d_loc, zi, op, mode_index: int):
        m = 2 * self.cfg.n_sections
        lo = self.axis.index * self.b_loc
        xw = x2d_loc * self.hann2d[lo : lo + self.b_loc]
        if mode_index == 0:
            y, zf = xw, zi.reshape(m)
        else:
            # One local "frame" of b_loc blocks, products at their own shape
            # (frames=1): this engine's contract is float parity with the
            # throughput engine, not bitwise chunking invariance.
            y_zs, zhat = biquad._composite_frame_terms(op, xw[None], frames=1)
            z_start, zf = biquad.frame_chain(op, zi.reshape(m), zhat[:, -1], self.axis)
            y = biquad._composite_emit(op, y_zs, zhat, z_start, frames=1)[0]
        # rows -> columns: the four-step transpose as an all-to-all
        y_cols = comm.all_to_all(y, self.axis, split_dim=1, concat_dim=0)  # (n2, n1/D)
        fr, fi = fft.fft_4step_sharded(y_cols, None, self.plan, self.axis)
        return torch.sqrt(fr * fr + fi * fi), zf.reshape(self.cfg.n_sections, 2)

    def process_frame(self, x, state, mode: FilterMode = FilterMode.BYPASS):
        """x (fft_size,), the whole frame on every rank -> (this rank's
        magnitude block (fft_size/D,), the new state, replicated)."""
        check_matmul_precision("highest")
        n = self.cfg.fft_size
        x = x if torch.is_tensor(x) else np.asarray(x, np.float32)
        x2d = x.reshape(self.cfg.fft_n2, self.cfg.fft_n1)
        x_loc = self.mesh.block(x2d, channel_dim=None, time_dim=0)
        mode_index = _MODE_TO_INDEX[FilterMode(mode)]
        op = self.op_fixed if mode_index == 1 else self.op_custom
        mag, zf = self._body(x_loc, torch.as_tensor(state, device=self.device), op, mode_index)
        return mag.reshape(n // self.D), zf

    def gather(self, mag: torch.Tensor) -> torch.Tensor:
        """The whole (fft_size,) spectrum from every rank's block."""
        return self.mesh.gather(mag, channel_dim=None, time_dim=-1)
