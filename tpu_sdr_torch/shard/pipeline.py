"""Sharded spectrum pipeline over a (channel, time) mesh (the counterpart of
``tpu_sdr.shard.pipeline``).

The distributed form of the single-stream dataflow: each rank holds a
(channel, frame-run) block of the chunk; ranks exchange only the per-frame
IIR state summaries along the time axis (and, for hop < fft_size, the
overlap halo); spectra come out as per-rank blocks and are gathered at the
host edge (``gather``).

Bit-consistency contract: for any mesh shape, the gathered outputs and the
final state are bit-identical to the single-device ``SpectrumPipeline``.
Each frame's products run at the single-device call shape
(``biquad._canonical_matmul``), every rank replays the global frame chain
in frame order before it keeps its own starts, and the spectrum kernels
work frame by frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_sdr_torch.core.config import FilterMode, PipelineConfig
from tpu_sdr_torch.runtime import banks
from tpu_sdr_torch.runtime.state import StreamState
from tpu_sdr_torch.runtime.stream import (
    _MODE_TO_INDEX,
    SpectrumPipeline,
    check_matmul_precision,
    process_stream,
    process_stream_complex,
)
from tpu_sdr_torch.core import comm
from tpu_sdr_torch.shard.mesh import ShardedArray, SdrMesh, make_sdr_mesh


class ShardedSpectrumPipeline(SpectrumPipeline):
    """Multi-rank engine: x (C, T) sharded (channel, time-frames).

    Every rank calls ``process`` with the same global chunk and the same
    global state; each computes its block and returns its output block
    ((C/cd, F/td, N) magnitudes) and the new global state. ``gather``
    assembles the global outputs. The device constants are the
    single-device engine's, on this rank's device; a per-channel bank holds
    only this rank's channel rows.
    """

    def __init__(self, cfg: PipelineConfig | None = None, mesh: SdrMesh | None = None):
        self.mesh = mesh if mesh is not None else make_sdr_mesh()
        super().__init__(cfg, device=self.mesh.device)

    def upload_sos_bank(self, sos_bank):
        """Per-channel coefficient reload on any (channel, time) mesh: every
        channel's design is validated; this rank builds the operators of
        its own channel rows (the bank is sharded over the channel axis and
        replicated over time)."""
        padded = banks.prepare_bank(sos_bank, self.cfg.channels, self.cfg.n_sections)
        lo, hi = self.mesh.channel_range(self.cfg.channels)
        op = banks.build_channel_bank_op(self.cfg, padded[lo:hi], self.device)
        self.bank_custom = {"op": op, "pp": self.bank_fixed["pp"]}

    def shard_input(self, x) -> ShardedArray:
        """Place a global host chunk: (C, T) or (T,), or complex (IQ) input
        as re/im-stacked (2, C, T) planes. Only this rank's block goes to
        its device."""
        if isinstance(x, ShardedArray):
            return x
        if np.ndim(x) == 1:
            x = x[None, :]
        if x.is_complex() if torch.is_tensor(x) else np.iscomplexobj(x):
            # split this rank's block only into its planes
            blk = x[self.mesh.block_index(x.shape, -2, -1)]
            if torch.is_tensor(blk):
                planes = torch.stack([blk.real, blk.imag]).to(self.device, torch.float32)
            else:
                planes = torch.as_tensor(
                    np.stack([blk.real, blk.imag]).astype(np.float32), device=self.device)
            return ShardedArray(planes, (2,) + tuple(x.shape))
        return self.mesh.put(x, channel_dim=-2, time_dim=-1)

    def _check_global(self, shape):
        # friendly errors BEFORE any transfer (as the reference)
        tpd = self.mesh.shape["time"] * self.cfg.fft_size
        if shape[-1] % tpd:
            raise ValueError(
                f"stream chunk length {shape[-1]} must be a multiple of "
                f"time_shards*fft_size = {tpd}"
            )
        cd = self.mesh.shape["channel"]
        if self.cfg.channels % cd:
            raise ValueError(
                f"channels ({self.cfg.channels}) must be a multiple of the mesh "
                f"channel axis ({cd})"
            )

    def _local_state(self, state: StreamState, lead: int) -> StreamState:
        lo, hi = self.mesh.channel_range(self.cfg.channels)
        rows = lambda t: None if t is None else t.narrow(lead, lo, hi - lo).to(self.device)
        return dataclasses.replace(
            state, sos_state=rows(state.sos_state), history=rows(state.history),
            window_phase=state.window_phase.to(self.device),
            frame_count=state.frame_count.to(self.device),
        )

    def _global_state(self, state: StreamState, lead: int) -> StreamState:
        if self.mesh.shape["channel"] == 1:
            return state
        rows = lambda t: None if t is None else comm.all_gather(t, self.mesh.channel, lead)
        return dataclasses.replace(
            state, sos_state=rows(state.sos_state), history=rows(state.history)
        )

    def _run(self, x, state, mode, outputs, complex_input: bool):
        x_local = x.local
        check_matmul_precision(self.matmul_precision)
        lead = 1 if complex_input else 0
        fn = process_stream_complex if complex_input else process_stream
        out, new_state = fn(
            x_local, self._local_state(state, lead), self.bank_fixed, self.bank_custom,
            self.hann_w, self.plan, mode_index=_MODE_TO_INDEX[FilterMode(mode)],
            cfg=self.cfg, outputs=outputs, time_axis=self.mesh.time_axis,
        )
        return out, self._global_state(new_state, lead)

    def process(
        self,
        x,
        state: StreamState,
        mode: FilterMode = FilterMode.BYPASS,
        outputs: str = "magnitude",
    ):
        """x: the global chunk (C, T) or (T,), NumPy or a tensor, or a
        ``ShardedArray`` from ``shard_input`` -> (this rank's output
        blocks, the new global state). Complex (IQ) input takes a state
        from ``initial_state(batch_shape=(2,))``."""
        complex_input = (
            x.is_complex() if torch.is_tensor(x)
            else (not isinstance(x, ShardedArray) and np.iscomplexobj(x))
        )
        if complex_input:
            self._check_iq_state(state)
        shape = x.shape if isinstance(x, ShardedArray) else np.shape(x)
        if len(shape) > 2:
            raise ValueError(
                f"x must be (C, T) or (T,), got {tuple(shape)}; re/im planes go to "
                "process_planes"
            )
        self._check_global(shape)
        return self._run(self.shard_input(x), state, mode, outputs, complex_input)

    def process_planes(
        self,
        xs,
        state: StreamState,
        mode: FilterMode = FilterMode.BYPASS,
        outputs: str = "magnitude",
    ):
        """IQ input as global re/im planes (2, C, T) (or their
        ``ShardedArray``, e.g. from a sharded ``StreamFeeder``), with the
        re/im-stacked state of ``initial_state(batch_shape=(2,))``."""
        shape = tuple(xs.shape) if isinstance(xs, ShardedArray) else np.shape(xs)
        if len(shape) != 3 or shape[0] != 2:
            raise ValueError(f"xs must be re/im planes (2, C, T), got {tuple(shape)}")
        self._check_iq_state(state)
        self._check_global(shape)
        xs = self.mesh.put(xs, channel_dim=-2, time_dim=-1)
        return self._run(xs, state, mode, outputs, complex_input=True)

    def gather(self, out: dict) -> dict:
        """The global outputs (C, F, N) from every rank's blocks (a
        collective: every rank of the mesh calls it)."""
        return {k: self.mesh.gather(v, channel_dim=-3, time_dim=-2) for k, v in out.items()}
