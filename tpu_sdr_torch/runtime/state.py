"""Carried stream state (the counterpart of ``tpu_sdr.runtime.state``).

``to_numpy`` and ``from_numpy`` use the reference's dict keys, shapes and
dtypes, so a checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class StreamState:
    """Per-channel carried state of the streaming DSP chain.

    Leaves:
      sos_state    (..., channels, n_sections, 2) float32 - TDF-II biquad
                   state per section per channel (scipy ``zi`` convention),
                   for the selected filter path.
      window_phase () int32 - sample index mod fft_size of the next sample.
      frame_count  () int32 - spectra produced so far.
      history      (..., channels, fft_size - hop) float32 - trailing
                   filtered samples for overlapped framing; None when
                   hop == fft_size.
    """

    sos_state: torch.Tensor
    window_phase: torch.Tensor
    frame_count: torch.Tensor
    history: torch.Tensor | None = None

    @staticmethod
    def initial(
        channels: int,
        n_sections: int = 6,
        batch_shape=(),
        history_len: int = 0,
        *,
        device="cuda",
    ) -> "StreamState":
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        return StreamState(
            sos_state=torch.zeros((*batch_shape, channels, n_sections, 2), **f32),
            window_phase=torch.zeros((), **i32),
            frame_count=torch.zeros((), **i32),
            history=(
                torch.zeros((*batch_shape, channels, history_len), **f32)
                if history_len
                else None
            ),
        )

    def to_numpy(self) -> dict:
        """Checkpoint: copy to the host as plain NumPy arrays."""
        as_np = lambda t: t.detach().cpu().numpy()
        return {
            "sos_state": as_np(self.sos_state),
            "window_phase": as_np(self.window_phase),
            "frame_count": as_np(self.frame_count),
            "history": None if self.history is None else as_np(self.history),
        }

    @staticmethod
    def from_numpy(d: dict, *, device="cuda") -> "StreamState":
        as_t = lambda a: torch.tensor(np.asarray(a), device=device)
        h = d.get("history")
        return StreamState(
            sos_state=as_t(d["sos_state"]),
            window_phase=as_t(d["window_phase"]),
            frame_count=as_t(d["frame_count"]),
            history=None if h is None else as_t(h),
        )
