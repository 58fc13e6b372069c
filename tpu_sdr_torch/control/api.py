"""SpectrumAnalyzer — the system facade (FPGA top-level + command plane).

The counterpart of ``tpu_sdr.control.api`` on the port's single-device
``SpectrumPipeline``: owns the engine, the runtime mode/comm state, the
byte-protocol decoder, and the output framing hook. A host that used to talk
to the FPGA over UART bytes can drive this object byte-for-byte
(``handle_bytes``); a native host uses the typed methods directly.

The host edge: ``process`` copies the magnitudes to the host once, as NumPy
float32. Under ``bf16_io`` the device's bfloat16 magnitudes are copied as
they are and widened to float32 on the host, which is exact (NumPy has no
bfloat16); the reference hands back an ``ml_dtypes`` bfloat16 array.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from tpu_sdr_torch.control import designer as designer_mod
from tpu_sdr_torch.control.commands import Command, CommandDecoder, DecodedEvent
from tpu_sdr_torch.core.config import CommMode, FilterMode, PipelineConfig
from tpu_sdr_torch.runtime.state import StreamState


@dataclasses.dataclass
class AnalyzerStats:
    """Host-side observability counters (the GUI stats-tile contract,
    ``fft_analyzer_gui.py:439-455``)."""

    frames_produced: int = 0
    samples_consumed: int = 0
    commands_handled: int = 0
    coefficient_uploads: int = 0
    uploads_rejected: int = 0
    resets: int = 0
    last_peak_bin: int = -1
    last_peak_mag: float = 0.0
    started_at: float | None = None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def reset(self):
        """Zero the counters (GUI 'reset_plot'; the analyzer keeps running).

        Re-anchors ``started_at`` so rate estimates (samples/elapsed, e.g.
        the roofline endpoint) stay consistent with the zeroed counters.
        """
        self.frames_produced = 0
        self.samples_consumed = 0
        self.last_peak_bin = -1
        self.last_peak_mag = 0.0
        if self.started_at is not None:
            self.started_at = time.time()


class SpectrumAnalyzer:
    """High-level runtime-reconfigurable spectrum analyzer.

    Typical native use::

        sa = SpectrumAnalyzer(PipelineConfig())    # device=None: CUDA
        sa.start()
        sa.upload_filter(design_iir_filter(...).sos)
        sa.set_filter_mode(FilterMode.CUSTOM)
        spectra = sa.process(samples)          # (C, F, N) magnitudes

    Wire-compatible use (the FPGA byte protocol)::

        sa.handle_bytes(bytes([0xB1, 0x55]))   # bypass + start
        sa.handle_bytes(b"\\xf1" + twelve_coeff_bytes)
    """

    def __init__(
        self,
        cfg: PipelineConfig | None = None,
        mesh=None,
        on_spectrum: Callable[[np.ndarray, int], None] | None = None,
        device=None,
    ):
        """``device``: None runs on CUDA (raising without a GPU), "cpu"
        the kernels' plain versions. ``mesh`` (a ``shard.mesh.SdrMesh``)
        runs the sharded engine on the mesh's devices: every rank of the
        mesh drives its own analyzer with the same commands and chunks, and
        ``process`` returns the gathered (global) magnitudes on each."""
        self.cfg = cfg or PipelineConfig()
        self.mesh = mesh
        if mesh is not None:
            if device is not None:
                raise ValueError("mesh= runs on the mesh's devices; pass no device")
            from tpu_sdr_torch.shard import ShardedSpectrumPipeline

            self.pipe = ShardedSpectrumPipeline(self.cfg, mesh)
        else:
            from tpu_sdr_torch.runtime.stream import SpectrumPipeline

            self.pipe = SpectrumPipeline(self.cfg, device=device)
        self.decoder = CommandDecoder()
        self.filter_mode = FilterMode.BYPASS  # reset default, command_control.vhd:31
        self.comm_mode = CommMode.ETHERNET  # default, sequ2.vhd:82-96
        self.running = False
        self.uart_streaming = False
        self.state = self._fresh_state()
        # None until first process(); then fixed real/complex until reset
        self._complex_stream: bool | None = None
        self.stats = AnalyzerStats()
        self.custom_sos: np.ndarray | None = None
        self.last_upload_error: str | None = None
        # host edge: called with (magnitude_frame (N,), frame_index) per frame
        self.on_spectrum = on_spectrum

    # ------------------------------------------------------------------
    # typed control API
    # ------------------------------------------------------------------

    def _fresh_state(self) -> StreamState:
        # the pipeline knows its own state shape (incl. hop history)
        return self.pipe.initial_state()

    def start(self):
        """0x55: begin acquisition."""
        self.running = True
        if self.stats.started_at is None:
            self.stats.started_at = time.time()

    def stop(self):
        self.running = False

    def reset(self):
        """0xFF: global reset — stream state zeroed, datapath mux to BYPASS
        (the RTL reset default). Coefficients survive reset, as the
        coefficient RAM does in hardware (``src/coeff_cdc.vhd:34-46``)."""
        self.state = self._fresh_state()
        self._complex_stream = None
        self.running = False
        self.uart_streaming = False
        self.filter_mode = FilterMode.BYPASS
        self.decoder.reset()
        self.stats.resets += 1

    def set_filter_mode(self, mode: FilterMode):
        self.filter_mode = FilterMode(mode)

    def set_comm_mode(self, mode: CommMode):
        self.comm_mode = CommMode(mode)

    def upload_filter(self, sos: np.ndarray):
        """Runtime coefficient reload (the 0xF1 path, typed form)."""
        self.pipe.upload_sos(sos)
        self.custom_sos = np.atleast_2d(np.asarray(sos, np.float64))
        self.stats.coefficient_uploads += 1
        # a successful upload supersedes any earlier rejection — stale
        # rejection text must not outlive the filter it rejected (review
        # finding)
        self.last_upload_error = None

    def upload_filter_bank(self, sos_bank: np.ndarray):
        """Per-channel coefficient reload (channels, sections, 6) — the
        multi-channel filter bank (BASELINE config 3)."""
        from tpu_sdr_torch.runtime import banks

        self.pipe.upload_sos_bank(sos_bank)
        # store the PADDED (C, S, 6) bank: checkpointable even when the
        # input was a ragged list of per-channel designs
        self.custom_sos = banks.prepare_bank(
            sos_bank, self.cfg.channels, self.cfg.n_sections
        ).astype(np.float64)
        self.stats.coefficient_uploads += 1
        self.last_upload_error = None  # see upload_filter

    # ------------------------------------------------------------------
    # wire protocol
    # ------------------------------------------------------------------

    def handle_bytes(self, data: bytes) -> list[DecodedEvent]:
        """Feed raw command bytes (the UART RX path).

        A rejected coefficient upload (unstable poles) must not abort the
        buffer: the FPGA this protocol mirrors accepts any 12 bytes, so the
        rejection is recorded (``stats.uploads_rejected`` /
        ``last_upload_error``) and the remaining commands still apply.
        """
        events = self.decoder.feed(data)
        for ev in events:
            try:
                self._apply_event(ev)
            except ValueError as e:
                if ev.kind != "coefficients":
                    raise
                self.last_upload_error = str(e)
                self.stats.uploads_rejected += 1
        return events

    def _apply_event(self, ev: DecodedEvent):
        if ev.kind == "coefficients":
            sos = designer_mod.wire_bytes_to_sos(ev.coefficients)
            self.upload_filter(sos)
            return
        if ev.kind != "command":
            return
        self.stats.commands_handled += 1
        c = ev.command
        if c == Command.START:
            self.start()
        elif c == Command.RESET:
            self.reset()
        elif c == Command.MODE_FIXED:
            self.set_filter_mode(FilterMode.FIXED)
        elif c == Command.MODE_CUSTOM:
            self.set_filter_mode(FilterMode.CUSTOM)
        elif c == Command.MODE_BYPASS:
            self.set_filter_mode(FilterMode.BYPASS)
        elif c == Command.COMM_ETH:
            self.set_comm_mode(CommMode.ETHERNET)
        elif c == Command.COMM_UART:
            self.set_comm_mode(CommMode.UART)
        elif c == Command.DATA_REQ:
            self.uart_streaming = True

    # ------------------------------------------------------------------
    # datapath
    # ------------------------------------------------------------------

    def process(self, samples, outputs: str = "magnitude"):
        """Run a frame-aligned chunk through the datapath.

        Returns the output dict (or None when not started — the FPGA ignores
        samples before 0x55), its magnitudes as a host float32 array.
        Updates carried state, counters, and pushes per-frame magnitudes to
        ``on_spectrum`` when attached. ``samples`` may be a NumPy array or a
        tensor on any device; only its shape is read here.
        """
        if not self.running:
            return None
        if torch.is_tensor(samples):
            is_complex, shape = samples.is_complex(), tuple(samples.shape)
        else:
            is_complex, shape = bool(np.iscomplexobj(samples)), np.shape(samples)
        if self._complex_stream is not None and is_complex != self._complex_stream:
            raise ValueError(
                "cannot switch between real and complex (IQ) input "
                "mid-stream; send reset (0xFF) first"
            )
        # first chunk after reset fixes the stream kind; IQ input needs the
        # re/im-stacked state. The latch (and the state swap) only commit
        # AFTER pipe.process succeeds — a rejected first chunk (bad length)
        # must not poison the stream kind and force a spurious reset
        # (review finding).
        state = self.state
        if self._complex_stream is None and is_complex:
            state = self.pipe.initial_state(batch_shape=(2,))
        out, new_state = self.pipe.process(
            samples, state, self.filter_mode, outputs
        )
        if self.mesh is not None:
            out = self.pipe.gather(out)
        self.state = new_state
        self._complex_stream = is_complex
        n_frames = shape[-1] // self.cfg.effective_hop  # frames per chunk (hop-aware)
        self.stats.samples_consumed += int(np.prod(shape))
        if "magnitude" in out:
            # one device->host copy, handed back to the caller so that no
            # consumer fetches the device buffer again; bf16 widens on the host
            mags = out["magnitude"].cpu().float().numpy()  # (C, F, N)
            out = dict(out)
            out["magnitude"] = mags
            first = self.stats.frames_produced
            self.stats.frames_produced += n_frames
            # real input: peak over the non-redundant half; IQ: full spectrum
            span = (
                mags[0, -1]
                if self._complex_stream
                else mags[0, -1][: self.cfg.fft_size // 2]
            )
            peak = int(np.argmax(span))
            self.stats.last_peak_bin = peak
            self.stats.last_peak_mag = float(span[peak])
            if self.on_spectrum is not None:
                for f in range(mags.shape[1]):
                    self.on_spectrum(mags[0, f], first + f)
        else:
            self.stats.frames_produced += n_frames
        return out

    # ------------------------------------------------------------------
    # checkpoint / resume (SURVEY.md §5.4: state is a pytree by construction)
    # ------------------------------------------------------------------

    def checkpoint(self) -> dict:
        return {
            "state": self.state.to_numpy(),
            "filter_mode": int(self.filter_mode),
            "comm_mode": int(self.comm_mode),
            "running": self.running,
            "custom_sos": None
            if self.custom_sos is None
            else self.custom_sos.tolist(),
            # a (C, S, 6) bank restores via upload_filter_bank
            "custom_is_bank": (
                self.custom_sos is not None and self.custom_sos.ndim == 3
            ),
            # an armed 0xA5 DATA_REQ stream must survive resume like every
            # other piece of command-plane state
            "uart_streaming": self.uart_streaming,
            # tri-state: None = kind not yet fixed by a first chunk. Must
            # be persisted explicitly — inferring it from the state shape
            # collapsed None to real, so a restored not-yet-streaming
            # analyzer rejected IQ input the original would have accepted
            # (review finding)
            "complex_stream": self._complex_stream,
            "stats": self.stats.as_dict(),
        }

    def restore(self, ckpt: dict):
        """Resume from ``checkpoint()``'s dict, this package's or the
        reference's (the same keys; ``convert.analyzer_checkpoint``)."""
        self.state = StreamState.from_numpy(ckpt["state"], device=self.pipe.device)
        if "complex_stream" in ckpt:
            self._complex_stream = ckpt["complex_stream"]
        else:
            # legacy checkpoints: the kind is encoded in the state shape
            # ((2, C, S, 2) = IQ) — except an untouched fresh state, which
            # means the kind was never fixed
            self._complex_stream = (
                True if self.state.sos_state.ndim == 4
                else (False if int(self.state.frame_count) > 0 else None)
            )
        self.filter_mode = FilterMode(ckpt["filter_mode"])
        self.comm_mode = CommMode(ckpt["comm_mode"])
        self.running = bool(ckpt["running"])
        self.uart_streaming = bool(ckpt.get("uart_streaming", False))
        if ckpt.get("custom_sos") is not None:
            sos = np.asarray(ckpt["custom_sos"])
            if ckpt.get("custom_is_bank", sos.ndim == 3):
                self.upload_filter_bank(sos)
            else:
                self.upload_filter(sos)
        # continue the counters (frame indices must not repeat after resume)
        saved = ckpt.get("stats")
        if saved:
            for k, v in saved.items():
                if hasattr(self.stats, k):
                    setattr(self.stats, k, v)
