"""The block-stream runtime: frames in, spectra out, state carried.

The counterpart of ``tpu_sdr.runtime.stream``. Datapath order, per frame,
with frame-aligned hop (hop == fft_size):

    samples -> Hann window -> {bypass | fixed IIR12 | custom IIR12}
            -> 16K four-step DFT -> magnitude (+ optional outputs)

With hop < fft_size (``_process_stream_hop``) the IIR runs on the raw
continuous stream, and overlapped frames of it, with the carried history,
are windowed and transformed (the STFT order).

Magnitude output at the 128x128 geometry goes through the spectrum kernels
(``kernels/cuda/iir_fft``): BYPASS windows inside the kernel; FIXED/CUSTOM
run the window and the composite IIR as matrix products first and call the
kernel with ``apply_window=False`` (the hybrid structure, every tier's
default), or, with ``fused_two_pass`` at the f32/f32max tiers, run the IIR
inside two kernels (``iir_summaries``, then ``spectrum_from_state`` from
each frame's entry state) with only the 12-float frame chain between them.
A per-channel CUSTOM bank (``upload_sos_bank``) always takes the hybrid
branch. Complex (IQ) input runs as stacked re/im planes
(``process_stream_complex``, kernel ``spectrum_mag_complex``). Other shapes
and outputs take the plain four-step path.

Precision: every matrix product of this module runs in IEEE fp32, at every
tier. The pipeline checks that PyTorch's float32 matmul precision is
"highest" before each dispatch instead of relying on it.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sdr_torch.control import golden
from tpu_sdr_torch.core.config import FilterMode, PipelineConfig
from tpu_sdr_torch.core.halo import left_halo
from tpu_sdr_torch.core.spans import span
from tpu_sdr_torch.kernels import biquad, fft, magnitude, window
from tpu_sdr_torch.kernels.cuda import iir_fft
from tpu_sdr_torch.runtime import banks
from tpu_sdr_torch.runtime.state import StreamState

_MODE_TO_INDEX = {FilterMode.BYPASS: 0, FilterMode.FIXED: 1, FilterMode.CUSTOM: 2}


def _kernel_out_dtype(cfg: PipelineConfig) -> str:
    """Magnitude store dtype: bf16 when the bf16 tier opts into bf16_io."""
    return "bfloat16" if cfg.dtype == "bf16" and cfg.bf16_io else "float32"


def _maybe_bf16_y(cfg: PipelineConfig, y: torch.Tensor) -> torch.Tensor:
    """bf16_io: the IIR output reaches the spectrum kernel as bf16."""
    if cfg.dtype == "bf16" and cfg.bf16_io:
        return y.to(torch.bfloat16)
    return y


def _finalize_bf16_io(cfg: PipelineConfig, out: dict) -> dict:
    """bf16_io dtype contract on the plain path: magnitudes come back
    bfloat16 (the fp32 results rounded once), as the kernel stores them, so
    one config never yields two output dtypes. Other outputs stay fp32."""
    if cfg.dtype == "bf16" and cfg.bf16_io and "magnitude" in out:
        out["magnitude"] = out["magnitude"].to(torch.bfloat16)
    return out


def _decode_outputs(cfg: PipelineConfig, fr, fi, outputs: str) -> dict:
    """Spectrum decode of the plain path: one place owns the outputs
    vocabulary and the bf16_io finalize."""
    out = {}
    if outputs in ("magnitude", "all"):
        out["magnitude"] = magnitude.magnitude(fr, fi)
    if outputs in ("complex", "all"):
        out["re"], out["im"] = fr, fi
    if outputs in ("power", "all"):
        out["power"] = magnitude.power(fr, fi)
    if outputs in ("phase", "all"):
        out["phase"] = magnitude.phase(fr, fi)
    return _finalize_bf16_io(cfg, out)


def check_matmul_precision(expected: str):
    """Raise unless float32 matrix products run at the ``expected``
    PyTorch precision with TF32 off."""
    got = torch.get_float32_matmul_precision()
    if got != expected or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            f"the spectrum pipeline computes in IEEE fp32 and needs "
            f"torch.get_float32_matmul_precision() == {expected!r} and "
            f"torch.backends.cuda.matmul.allow_tf32 == False; got {got!r} "
            f"and {torch.backends.cuda.matmul.allow_tf32}"
        )


def _run_iir(op, xw: torch.Tensor, zi: torch.Tensor, cfg: PipelineConfig, time_axis=None):
    """The composite cascade, shared or per-channel bank (leading channel
    axis on the leaves; under channel sharding the shard's rows of a bank
    of ``cfg.channels``), optionally time-sharded over ``time_axis``."""
    if op.T.ndim == 3:
        return biquad.sosfilt_blocked_composite_bank(
            op, xw, zi, time_axis=time_axis, channels=cfg.channels
        )
    return biquad.sosfilt_blocked_composite(op, xw, zi, time_axis=time_axis)


def process_stream(
    x: torch.Tensor,
    state: StreamState,
    bank_fixed: dict,
    bank_custom: dict,
    hann_w: torch.Tensor,
    plan: dict,
    *,
    mode_index: int,
    cfg: PipelineConfig,
    outputs: str = "magnitude",
    time_axis=None,
):
    """Process a stream chunk x (..., channels, T), T a multiple of fft_size.

    (x, state, banks) -> (out dict, new state). ``mode_index``: 0 bypass /
    1 fixed / 2 custom. Each bank is a dict {"op": BlockedSOSComposite,
    "pp": PallasSOSPlan or None}; a per-channel bank's op has a leading
    channel axis. hop < fft_size runs ``_process_stream_hop``.

    ``time_axis`` (a ``shard.mesh.MeshAxis``): x is this shard's run of a
    stream sharded over that axis. The IIR state chain then all-gathers
    per-frame summaries and stays bit-identical to the unsharded run; the
    counters account for the global stream (``shard/pipeline.py``).
    """
    n = cfg.fft_size
    if cfg.effective_hop != n:
        return _process_stream_hop(
            x, state, bank_fixed, bank_custom, hann_w, plan,
            mode_index=mode_index, cfg=cfg, outputs=outputs, time_axis=time_axis,
        )
    t = x.shape[-1]
    n_frames = t // n
    lead = x.shape[:-1]  # (..., channels)
    t_global = t if time_axis is None else t * time_axis.size

    if cfg.pallas_geometry_ok() and outputs == "magnitude":
        bank = bank_fixed if mode_index != 2 else bank_custom
        pp = bank["pp"]
        flat = x.reshape(-1, n)
        # Entry states of the bypass form, which ignores them.
        zs = lambda: torch.zeros(
            (flat.shape[0], pp.state_dim), dtype=torch.float32, device=x.device
        )
        # The kernel computes in IEEE fp32 at every tier, so the reference's
        # per-tier precision, karatsuba and flat_emit keywords keep their
        # defaults here; only the store dtype differs by tier.
        kw = dict(bypass=True, out_dtype=_kernel_out_dtype(cfg))
        banked = mode_index == 2 and bank["op"].T.ndim == 3
        if mode_index == 0:
            mag = iir_fft.spectrum_from_state(flat, zs(), pp, **kw)
            zf = state.sos_state
        elif cfg.dtype in ("f32max", "f32") and cfg.fused_two_pass and not banked:
            # The fused two-pass pipeline: each frame's zero-state end state
            # from the summaries kernel, the 12-float frame chain, then the
            # IIR from each frame's entry state inside the spectrum kernel.
            # A per-channel bank takes the hybrid branch: the kernels hold
            # one shared cascade (``pp``).
            m = pp.state_dim
            w = iir_fft.iir_summaries(flat, pp).reshape(*lead, n_frames, m)
            z_starts, z_final = biquad.frame_chain(
                pp, state.sos_state.reshape(*lead, m), w, time_axis
            )
            mag = iir_fft.spectrum_from_state(flat, z_starts.reshape(-1, m), pp)
            zf = z_final.reshape(*lead, m // 2, 2)
        else:
            xw = (x.reshape(*lead, n_frames, n) * hann_w).reshape(*lead, t)
            y, zf = _run_iir(bank["op"], xw, state.sos_state, cfg, time_axis)
            mag = iir_fft.spectrum_from_state(
                _maybe_bf16_y(cfg, y).reshape(-1, n), zs(), pp,
                apply_window=False, **kw,
            )
        out = {"magnitude": mag.reshape(*lead, n_frames, n)}
    else:
        # 1. Window over the frame-aligned stream.
        xw = (x.reshape(*lead, n_frames, n) * hann_w).reshape(*lead, t)
        # 2. IIR filter bank (or bypass).
        if mode_index == 0:
            y = xw
            zf = state.sos_state
        else:
            op = (bank_fixed if mode_index == 1 else bank_custom)["op"]
            y, zf = _run_iir(op, xw, state.sos_state, cfg, time_axis)
        # 3. Per-frame DFT of the real frames + output decode.
        frames = y.reshape(*lead, n_frames, n)
        fr, fi = fft.fft_4step(frames, None, plan)
        out = _decode_outputs(cfg, fr, fi, outputs)

    new_state = StreamState(
        sos_state=zf,
        window_phase=(state.window_phase + t_global) % n,
        frame_count=state.frame_count + t_global // n,
    )
    return out, new_state


def _process_stream_hop(
    x, state, bank_fixed, bank_custom, hann_w, plan, *, mode_index, cfg, outputs,
    time_axis=None,
):
    """Overlapped (STFT) framing: hop < fft_size, with carried history.

    The IIR runs on the raw continuous stream; frames of fft_size samples,
    hop apart, are cut from [history, y] and windowed and transformed. The
    state carries the last (fft_size - hop) filtered samples, so chunked
    streaming equals a one-shot run bit for bit. Magnitude output at the
    128x128 geometry takes the spectrum kernel with the window inside it
    (the raw frames, at every tier); other outputs the plain path.

    Under time sharding (``time_axis``) the sharded IIR's overlap tail goes
    to the right-hand neighbour (``core.halo.left_halo``), shard 0 splices
    in the carried history, and the new history is the last shard's tail,
    replicated.
    """
    n = cfg.fft_size
    hop = cfg.effective_hop
    t = x.shape[-1]
    lead = x.shape[:-1]
    n_frames = t // hop
    n_shards = 1 if time_axis is None else time_axis.size

    # 1. IIR on the raw continuous stream.
    if mode_index == 0:
        y, zf = x, state.sos_state
    else:
        op = (bank_fixed if mode_index == 1 else bank_custom)["op"]
        y, zf = _run_iir(op, x, state.sos_state, cfg, time_axis)

    # 2. Overlapped frames from the left context + this chunk.
    if time_axis is None:
        ext = torch.cat([state.history, y], dim=-1)  # (..., n - hop + t)
        new_history = ext[..., t:].contiguous()
    else:
        tail = y[..., t - (n - hop) :].contiguous()
        left, new_history = left_halo(tail, state.history, time_axis)
        ext = torch.cat([left, y], dim=-1)
    frames = ext.unfold(-1, n, hop)  # (..., F, n), a view

    # 3. Window + DFT + decode.
    if cfg.pallas_geometry_ok() and outputs == "magnitude":
        pp = (bank_fixed if mode_index != 2 else bank_custom)["pp"]
        flat = frames.reshape(-1, n)
        zs = torch.zeros((flat.shape[0], pp.state_dim), dtype=torch.float32, device=x.device)
        mag = iir_fft.spectrum_from_state(
            flat, zs, pp, bypass=True, apply_window=True,
            out_dtype=_kernel_out_dtype(cfg),
        )
        out = {"magnitude": mag.reshape(*lead, n_frames, n)}
    else:
        fr, fi = fft.fft_4step(frames * hann_w, None, plan)
        out = _decode_outputs(cfg, fr, fi, outputs)

    new_state = StreamState(
        sos_state=zf,
        window_phase=(state.window_phase + t * n_shards) % n,
        frame_count=state.frame_count + n_frames * n_shards,
        history=new_history,
    )
    return out, new_state


def process_stream_complex(
    xs: torch.Tensor,
    state: StreamState,
    bank_fixed: dict,
    bank_custom: dict,
    hann_w: torch.Tensor,
    plan: dict,
    *,
    mode_index: int,
    cfg: PipelineConfig,
    outputs: str = "magnitude",
    time_axis=None,
):
    """Complex (IQ) stream: xs (2, ..., channels, T) stacked re/im planes.

    The window and the real-coefficient IIR act on re and im independently,
    so they run on the stacked planes; the state carries a leading 2-axis
    (``initial_state(batch_shape=(2,))``). Magnitude output at the 128x128
    geometry takes the complex spectrum kernel (``spectrum_mag_complex``);
    other outputs combine the plain path's spectra of the two planes by DFT
    linearity, X = FFT(re) + i*FFT(im). ``time_axis`` as in
    ``process_stream``.
    """
    n = cfg.fft_size
    if not (cfg.pallas_geometry_ok() and outputs == "magnitude" and cfg.effective_hop == n):
        out, new_state = process_stream(
            xs, state, bank_fixed, bank_custom, hann_w, plan,
            mode_index=mode_index, cfg=cfg, outputs="complex", time_axis=time_axis,
        )
        fr = out["re"][0] - out["im"][1]
        fi = out["im"][0] + out["re"][1]
        # The counters derive from T, so the stacked planes advance the
        # stream once: new_state is already right.
        return _decode_outputs(cfg, fr, fi, outputs), new_state
    t = xs.shape[-1]
    n_frames = t // n
    t_global = t if time_axis is None else t * time_axis.size
    lead = xs.shape[1:-1]  # (..., channels)
    bank = bank_fixed if mode_index != 2 else bank_custom
    if mode_index == 0:
        y, zf, apply_window = xs, state.sos_state, True
    else:
        xw = (xs.reshape(2, *lead, n_frames, n) * hann_w).reshape(2, *lead, t)
        y, zf = _run_iir(bank["op"], xw, state.sos_state, cfg, time_axis)
        apply_window = False
    yr, yi = y[0], y[1]
    # bf16_io: only the filtered planes reach the kernel as bf16. In BYPASS
    # the kernel windows first, and rounding the raw input before that
    # multiply would break "fp32 results rounded once on store".
    if not apply_window:
        yr, yi = _maybe_bf16_y(cfg, yr), _maybe_bf16_y(cfg, yi)
    mag = iir_fft.spectrum_mag_complex(
        yr.reshape(-1, n), yi.reshape(-1, n), bank["pp"],
        apply_window=apply_window, out_dtype=_kernel_out_dtype(cfg),
    )
    new_state = StreamState(
        sos_state=zf,
        window_phase=(state.window_phase + t_global) % n,
        frame_count=state.frame_count + t_global // n,
        history=state.history,
    )
    return {"magnitude": mag.reshape(*lead, n_frames, n)}, new_state


class SpectrumPipeline:
    """The single-device engine: owns the device constants and the banks.

    ``device`` defaults to "cuda"; construction raises when CUDA is absent
    unless the caller asks for the CPU (``device="cpu"``), where the
    spectrum kernel's plain PyTorch version runs instead. Under a profiler
    each ``process`` / ``process_planes`` call is a ``tpu_sdr.dispatch``
    span (``core.spans``).
    """

    def __init__(self, cfg: PipelineConfig | None = None, device=None):
        self.cfg = cfg or PipelineConfig()
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SpectrumPipeline: no CUDA device is available; pass "
                "device='cpu' to run the plain versions on the CPU"
            )
        # Every tier computes in IEEE fp32 in this port (tensor-core tiers
        # are later work): the precision that process() checks for.
        self.matmul_precision = "highest"
        self.hann_w = window.hann_coefficients(
            self.cfg.fft_size, self.cfg.rtl_faithful_window, device=self.device
        )
        self.plan = fft.plan_constants(
            self.cfg.fft_n1, self.cfg.fft_n2, device=self.device
        )
        # The custom bank boots as identity until coefficients are uploaded.
        self.bank_fixed = self._build_bank(golden.fixed_filter_sos())
        self.bank_custom = self._build_bank(
            biquad.sos_identity(self.cfg.n_sections)
        )

    def _build_bank(self, sos: np.ndarray) -> dict:
        return banks.build_bank(self.cfg, self.hann_w, self.plan, sos)

    def initial_state(self, batch_shape=()) -> StreamState:
        return StreamState.initial(
            self.cfg.channels,
            self.cfg.n_sections,
            batch_shape,
            history_len=self.cfg.fft_size - self.cfg.effective_hop,
            device=self.device,
        )

    def upload_sos(self, sos: np.ndarray):
        """Runtime coefficient reload of the custom bank.

        Unstable sections (poles on or outside the unit circle) are rejected.
        """
        self.bank_custom = self._build_bank(
            banks.prepare_sos(sos, self.cfg.n_sections)
        )

    def upload_sos_bank(self, sos_bank):
        """Per-channel coefficient reload of the custom bank.

        ``sos_bank``: (channels, sections, 6) array, or a list of
        per-channel SOS arrays (orders may differ; each is padded to the
        engine depth), stability-validated per channel. The bank keeps the
        fixed bank's kernel plan for the spectrum after the IIR (a banked
        CUSTOM dispatch takes the hybrid branch).
        """
        padded = banks.prepare_bank(sos_bank, self.cfg.channels, self.cfg.n_sections)
        op = banks.build_channel_bank_op(self.cfg, padded, self.device)
        self.bank_custom = {"op": op, "pp": self.bank_fixed["pp"]}

    def _check_iq_state(self, state: StreamState):
        expected = (2, self.cfg.channels, self.cfg.n_sections, 2)
        if tuple(state.sos_state.shape) != expected:
            raise ValueError(
                "complex input needs a re/im-stacked state of shape "
                f"{expected}, got {tuple(state.sos_state.shape)}: create it "
                "with initial_state(batch_shape=(2,))"
            )

    def _check_length(self, t: int):
        if t % self.cfg.fft_size:
            raise ValueError(
                f"stream chunk length {t} must be a multiple of "
                f"fft_size={self.cfg.fft_size} (frame-aligned dispatch)"
            )

    def _run(self, x, state, mode, outputs, complex_input: bool):
        self._check_length(x.shape[-1])
        check_matmul_precision(self.matmul_precision)
        fn = process_stream_complex if complex_input else process_stream
        return fn(
            x, state, self.bank_fixed, self.bank_custom, self.hann_w, self.plan,
            mode_index=_MODE_TO_INDEX[FilterMode(mode)], cfg=self.cfg,
            outputs=outputs,
        )

    def process(
        self,
        x,
        state: StreamState,
        mode: FilterMode = FilterMode.BYPASS,
        outputs: str = "magnitude",
    ):
        """x: (..., channels, T) or (T,) -> (out dict, new_state).

        x may be a NumPy array or a tensor; real input is moved to the
        pipeline's device as float32. Complex (IQ) input is accepted with a
        state from ``initial_state(batch_shape=(2,))``: it is moved to the
        device as complex64 and split there into stacked re/im planes.
        """
        with span("tpu_sdr.dispatch"):
            complex_input = x.is_complex() if torch.is_tensor(x) else np.iscomplexobj(x)
            if complex_input:
                self._check_iq_state(state)
                xc = torch.as_tensor(x).to(self.device, torch.complex64)
                if xc.ndim == 1:
                    xc = xc[None, :]
                x = torch.stack([xc.real, xc.imag])
            else:
                x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
                if x.ndim == 1:
                    x = x[None, :]
            return self._run(x, state, mode, outputs, complex_input)

    def process_planes(
        self,
        xs,
        state: StreamState,
        mode: FilterMode = FilterMode.BYPASS,
        outputs: str = "magnitude",
    ):
        """Complex (IQ) input as pre-split planes: xs (2, ..., T) float32,
        re then im, e.g. a device-resident chunk split once; the output keeps
        xs's axes between the 2 and T ((2, T) gives (frames, N)). Takes a
        re/im-stacked state (leading axis 2), e.g.
        ``initial_state(batch_shape=(2,))``; as in the reference, only that
        leading axis is checked."""
        with span("tpu_sdr.dispatch"):
            xs = torch.as_tensor(xs, dtype=torch.float32, device=self.device)
            if xs.ndim < 2 or xs.shape[0] != 2:
                raise ValueError(
                    f"xs must stack re/im as a leading 2-axis, got {tuple(xs.shape)}"
                )
            if state.sos_state.shape[:1] != (2,):
                raise ValueError(
                    "plane-stacked input needs the re/im-stacked state: create it "
                    "with initial_state(batch_shape=(2,))"
                )
            return self._run(xs, state, mode, outputs, complex_input=True)
