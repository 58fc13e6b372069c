"""Carry constants and state from the JAX package into the port.

Every function takes the JAX package's object as a dict of NumPy arrays,
keyed by the JAX dataclass field names (or the plan dict's keys), for
example ``{f.name: np.asarray(getattr(pp, f.name)) for f in
dataclasses.fields(pp)}``, or, for the narrowband layer's states, the
JAX state's ``to_numpy()`` dict, and returns the port's object on
``device``. Values are copied bit for bit. Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_sdr_torch.kernels.biquad import BlockedSOSComposite
from tpu_sdr_torch.kernels.cuda.iir_fft import PallasSOSPlan
from tpu_sdr_torch.kernels.ddc import DDCState
from tpu_sdr_torch.kernels.demod import AGCState, DemodState, SquelchState
from tpu_sdr_torch.kernels.fastconv import FastFIRState
from tpu_sdr_torch.kernels.iqcorr import IQCorrectorState
from tpu_sdr_torch.kernels.resample import ResamplerState
from tpu_sdr_torch.kernels.stereo import StereoDecoderState
from tpu_sdr_torch.runtime.receiver import ReceiverState
from tpu_sdr_torch.runtime.state import StreamState

FFT_PLAN_KEYS = ("w1r", "w1i", "w2r", "w2i", "twr", "twi")


def _tensors(d: dict, keys, what: str, device) -> dict:
    if set(d) != set(keys):
        raise KeyError(
            f"{what}: expected keys {sorted(keys)}, got {sorted(d)}"
        )
    return {k: torch.tensor(np.asarray(d[k]), device=device) for k in keys}


def _fields(cls) -> tuple:
    return tuple(f.name for f in dataclasses.fields(cls))


def kernel_plan(d: dict, *, device="cuda") -> PallasSOSPlan:
    """A JAX ``PallasSOSPlan`` (leaves T ... twi_h) -> the port's plan."""
    return PallasSOSPlan(
        **_tensors(d, _fields(PallasSOSPlan), "PallasSOSPlan", device)
    )


def composite(d: dict, *, device="cuda") -> BlockedSOSComposite:
    """A JAX ``BlockedSOSComposite`` (T, M, P, APow, W, ALB) -> the port's."""
    return BlockedSOSComposite(
        **_tensors(d, _fields(BlockedSOSComposite), "BlockedSOSComposite", device)
    )


def bank(d: dict, *, device="cuda") -> dict:
    """A JAX filter bank {"op": ..., "pp": ... or None}, each leaf dict as
    above, -> the port's bank. A per-channel bank (``upload_sos_bank``:
    op leaves with a leading channel axis, the fixed bank's plan) carries
    over the same way."""
    return {
        "op": composite(d["op"], device=device),
        "pp": None if d["pp"] is None else kernel_plan(d["pp"], device=device),
    }


def fft_plan(d: dict, *, device="cuda") -> dict:
    """A JAX ``fft.plan_constants`` dict -> the port's plan dict."""
    return _tensors(d, FFT_PLAN_KEYS, "FFT plan", device)


def window(w: np.ndarray, *, device="cuda") -> torch.Tensor:
    """JAX window coefficients (N,) -> a tensor on ``device``."""
    return torch.tensor(np.asarray(w), device=device)


def state(d: dict, *, device="cuda") -> StreamState:
    """A JAX ``StreamState.to_numpy()`` checkpoint -> the port's state,
    with the carried ``history`` of hop < fft_size where it has one."""
    return StreamState.from_numpy(d, device=device)


ANALYZER_KEYS = ("state", "filter_mode", "comm_mode", "running")


def analyzer_checkpoint(d: dict) -> dict:
    """A JAX ``SpectrumAnalyzer.checkpoint()`` dict -> one that the port's
    ``SpectrumAnalyzer.restore`` takes: the same keys (the command plane,
    the coefficients, the stream-kind latch, the stats), the stream
    state's arrays copied as NumPy."""
    missing = [k for k in ANALYZER_KEYS if k not in d]
    if missing:
        raise KeyError(f"analyzer checkpoint: missing keys {missing}")
    st = d["state"]
    return {**d, "state": {k: None if v is None else np.array(v) for k, v in st.items()}}


# ------------------------------------------------ the narrowband layer


def ddc_state(d: dict, *, device="cuda") -> DDCState:
    """A JAX ``DDCState.to_numpy()`` checkpoint -> the port's state."""
    return DDCState.from_numpy(d, device=device)


def demod_state(d: dict, *, device="cuda") -> DemodState:
    """A JAX ``DemodState.to_numpy()`` checkpoint -> the port's state."""
    return DemodState.from_numpy(d, device=device)


def agc_state(d: dict, *, device="cuda") -> AGCState:
    """A JAX ``AGCState.to_numpy()`` checkpoint -> the port's state."""
    return AGCState.from_numpy(d, device=device)


def squelch_state(d: dict, *, device="cuda") -> SquelchState:
    """A JAX ``SquelchState.to_numpy()`` checkpoint -> the port's state."""
    return SquelchState.from_numpy(d, device=device)


def resampler_state(d: dict, *, device="cuda") -> ResamplerState:
    """A JAX ``ResamplerState.to_numpy()`` checkpoint -> the port's state."""
    return ResamplerState.from_numpy(d, device=device)


def stereo_state(d: dict, *, device="cuda") -> StereoDecoderState:
    """A JAX ``StereoDecoderState.to_numpy()`` checkpoint -> the port's."""
    return StereoDecoderState.from_numpy(d, device=device)


def receiver_state(d: dict, *, device="cuda") -> ReceiverState:
    """A JAX ``ReceiverState.to_numpy()`` checkpoint (nested dicts) -> the
    port's state."""
    return ReceiverState.from_numpy(d, device=device)


def channelizer_state(history: np.ndarray, *, device="cuda") -> torch.Tensor:
    """A JAX ``Channelizer`` history (..., (taps-1)*m) -> a tensor."""
    return torch.tensor(np.asarray(history), device=device)


def fir(h: np.ndarray) -> np.ndarray:
    """A JAX FIR design or prototype (``DDC.fir``, ``Resampler.fir``,
    ``Channelizer.prototype``) as the float64 array the port's ``fir=``
    arguments take."""
    return np.array(h, dtype=np.float64)


def dft(cos: np.ndarray, sin: np.ndarray, *, device="cuda") -> tuple:
    """JAX ``pfb.dft_matrices`` (cos, sin) -> two tensors."""
    return (torch.tensor(np.asarray(cos), device=device),
            torch.tensor(np.asarray(sin), device=device))


# ------------------------------------------------ the receiver extensions


def fastfir_state(d: dict, *, device="cuda") -> FastFIRState:
    """A JAX ``FastFIRState.to_numpy()`` checkpoint -> the port's state."""
    return FastFIRState.from_numpy(d, device=device)


def iqcorr_state(d: dict, *, device="cuda") -> IQCorrectorState:
    """A JAX ``IQCorrectorState.to_numpy()`` checkpoint -> the port's state."""
    return IQCorrectorState.from_numpy(d, device=device)
