"""Carry constants and state from the JAX package into the port.

Every function takes the JAX package's object as a dict of NumPy arrays,
keyed by the JAX dataclass field names (or the plan dict's keys), for
example ``{f.name: np.asarray(getattr(pp, f.name)) for f in
dataclasses.fields(pp)}``, and returns the port's object on ``device``.
Values are copied bit for bit. Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_sdr_torch.kernels.biquad import BlockedSOSComposite
from tpu_sdr_torch.kernels.cuda.iir_fft import PallasSOSPlan
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
    above, -> the port's bank."""
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
    """A JAX ``StreamState.to_numpy()`` checkpoint -> the port's state."""
    return StreamState.from_numpy(d, device=device)
