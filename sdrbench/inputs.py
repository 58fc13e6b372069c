"""The general traffic generator: designs, input chunks and check samples,
all drawn from ``--seed``.

A chunk is ``frames_per_chunk`` frames of every channel. The stream is a
ring of ``ring_chunks`` distinct chunks made on the device at set-up: chunk
k of the stream is ring slot k mod R, so any stretch of the stream can be
rebuilt from the ring. Each channel carries two tones and white noise
(real input: sines in [0, fs/2); IQ: complex exponentials in [-fs/2, fs/2)),
the tones running on through the ring's slots.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sps

# Independent streams of random numbers drawn from one seed.
_DESIGNS, _TONES, _NOISE, _CHECK = 1, 2, 3, 4



def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of ``seed`` (any whole number)."""
    return np.random.default_rng([seed % 2**64, stream])


def make_designs(cfg: dict, seed: int) -> np.ndarray | None:
    """(channels, sections, 6) float64 SOS, one design a channel, or None
    for a configuration without designs. The mix's types in equal shares
    in an order drawn from the seed; band edges drawn from the
    configuration's ranges."""
    d = cfg.get("designs")
    if d is None:
        return None
    r = rng(seed, _DESIGNS)
    channels, nyq = cfg["channels"], cfg["sample_rate_hz"] / 2
    if d["kind"] != "butterworth":
        raise ValueError(f"designs of kind {d['kind']!r}: only butterworth is drawn")
    kinds = r.permutation([d["mix"][i % len(d["mix"])] for i in range(channels)])
    design = lambda order, wn, btype: sps.butter(order, wn, btype=btype, output="sos")
    bank = []
    for btype in kinds:
        if btype == "bandpass":
            centre = r.uniform(*d["bandpass_center_hz"])
            half = r.uniform(*d["bandpass_width_hz"]) / 2
            sos = design(d["bandpass_order"], [(centre - half) / nyq, (centre + half) / nyq], btype)
        else:
            sos = design(d[f"{btype}_order"], r.uniform(*d["cutoff_hz"]) / nyq, btype)
        if sos.shape[0] != cfg["n_sections"]:
            raise ValueError(f"a {btype} design has {sos.shape[0]} sections, the configuration {cfg['n_sections']}")
        bank.append(sos)
    return np.stack(bank)


def make_ring(cfg: dict, traffic: dict, seed: int, device):
    """The ring of input chunks on ``device``, float32: (R, C, T) for real
    input, (R, 2, C, T) re/im planes for IQ, T = frames_per_chunk * N.
    Built slot by slot in a few large calls."""
    import torch

    channels, n = cfg["channels"], cfg["fft_size"]
    t = traffic["frames_per_chunk"] * n
    slots = traffic["ring_chunks"]
    iq = cfg["input"] == "complex_planes"
    sig = traffic["signal"]
    r = rng(seed, _TONES)
    freqs = r.uniform(-0.5 if iq else 0.0, 0.5, size=(2, channels))  # cycles a sample
    amps = r.uniform(*sig["tone_amplitude"], size=(2, channels))
    phases = r.uniform(0.0, 1.0, size=(2, channels))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng(seed, _NOISE).integers(0, 2**63 - 1)))
    as_col = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)[:, None]
    ring = torch.empty((slots, 2, channels, t) if iq else (slots, channels, t),
                       dtype=torch.float32, device=device)
    n_idx = torch.arange(t, dtype=torch.float64, device=device)
    for s in range(slots):
        planes = torch.zeros((2 if iq else 1, channels, t), dtype=torch.float64, device=device)
        for k in range(2):
            angle = torch.remainder(as_col(freqs[k]) * (n_idx + s * t) + as_col(phases[k]), 1.0)
            angle *= 2 * np.pi
            if iq:
                planes[0] += as_col(amps[k]) * torch.cos(angle)
                planes[1] += as_col(amps[k]) * torch.sin(angle)
            else:
                planes[0] += as_col(amps[k]) * torch.sin(angle)
            del angle
        noise = torch.randn(planes.shape, generator=gen, dtype=torch.float32, device=device)
        ring[s] = (planes.to(torch.float32) + sig["noise_rms"] * noise).reshape(ring.shape[1:])
        del planes, noise
    return ring


def check_sample(cell_traffic: dict, channels: int, seed: int) -> tuple[list[float], np.ndarray]:
    """Where in the window the compared chunks are taken (sorted fractions
    of it; the window's last chunk is compared besides) and which channels
    of each are compared (sorted)."""
    r = rng(seed, _CHECK)
    c = cell_traffic["check"]
    fractions = sorted(r.uniform(0.0, 1.0, size=c["chunks"]).tolist())
    picked = np.sort(r.choice(channels, size=min(c["channels"], channels), replace=False))
    return fractions, picked
