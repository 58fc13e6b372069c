"""The sharded streaming modules' cases (channelizer, Welch PSD, FastFIR,
DDC, DDC bank, scanner), run in every rank of a 4-rank Gloo group
(``torch_shard_harness``); ``tests/test_torch_shard_modules.py`` holds their
results against the single-device port and the JAX package.

Imports ``tpu_sdr_torch``, numpy and scipy only. Each ``run_*`` function
drives one engine, sharded or single-device (``gather`` assembles a sharded
engine's blocks), on seeded inputs, and returns NumPy copies.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sps

from tpu_sdr_torch.kernels.ddc import DDC, DDCBank
from tpu_sdr_torch.kernels.fastconv import FastFIR
from tpu_sdr_torch.kernels.pfb import Channelizer
from tpu_sdr_torch.runtime.psd import WelchPSD
from tpu_sdr_torch.runtime.scanner import SpectrumScanner
from tpu_sdr_torch.shard import (
    ShardedChannelizer,
    ShardedDDC,
    ShardedDDCBank,
    ShardedFastFIR,
    ShardedWelchPSD,
    make_sdr_mesh,
)

MESHES = [(1, 2), (2, 1), (2, 2), (1, 4), (4, 1)]
M, P, FS = 128, 8, 1e6
CENTERS = [77e3, -150e3, 313_131.5, 42e3, 250e3, -321e3, 111e3, 9e3]


def rand(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def tones(freqs_amps, t_len: int, fs: float = FS, noise: float = 1e-4, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = np.arange(t_len)
    x = noise * rng.standard_normal(t_len)
    for f, a in freqs_amps:
        x = x + a * np.cos(2 * np.pi * f * n / fs + rng.uniform(0, 2 * np.pi))
    return x.astype(np.float32)


def npy(v):
    """NumPy copies of a result: tensors, dicts of them, state objects."""
    if isinstance(v, dict):
        return {k: npy(x) for k, x in v.items()}
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    if hasattr(v, "__array__"):
        return np.asarray(v)
    if hasattr(v, "__dict__"):
        return {k: npy(x) for k, x in vars(v).items()}
    return v


def _ident(v):
    return v


def channelizer(use_pallas: bool = False, device="cpu"):
    return Channelizer(m=M, taps=P, sample_rate=FS, use_pallas=use_pallas, device=device)


def run_channelizer(eng, c_ax: int, gather=_ident):
    """Real input (2*c_ax channels, 64*M), then IQ planes, one dispatch each."""
    c = 2 * c_ax
    x = rand((c, 64 * M), 11)
    out, st = eng.process(x, eng.initial_state((c,)))
    xs = rand((2, c, 32 * M), 12)
    out_iq, st_iq = eng.process_planes(xs, eng.initial_state((2, c)))
    return npy({"real": gather(out), "state": st, "iq": gather(out_iq), "iq_state": st_iq})


def run_channelizer_chunks(eng, gather=_ident):
    x = rand((1, 128 * M), 13)
    st, parts = eng.initial_state((1,)), []
    for i in range(2):
        o, st = eng.process(x[:, i * 64 * M : (i + 1) * 64 * M], st)
        parts.append(npy(gather(o))["re"])
    return {"re": np.concatenate(parts, axis=-2), "state": npy(st)}


def run_welch(eng, noverlap: int, gather=_ident):
    x = rand((4, 16 * 512), 21 + noverlap)
    xs = rand((2, 4, 16 * 512), 22 + noverlap)
    if gather is _ident:  # the single-device estimator takes planes apart
        return npy({"real": eng.compute(x), "iq": eng.compute_iq(xs[0], xs[1])})
    return npy({"real": gather(eng.compute(x)), "iq": gather(eng.compute_iq(xs))})


def fastfir(kind: str, device="cpu"):
    if kind == "complex":
        h = sps.firwin(201, 0.2) * np.exp(2j * np.pi * 0.15 * np.arange(201))
        return FastFIR(h, nfft=2048, block=1024, device=device)
    return FastFIR(sps.firwin(129, 0.3 if kind == "real" else 0.4), nfft=1024, block=512,
                   device=device)


def run_fastfir(eng, c_ax: int, t_ax: int, gather=_ident):
    c = 2 * c_ax
    x = rand((c, t_ax * 2 * 512), 31)
    out, st = eng.process(x, eng.initial_state((c,)))
    return npy({"out": gather(out), "state": st})


def run_fastfir_iq(eng, gather=_ident):
    planes = rand((2, 2, 4 * 1024), 32)
    out, st = eng.process_planes(planes, eng.initial_state((2,)))
    return npy({"out": gather(out), "state": st})


def run_fastfir_chunks(eng, gran: int, gather=_ident):
    x = rand((2, 2 * gran), 33)
    st, parts = eng.initial_state((2,)), []
    for i in range(2):
        o, st = eng.process(x[..., i * gran : (i + 1) * gran], st)
        parts.append(npy(gather(o)))
    return {"out": np.concatenate(parts, -1), "state": npy(st)}


def ddc(device="cpu"):
    return DDC(fs=1e6, center_hz=123_456.789, decimation=8, device=device)


def run_ddc(eng, gather=_ident):
    """Real (4, 64*8) one dispatch; IQ planes over two carried chunks."""
    x = rand((4, 64 * 8), 41)
    out, st = eng.process(x, eng.initial_state((4,)))
    xs = rand((2, 4, 64 * 8), 42)
    g1, s1 = eng.process_planes(xs, eng.initial_state((4,)))
    g2, s2 = eng.process_planes(xs, s1)
    return npy({"real": gather(out), "state": st, "iq1": gather(g1), "iq2": gather(g2),
                "iq_state": s2})


def ddc_bank(device="cpu"):
    return DDCBank(fs=1e6, centers_hz=CENTERS, decimation=8, device=device)


def run_ddc_bank(eng, gather=_ident):
    """A real stream; IQ planes over two chunks with a retune between."""
    x = rand(128 * 8, 51)
    out, st = eng.process(x, eng.initial_state())
    xs = rand((2, 128 * 8), 52)
    g1, s1 = eng.process_planes(xs, eng.initial_state())
    eng.retune([c + 1000.0 for c in CENTERS])
    g2, s2 = eng.process_planes(xs, s1)
    return npy({"real": gather(out), "state": st, "iq1": gather(g1), "iq2": gather(g2),
                "iq_state": s2})


SCAN_KW = dict(channel_bw=25e3, k_per_dispatch=8, taps_per_phase=8)


def scan_input():
    return tones([(137.5e3, 0.4), (362.5e3, 0.02)], 131072)


def run_scan(sc):
    res = sc.scan(scan_input())
    return {"power": res.power, "occupied": res.occupied, "floor": res.noise_floor_db,
            "hits": [h["center_hz"] for h in res.hits]}


def _each_mesh(fn, meshes=MESHES):
    res = {}
    for shape in meshes:
        mesh = make_sdr_mesh(*shape, devices="cpu")
        if mesh.member:
            res[shape] = fn(mesh, *shape)
    return res


def channelizer_meshes():
    def run(mesh, c, t):
        sh = ShardedChannelizer(channelizer(), mesh)
        return run_channelizer(sh, c, sh.gather)

    return _each_mesh(run)


def channelizer_pallas():
    """use_pallas=True: the pfb_fold_dft kernel's path (its plain version
    on the CPU) in every rank."""
    def run(mesh, c, t):
        sh = ShardedChannelizer(channelizer(use_pallas=True), mesh)
        return run_channelizer(sh, c, sh.gather)

    return _each_mesh(run, [(2, 2), (1, 4)])


def channelizer_chunks_and_validation():
    mesh = make_sdr_mesh(1, 4, devices="cpu")
    sh = ShardedChannelizer(channelizer(), mesh)
    res = {"chunks": run_channelizer_chunks(sh, sh.gather)}
    try:
        sh.process(np.zeros((1, 4 * M), np.float32), sh.initial_state((1,)))
    except ValueError as e:
        res["halo"] = str(e)
    return res


def welch_meshes():
    def run(mesh, c, t):
        res = {}
        for nov in (0, 256):
            sh = ShardedWelchPSD(WelchPSD(fs=1e6, nperseg=512, noverlap=nov, device="cpu"), mesh)
            res[nov] = run_welch(sh, nov, sh.gather)
        return res

    return _each_mesh(run)


def welch_validation():
    mesh = make_sdr_mesh(1, 4, devices="cpu")
    res = {}
    try:
        ShardedWelchPSD(WelchPSD(average="median", device="cpu"), mesh)
    except ValueError as e:
        res["median"] = str(e)
    sh = ShardedWelchPSD(WelchPSD(nperseg=512, device="cpu"), mesh)
    for key, t in (("short", 4 * 256), ("divide", 4 * 512 + 2)):
        try:
            sh.compute(np.zeros((1, t), np.float32))
        except ValueError as e:
            res[key] = str(e)
    return res


def fastfir_meshes():
    def run(mesh, c, t):
        sh = ShardedFastFIR(fastfir("real"), mesh)
        return run_fastfir(sh, c, t, sh.gather)

    return _each_mesh(run)


def fastfir_iq_chunks_validation():
    res = {}
    mesh = make_sdr_mesh(2, 2, devices="cpu")
    sh = ShardedFastFIR(fastfir("complex"), mesh)
    res["iq"] = run_fastfir_iq(sh, sh.gather)
    mesh = make_sdr_mesh(1, 4, devices="cpu")
    sh = ShardedFastFIR(fastfir("chunks"), mesh)
    res["chunks"] = run_fastfir_chunks(sh, sh.chunk_granularity, sh.gather)
    sh = ShardedFastFIR(fastfir("real"), mesh)
    for key, shape in (("divide", (2, 514)), ("multiple", (2, 4 * 256))):
        try:
            sh.process(np.zeros(shape, np.float32), sh.initial_state((2,)))
        except ValueError as e:
            res[key] = str(e)
    return res


def ddc_meshes():
    def run(mesh, c, t):
        sh = ShardedDDC(ddc(), mesh)
        return run_ddc(sh, sh.gather)

    return _each_mesh(run)


def ddc_bank_meshes():
    def run(mesh, c, t):
        sh = ShardedDDCBank(ddc_bank(), mesh)
        return run_ddc_bank(sh, sh.gather)

    return _each_mesh(run)


def ddc_validation():
    res = {}
    mesh = make_sdr_mesh(2, 2, devices="cpu")
    sh = ShardedDDCBank(DDCBank(fs=1e6, centers_hz=[1e3, 2e3, 3e3], decimation=8,
                                device="cpu"), mesh)
    try:
        sh.process(np.zeros(64 * 8, np.float32), sh.initial_state())
    except ValueError as e:
        res["carriers"] = str(e)
    sh = ShardedDDCBank(DDCBank(fs=1e6, centers_hz=[1e3, 2e3, 3e3, 4e3], decimation=8,
                                device="cpu"), mesh)
    try:
        sh.process(np.zeros((2, 64 * 8), np.float32), sh.initial_state())
    except ValueError as e:
        res["one_stream"] = str(e)
    mesh = make_sdr_mesh(1, 4, devices="cpu")
    sh = ShardedDDC(DDC(decimation=8, taps_per_phase=8, device="cpu"), mesh)
    for key, t in (("halo", 4 * 48), ("divide", 102)):
        try:
            sh.process(np.zeros((1, t), np.float32), sh.initial_state((1,)))
        except ValueError as e:
            res[key] = str(e)
    return res


def scanner_meshes():
    res = _each_mesh(lambda mesh, c, t: run_scan(
        SpectrumScanner(FS, 0.0, 500e3, mesh=mesh, **SCAN_KW)), [(2, 2), (4, 1), (1, 4)])
    try:
        SpectrumScanner(FS, 0.0, 500e3, channel_bw=25e3, k_per_dispatch=6,
                        mesh=make_sdr_mesh(4, 1, devices="cpu"))
    except ValueError as e:
        res["k"] = str(e)
    return res


CASES = [channelizer_meshes, channelizer_pallas, channelizer_chunks_and_validation,
         welch_meshes, welch_validation, fastfir_meshes, fastfir_iq_chunks_validation,
         ddc_meshes, ddc_bank_meshes, ddc_validation, scanner_meshes]
