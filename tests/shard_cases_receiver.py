"""The sharded receiver chain's cases (FM/AM/SSB demodulators, AGC, the
resampler, the stereo decoder, ``ShardedReceiver`` and
``ShardedReceiverBank``), run in every rank of a 4-rank Gloo group
(``torch_shard_harness``); ``tests/test_torch_shard_receiver.py`` holds
their results against the single-device port and the JAX package.

Imports ``tpu_sdr_torch``, numpy and scipy only. Each ``run_*`` function
drives one stage, sharded or single-device (``gather`` assembles a sharded
stage's blocks), over carried-state chunks, and returns NumPy copies.
"""

from __future__ import annotations

import numpy as np

from shard_cases_modules import npy
from tpu_sdr_torch.kernels.demod import AGC, AMDemodulator, FMDemodulator, SSBDemodulator
from tpu_sdr_torch.kernels.resample import Resampler
from tpu_sdr_torch.kernels.stereo import StereoDecoder, make_mpx
from tpu_sdr_torch.runtime.receiver import Receiver, ReceiverBank
from tpu_sdr_torch.shard import (
    ShardedAGC,
    ShardedAMDemodulator,
    ShardedFMDemodulator,
    ShardedReceiver,
    ShardedReceiverBank,
    ShardedResampler,
    ShardedSSBDemodulator,
    ShardedStereoDecoder,
    make_sdr_mesh,
)

FS = 100_000.0
RX_FS = 1_000_000.0
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4), (4, 1)]
RX_MODES = ["wbfm", "am", "usb"]
BANK_CENTERS = [150e3, 250e3, 330e3, 410e3]


def planes(c: int, t: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((c, t)).astype(np.float32),
            rng.standard_normal((c, t)).astype(np.float32))


def _id(v):
    return v


def run_demod(eng, c: int, t: int, seed: int, chunks: int = 2, swap: bool = False,
              gather=_id):
    """``chunks`` dispatches of the same (re, im) planes with the state
    carried (``swap``: the second takes (im, re), as the reference's AM
    test)."""
    re, im = planes(c, t, seed)
    st, outs = eng.initial_state((c,)), []
    for k in range(chunks):
        a, b = (im, re) if swap and k else (re, im)
        y, st = eng.process(a, b, st)
        outs.append(npy(gather(y)))
    return {"audio": outs, "state": npy(st)}


def run_agc(eng, c: int, t: int, gather=_id):
    x = np.random.default_rng(61).standard_normal((c, t)).astype(np.float32)
    y, st = eng.process_real(x, eng.initial_state((c,)))
    re, im = planes(c, t, 62)
    yr, yi, st2 = eng.process(re, im, st)
    return npy({"real": gather(y), "state": st, "re": gather(yr), "im": gather(yi),
                "state2": st2})


def run_resampler(eng, c: int, t: int, gather=_id):
    x = np.random.default_rng(63).standard_normal((c, t)).astype(np.float32)
    st, outs = eng.initial_state((c,)), []
    for _ in range(2):
        y, st = eng.process(x, st)
        outs.append(npy(gather(y)))
    return {"out": outs, "state": npy(st)}


def stereo_mpx(c: int, t: int, fs: float = 200_000.0):
    n = np.arange(2 * t)
    left = 0.5 * np.sin(2 * np.pi * 700.0 * n / fs)
    right = 0.4 * np.sin(2 * np.pi * 1100.0 * n / fs)
    mpx = make_mpx(left, right, fs).astype(np.float32)
    return np.stack([np.roll(mpx, 13 * i) for i in range(c)])


def run_stereo(eng, c: int, t: int, gather=_id):
    m = stereo_mpx(c, t)
    st, outs = eng.initial_state((c,)), []
    for k in range(2):
        lr, st = eng.process(m[:, k * t : (k + 1) * t], st)
        outs.append(npy(gather(lr)))
    return {"lr": outs, "state": npy(st)}


def rx_input(mode: str, t: int) -> np.ndarray:
    n = np.arange(t)
    fs = RX_FS
    if mode == "stereo":
        mpx = make_mpx(0.5 * np.sin(2 * np.pi * 700.0 * n / fs),
                       0.4 * np.sin(2 * np.pi * 300.0 * n / fs), fs)
        ph = 2 * np.pi * 250e3 * n / fs + 2 * np.pi * 75e3 / fs * np.cumsum(mpx)
        return np.stack([0.5 * np.cos(ph), 0.4 * np.cos(ph + 0.3)]).astype(np.float32)
    if mode == "squelch":
        msg = np.sin(2 * np.pi * 600.0 * n / fs)
        return np.stack([(1 + 0.5 * msg) * 0.4 * np.cos(2 * np.pi * 250e3 * n / fs),
                         1e-3 * np.random.default_rng(2).standard_normal(t)]).astype(np.float32)
    msg = np.sin(2 * np.pi * 500.0 * n / fs)
    ph = 2 * np.pi * 250e3 * n / fs + 2 * np.pi * 50e3 / fs * np.cumsum(msg)
    return np.stack([0.5 * np.cos(ph), 0.4 * np.cos(ph + 0.3)]).astype(np.float32)


def receiver(mode: str, receiver_cls=Receiver, **kw):
    extra = dict(stereo=True) if mode == "stereo" else (
        dict(squelch_db=-25.0) if mode == "squelch" else {})
    rx_mode = {"stereo": "wbfm", "squelch": "am"}.get(mode, mode)
    return receiver_cls(fs=RX_FS, center_hz=250e3, mode=rx_mode, audio_rate=16e3, **extra, **kw)


def run_receiver(eng, mode: str, t: int, gather=_id):
    x = rx_input(mode, t)
    st, outs = eng.initial_state((2,)), []
    for _ in range(2):
        a, st = eng.process(x, st)
        outs.append(npy(gather(a)))
    return {"audio": outs, "state": npy(st)}


def bank_input(mode: str, t: int) -> np.ndarray:
    n = np.arange(t)
    fs = RX_FS
    if mode == "stereo":
        mpx = make_mpx(0.5 * np.sin(2 * np.pi * 700.0 * n / fs),
                       0.4 * np.sin(2 * np.pi * 300.0 * n / fs), fs)
        return (0.5 * np.cos(2 * np.pi * 150e3 * n / fs
                             + 2 * np.pi * 75e3 / fs * np.cumsum(mpx))).astype(np.float32)
    msg = np.sin(2 * np.pi * 700.0 * n / fs)
    return (0.4 * np.cos(2 * np.pi * 150e3 * n / fs + 2 * np.pi * 40e3 / fs * np.cumsum(msg))
            + 0.3 * (1 + 0.5 * msg) * np.cos(2 * np.pi * 330e3 * n / fs)
            + 0.01 * np.random.default_rng(0).standard_normal(t)).astype(np.float32)


def receiver_bank(mode: str, bank_cls=ReceiverBank, **kw):
    if mode == "stereo":
        return bank_cls(fs=RX_FS, centers_hz=[150e3, 350e3], mode="wbfm", audio_rate=16e3,
                        stereo=True, **kw)
    return bank_cls(fs=RX_FS, centers_hz=BANK_CENTERS, mode=mode, audio_rate=16e3, **kw)


def run_bank(eng, mode: str, t: int, gather=_id):
    x = bank_input(mode, t)
    st, outs = eng.initial_state(), []
    for _ in range(2):
        a, st = eng.process(x, st)
        outs.append(npy(gather(a)))
    return {"audio": outs, "state": npy(st)}


def _each_mesh(fn, meshes=MESHES):
    res = {}
    for shape in meshes:
        mesh = make_sdr_mesh(*shape, devices="cpu")
        if mesh.member:
            res[shape] = fn(mesh, *shape)
    return res


def fm():
    def run(mesh, c, t):
        sh = ShardedFMDemodulator(FMDemodulator(FS, deviation_hz=5e3, deemphasis_tau=75e-6,
                                                device="cpu"), mesh)
        return run_demod(sh, 8, t * 512, 71, gather=sh.gather)

    return _each_mesh(run)


def am():
    def run(mesh, c, t):
        sh = ShardedAMDemodulator(AMDemodulator(FS, device="cpu"), mesh)
        return run_demod(sh, 4, t * 384, 72, swap=True, gather=sh.gather)

    return _each_mesh(run, [(2, 2), (1, 4)])


def ssb():
    def run(mesh, c, t):
        sh = ShardedSSBDemodulator(SSBDemodulator(FS, bfo_hz=1500.0, device="cpu"), mesh)
        return run_demod(sh, 4, t * 256, 73, gather=sh.gather)

    return _each_mesh(run, [(2, 2), (4, 1)])


def agc():
    def run(mesh, c, t):
        sh = ShardedAGC(AGC(mu=5e-3, ref=1.0, device="cpu"), mesh)
        return run_agc(sh, 4, t * 256, gather=sh.gather)

    return _each_mesh(run, [(2, 2), (1, 4)])


def resampler():
    def run(mesh, c, t):
        sh = ShardedResampler(Resampler(up=3, down=2, taps_per_phase=6, device="cpu"), mesh)
        return run_resampler(sh, 8, t * 64, gather=sh.gather)

    return _each_mesh(run)


def stereo():
    def run(mesh, c, t):
        sh = ShardedStereoDecoder(StereoDecoder(200_000.0, deemphasis_tau=75e-6, leak=0.98,
                                                device="cpu"), mesh)
        return run_stereo(sh, 8, t * 512, gather=sh.gather)

    return _each_mesh(run)


def receivers():
    def run(mesh, c, t):
        res = {}
        for mode in RX_MODES + ["stereo"]:
            sh = ShardedReceiver(receiver(mode, device="cpu"), mesh)
            res[mode] = run_receiver(sh, mode, sh.chunk_granularity, gather=sh.gather)
            res[mode]["granularity"] = sh.chunk_granularity
        return res

    return _each_mesh(run, [(2, 2), (1, 4)])


def receiver_squelch_validation():
    mesh = make_sdr_mesh(2, 2, devices="cpu")
    sh = ShardedReceiver(receiver("squelch", device="cpu"), mesh)
    res = {"squelch": run_receiver(sh, "squelch", sh.chunk_granularity, gather=sh.gather)}
    mesh = make_sdr_mesh(1, 4, devices="cpu")
    rx = Receiver(fs=1e6, center_hz=100e3, mode="wbfm", audio_rate=16e3, device="cpu")
    sh = ShardedReceiver(rx, mesh)
    try:
        sh.process(np.zeros((1, rx.chunk_granularity), np.float32), sh.initial_state((1,)))
    except ValueError as e:
        res["granularity"] = str(e)
    return res


def banks():
    def run(mesh, c, t):
        res = {}
        for mode in ("wbfm", "am"):
            sh = ShardedReceiverBank(receiver_bank(mode, device="cpu"), mesh)
            res[mode] = run_bank(sh, mode, sh.chunk_granularity, gather=sh.gather)
        return res

    res = _each_mesh(run, [(2, 2), (4, 1)])
    mesh = make_sdr_mesh(2, 2, devices="cpu")
    sh = ShardedReceiverBank(receiver_bank("stereo", device="cpu"), mesh)
    res["stereo"] = run_bank(sh, "stereo", sh.chunk_granularity, gather=sh.gather)
    return res


CASES = [fm, am, ssb, agc, resampler, stereo, receivers, receiver_squelch_validation, banks]
