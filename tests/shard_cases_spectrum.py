"""The sharded spectrum engines' cases, run in every rank of a 4-rank Gloo
group (``torch_shard_harness``); ``tests/test_torch_shard_spectrum.py``
holds their results against the single-device port and the JAX package.

Imports ``tpu_sdr_torch``, numpy and scipy only. Each case makes its meshes
(every rank together; ranks outside a 2-rank sub-mesh skip its work) and
returns, on rank 0, NumPy copies of the gathered outputs and states.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sps
import torch

from tpu_sdr_torch import FilterMode, PipelineConfig, SpectrumAnalyzer, StreamFeeder
from tpu_sdr_torch.kernels import fft
from tpu_sdr_torch.runtime import source
from tpu_sdr_torch.shard import LatencyPipeline, ShardedFastFIR, ShardedSpectrumPipeline
from tpu_sdr_torch.shard import distributed, make_sdr_mesh

N = 16384
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4), (4, 1)]
C, FRAMES = 4, 8
SOS = sps.butter(12, 0.22, output="sos")
CHUNK_SOS = sps.cheby1(12, 0.5, 0.3, output="sos")
HOP_SOS = sps.ellip(12, 0.5, 70, 0.3, output="sos")


def bank_designs(c: int) -> np.ndarray:
    return np.stack([sps.butter(12, 0.1 * (i + 1), output="sos") for i in range(c)])


def noise(c: int, frames: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((c, frames * N)).astype(np.float32)


def iq_noise(c: int, frames: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (c, frames * N)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


PATHS = {  # name -> (PipelineConfig kwargs, mode, input kind)
    "custom": (dict(), "CUSTOM", "real"),
    "fixed": (dict(), "FIXED", "real"),
    "bypass": (dict(), "BYPASS", "real"),
    "fused": (dict(fused_two_pass=True), "CUSTOM", "real"),
    "hop": (dict(hop=8192), "CUSTOM", "real"),
    "bank": (dict(), "CUSTOM", "bank"),
    "iq": (dict(), "CUSTOM", "iq"),
    "bf16_io": (dict(dtype="bf16", bf16_io=True), "CUSTOM", "real"),
}


def make_pipe(path: str, pipe_cls, **kw):
    cfg_kw, mode, kind = PATHS[path]
    pipe = pipe_cls(PipelineConfig(channels=C, **cfg_kw), **kw)
    pipe.upload_sos(HOP_SOS if path == "hop" else SOS)
    if kind == "bank":
        pipe.upload_sos_bank(bank_designs(C))
    x = iq_noise(C, FRAMES, 5) if kind == "iq" else noise(C, FRAMES, 3)
    state = pipe.initial_state(batch_shape=(2,) if kind == "iq" else ())
    return pipe, x, state, FilterMode[mode]


def _np(t):
    return None if t is None else t.detach().float().cpu().numpy()


def run_path(pipe, x, state, mode, chunks: int = 2, outputs: str = "magnitude", gather=None):
    """``chunks`` carried-state dispatches; returns the outputs (gathered by
    ``gather``) concatenated along frames, and the final state."""
    outs = []
    for part in np.split(x, chunks, axis=-1):
        out, state = pipe.process(part, state, mode, outputs)
        outs.append(out if gather is None else gather(out))
    res = {k: np.concatenate([_np(o[k]) for o in outs], axis=-2) for k in outs[0]}
    res.update(sos_state=_np(state.sos_state), history=_np(state.history),
               frame_count=int(state.frame_count), window_phase=int(state.window_phase))
    return res


def _each_mesh(fn, meshes=MESHES):
    res = {}
    for shape in meshes:
        mesh = make_sdr_mesh(*shape, devices="cpu")
        if mesh.member:
            res[shape] = fn(mesh)
    return res


def _path_case(path: str, meshes=MESHES):
    def run(mesh):
        pipe, x, state, mode = make_pipe(path, ShardedSpectrumPipeline, mesh=mesh)
        return run_path(pipe, x, state, mode, gather=pipe.gather)

    return _each_mesh(run, meshes)


def custom():
    return _path_case("custom")


def fused():
    return _path_case("fused")


def hop():
    return _path_case("hop")


def bank():
    return _path_case("bank")


def iq():
    return _path_case("iq")


def fixed_bypass():
    return {p: _path_case(p, [(2, 2)]) for p in ("fixed", "bypass")}


def bf16_io():
    return _path_case("bf16_io", [(2, 2), (1, 4)])


def outputs_all():
    """The plain path (every output) on a (2, 2) mesh, BYPASS and CUSTOM."""
    def run(mesh):
        res = {}
        for mode in ("BYPASS", "CUSTOM"):
            pipe, x, state, _ = make_pipe("custom", ShardedSpectrumPipeline, mesh=mesh)
            res[mode] = run_path(pipe, x, state, FilterMode[mode], outputs="all",
                                 gather=pipe.gather)
        return res

    return _each_mesh(run, [(2, 2)])


def chunks():
    """One channel on (1, 4): one dispatch, then two chunks twice."""
    def run(mesh):
        pipe = ShardedSpectrumPipeline(PipelineConfig(channels=1), mesh)
        pipe.upload_sos(CHUNK_SOS)
        x = noise(1, 8, 4)
        res = {"whole": run_path(pipe, x, pipe.initial_state(), FilterMode.CUSTOM, 1, gather=pipe.gather)}
        for k in ("chunked", "again"):
            res[k] = run_path(pipe, x, pipe.initial_state(), FilterMode.CUSTOM, 2, gather=pipe.gather)
        return res

    return _each_mesh(run, [(1, 4)])


def validation():
    """The friendly errors, raised before any transfer, on every rank."""
    res = {}
    try:
        make_sdr_mesh(channel=3, time=3, devices="cpu")
    except ValueError as e:
        res["mesh"] = str(e)
    mesh = make_sdr_mesh(2, 2, devices="cpu")
    pipe = ShardedSpectrumPipeline(PipelineConfig(channels=3), mesh)
    try:
        pipe.process(np.zeros((3, 2 * N), np.float32), pipe.initial_state())
    except ValueError as e:
        res["channels"] = str(e)
    pipe = ShardedSpectrumPipeline(PipelineConfig(channels=2), mesh)
    try:
        pipe.process(np.zeros((2, N), np.float32), pipe.initial_state())
    except ValueError as e:
        res["length"] = str(e)
    from tpu_sdr_torch.kernels.fastconv import FastFIR

    sff = ShardedFastFIR(FastFIR(sps.firwin(65, 0.3), nfft=1024, block=512, device="cpu"), mesh)
    for key, shape in (("fir_channels", (3, 2 * 512)), ("fir_block", (2, 2 * 256))):
        try:
            sff.process(np.zeros(shape, np.float32), sff.initial_state(shape[:1]))
        except ValueError as e:
            res[key] = str(e)
    return res


def intra_fft():
    """fft_4step_sharded over the 4 ranks' time axis, real and complex."""
    mesh = make_sdr_mesh(1, 4, devices="cpu")
    plan = fft.plan_constants(128, 128, device="cpu")
    rng = np.random.default_rng(0)
    xr = rng.standard_normal((128, 128)).astype(np.float32)
    xi = rng.standard_normal((128, 128)).astype(np.float32)
    res = {}
    for kind, im in (("real", None), ("complex", xi)):
        cols = lambda a: None if a is None else mesh.block(a, None, -1)
        fr, fi = fft.fft_4step_sharded(cols(xr), cols(im), plan, mesh.time)
        res[kind] = (_np(mesh.gather(fr, None, -1)), _np(mesh.gather(fi, None, -1)))
    return res


BLOCKED_SOS = sps.butter(6, 0.2, output="sos")


def blocked_input():
    rng = np.random.default_rng(31)
    return (rng.standard_normal((2, 4 * 4 * 128)).astype(np.float32),
            (0.1 * rng.standard_normal((2, 3, 2))).astype(np.float32))


def blocked_timesharded():
    """biquad.sosfilt_blocked_timesharded over the 4 ranks' time axis,
    frames of 4 blocks: the gathered output and the global final state."""
    from tpu_sdr_torch.kernels import biquad

    mesh = make_sdr_mesh(1, 4, devices="cpu")
    op = biquad.precompute(BLOCKED_SOS, 128, device="cpu")
    x, zi = blocked_input()
    y, zf = biquad.sosfilt_blocked_timesharded(
        op, mesh.block(x, None, -1), torch.as_tensor(zi), time_axis=mesh.time, frame_blocks=4)
    return {"y": _np(mesh.gather(y, None, -1)), "zf": _np(zf)}


def analyzer():
    """SpectrumAnalyzer(mesh=...) driven by command bytes on (2, 2): bypass
    + start, a chunk; a 0xF1 upload + CUSTOM, a chunk; a checkpoint."""
    mesh = make_sdr_mesh(2, 2, devices="cpu")
    return drive_analyzer(SpectrumAnalyzer(PipelineConfig(channels=2), mesh=mesh))


def drive_analyzer(sa):
    """The command drive; ``sa`` is any package's analyzer (bytes in)."""
    from tpu_sdr_torch.control.commands import Command, encode_coefficient_upload
    from tpu_sdr_torch.control.designer import design_iir_filter

    x = noise(2, 2, 9)
    frames = []
    sa.on_spectrum = lambda mag, i: frames.append((i, float(mag[1])))
    sa.handle_bytes(bytes([Command.MODE_BYPASS, Command.START]))
    a = np.asarray(sa.process(x)["magnitude"])
    notch = design_iir_filter("butterworth", "bandstop", 2, 1e6, (230e3, 270e3))
    sa.handle_bytes(encode_coefficient_upload(notch.to_wire_bytes())
                    + bytes([Command.MODE_CUSTOM]))
    b = np.asarray(sa.process(x)["magnitude"])
    ck = sa.checkpoint()
    return {"a": a, "b": b, "frames": frames, "sos_state": ck["state"]["sos_state"],
            "frame_count": int(ck["state"]["frame_count"])}


def feeder():
    """StreamFeeder(sharding=mesh) -> ShardedSpectrumPipeline.process on
    (2, 2): each rank stages only its block; 3 chunks."""
    mesh = make_sdr_mesh(2, 2, devices="cpu")
    pipe = ShardedSpectrumPipeline(PipelineConfig(channels=2), mesh)
    pipe.upload_sos(SOS)
    return drive_feeder(pipe, StreamFeeder, dict(sharding=mesh), gather=pipe.gather)


FEED = dict(tones_hz=((125e3, 0.5), (300e3, 0.25)), noise=0.1, channels=2, seed=7)


def drive_feeder(pipe, feeder_cls, kw, gather=None):
    f = feeder_cls(source.SyntheticSource(**FEED), chunk_samples=2 * N, **kw).start()
    state, outs, blocks = pipe.initial_state(), [], []
    try:
        for _ in range(3):
            x = f.get(timeout=30)
            blocks.append(tuple(getattr(x, "local", x).shape))
            out, state = pipe.process(x, state, FilterMode.CUSTOM)
            outs.append(_np((out if gather is None else gather(out))["magnitude"]))
    finally:
        f.stop()
    return {"mag": np.concatenate(outs, axis=-2), "sos_state": _np(state.sos_state),
            "blocks": blocks}


def latency():
    """LatencyPipeline on (1, 2) and (1, 4): a BYPASS frame, three CUSTOM
    frames with the state carried, a FIXED frame of zeros, validation."""
    def run(mesh):
        lat = LatencyPipeline(PipelineConfig(channels=1), mesh)
        rng = np.random.default_rng(40)
        x = rng.standard_normal(N).astype(np.float32)
        mag, _ = lat.process_frame(x, lat.initial_state(), FilterMode.BYPASS)
        res = {"bypass": _np(lat.gather(mag))}
        lat.upload_sos(HOP_SOS)
        xs = np.random.default_rng(41).standard_normal(3 * N).astype(np.float32)
        z, mags = lat.initial_state(), []
        for f in range(3):
            mag, z = lat.process_frame(xs[f * N : (f + 1) * N], z, FilterMode.CUSTOM)
            mags.append(_np(lat.gather(mag)))
        res["custom"], res["custom_state"] = np.stack(mags), _np(z)
        mag, _ = lat.process_frame(np.zeros(N, np.float32), lat.initial_state(), FilterMode.FIXED)
        res["fixed_zero"] = _np(lat.gather(mag))
        for key, cfg in (("channels", PipelineConfig(channels=2)),
                         ("iir_block", PipelineConfig(fft_n1=64, fft_n2=256, iir_block=128))):
            try:
                LatencyPipeline(cfg, mesh)
            except ValueError as e:
                res[key] = str(e)
        return res

    return _each_mesh(run, [(1, 2), (1, 4)])


def pod_mesh():
    """distributed.pod_mesh over all 4 ranks: the default layout and a
    channel split; with two hosts of two ranks, a channel axis of 1 warns."""
    import os
    import warnings

    res = {"default": dict(distributed.pod_mesh(devices="cpu").shape)}
    res["channel2"] = dict(distributed.pod_mesh(channel=2, devices="cpu").shape)
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    try:
        res["hosts"] = dict(distributed.pod_mesh(devices="cpu").shape)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            distributed.pod_mesh(channel=1, devices="cpu")
        res["warned"] = any("not a multiple of hosts" in str(m.message) for m in w)
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    try:
        distributed.pod_mesh(channel=3, devices="cpu")
    except ValueError as e:
        res["bad"] = str(e)
    return res


CASES = [custom, fused, hop, bank, iq, fixed_bypass, bf16_io, outputs_all, chunks, validation,
         intra_fft, blocked_timesharded, analyzer, feeder, latency, pod_mesh]
