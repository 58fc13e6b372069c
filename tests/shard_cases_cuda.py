"""The sharded engines on the card (``tests/test_torch_cuda.py``): ranks
spawned on cuda:0. ``GLOO`` runs in a 2-rank Gloo group (several ranks on
one card: the collectives stage through the host), ``GLOO4`` in a 4-rank
Gloo group, ``NCCL`` in a 1-rank NCCL group. Imports ``tpu_sdr_torch``,
numpy and scipy only."""

from __future__ import annotations

import numpy as np
import scipy.signal as sps

from tpu_sdr_torch import FilterMode, PipelineConfig
from tpu_sdr_torch.kernels.cuda import launch
from tpu_sdr_torch.shard import LatencyPipeline, ShardedSpectrumPipeline, make_sdr_mesh

N = 16384
SOS = sps.butter(12, 0.25, output="sos")


def spectrum_input() -> np.ndarray:
    return np.random.default_rng(7).standard_normal((4, 8 * N)).astype(np.float32)


# The 4-rank cases' meshes (channel, time), chunks and channels' designs.
TIME_MESHES = [(1, 4), (2, 2)]
TIME_CHUNKS = 2


def bank_designs() -> list:
    return [sps.butter(12, 0.1 * (c + 1), output="sos") for c in range(4)]


def time_input() -> np.ndarray:
    """4 channels x 16 frames: 2 chunks of 8 frames, 2 or 4 a rank."""
    return np.random.default_rng(9).standard_normal((4, 16 * N)).astype(np.float32)


def latency_input() -> np.ndarray:
    return np.random.default_rng(8).standard_normal(3 * N).astype(np.float32)


def gloo_spectrum():
    """(1, 2) on cuda:0: BYPASS and CUSTOM, two carried-state dispatches."""
    mesh = make_sdr_mesh(1, 2, devices="cuda:0")
    res = {"backend": mesh.time.backend}
    for mode in (FilterMode.BYPASS, FilterMode.CUSTOM):
        pipe = ShardedSpectrumPipeline(PipelineConfig(channels=4), mesh)
        pipe.upload_sos(SOS)
        st, mags = pipe.initial_state(), []
        for part in np.split(spectrum_input(), 2, axis=-1):
            out, st = pipe.process(part, st, mode)
            mags.append(pipe.gather(out)["magnitude"].cpu().numpy())
        res[mode.name] = (np.concatenate(mags, axis=-2), st.sos_state.cpu().numpy())
    return res


def gloo_time4():
    """CUSTOM with a shared design and with a per-channel bank on the 4
    ranks' (1, 4) and (2, 2) meshes, TIME_CHUNKS carried-state dispatches:
    the gathered magnitudes, the final state and each rank's launches of
    the IIR state kernel (``csrc/iir_state.cu``), of the emit kernel
    (``csrc/iir_emit.cu``) and of the forcing kernel (``csrc/iir_force.cu``),
    and its plain calls of each."""
    res = {}
    for shape in TIME_MESHES:
        mesh = make_sdr_mesh(*shape, devices="cuda:0")
        for path in ("shared", "bank"):
            pipe = ShardedSpectrumPipeline(PipelineConfig(channels=4), mesh)
            if path == "shared":
                pipe.upload_sos(SOS)
            else:
                pipe.upload_sos_bank(bank_designs())
            st, mags = pipe.initial_state(), []
            launch.reset_counts()
            for part in np.split(time_input(), TIME_CHUNKS, axis=-1):
                out, st = pipe.process(part, st, FilterMode.CUSTOM)
                mags.append(pipe.gather(out)["magnitude"].cpu().numpy())
            res[shape, path] = (np.concatenate(mags, axis=-2), st.sos_state.cpu().numpy(),
                                launch.counts["kernel"]["iir_state"],
                                launch.counts["plain"]["iir_state"],
                                launch.counts["kernel"]["iir_emit"],
                                launch.counts["plain"]["iir_emit"],
                                launch.counts["kernel"]["iir_force"],
                                launch.counts["plain"]["iir_force"])
    return res


def nccl_latency():
    """LatencyPipeline on the 1-rank NCCL group: a BYPASS frame and three
    CUSTOM frames with the state carried."""
    mesh = make_sdr_mesh(channel=1)
    lat = LatencyPipeline(PipelineConfig(channels=1), mesh)
    x = latency_input()
    res = {"backend": mesh.time.backend}
    res["BYPASS"] = lat.gather(lat.process_frame(x[:N], lat.initial_state())[0]).cpu().numpy()
    lat.upload_sos(SOS)
    z, mags = lat.initial_state(), []
    for f in range(3):
        mag, z = lat.process_frame(x[f * N : (f + 1) * N], z, FilterMode.CUSTOM)
        mags.append(lat.gather(mag).cpu().numpy())
    res["CUSTOM"] = np.stack(mags)
    res["collectives"] = mesh.stats["calls"]
    return res


GLOO = [gloo_spectrum]
GLOO4 = [gloo_time4]
NCCL = [nccl_latency]
