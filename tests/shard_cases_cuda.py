"""The sharded engines on the card (``tests/test_torch_cuda.py``): ranks
spawned on cuda:0. ``GLOO`` runs in a 2-rank Gloo group (several ranks on
one card: the collectives stage through the host), ``NCCL`` in a 1-rank
NCCL group. Imports ``tpu_sdr_torch``, numpy and scipy only."""

from __future__ import annotations

import numpy as np
import scipy.signal as sps

from tpu_sdr_torch import FilterMode, PipelineConfig
from tpu_sdr_torch.shard import LatencyPipeline, ShardedSpectrumPipeline, make_sdr_mesh

N = 16384
SOS = sps.butter(12, 0.25, output="sos")


def spectrum_input() -> np.ndarray:
    return np.random.default_rng(7).standard_normal((4, 8 * N)).astype(np.float32)


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
NCCL = [nccl_latency]
