"""The port's multi-process path, actually executed: real OS processes on
the CPU (Gloo) run ``shard.distributed.initialize`` on a ``file://``
rendezvous, ``pod_mesh`` and one ``ShardedSpectrumPipeline`` step, and the
gathered spectra and final state equal the single-device
``SpectrumPipeline`` bit for bit (and the JAX package's within the
single-device tests' floor). Two ranks on one host; four ranks as two
hosts of two (``LOCAL_WORLD_SIZE=2``, so the channel axis spans the hosts).
"""

import numpy as np
import pytest
import torch

import shard_cases_distributed as cases
from torch_shard_harness import run_group
from tpu_sdr.core.config import FilterMode as JFilterMode
from tpu_sdr.core.config import PipelineConfig as JPipelineConfig
from tpu_sdr.runtime import SpectrumPipeline as JSpectrumPipeline
from tpu_sdr_torch import FilterMode, PipelineConfig, SpectrumPipeline
from tpu_sdr_torch.shard import distributed

torch.set_num_threads(1)

PARITY_FLOOR_DB = 90.0  # the f32 tier (tests/test_torch_bank.py)


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.sum((ref - np.asarray(got, np.float64)) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.sum(ref**2) / err)


def _run_verify(tmp_path, nprocs: int, env: dict, mesh: dict):
    results, errors = run_group(tmp_path, "shard_cases_distributed", nprocs, env)
    assert "pipeline_step" in results, errors
    got = results["pipeline_step"]
    assert got["mesh"] == mesh and got["backend"] == "gloo"
    x = np.random.default_rng(17).standard_normal(
        (nprocs, cases.FRAMES * 16384)).astype(np.float32)
    pipe = SpectrumPipeline(PipelineConfig(channels=nprocs), device="cpu")
    out, st = pipe.process(x, pipe.initial_state(), FilterMode.FIXED)
    assert np.array_equal(got["mag"], out["magnitude"].numpy())
    assert np.array_equal(got["sos_state"], st.sos_state.numpy())
    assert got["frame_count"] == cases.FRAMES
    jpipe = JSpectrumPipeline(JPipelineConfig(channels=nprocs))
    jout, _ = jpipe.process(x, jpipe.initial_state(), JFilterMode.FIXED)
    assert snr_db(np.asarray(jout["magnitude"]), got["mag"]) >= PARITY_FLOOR_DB


def test_two_process_distributed_pipeline_bitwise(tmp_path):
    _run_verify(tmp_path, 2, {}, {"channel": 1, "time": 2})


def test_four_process_distributed_pipeline_bitwise(tmp_path):
    _run_verify(tmp_path, 4, {"LOCAL_WORLD_SIZE": "2"}, {"channel": 2, "time": 2})


def test_initialize_single_process_and_scaling_efficiency(monkeypatch):
    """No coordinator and one process: nothing to bring up. A coordinator
    without this process's id is refused. scaling_efficiency needs n=1."""
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1")
    with pytest.raises(ValueError, match="process's id"):
        distributed.initialize(num_processes=2)
    assert distributed.scaling_efficiency({1: 10.0, 2: 15.0, 4: 20.0}) == {
        1: 1.0, 2: 0.75, 4: 0.5}
    with pytest.raises(ValueError, match="n=1"):
        distributed.scaling_efficiency({2: 1.0})
