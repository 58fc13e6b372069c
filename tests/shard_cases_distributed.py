"""The multi-process path's case: ``distributed.initialize`` (done by the
harness), ``pod_mesh`` and one ``ShardedSpectrumPipeline`` FIXED step on
every rank of the group, run by ``tests/test_torch_shard_distributed.py``.
Imports ``tpu_sdr_torch``, numpy and scipy only."""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from tpu_sdr_torch import FilterMode, PipelineConfig
from tpu_sdr_torch.shard import ShardedSpectrumPipeline, distributed

FRAMES = 4


def pipeline_step():
    world = dist.get_world_size()
    mesh = distributed.pod_mesh(devices="cpu")
    pipe = ShardedSpectrumPipeline(PipelineConfig(channels=world), mesh)
    x = np.random.default_rng(17).standard_normal((world, FRAMES * 16384)).astype(np.float32)
    out, st = pipe.process(x, pipe.initial_state(), FilterMode.FIXED)
    return {"mesh": dict(mesh.shape), "mag": pipe.gather(out)["magnitude"].numpy(),
            "sos_state": st.sos_state.numpy(), "frame_count": int(st.frame_count),
            "backend": dist.get_backend()}


CASES = [pipeline_step]
