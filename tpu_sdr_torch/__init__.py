"""PyTorch/CUDA port of the tpu_sdr spectrum pipeline.

Imports torch, numpy and scipy only; nothing of JAX or of ``tpu_sdr``.
"""

from tpu_sdr_torch.core.config import CommMode, FilterMode, PipelineConfig
from tpu_sdr_torch.runtime import SpectrumPipeline, StreamState

__all__ = [
    "CommMode", "FilterMode", "PipelineConfig", "SpectrumPipeline", "StreamState",
]
