from tpu_sdr_torch.core.config import (
    CommMode,
    FilterMode,
    HostConfig,
    PipelineConfig,
    default_config,
)
from tpu_sdr_torch.core import qformat  # noqa: F401

__all__ = ["CommMode", "FilterMode", "HostConfig", "PipelineConfig", "default_config"]
