from tpu_sdr_torch.core.config import (
    CommMode,
    FilterMode,
    HostConfig,
    PipelineConfig,
    default_config,
)

__all__ = ["CommMode", "FilterMode", "HostConfig", "PipelineConfig", "default_config"]
