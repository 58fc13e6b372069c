from tpu_sdr_torch.core.config import CommMode, FilterMode, PipelineConfig

__all__ = ["CommMode", "FilterMode", "PipelineConfig"]
