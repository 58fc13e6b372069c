"""PyTorch/CUDA port of the tpu_sdr spectrum pipeline.

Imports torch, numpy and scipy only; nothing of JAX or of ``tpu_sdr``.
"""

__version__ = "0.1.0"

from tpu_sdr_torch.core.config import CommMode, FilterMode, PipelineConfig, default_config
from tpu_sdr_torch.runtime import (
    RecordingSource,
    SampleRecorder,
    SpectrumPipeline,
    StreamFeeder,
    StreamState,
    WelchPSD,
)
from tpu_sdr_torch.control import (
    AnalyzerStats,
    Command,
    CommandDecoder,
    FilterDesign,
    SpectrumAnalyzer,
    design_iir_filter,
    sos_to_wire_bytes,
    wire_bytes_to_sos,
)

__all__ = [
    "AnalyzerStats", "Command", "CommandDecoder", "CommMode", "FilterDesign",
    "FilterMode", "PipelineConfig", "RecordingSource", "SampleRecorder", "SpectrumAnalyzer",
    "SpectrumPipeline", "StreamFeeder", "StreamState", "WelchPSD", "default_config",
    "design_iir_filter", "sos_to_wire_bytes", "wire_bytes_to_sos",
]
