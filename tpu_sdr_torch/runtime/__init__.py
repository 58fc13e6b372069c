from tpu_sdr_torch.runtime.state import StreamState
from tpu_sdr_torch.runtime.stream import SpectrumPipeline

__all__ = ["SpectrumPipeline", "StreamState"]
