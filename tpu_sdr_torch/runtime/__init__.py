from tpu_sdr_torch.runtime.receiver import Receiver, ReceiverBank, write_wav
from tpu_sdr_torch.runtime.state import StreamState
from tpu_sdr_torch.runtime.stream import SpectrumPipeline

__all__ = ["Receiver", "ReceiverBank", "SpectrumPipeline", "StreamState", "write_wav"]
