from tpu_sdr_torch.runtime.feeder import StreamFeeder
from tpu_sdr_torch.runtime.psd import WelchPSD
from tpu_sdr_torch.runtime.receiver import Receiver, ReceiverBank, write_wav
from tpu_sdr_torch.runtime.recorder import RecordingSource, SampleRecorder
from tpu_sdr_torch.runtime.scanner import SpectrumScanner
from tpu_sdr_torch.runtime.state import StreamState
from tpu_sdr_torch.runtime.stream import SpectrumPipeline

__all__ = [
    "Receiver", "ReceiverBank", "RecordingSource", "SampleRecorder", "SpectrumPipeline",
    "SpectrumScanner", "StreamFeeder", "StreamState", "WelchPSD", "write_wav",
]
