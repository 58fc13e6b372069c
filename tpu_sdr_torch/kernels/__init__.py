"""The port's DSP kernels and the classes built on them (the counterpart of
``tpu_sdr.kernels``, with the same package-level names)."""

from tpu_sdr_torch.kernels import window, biquad, fft, magnitude, pfb, ddc, resample  # noqa: F401
from tpu_sdr_torch.kernels.pfb import Channelizer  # noqa: F401
from tpu_sdr_torch.kernels.ddc import DDC, DDCBank  # noqa: F401
from tpu_sdr_torch.kernels.resample import Resampler  # noqa: F401
from tpu_sdr_torch.kernels import demod  # noqa: F401
from tpu_sdr_torch.kernels.demod import (  # noqa: F401
    AGC,
    AMDemodulator,
    FMDemodulator,
    Squelch,
    SSBDemodulator,
)
from tpu_sdr_torch.kernels.iqcorr import IQCorrector  # noqa: F401
from tpu_sdr_torch.kernels.stereo import StereoDecoder  # noqa: F401
from tpu_sdr_torch.kernels import digital  # noqa: F401
from tpu_sdr_torch.kernels.fastconv import FastFIR  # noqa: F401
from tpu_sdr_torch.kernels.digital import BurstModem, FSKModem  # noqa: F401
from tpu_sdr_torch.kernels import fec  # noqa: F401
from tpu_sdr_torch.kernels.fec import ConvCode  # noqa: F401
from tpu_sdr_torch.kernels import rds  # noqa: F401
from tpu_sdr_torch.kernels.rds import RDSDecoder, RDSEncoder  # noqa: F401
