"""The control plane: the analyzer facade, the command protocol, the filter
designer and the golden host model (the counterpart of ``tpu_sdr.control``)."""

from tpu_sdr_torch.control import commands, designer, golden  # noqa: F401
from tpu_sdr_torch.control.api import AnalyzerStats, SpectrumAnalyzer  # noqa: F401
from tpu_sdr_torch.control.commands import Command, CommandDecoder  # noqa: F401
from tpu_sdr_torch.control.designer import (  # noqa: F401
    FilterDesign,
    design_iir_filter,
    sos_to_wire_bytes,
    wire_bytes_to_sos,
)
