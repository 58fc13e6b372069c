"""The live web GUI: the backend and its stdlib server (the counterpart of
``tpu_sdr.gui``)."""

from tpu_sdr_torch.gui.backend import GuiBackend  # noqa: F401
from tpu_sdr_torch.gui.server import serve  # noqa: F401
