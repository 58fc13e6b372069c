"""The cost model and the device trace (the counterpart of ``tpu_sdr.bench``)."""

from tpu_sdr_torch.bench.roofline import pipeline_cost, roofline_report  # noqa: F401
