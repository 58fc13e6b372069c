"""What the entry drivers share: the port's ``PipelineConfig`` for a
configuration file, and the mode named in a traffic mix."""

from __future__ import annotations


def pipeline_config(cfg: dict):
    """The ``tpu_sdr_torch.PipelineConfig`` of a configuration file."""
    from tpu_sdr_torch import PipelineConfig

    return PipelineConfig(
        fft_size=cfg["fft_size"],
        channels=cfg["channels"],
        n_sections=cfg["n_sections"],
        sample_rate=cfg["sample_rate_hz"],
        hop=None if cfg["hop"] == cfg["fft_size"] else cfg["hop"],
        dtype=cfg["tier"],
        bf16_io=cfg.get("bf16_io", False),
    )


def filter_mode(traffic: dict):
    from tpu_sdr_torch import FilterMode

    return FilterMode[traffic["mode"]]
