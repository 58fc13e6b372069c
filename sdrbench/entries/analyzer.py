"""Entry: the facade, ``SpectrumAnalyzer.process``, on real (channels,
frames * N) chunks on the device; each call returns the magnitudes on the
host (its one device-to-host copy). A CUSTOM mix uploads the configuration's
per-channel designs (``upload_filter_bank``) and selects the mode as a host
would."""

from __future__ import annotations

from sdrbench import system


class Entry:
    def __init__(self, cfg: dict, traffic: dict, designs, device):
        from tpu_sdr_torch import FilterMode, SpectrumAnalyzer

        self.sa = SpectrumAnalyzer(system.pipeline_config(cfg), device=device)
        self.mode = system.filter_mode(traffic)
        if self.mode == FilterMode.CUSTOM:
            self.sa.upload_filter_bank(designs)
        self.reset()

    def reset(self):
        """A fresh stream: the analyzer's reset, then the mode and START
        again (coefficients survive a reset)."""
        self.sa.reset()
        self.sa.set_filter_mode(self.mode)
        self.sa.start()

    def dispatch(self, chunk):
        return self.sa.process(chunk)["magnitude"]

    def to_host(self, out, channels):
        """The (C', F, N) magnitudes of the compared channels."""
        return out[channels]

    def iir_state(self, channels):
        """The cascade state carried after the last chunk, (C', S, 2), of
        the compared channels."""
        return self.sa.state.sos_state[..., channels, :, :].cpu().numpy()

    def frames_counted(self) -> int:
        """The stream's frame counter."""
        return int(self.sa.state.frame_count)


def build(cfg: dict, traffic: dict, designs, device) -> Entry:
    return Entry(cfg, traffic, designs, device)
