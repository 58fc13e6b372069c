"""Entry: ``SpectrumPipeline.process`` on real (channels, frames * N) chunks
on the device, or, for a configuration whose input is ``complex_planes``,
``SpectrumPipeline.process_planes`` on IQ chunks given as stacked re/im
planes (2, channels, frames * N) with the re/im-stacked state. The state is
carried from chunk to chunk; the magnitudes stay on the device. A CUSTOM mix
uploads the configuration's per-channel designs (``upload_sos_bank``)."""

from __future__ import annotations

from sdrbench import system


class Entry:
    def __init__(self, cfg: dict, traffic: dict, designs, device):
        from tpu_sdr_torch import FilterMode, SpectrumPipeline

        self.pipe = SpectrumPipeline(system.pipeline_config(cfg), device=device)
        self.planes = cfg["input"] == "complex_planes"
        self.process = self.pipe.process_planes if self.planes else self.pipe.process
        self.mode = system.filter_mode(traffic)
        if self.mode == FilterMode.CUSTOM:
            self.pipe.upload_sos_bank(designs)
        self.reset()

    def reset(self):
        """A fresh stream."""
        self.state = self.pipe.initial_state(batch_shape=(2,) if self.planes else ())

    def dispatch(self, chunk):
        out, self.state = self.process(chunk, self.state, self.mode)
        return out["magnitude"]

    def to_host(self, out, channels):
        """The (C', F, N) magnitudes of the compared channels, in float32."""
        return out[channels].float().cpu().numpy()

    def iir_state(self, channels):
        """The cascade state carried after the last chunk, (C', S, 2), of
        the compared channels."""
        return self.state.sos_state[..., channels, :, :].cpu().numpy()

    def frames_counted(self) -> int:
        """The stream's frame counter."""
        return int(self.state.frame_count)


def build(cfg: dict, traffic: dict, designs, device) -> Entry:
    return Entry(cfg, traffic, designs, device)
