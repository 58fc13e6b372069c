"""Entry of a multi-rank cell: ``ShardedSpectrumPipeline.process`` (or
``process_planes`` for ``complex_planes`` input) over the (channel, time)
mesh that the configuration's ``mesh`` key gives (``{"channel": c,
"time": t}``, c * t = the cell's chips), one rank a card. ``place`` cuts
each ring slot to this rank's block once at set-up, so no input crosses
between cards in the window, as in a pod whose hosts each feed their own
cards. Every rank carries the global state (the pipeline all-gathers the
channel rows); the magnitudes stay on each rank's card as its block until
``to_host`` gathers them (a collective). A CUSTOM mix uploads the
configuration's per-channel designs (``upload_sos_bank``: each rank builds
its own channel rows)."""

from __future__ import annotations

from sdrbench import system


class Entry:
    def __init__(self, cfg: dict, traffic: dict, designs, device, ranks):
        from tpu_sdr_torch import FilterMode
        from tpu_sdr_torch.shard.mesh import make_sdr_mesh
        from tpu_sdr_torch.shard.pipeline import ShardedSpectrumPipeline

        mesh = cfg["mesh"]
        if mesh["channel"] * mesh["time"] != ranks.world:
            raise ValueError(f"a {mesh['channel']} x {mesh['time']} mesh over {ranks.world} ranks")
        self.pipe = ShardedSpectrumPipeline(
            system.pipeline_config(cfg), make_sdr_mesh(mesh["channel"], mesh["time"], devices=device))
        self.planes = cfg["input"] == "complex_planes"
        self.process = self.pipe.process_planes if self.planes else self.pipe.process
        self.mode = system.filter_mode(traffic)
        if self.mode == FilterMode.CUSTOM:
            self.pipe.upload_sos_bank(designs)
        self.reset()

    def place(self, ring):
        """This rank's (channel, time) block of each ring slot, contiguous
        on its card."""
        from tpu_sdr_torch.shard.mesh import ShardedArray

        mesh = self.pipe.mesh
        return [ShardedArray(mesh.block(slot, -2, -1).contiguous(), tuple(slot.shape))
                for slot in ring]

    def reset(self):
        """A fresh stream."""
        self.state = self.pipe.initial_state(batch_shape=(2,) if self.planes else ())

    def dispatch(self, block):
        out, self.state = self.process(block, self.state, self.mode)
        return out["magnitude"]

    def to_host(self, out, channels):
        """The (C', F, N) magnitudes of the compared channels, in float32,
        gathered from every rank's block (a collective)."""
        return self.pipe.gather({"magnitude": out})["magnitude"][channels].float().cpu().numpy()

    def iir_state(self, channels):
        """The cascade state carried after the last chunk, (C', S, 2), of
        the compared channels: global on every rank."""
        return self.state.sos_state[..., channels, :, :].cpu().numpy()

    def frames_counted(self) -> int:
        """The stream's frame counter."""
        return int(self.state.frame_count)


def build(cfg: dict, traffic: dict, designs, device, ranks) -> Entry:
    return Entry(cfg, traffic, designs, device, ranks)
