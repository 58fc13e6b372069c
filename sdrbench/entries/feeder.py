"""Entry: ``SpectrumPipeline.process`` on real (channels, frames * N) chunks
that reach the device from host memory through ``StreamFeeder``, as in a
deployment whose front end acquires into pinned host buffers.

The entry holds a ``PinnedRingSource`` of one slot a chunk of the ring. At
the first dispatch (set-up) it takes the whole input ring once, from the
harness's chunk (a view of it), and copies it into the pinned slots. From
then on the pipeline reads only what the feeder hands over: each chunk's
slot copied straight to the card on the feeder's side stream
(``feeder_depth`` chunks staged ahead), with no host copy and no device
copy kept. The state is carried from chunk to chunk; the magnitudes stay
on the device. A CUSTOM mix uploads the configuration's per-channel designs
(``upload_sos_bank``).

The feeder hands the slots over in ring order, so chunk k of a stream is
slot k mod R, as the harness rebuilds it: each dispatch checks that the
slot the harness names is the one handed over. Where the harness starts
its stream again at slot 0 without a reset (the traced stretch after its
warm-up), the feeder starts over at slot 0, as at a reset, and the state
runs on.
"""

from __future__ import annotations

import sys

from sdrbench import system


class Entry:
    def __init__(self, cfg: dict, traffic: dict, designs, device):
        import torch

        from tpu_sdr_torch import FilterMode, SpectrumPipeline, StreamFeeder
        from tpu_sdr_torch.runtime.source import PinnedRingSource

        if cfg["input"] != "real":
            raise ValueError(f"the feeder entry takes real input, not {cfg['input']!r}")
        self.pipe = SpectrumPipeline(system.pipeline_config(cfg), device=device)
        self.mode = system.filter_mode(traffic)
        if self.mode == FilterMode.CUSTOM:
            self.pipe.upload_sos_bank(designs)
        shape = (cfg["channels"], traffic["frames_per_chunk"] * cfg["fft_size"])
        self.source = PinnedRingSource(traffic["ring_chunks"], shape,
                                       pin=torch.device(device).type == "cuda")
        self.feeder = StreamFeeder(self.source, shape[-1], depth=traffic["feeder_depth"],
                                   device=device)
        self.filled = False
        self.since = self._counts()
        self.reset()

    def _counts(self) -> dict:
        return dict(self.feeder.stats, ring_waits=self.source.release_waits)

    def _fill(self, ring):
        """Copy the harness's ring into the pinned slots and start the
        feeder over them."""
        if tuple(ring.shape) != (len(self.source.slots), *self.source.slots[0].shape):
            raise ValueError(f"a ring of {tuple(ring.shape)} for slots of "
                             f"{tuple(self.source.slots[0].shape)}")
        for slot, chunk in zip(self.source.slots, ring):
            slot.copy_(chunk)
        self.filled = True
        self.feeder.start()

    def _restart(self) -> dict:
        """The feeder stopped and drained, the source back at slot 0, the
        feeder started again; returns the counts while it stood."""
        self.feeder.stop()
        self.source.reset()
        self.next_slot = 0
        counts = self._counts()
        self.feeder.start()
        return counts

    def reset(self):
        """A fresh stream: the feeder started over at slot 0 and a fresh
        state."""
        if self.filled:
            self.since = self._restart()
        self.next_slot = 0
        self.handed = 0
        self.state = self.pipe.initial_state()

    def dispatch(self, chunk):
        if not self.filled:
            self._fill(chunk._base)
        want = chunk.storage_offset() // chunk.numel()
        if want != self.next_slot:
            if want != 0:
                raise RuntimeError(f"the harness names ring slot {want}; the feeder hands "
                                   f"over slot {self.next_slot}")
            self._restart()
        x = self.feeder.get()
        self.next_slot = (self.next_slot + 1) % len(self.source.slots)
        self.handed += 1
        out, self.state = self.pipe.process(x, self.state, self.mode)
        return out["magnitude"]

    def to_host(self, out, channels):
        """The (C', F, N) magnitudes of the compared channels, in float32."""
        return out[channels].float().cpu().numpy()

    def iir_state(self, channels):
        """The cascade state carried after the last chunk, (C', S, 2), of
        the compared channels."""
        return self.state.sos_state[..., channels, :, :].cpu().numpy()

    def frames_counted(self) -> int:
        """The stream's frame counter. Logs what the feeder did since the
        last reset: chunks handed over, chunks staged (the handed ones and
        those staged ahead) and their bytes, host copies and waits. The
        configuration's guarantee that every chunk crosses the link as it
        is: a chunk copied on the host first, or bytes staged other than the
        staged chunks' own, fail the run."""
        if self.filled:
            now, s = self._counts(), self.since
            staged = now["chunks_staged"] - s["chunks_staged"]
            nbytes, chunk = now["bytes_staged"] - s["bytes_staged"], self.source.slots[0].numel() * 4
            print(f"sdrbench: feeder since the reset: {self.handed} chunks handed over, "
                  f"{staged} staged, bytes_staged {nbytes} ({staged} x {chunk} B), "
                  + ", ".join(f"{k} {now[k] - s[k]}"
                              for k in ("host_copies", "consumer_waits", "ring_waits")),
                  file=sys.stderr, flush=True)
            if now["host_copies"] != s["host_copies"] or nbytes != staged * chunk:
                raise RuntimeError("the feeder copied chunks on the host or staged other bytes "
                                   "than its chunks': the pinned path was not taken")
        return int(self.state.frame_count)

    def __del__(self):
        if getattr(self, "filled", False):
            self.feeder.stop()


def build(cfg: dict, traffic: dict, designs, device) -> Entry:
    return Entry(cfg, traffic, designs, device)
