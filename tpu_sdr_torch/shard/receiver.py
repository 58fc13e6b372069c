"""The full tune-to-audio chain over the (channel, time) mesh (the
counterpart of ``tpu_sdr.shard.receiver``).

Composes the sharded stages: ``ShardedDDC`` (mixed-tail halo), the sharded
demodulators and AGC (one-sample halo + replicated affine-chain replay),
``ShardedStereoDecoder`` (2-float block-phasor halo + replicated pilot EMA
replay, for stereo receivers) and ``ShardedResampler`` (input-tail halo)
into one streaming receiver whose audio is bit-identical to the
single-device ``Receiver`` for every mesh shape. Data stays in per-rank
(channel, time) blocks between stages; only the carried states (a few
floats a channel) are global.
"""

from __future__ import annotations

import torch

from tpu_sdr_torch.kernels.demod import AMDemodulator, FMDemodulator, SSBDemodulator
from tpu_sdr_torch.runtime.receiver import Receiver, ReceiverBank, ReceiverState
from tpu_sdr_torch.shard.ddc import ShardedDDC
from tpu_sdr_torch.shard.ddcbank import ShardedDDCBank
from tpu_sdr_torch.shard.demod import (
    ShardedAGC,
    ShardedAMDemodulator,
    ShardedFMDemodulator,
    ShardedSquelch,
    ShardedSSBDemodulator,
)
from tpu_sdr_torch.shard.mesh import SdrMesh
from tpu_sdr_torch.shard.resample import ShardedResampler
from tpu_sdr_torch.shard.stereo import ShardedStereoDecoder


class _ShardedAudioChain:
    """The post-DDC stages (demod -> stereo -> AGC -> squelch -> resample)
    on this rank's blocks, shared by ``ShardedReceiver`` (a station a
    channel row) and ``ShardedReceiverBank`` (a station a CARRIER row of a
    shared stream): both feed (rows, T) baseband blocks."""

    def __init__(self, rx: Receiver, mesh: SdrMesh):
        if isinstance(rx.demod, FMDemodulator):
            self.demod = ShardedFMDemodulator(rx.demod, mesh)
        elif isinstance(rx.demod, AMDemodulator):
            self.demod = ShardedAMDemodulator(rx.demod, mesh)
        elif isinstance(rx.demod, SSBDemodulator):
            self.demod = ShardedSSBDemodulator(rx.demod, mesh)
        else:
            raise TypeError(f"unsupported demod {type(rx.demod).__name__}")
        self.stereo_dec = (None if rx.stereo_dec is None
                           else ShardedStereoDecoder(rx.stereo_dec, mesh))
        self.agc = None if rx.agc is None else ShardedAGC(rx.agc, mesh)
        self.squelch = None if rx.squelch is None else ShardedSquelch(rx.squelch, mesh)
        self.resampler = ShardedResampler(rx.resampler, mesh)

    def run(self, bb, state: ReceiverState, ddc_state):
        """Local baseband blocks and local state rows -> (local audio
        block, new local state rows)."""
        audio, dm = self.demod._local(bb["re"], bb["im"], state.demod)
        st_state = state.stereo
        if self.stereo_dec is not None:
            audio, st_state = self.stereo_dec._local(audio, state.stereo)
        agc_state = state.agc
        if self.agc is not None:
            audio, agc_state = self.agc._local_real(audio, state.agc)
        sq_state = state.squelch
        if self.squelch is not None:
            gate, sq_state = self.squelch._local(bb["re"], bb["im"], state.squelch)
            if self.stereo_dec is not None:
                gate = gate[..., None, :]  # broadcast over the (L, R) axis
            audio = audio * gate
        audio, rs = self.resampler._local(audio, state.resamp)
        return audio, ReceiverState(ddc_state, dm, agc_state, rs, sq_state, st_state)


class _ShardedReceiverBase:
    def __init__(self, mesh: SdrMesh, ddc, rx: Receiver, granularity: int):
        self.mesh = mesh
        self.ddc = ddc
        self._chain = _ShardedAudioChain(rx, mesh)
        self.chunk_granularity = mesh.shape["time"] * granularity

    # stage handles (public attributes for tests and introspection)
    @property
    def demod(self):
        return self._chain.demod

    @property
    def stereo_dec(self):
        return self._chain.stereo_dec

    @property
    def agc(self):
        return self._chain.agc

    @property
    def squelch(self):
        return self._chain.squelch

    @property
    def resampler(self):
        return self._chain.resampler

    def _check(self, t: int):
        if t % self.chunk_granularity:
            raise ValueError(
                f"chunk length {t} not a multiple of chunk_granularity={self.chunk_granularity}"
            )

    def _process(self, x, state: ReceiverState, iq: bool, channel_dim):
        shape = tuple(x.shape)
        self._check(shape[-1])
        self.ddc._check(shape, state.ddc, iq)
        st = self.mesh.local_rows(state)
        bb, ds = self.ddc._local(self.mesh.block(x, channel_dim, -1), st.ddc, iq)
        audio, new = self._chain.run(bb, st, ds)
        return audio, self.mesh.global_rows(new)

    def gather(self, audio: torch.Tensor) -> torch.Tensor:
        """The global audio (rows, T') or (rows, 2, T') from every rank's
        block."""
        return self.mesh.gather(audio, 0, -1)


class ShardedReceiver(_ShardedReceiverBase):
    """``Receiver`` over a (channel, time) mesh. Input is (C, T) real
    wideband (or (2, C, T) IQ planes): C over the channel axis, T over
    time. Chunks must be multiples of ``chunk_granularity`` (the
    single-device granularity times the time-shard count)."""

    def __init__(self, rx: Receiver, mesh: SdrMesh):
        self.rx = rx
        super().__init__(mesh, ShardedDDC(rx.ddc, mesh), rx, rx.chunk_granularity)

    @property
    def realized_audio_rate(self) -> float:
        return self.rx.realized_audio_rate

    def retune(self, center_hz: float):
        self.rx.retune(center_hz)

    def initial_state(self, batch_shape: tuple = ()) -> ReceiverState:
        return self.rx.initial_state(batch_shape)

    def process(self, x, state: ReceiverState):
        """Real wideband (C, T) -> (this rank's audio block, the new global
        state)."""
        return self._process(x, state, False, -2)

    def process_planes(self, xs, state: ReceiverState):
        """IQ wideband planes (2, C, T) -> (this rank's audio block, state)."""
        return self._process(xs, state, True, -2)


class ShardedReceiverBank(_ShardedReceiverBase):
    """``ReceiverBank`` over a (channel, time) mesh: K stations on ONE
    shared wideband stream, carriers over the channel axis (the
    ``ShardedDDCBank`` mix), time over the time axis, every later stage the
    same sharded chain as ``ShardedReceiver``. Audio is bit-identical to
    the single-device ``ReceiverBank`` for every mesh shape. Input is (T,)
    real or (2, T) IQ; K must divide over the channel shards."""

    def __init__(self, bank: ReceiverBank, mesh: SdrMesh):
        self.bankrx = bank
        super().__init__(mesh, ShardedDDCBank(bank.bank, mesh), bank._rx,
                         bank.chunk_granularity)

    @property
    def k(self) -> int:
        return self.bankrx.k

    @property
    def realized_audio_rate(self) -> float:
        return self.bankrx.realized_audio_rate

    def retune(self, centers_hz):
        self.bankrx.retune(centers_hz)

    def initial_state(self, batch_shape: tuple = ()) -> ReceiverState:
        return self.bankrx.initial_state(batch_shape)

    def process(self, x, state: ReceiverState):
        """Real shared stream (T,) -> (this rank's (K/cd, T'/td) audio
        block, the new global state)."""
        return self._process(x, state, False, None)

    def process_planes(self, xs, state: ReceiverState):
        """IQ shared stream (2, T) -> (this rank's audio block, state)."""
        return self._process(xs, state, True, None)
