"""The sharded engines on ``torch.distributed`` (the counterpart of
``tpu_sdr.shard``): one process a device over a (channel, time) mesh; the
execution model is described in ``shard/mesh.py``."""

from tpu_sdr_torch.shard.mesh import make_sdr_mesh  # noqa: F401
from tpu_sdr_torch.shard.pipeline import ShardedSpectrumPipeline  # noqa: F401
from tpu_sdr_torch.shard.latency import LatencyPipeline  # noqa: F401
from tpu_sdr_torch.shard.channelizer import ShardedChannelizer  # noqa: F401
from tpu_sdr_torch.shard.psd import ShardedWelchPSD  # noqa: F401
from tpu_sdr_torch.shard.ddc import ShardedDDC  # noqa: F401
from tpu_sdr_torch.shard.ddcbank import ShardedDDCBank  # noqa: F401
from tpu_sdr_torch.shard.demod import (  # noqa: F401
    ShardedAGC,
    ShardedAMDemodulator,
    ShardedFMDemodulator,
    ShardedSquelch,
    ShardedSSBDemodulator,
)
from tpu_sdr_torch.shard.resample import ShardedResampler  # noqa: F401
from tpu_sdr_torch.shard.fastconv import ShardedFastFIR  # noqa: F401
from tpu_sdr_torch.shard.receiver import (  # noqa: F401
    ShardedReceiver,
    ShardedReceiverBank,
)
from tpu_sdr_torch.shard.stereo import ShardedStereoDecoder  # noqa: F401
