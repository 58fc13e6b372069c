"""Frequency scanner: sweep a DDC bank across a span, report occupancy (the
counterpart of ``tpu_sdr.runtime.scanner``).

The span is gridded into channels; a ``DDCBank`` mixes ``k_per_dispatch``
carriers per dispatch (the input read once per batch), the per-channel
band power is the mean |z|^2 of the decimated baseband after the FIR
transient, reduced on the device with a fixed-order sum
(``ddc.fixed_sum``) to one (K,) array a batch, and channels above the
median floor + ``threshold_db`` are flagged. A real tone of amplitude A
in-channel reads A^2/4 (one mixer image), an IQ tone A^2.

The default FIR (16 taps a branch, Blackman-Harris) keeps adjacent
channels far below the threshold. ``mesh=`` (a ``shard.mesh.SdrMesh``)
spreads each batch's carriers over the mesh's channel axis and the stream
over its time axis (``shard.ShardedDDCBank``); the input is then one
stream, and the gathered planes give the single-device powers bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_sdr_torch.kernels.ddc import DDCBank, fixed_sum


@dataclasses.dataclass
class ScanResult:
    centers_hz: np.ndarray  # (n_channels,)
    power: np.ndarray  # (n_channels,) linear mean|z|^2
    power_db: np.ndarray  # (n_channels,) 10*log10(power)
    noise_floor_db: float  # median of power_db
    occupied: np.ndarray  # (n_channels,) bool
    threshold_db: float

    @property
    def hits(self) -> list[dict]:
        """Occupied channels, strongest first."""
        idx = np.flatnonzero(self.occupied)
        idx = idx[np.argsort(-self.power_db[idx])]
        return [
            {
                "center_hz": float(self.centers_hz[i]),
                "power_db": float(self.power_db[i]),
                "snr_db": float(self.power_db[i] - self.noise_floor_db),
            }
            for i in idx
        ]


class SpectrumScanner:
    """Grid [f_start, f_stop) into ``channel_bw``-wide channels and scan.

    ``k_per_dispatch`` carriers are mixed per DDCBank dispatch; the last
    batch is padded by repeating its first center (padding results are
    dropped). ``decimation`` defaults to the largest R whose output rate
    still covers one channel. Real input (``scan``) or IQ planes
    (``scan_planes``). ``device`` None means CUDA."""

    def __init__(
        self,
        fs: float = 1_000_000.0,
        f_start: float = 0.0,
        f_stop: float = 500_000.0,
        channel_bw: float = 25_000.0,
        threshold_db: float = 10.0,
        k_per_dispatch: int = 16,
        decimation: int | None = None,
        taps_per_phase: int = 16,
        window: str = "blackmanharris",
        mesh=None,
        device=None,
    ):
        if mesh is not None:
            if device is not None:
                raise ValueError("mesh= runs on the mesh's devices; pass no device")
            device = mesh.device
        if f_stop <= f_start:
            raise ValueError(f"empty span [{f_start}, {f_stop})")
        if channel_bw <= 0:
            raise ValueError(f"channel_bw must be > 0; got {channel_bw}")
        self.fs = float(fs)
        self.channel_bw = float(channel_bw)
        self.threshold_db = float(threshold_db)
        n = int(np.floor((f_stop - f_start) / channel_bw))
        if n < 1:
            raise ValueError("span narrower than one channel")
        self.centers_hz = f_start + channel_bw * (0.5 + np.arange(n))
        # `is not None`: decimation=0 must reach DDCBank's own validation
        r = (
            int(decimation) if decimation is not None
            else max(1, int(self.fs // channel_bw))
        )
        self.k = min(int(k_per_dispatch), n)
        self.bank = DDCBank(
            fs=self.fs,
            centers_hz=[float(c) for c in self.centers_hz[: self.k]],
            decimation=r,
            taps_per_phase=taps_per_phase,
            window=window,
            device=device,
        )
        self.device = self.bank.device
        self.mesh = mesh
        self._exec = self.bank
        if mesh is not None:
            from tpu_sdr_torch.shard.ddcbank import ShardedDDCBank

            if self.k % mesh.shape["channel"]:
                raise ValueError(
                    f"k_per_dispatch={self.k} must divide over "
                    f"{mesh.shape['channel']} channel shards")
            self._exec = ShardedDDCBank(self.bank, mesh)

    @property
    def n_channels(self) -> int:
        return self.centers_hz.size

    @property
    def decimation(self) -> int:
        return self.bank._template.r

    def _measure_batch(self, x, centers, iq: bool) -> np.ndarray:
        self._exec.retune([float(c) for c in centers])
        if self.mesh is None:
            batch = x.shape[1:-1] if iq else x.shape[:-1]
            state = self.bank.initial_state(batch)
        else:
            state = self._exec.initial_state()
        out, _ = (self._exec.process_planes if iq else self._exec.process)(x, state)
        if self.mesh is not None:
            out = self._exec.gather(out)
        # Discard the FIR transient (the first P-1 decimated outputs ramp
        # from zero history), then mean |z|^2 over time and any input
        # batch axes, per carrier: one (K,) array to the host.
        re, im = out["re"], out["im"]
        skip = min(self.bank._template.p - 1, re.shape[-1] - 1)
        rr = re[..., skip:]
        ii = im[..., skip:]
        p2 = (rr * rr + ii * ii).reshape(self.k, -1)
        power = fixed_sum(p2) / p2.shape[-1]
        return power.cpu().numpy().astype(np.float64)

    def _scan(self, x, iq: bool) -> ScanResult:
        if self.mesh is None:
            x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        elif not torch.is_tensor(x):
            x = np.asarray(x, np.float32)  # each rank uploads its own slice
        t = x.shape[-1]
        r = self.decimation
        p = self.bank._template.p
        ts = 1 if self.mesh is None else self.mesh.shape["time"]
        grain = r * ts
        t_use = (t // grain) * grain
        # the FIR transient plus one output; each time shard also needs the
        # (p-1)*r halo in its slice
        min_t = max(r * (p + 1), ts * (p - 1) * r)
        if t_use < min_t:
            raise ValueError(f"need at least {min_t} samples; got {t}")
        x = x[..., :t_use]
        power = np.empty(self.n_channels)
        for lo in range(0, self.n_channels, self.k):
            batch = self.centers_hz[lo : lo + self.k]
            pad = self.k - batch.size
            if pad:
                batch = np.concatenate([batch, np.repeat(batch[:1], pad)])
            batch_power = self._measure_batch(x, batch, iq)
            power[lo : lo + self.k - pad] = batch_power[: self.k - pad]
        power_db = 10.0 * np.log10(np.maximum(power, 1e-30))
        floor = float(np.median(power_db))
        occupied = power_db > floor + self.threshold_db
        return ScanResult(
            centers_hz=self.centers_hz.copy(),
            power=power,
            power_db=power_db,
            noise_floor_db=floor,
            occupied=occupied,
            threshold_db=self.threshold_db,
        )

    def scan(self, x) -> ScanResult:
        """Real input (T,) or (..., T) (NumPy or a tensor): batch axes are
        averaged into the per-channel power (a multi-capture scan)."""
        if x.is_complex() if torch.is_tensor(x) else np.iscomplexobj(x):
            # a complex->float cast would split each tone into +-f mirrors
            # at half power, corrupting occupancy decisions
            raise ValueError(
                "complex (IQ) input: split re/im and use scan_planes"
            )
        return self._scan(x, iq=False)

    def scan_planes(self, xs) -> ScanResult:
        """IQ planes (2, ..., T)."""
        return self._scan(xs, iq=True)
