"""Configuration for the PyTorch/CUDA spectrum pipeline.

A copy of ``tpu_sdr.core.config`` (``FilterMode``, ``CommMode``,
``PipelineConfig``, ``HostConfig``, ``default_config``): the port imports nothing of ``tpu_sdr``, so it keeps its
own copy of the jax-free configuration. Field names, defaults and validation
are identical, so one config value means the same deployment in either
package.
"""

from __future__ import annotations

import dataclasses
import enum


class FilterMode(enum.IntEnum):
    """Datapath routing, mirroring the reference command bytes.

    Reference: ``src/command_control.vhd:46-74`` decodes 0x00 (fixed filter),
    0xA1 (custom filter), 0xB1 (bypass, the reset default :31).
    """

    FIXED = 0x00
    CUSTOM = 0xA1
    BYPASS = 0xB1


class CommMode(enum.IntEnum):
    """Output transport select, mirroring reference ``imp/sequ2.vhd:82-96``."""

    ETHERNET = 0xEF
    UART = 0xFE


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static (shape-defining) configuration. Hashable.

    Defaults reproduce the reference scale facts: 16K-point FFT, 1 MSPS,
    12th-order IIR = 6 biquad sections.
    """

    # FFT frame length; must equal fft_n1 * fft_n2.
    fft_size: int = 16384
    # Four-step FFT factors (the kernel takes the 128x128 factorization).
    fft_n1: int = 128
    fft_n2: int = 128
    # Biquad cascade depth: 12th-order = 6 second-order sections.
    n_sections: int = 6
    # Block length of the blocked state-space IIR.
    iir_block: int = 128
    # Number of parallel channels processed together.
    channels: int = 1
    # Nominal sample rate in Hz (display/derived quantities only).
    sample_rate: float = 1_000_000.0
    # Window/FFT hop. None = fft_size, no overlap (the reference's framing).
    hop: int | None = None
    # Numeric quality tier: "f32" (default), "f32max" or "bf16". In this
    # port every tier computes in IEEE fp32; the tiers differ only in the
    # bf16_io casts below (tensor-core tiers are later work, see ROADMAP).
    dtype: str = "f32"
    # True: the RTL-faithful offset window (2*hann-1 = -cos) instead of the
    # true Hann window.
    rtl_faithful_window: bool = False
    # Use the fused window+FFT+magnitude kernel for magnitude output at the
    # 128x128 geometry; False takes the plain four-step path.
    use_pallas: bool = True
    # True: the fully-fused two-pass kernel pipeline for the f32/f32max
    # tiers (the IIR inside the kernels); the bf16 tier ignores it.
    fused_two_pass: bool = False
    # bf16 tier only: the IIR output reaches the FFT kernel as bfloat16 and
    # the magnitudes are stored as bfloat16 (the fp32 results rounded once).
    bf16_io: bool = False
    # Magnitude store layout of the kernel. The port's kernel always writes
    # natural-order (F, n) rows, so both values give the same bits.
    pallas_flat_emit: bool = True

    def __post_init__(self):
        if self.fft_n1 * self.fft_n2 != self.fft_size:
            raise ValueError(
                f"fft_n1*fft_n2 ({self.fft_n1}*{self.fft_n2}) != fft_size "
                f"({self.fft_size})"
            )
        if self.fft_size % self.iir_block != 0:
            raise ValueError("fft_size must be a multiple of iir_block")
        if self.hop is not None and not (0 < self.hop <= self.fft_size):
            raise ValueError("hop must be in (0, fft_size]")
        if self.hop is not None and self.fft_size % self.hop:
            raise ValueError("hop must divide fft_size (aligned framing)")
        if self.dtype not in ("f32", "f32max", "bf16"):
            raise ValueError(
                f"dtype must be f32 | f32max | bf16, got {self.dtype!r}"
            )

    @property
    def effective_hop(self) -> int:
        return self.fft_size if self.hop is None else self.hop

    def pallas_geometry_ok(self) -> bool:
        """Whether the fused spectrum kernel applies to this configuration.

        The kernel and its plan hard-code the 128x128 four-step geometry;
        every other legal factorization takes the plain four-step path. This
        single predicate is the eligibility gate that bank construction
        (``runtime/banks.build_bank``) and the dispatch in
        ``runtime/stream.py`` share.
        """
        return (
            self.use_pallas
            and self.fft_n1 == 128
            and self.fft_n2 == 128
            and self.iir_block == 128
        )

    @property
    def bins_per_hz(self) -> float:
        return self.fft_size / self.sample_rate

    @property
    def hz_per_bin(self) -> float:
        return self.sample_rate / self.fft_size


@dataclasses.dataclass
class HostConfig:
    """Host-edge (transport / GUI) configuration.

    Mirrors the USER CONFIG block of the reference GUI
    (``scripts/fft_analyzer_gui.py:17-54``).
    """

    udp_bind_ip: str = "0.0.0.0"
    udp_port: int = 6006
    expected_src_ip: str = "169.254.252.255"
    expected_src_port: int = 5005
    frame_size_bytes: int = 65536
    packets_per_frame: int = 64
    packet_data_size: int = 1024
    ethernet_payload_size: int = 1025
    display_fps_cap: float = 30.0
    http_port: int = 5000
    uart_baud: int = 230400


def default_config(**overrides) -> PipelineConfig:
    return PipelineConfig(**overrides)
