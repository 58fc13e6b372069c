"""h2d_link_share (%, device trace): a chunk's bytes over its copy's device
time (``h2d_device_ms``), as a share of the host link's peak in one
direction.

The peak: PCIe Gen5 x16, the H100 SXM's host interface (NVIDIA's data
sheet), 32 GT/s a lane x 16 lanes x 128/130 (the 128b/130b line code) / 8
bits = 63.0 GB/s a direction. The bytes: the chunk as the feeder copies it,
float32, 4 bytes a sample (8 for an IQ sample's two planes), counted from
the cell's shape: 64 x 16 x 16384 x 4 = 67,108,864 B in
``bank64.custom.hostfed``."""

from sdrbench.metrics.h2d_device_ms import read as h2d_device_ms

LINK_PEAK_BYTES_S = 32e9 * 16 * (128 / 130) / 8


def chunk_bytes(cell) -> int:
    return cell.samples_per_chunk * (8 if cell.complex_input else 4)


def read(ctx):
    ms = h2d_device_ms(ctx)
    if ms is None:
        return None
    return 100.0 * chunk_bytes(ctx.cell) / (ms / 1e3) / LINK_PEAK_BYTES_S
