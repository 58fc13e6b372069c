"""spectrum_bypass_roofline (%, device trace): the real spectrum function's
least time (the frames read once and the magnitudes written once at 3.35
TB/s, or 2.5 N log2 N fp32 operations a frame at 67 TFLOP/s; the longer)
over the device time of ``spectrum_bypass_kernel`` (row 1), a chunk. The
counts come from the chunk's shape (rank 0's block of it in a multi-rank
cell)."""

from sdrbench import roofline


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.ms_per_chunk(lambda name, cat: "spectrum_bypass_kernel" in name)
    if ms is None:
        return None
    frames = roofline.traced_frames(ctx.cell)
    return 100.0 * roofline.bound_s(*roofline.spectrum_real(frames, ctx.cell.config["fft_size"])) * 1e3 / ms
