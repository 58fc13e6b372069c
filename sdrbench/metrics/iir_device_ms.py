"""iir_device_ms (ms/chunk, device trace): device time a chunk of every op
but the spectrum kernel (``csrc/spectrum_*.cu``, by its kernel name) and
the copies: the window multiply, the IIR products and the frame chain of
``kernels/biquad.py``."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.ms_per_chunk(
        lambda name, cat: not ("spectrum_" in name and "_kernel" in name) and cat != "gpu_memcpy")
