"""d2h_copy_ms (ms/chunk, device trace): device time a chunk of the
device-to-host copies, the facade's return of the magnitudes."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.ms_per_chunk(lambda name, cat: cat == "gpu_memcpy" and "DtoH" in name)
