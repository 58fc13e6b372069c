"""device_ops_per_chunk (ops/chunk, device trace): device ops (kernels,
copies, sets) charged to a chunk by correlation id. It is split by the
end-to-end metric it moves: ``.sat`` (the host-bound closed-loop cell,
``msps``), ``.dev`` (the device-bound cells, ``msps.dev``), ``.rt`` (the
facade's open loop)."""


def read(ctx):
    return ctx.trace.ops_per_chunk() if ctx.trace is not None else None
