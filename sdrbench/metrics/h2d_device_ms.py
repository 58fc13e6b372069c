"""h2d_device_ms (ms/chunk, device trace): device time a chunk of the
feeder's host-to-device copies (``runtime/feeder.py``), the chunk crossing
the link.

The producer launches each copy on its own thread, ahead of the consumer,
and ``trace.py`` keeps only the ops whose launching call started inside
some chunk's range, on whatever thread: a copy launched between two ranges
is not in the view. So the reader takes the mean over the copies it sees,
one chunk's crossing each, and not their sum over the chunks, which would
read low by the share that fell between ranges.

The harness's profiler records the consumer's thread only, so the
producer's spans are not in the trace: a chunk's copy is taken by kind, a
``Memcpy HtoD`` from pinned memory, and by size: the view holds no byte
counts, so a copy counts where its device time is at least half the
longest such copy's (each chunk is the same size; a small upload takes
microseconds). A program without the feeder reads None."""


def chunk_copies_us(view) -> list[float] | None:
    """Device us of each chunk's copy that the view holds; None where it
    holds none."""
    pinned = [te - ts for ops in view.chunks for ts, te, name, cat in ops
              if cat == "gpu_memcpy" and "HtoD" in name and "Pinned" in name]
    times = [us for us in pinned if us >= max(pinned) / 2] if pinned else []
    return times or None


def read(ctx):
    if ctx.trace is None:
        return None
    times = chunk_copies_us(ctx.trace)
    return None if times is None else sum(times) / len(times) / 1e3
