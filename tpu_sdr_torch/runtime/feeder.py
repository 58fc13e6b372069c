"""Double-buffered host->device sample staging, the async-FIFO analog (the
counterpart of ``tpu_sdr.runtime.feeder``).

The reference decouples its 1 MSPS producer from the burst consumer with a
dual-clock FIFO (``imp/fifo.vhd``). Here the producer is a host sample
source and the consumer is the device pipeline: a background thread reads
the source and stages chunks on the device ahead of consumption, so
acquisition, host->device copy and compute overlap. ``depth`` staged chunks
play the FIFO-depth role; when the consumer stalls, the feeder blocks
(backpressure) rather than dropping.

    feeder = StreamFeeder(source, chunk_samples=4 * 16384)
    feeder.start()
    for _ in range(n):
        x = feeder.get()              # on the device, copy ordered before use
        out, state = pipe.process(x, state, mode)

On a CUDA device each chunk goes through a pinned host buffer and
``.to(device, non_blocking=True)`` on a side stream; an event recorded after
the copy is what ``get()`` makes the consumer's current stream wait on. A
pinned buffer is refilled only after its previous copy's event has
completed: ``depth`` chunks can wait in the queue while the producer fills
one more, so a depth-d feeder owns d + 1 buffers. On the CPU a chunk is a
tensor copy of the host array.

A source that takes the copy's event back (``release(slot, event)``, as
``source.PinnedRingSource`` does) and whose ``read()`` returns a pinned
float32 tensor skips the host copy: the slot itself is copied to the device
on the side stream, and the copy's event goes back to the source, which
hands the slot out again only after it. Each chunk crosses the link anew;
no device copy of a slot is kept. On the CPU such a tensor is cloned.
Other sources, whatever they return, and a sharded feeder take the path
above.

``stats`` counts ``chunks_staged`` (chunks put in the queue),
``bytes_staged`` (their bytes), ``host_copies`` (those of them copied on
the host first: 0 on the pinned path), ``consumer_waits`` (``get()`` calls
that found nothing staged) and ``release_waits`` (staging buffers whose
previous copy had not finished when they were due; a ring source counts
its slots' waits itself). While a profiler runs,
the producer opens the span ``tpu_sdr.feeder.stage`` around one chunk's
read and copy launch, and ``get()`` the span ``tpu_sdr.feeder.get``
(``core/spans.py``).

Complex (IQ) sources are split into re/im planes on the host (shape
(2, ..., T) float32); consume those chunks with
``pipe.process_planes(x, state, mode)``.

``sharding=mesh`` (a ``shard.mesh.SdrMesh``) feeds a sharded engine: each
rank's feeder reads the whole chunk from its source, stages only this
rank's (channel, time) block (channels on the chunk's second-to-last axis,
time on its last) to the rank's device, and hands it over as a
``ShardedArray`` for ``ShardedSpectrumPipeline.process`` (or
``process_planes``).
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from tpu_sdr_torch.core.spans import span


class StreamFeeder:
    def __init__(
        self,
        source,
        chunk_samples: int,
        depth: int = 2,
        sharding=None,
        pace: bool = False,
        device=None,
    ):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if sharding is not None and device is not None and torch.device(device) != sharding.device:
            raise ValueError(
                f"device={device!r} beside sharding on {sharding.device}: a sharded feeder "
                "stages on its mesh's device"
            )
        self.sharding = sharding
        if sharding is not None:
            device = sharding.device
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "StreamFeeder: no CUDA device is available; pass device='cpu' to stage "
                "chunks as CPU tensors"
            )
        self.source = source
        self.chunk_samples = chunk_samples
        self.pace = pace
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._pinned: list = []  # [buffer, copy-done event or None], depth + 1 of them
        self._next = 0
        self._stream = None
        self.stats = {"chunks_staged": 0, "bytes_staged": 0, "host_copies": 0,
                      "consumer_waits": 0, "release_waits": 0}

    @property
    def chunks_staged(self) -> int:
        return self.stats["chunks_staged"]

    def start(self):
        # A restart must never run two producers over one source: if a
        # previous thread out-waited stop()'s bounded join (blocked in a long
        # source.read()), wait it out before spawning the replacement.
        if self._thread is not None and self._thread.is_alive():
            self._stop.set()
            self._thread.join()
        self._thread = None
        self._error = None  # a restart starts clean
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _host_array(self, x) -> np.ndarray:
        if isinstance(x, torch.Tensor):
            x = x.numpy()
        if np.iscomplexobj(x):
            # IQ source: the (2, ..., T) stacked re/im layout the complex
            # pipeline consumes; never silently drop the Q plane.
            x = np.asarray(x)
            return np.stack([x.real, x.imag], axis=0).astype(np.float32)
        return np.asarray(x, np.float32)

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
            self._pinned = [[None, None] for _ in range(self.depth + 1)]
        return self._stream

    def _copy(self, buf: torch.Tensor):
        """Copy the host tensor ``buf`` to the device on the side stream;
        returns (device tensor, the copy's event)."""
        stream = self._side_stream()
        with torch.cuda.stream(stream):
            dev = buf.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return dev, done

    def _stage_cuda(self, host: np.ndarray):
        """Copy ``host`` to the device through the next pinned buffer on the
        side stream; returns (device tensor, the copy's event)."""
        self._side_stream()
        slot = self._pinned[self._next]
        self._next = (self._next + 1) % len(self._pinned)
        buf, done = slot
        if done is not None and not done.query():
            self.stats["release_waits"] += 1
            done.synchronize()  # its previous copy must have read it
        if buf is None or buf.shape != host.shape:
            buf = torch.empty(host.shape, dtype=torch.float32, pin_memory=True)
        buf.numpy()[...] = host
        dev, done = self._copy(buf)
        slot[0], slot[1] = buf, done
        return dev, done

    def _direct(self, x) -> bool:
        """Whether ``x`` crosses as it is: a float32 tensor from a pinned
        slot (any CPU tensor on a CPU feeder) of a source that takes the
        copy's event back, unsharded."""
        return (isinstance(x, torch.Tensor) and x.dtype == torch.float32 and self.sharding is None
                and x.device.type == "cpu" and (self.device.type == "cpu" or x.is_pinned())
                and callable(getattr(self.source, "release", None)))

    def _stage(self):
        """Read one chunk and launch its copy; returns the queue's item,
        its bytes and whether it was copied on the host first."""
        x = self.source.read(self.chunk_samples, pace=self.pace)
        if self._direct(x):
            nbytes = x.numel() * x.element_size()
            if self.device.type == "cpu":
                return (x.clone(), None, tuple(x.shape)), nbytes, False
            dev, done = self._copy(x)
            self.source.release(x, done)
            return (dev, done, tuple(x.shape)), nbytes, False
        host = self._host_array(x)
        shape = host.shape
        if self.sharding is not None:
            channel_dim = -2 if host.ndim >= 2 else None
            host = np.ascontiguousarray(host[self.sharding.block_index(shape, channel_dim, -1)])
        if self.device.type == "cuda":
            return (*self._stage_cuda(host), shape), host.nbytes, True
        return (torch.from_numpy(host.copy()), None, shape), host.nbytes, True

    def _run(self):
        try:
            while not self._stop.is_set():
                with span("tpu_sdr.feeder.stage"):
                    item, nbytes, host_copy = self._stage()
                # block (backpressure) until the consumer frees a slot
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.2)
                        self.stats["chunks_staged"] += 1
                        self.stats["bytes_staged"] += nbytes
                        self.stats["host_copies"] += host_copy
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced in get()
            self._error = e

    def _hand_over(self, item):
        dev, done, shape = item
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            # the tensor was allocated on the side stream: keep the caching
            # allocator from reusing its memory before the consumer is done
            dev.record_stream(stream)
        if self.sharding is not None:
            from tpu_sdr_torch.shard.mesh import ShardedArray

            return ShardedArray(dev, tuple(shape))
        return dev

    def get(self, timeout: float = 30.0):
        """Next staged chunk (FIFO order), on the feeder's device (with
        ``sharding``, this rank's block as a ``ShardedArray``); on CUDA
        the caller's current stream waits for its copy. Raises feeder errors
        promptly (short-poll so a dead producer fails fast)."""
        with span("tpu_sdr.feeder.get"):
            return self._get(timeout)

    def _get(self, timeout: float):
        deadline = time.monotonic() + timeout
        waited = False
        while True:
            # drain already-staged chunks before surfacing a producer error:
            # data staged before the failure is still valid signal
            try:
                return self._hand_over(self._q.get_nowait())
            except queue.Empty:
                pass
            if not waited:
                self.stats["consumer_waits"] += 1
                waited = True
            if self._error is not None:
                raise self._error
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError("feeder produced no chunk in time")
            try:
                return self._hand_over(self._q.get(timeout=min(0.2, remaining)))
            except queue.Empty:
                continue

    def _drain(self):
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def stop(self):
        self._stop.set()
        # a producer blocked on the full queue puts its chunk and sees the stop
        self._drain()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            if not self._thread.is_alive():
                self._thread = None
            # else: still blocked in source.read(); keep the reference so
            # start() can wait it out instead of running two producers
        # drain staged chunks so buffers free promptly
        self._drain()
