"""The two load loops and the record of a window.

Closed loop: the next chunk goes out as soon as fewer than ``in_flight``
chunks are unfinished on the device; the window ends at the first dispatch
due after ``seconds``, and lasts until every chunk sent in it has finished.
Open loop: chunk k is due at t0 + k * period, whatever the system does; a
chunk is timed from when it was due, so a stall charges the chunks behind
it, and the generator's own lateness (dispatch start minus due time) is
recorded beside it.

Both take the clock, the sleep and the device marks as arguments, so their
arithmetic is tested without a card.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time


@dataclasses.dataclass
class Window:
    """What one measured window saw."""

    kind: str  # "closed" or "open"
    t0: float
    t_end: float
    chunks: int
    samples_per_chunk: int
    setup_s: float = 0.0
    wait_s: float = 0.0  # closed loop: time spent waiting on the device
    latencies_s: list = dataclasses.field(default_factory=list)
    lateness_s: list = dataclasses.field(default_factory=list)
    kept: dict = dataclasses.field(default_factory=dict)  # chunk index -> output

    @property
    def seconds(self) -> float:
        return self.t_end - self.t0

    @property
    def samples(self) -> int:
        return self.chunks * self.samples_per_chunk


class _Keeper:
    """Keeps the outputs of the chunks sent at the given fractions of the
    window, and of its last chunk."""

    def __init__(self, fractions, seconds: float):
        self.due = collections.deque(sorted(f * seconds for f in fractions))
        self.kept = {}
        self.last = None

    def offer(self, k: int, elapsed: float, out):
        if self.due and elapsed >= self.due[0]:
            self.kept[k] = out
            while self.due and elapsed >= self.due[0]:
                self.due.popleft()
        self.last = (k, out)

    def result(self) -> dict:
        if self.last is not None:
            self.kept[self.last[0]] = self.last[1]
        return self.kept


def closed_loop(dispatch, seconds: float, *, in_flight: int, samples_per_chunk: int,
                mark=lambda: None, fractions=(), max_chunks: int | None = None,
                span=contextlib.nullcontext, clock=time.perf_counter) -> Window:
    """Run ``dispatch(k)`` (chunk k of the stream; returns its output) with
    at most ``in_flight`` chunks unfinished. ``mark()`` records the device's
    progress after a dispatch and returns an object whose ``wait()`` blocks
    until it is reached (None: the dispatch is synchronous). Stops after
    ``seconds`` or ``max_chunks`` chunks."""
    pending = collections.deque()
    keeper = _Keeper(fractions, seconds)
    t0 = clock()
    k, wait_s = 0, 0.0
    while max_chunks is None or k < max_chunks:
        if len(pending) >= in_flight:
            t = clock()
            while len(pending) >= in_flight:
                pending.popleft().wait()
            wait_s += clock() - t
        now = clock()
        if now - t0 >= seconds:
            break
        with span():
            out = dispatch(k)
        marker = mark()
        if marker is not None:
            pending.append(marker)
        keeper.offer(k, now - t0, out)
        k += 1
    while pending:
        pending.popleft().wait()
    t_end = clock()
    return Window("closed", t0, t_end, k, samples_per_chunk, wait_s=wait_s, kept=keeper.result())


def wait_until(due: float, clock=time.perf_counter, sleep=time.sleep):
    """Sleep until a millisecond before ``due``, then spin to it."""
    ahead = due - clock()
    if ahead > 2e-3:
        sleep(ahead - 1e-3)
    while clock() < due:
        pass


def open_loop(dispatch, seconds: float, *, period_s: float, samples_per_chunk: int,
              fractions=(), max_chunks: int | None = None, span=contextlib.nullcontext,
              wait_span=contextlib.nullcontext, clock=time.perf_counter,
              sleep=time.sleep) -> Window:
    """Send chunk k at t0 + k * period_s, for every k due within
    ``seconds`` (or the first ``max_chunks``); ``dispatch(k)`` returns
    when chunk k's result is in the caller's hands. A chunk's latency runs
    from its due time to that return."""
    n = max(1, int(seconds / period_s)) if max_chunks is None else max_chunks
    keeper = _Keeper(fractions, n * period_s)
    latencies, lateness = [], []
    t0 = clock()
    for k in range(n):
        due = t0 + k * period_s
        with wait_span():
            wait_until(due, clock, sleep)
        start = clock()
        with span():
            out = dispatch(k)
        done = clock()
        latencies.append(done - due)
        lateness.append(start - due)
        keeper.offer(k, due - t0, out)
    t_end = clock()
    return Window("open", t0, t_end, n, samples_per_chunk, latencies_s=latencies,
                  lateness_s=lateness, kept=keeper.result())
