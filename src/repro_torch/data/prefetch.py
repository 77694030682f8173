"""Double-buffered device feed (the port of `repro.data.prefetch`): the
paper's Fig. 15 scheme. While the card computes step k, a background
thread materializes batch k+1; `depth` batches may wait in the ring.

The producer's copy to the card is a plain synchronous copy on the
device's default stream, the stream the train step runs on: the copy is
ordered after the work already queued there and before the step that
reads it, so no event is needed; the thread waits for that work, the
training loop does not. (A side-stream copy from pinned memory, which
would need the step's stream to wait on an event, is not part of the
port.)

An exception in `make_batch` is captured on the producer thread and
re-raised on the consumer side after the batches queued before it; a
dead producer never leaves the consumer blocked. `close()` is
idempotent. `transfer_seconds` is the producer's time a batch,
`consumer_wait_seconds` how long each `next()` blocked; `stall_report()`
folds both into `core.overlap.overlap_report`.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator

from repro_torch.core.overlap import overlap_report

_ERR = object()          # producer-failure sentinel (queued after good batches)


class DoubleBufferedFeed:
    def __init__(self, make_batch: Callable[[int], dict], *, depth: int = 2,
                 start_step: int = 0):
        self.make_batch = make_batch
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._timings: list[float] = []
        self._waits: list[float] = []
        self._error: BaseException | None = None
        self._closed = False
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        step = self._step
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                batch = self.make_batch(step)
            except BaseException as e:          # noqa: BLE001 — relayed
                self._error = e
                item: tuple = (_ERR, e)
            else:
                self._timings.append(time.perf_counter() - t0)
                item = (step, batch)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if item[0] is _ERR:
                return
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self) -> tuple[int, dict]:
        if self._error is not None and self._q.empty():
            self._raise()                       # sentinel already consumed
        t0 = time.perf_counter()
        item = self._q.get()
        self._waits.append(time.perf_counter() - t0)
        if item[0] is _ERR:
            self._raise()
        return item

    def _raise(self):
        raise RuntimeError(
            "DoubleBufferedFeed producer failed in make_batch"
        ) from self._error

    @property
    def transfer_seconds(self) -> list[float]:
        return list(self._timings)

    @property
    def consumer_wait_seconds(self) -> list[float]:
        return list(self._waits)

    def stall_report(self) -> dict:
        """Producer busy time against consumer blocked time; the first
        wait (the pipeline fill) is dropped."""
        return overlap_report(sum(self._timings), sum(self._waits[1:]))

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)
