"""Background-thread buffered batch iterators (reference:
core/.../stages/Batchers.scala:11-130 — DynamicBufferedBatcher drains
whatever accumulated while downstream was busy, FixedBufferedBatcher
prefetches fixed-size batches, TimeIntervalBatcher flushes on a clock).

These are the host-side input-pipeline primitives behind the mini-batch
transformer stages and the serving source: a producer thread keeps the
queue full so the consumer's steps do not wait on ingestion.  The PyTorch
port's copy of the JAX package's ``ops/batchers.py``."""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator, List, Optional, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class _BufferedBatcherBase(Iterator[List[T]]):
    def __init__(self, it: Iterable[T], max_buffer_size: int):
        self._source = iter(it)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_buffer_size)
        self._started = False
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self._consumed = 0          # bumped by every __next__ (liveness)
        self._finished = threading.Event()   # producer exited (± sentinel)
        self._thread = threading.Thread(target=self._produce, daemon=True)

    def _produce(self) -> None:
        try:
            self._fill()
        except BaseException as e:  # re-raised on the consumer thread
            self._error = e
        finally:
            self._put_sentinel()
            # even when _put_sentinel gave up on a saturated queue, the
            # consumer's _get_blocking treats empty-queue + finished
            # producer as end-of-stream, so the sentinel is never lost
            self._finished.set()

    def _fill(self) -> None:
        raise NotImplementedError

    def _put(self, item) -> bool:
        """Enqueue, waking periodically so close() can unblock a producer
        parked on a full queue; False once closed (stop producing)."""
        while not self._done.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _put_sentinel(self) -> None:
        """Deliver end-of-stream even if the queue is momentarily full.

        Retries while the consumer shows signs of life (any __next__ since
        the last Full timeout) and gives up after 30s of zero consumer
        progress — so an abandoned batcher doesn't pin a spinning producer
        thread forever, while a merely busy consumer still gets its
        sentinel."""
        stalled_ticks = 0
        last_seen = self._consumed
        while not self._done.is_set() and stalled_ticks < 300:
            try:
                self._queue.put(_SENTINEL, timeout=0.1)
                return
            except queue.Full:
                if self._consumed != last_seen:
                    last_seen = self._consumed
                    stalled_ticks = 0
                else:
                    stalled_ticks += 1

    def _get_blocking(self):
        """Next queue item, or the sentinel once the producer has exited
        and the queue is drained (covers the saturated-queue give-up path
        in _put_sentinel)."""
        while True:
            try:
                return self._queue.get(timeout=0.1)
            except queue.Empty:
                if self._finished.is_set() and self._queue.empty():
                    return _SENTINEL

    def _exhausted(self) -> None:
        """Sentinel seen: stay exhausted, surface any producer error."""
        self._queue.put(_SENTINEL)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def start(self) -> None:
        if not self._started:
            self._started = True
            self._thread.start()

    def close(self) -> None:
        self._done.set()
        if self._started:
            self._thread.join(timeout=1.0)

    def __iter__(self) -> "Iterator[List[T]]":
        return self


class DynamicBufferedBatcher(_BufferedBatcherBase):
    """Yield lists sized by whatever the producer buffered since the last
    ``next()`` — slow consumers get bigger batches (amortizing fixed
    per-batch cost), fast consumers get small low-latency ones."""

    def __init__(self, it: Iterable[T], max_buffer_size: int = 2 ** 30):
        super().__init__(it, max_buffer_size)

    def _fill(self) -> None:
        for item in self._source:
            if not self._put(item):
                return

    def __next__(self) -> List[T]:
        self.start()
        self._consumed += 1
        first = self._get_blocking()
        if first is _SENTINEL:
            self._exhausted()
            raise StopIteration
        batch = [first]
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return batch
            if item is _SENTINEL:
                # re-plant so a subsequent __next__ terminates
                self._queue.put(_SENTINEL)
                return batch
            batch.append(item)


class FixedBufferedBatcher(_BufferedBatcherBase):
    """Prefetch fixed-size batches on a producer thread (reference:
    FixedBufferedBatcher, Batchers.scala:65)."""

    def __init__(self, it: Iterable[T], batch_size: int,
                 max_buffer_size: int = 2 ** 30):
        super().__init__(it, max_buffer_size)
        self.batch_size = int(batch_size)

    def _fill(self) -> None:
        batch: List[T] = []
        for item in self._source:
            if self._done.is_set():
                return
            batch.append(item)
            if len(batch) >= self.batch_size:
                if not self._put(batch):
                    return
                batch = []
        if batch:
            self._put(batch)

    def __next__(self) -> List[T]:
        self.start()
        self._consumed += 1
        item = self._get_blocking()
        if item is _SENTINEL:
            self._exhausted()
            raise StopIteration
        return item


class TimeIntervalBatcher(_BufferedBatcherBase):
    """Flush accumulated rows every ``interval_ms`` wall-clock
    milliseconds (reference: TimeIntervalBatcher, Batchers.scala:96 —
    used by TimeIntervalMiniBatchTransformer).

    The first row of a batch is awaited indefinitely; once one row is in
    hand the flush deadline is hard — a stalled producer yields a small
    on-time batch rather than a late big one."""

    def __init__(self, it: Iterable[T], interval_ms: int,
                 max_batch_size: Optional[int] = None,
                 max_buffer_size: int = 2 ** 30):
        super().__init__(it, max_buffer_size)
        self.interval_s = interval_ms / 1000.0
        self.max_batch_size = max_batch_size

    def _fill(self) -> None:
        for item in self._source:
            if not self._put(item):
                return

    def __next__(self) -> List[T]:
        self.start()
        self._consumed += 1
        first = self._get_blocking()
        if first is _SENTINEL:
            self._exhausted()
            raise StopIteration
        batch = [first]
        deadline = time.monotonic() + self.interval_s
        while True:
            if (self.max_batch_size is not None
                    and len(batch) >= self.max_batch_size):
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is _SENTINEL:
                self._queue.put(_SENTINEL)
                break
            batch.append(item)
        return batch
