"""Background-thread batch prefetching for the training loop.

Counterpart of `evoworld_tpu/data/prefetch.py`: a bounded-queue thread in
front of any batch iterator, the role of a multi-worker DataLoader. While the
card runs step N (CUDA launches return before the work ends), the worker
thread builds batch N+1 on the host.

Worker exceptions are re-raised at the consuming ``next()`` call, and the
thread is a daemon, so a crash mid-epoch fails the training loop loudly
instead of hanging it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class PrefetchIterator:
    """Wrap `it` so items are produced by a background thread.

    Args:
        it: any iterator (e.g. `episode_batches(...)`).
        depth: max batches buffered ahead (the torch `num_workers` analogue;
            2 is enough to hide host prep behind an async device step).
    """

    def __init__(self, it: Iterator[T], depth: int = 2):
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(it,), daemon=True)
        self._thread.start()

    def _run(self, it: Iterator[T]) -> None:
        try:
            for item in it:
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # re-raised on the consumer side
            self._err = e
        finally:
            while not self._stop.is_set():
                try:
                    self._queue.put(_SENTINEL, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self) -> T:
        item = self._queue.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the worker and drain; safe to call more than once."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
