"""Background prefetch iterator: overlap host work with device compute
(a copy of intact_tpu/utils/prefetch.py).

The train loop's host side (next synthetic batch, tokenize, normalize, the
host-to-device copy) runs on a worker thread, keeping `depth` prepared
batches ahead. CUDA launches return before the device finishes, so while
step N executes on the card the worker assembles batch N+1.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


class PrefetchIterator:
    """Wraps an iterator, applying `prepare` on a worker thread.

    Exceptions (incl. StopIteration) re-raise in the consumer. `depth`
    bounds host memory: at most depth prepared batches are in flight.
    """

    _DONE = object()

    def __init__(self, it: Iterator, prepare: Callable = lambda x: x,
                 depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: list[BaseException] = []
        self._closed = threading.Event()

        def worker():
            try:
                for item in it:
                    prepared = prepare(item)
                    # bounded put that notices close(): a consumer that
                    # stops early (trainer reached n_updates) must not leave
                    # this thread blocked forever holding prepared device
                    # buffers and the underlying iterator
                    while not self._closed.is_set():
                        try:
                            self._q.put(prepared, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if self._closed.is_set():
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised in consumer
                self._err.append(e)
            finally:
                # the sentinel MUST land (a dropped sentinel hangs the
                # consumer); bounded retries so close() still unblocks us
                while not self._closed.is_set():
                    try:
                        self._q.put(self._DONE, timeout=0.2)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err:
                raise self._err[0]
            raise StopIteration
        return item

    def close(self, timeout: float = 5.0) -> None:
        """Stop the worker and drop queued batches. Idempotent; call when
        abandoning the iterator before exhaustion."""
        self._closed.set()
        while True:  # unblock a worker waiting on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=timeout)

    def __del__(self):  # best-effort: don't leak the worker
        try:
            self.close(timeout=0.1)
        except Exception:
            pass
