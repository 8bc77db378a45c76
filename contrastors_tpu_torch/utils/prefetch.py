"""Background batch preparation, counterpart of
`contrastors_tpu/utils/prefetch.py`.

A daemon thread runs the dataset iterator (reading, tokenizing, collating)
and `transform` on each item, which makes the batch's pinned CPU tensors,
while the card runs the previous step; the loop's thread issues the copies
to the device itself (`.to(device, non_blocking=True)`). At most `depth`
prepared items wait in the queue. An exception in the worker is raised in
the loop's thread at the next `next()`, never dropped. `wait_seconds` sums
the time the loop's thread has waited on the queue.
"""

import queue
import threading
import time
from typing import Callable, Iterator, Optional


class PrefetchIterator:
    def __init__(self, it: Iterator, transform: Optional[Callable] = None, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self.wait_seconds = 0.0

        def worker():
            try:
                for item in it:
                    if transform is not None:
                        item = transform(item)
                    if not self._put(item):
                        return
            except BaseException as e:  # noqa: BLE001 - handed to the consumer, which raises it
                self._err = e
            self._put(self._sentinel)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue item unless close() was called; False when it was."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = self._q.get()
        self.wait_seconds += time.perf_counter() - t0
        if item is self._sentinel:
            self._q.put(self._sentinel)  # a later next() ends too
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self, timeout: float = 60.0):
        """Stop the worker after its current item and wait for it."""
        self._stop.set()
        self._thread.join(timeout)
