"""Background batch prefetching (port of ``sir_gcn_tpu/data/prefetch.py``).

The reference relies on torch DataLoader workers for this; here one
thread runs the host collation of the next batches (graph batching,
padding, NumPy concatenations) while the device computes. The copies to
the card stay with the consumer, on the calling thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


def prefetch(iterator: Iterable, size: int = 2) -> Iterator:
    """Run ``iterator`` in a daemon thread, buffering up to ``size`` items,
    and yield them in order.

    An exception in the producer is re-raised at the consumer. The
    producer thread is a daemon, so abandoning the iterator mid-epoch
    leaves no thread that keeps the process alive."""
    q: queue.Queue = queue.Queue(maxsize=size)

    def producer():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
            q.put((_SENTINEL, e))
            return
        q.put(_SENTINEL)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            return
        if (isinstance(item, tuple) and len(item) == 2
                and item[0] is _SENTINEL):
            raise item[1]
        yield item
