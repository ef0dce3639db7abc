"""Producer-thread prefetch (own copy of onebit_asr_tpu/data/prefetch.py).

One daemon thread iterates the source and runs `transfer` on each item up
to `depth` items ahead of the consumer. CUDA work the thread launches goes
to its current stream, which is the default stream, as the consumer's is:
a step the main thread launches on an item is ordered after the work that
made it.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(
    iterable: Iterable[T],
    transfer: Optional[Callable[[T], T]] = None,
    depth: int = 2,
    stats: Optional[Dict[str, float]] = None,
) -> Iterator[T]:
    """Items of `iterable` in order, made (and `transfer`ed) up to `depth`
    items ahead on a daemon thread. An exception of the source or of
    `transfer` is raised to the consumer at its position.

    `stats`, if given, accumulates in place `stats["wait_s"]`, the seconds
    the consumer blocked waiting for the producer (the train CLI's
    `input_wait_frac` is wait_s over the epoch's wall time), and
    `stats["items"]`."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))

    def worker():
        try:
            for item in iterable:
                if transfer is not None:
                    item = transfer(item)
                q.put(item)
        except BaseException as e:  # re-raised in the consuming thread
            q.put((_SENTINEL, e))
        else:
            q.put((_SENTINEL, None))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        if stats is not None:
            t0 = time.perf_counter()
            item = q.get()
            stats["wait_s"] = stats.get("wait_s", 0.0) + (time.perf_counter() - t0)
        else:
            item = q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is _SENTINEL:
            if item[1] is not None:
                raise item[1]
            return
        if stats is not None:
            stats["items"] = stats.get("items", 0) + 1
        yield item
