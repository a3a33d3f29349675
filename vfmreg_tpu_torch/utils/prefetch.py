"""Host-side IO / compute overlap: a copy of `vfmreg_tpu/utils/prefetch.py`.

`prefetch(iterable, size)` iterates `iterable` on a background thread,
`size` items ahead: the next frames are read and decoded while the card
registers the current one. An exception re-raises where the item would have
been consumed, and the thread stops when the consumer does.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(iterable: Iterable[T], size: int = 2) -> Iterator[T]:
    """Iterate `iterable` on a background thread, `size` items ahead."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def worker():
        def put_checked(obj) -> bool:
            # Every put polls `stop`: a blocking put on a full queue after the
            # consumer left would strand the thread for the life of the process.
            while not stop.is_set():
                try:
                    q.put(obj, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for item in iterable:
                if not put_checked(item):
                    return
        except BaseException as e:  # re-raised at the consumer
            put_checked((_SENTINEL, e))
            return
        put_checked((_SENTINEL, None))

    t = threading.Thread(target=worker, daemon=True, name="vfmreg-torch-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _SENTINEL:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()
