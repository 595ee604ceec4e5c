"""Background-thread batch prefetch for training and evaluation input.

Counterpart of ``gmf_tpu/data/prefetch.py``: a bounded producer thread,
so that host-side batch construction (sampling, matching, collation;
NumPy releases the GIL) overlaps the card's work on the previous step.
The reference feeds its trainers from multi-worker torch DataLoaders
(GMF_PointDSC/train_3dmatch.py num_workers=16).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_END = object()


def prefetch_iter(iterable: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate ``iterable`` on a daemon thread, ``depth`` items ahead.

    Order-preserving; exceptions from the producer re-raise at the
    consumer. ``depth <= 0`` returns the iterable unchanged.
    """
    if depth <= 0:
        yield from iterable
        return

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    err = []
    stop = threading.Event()

    def worker():
        try:
            for item in iterable:
                # bounded put that notices consumer abandonment, so a
                # dropped generator doesn't pin the thread (and its
                # buffered batches) on a full queue forever
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # propagate to the consumer
            err.append(e)
        finally:
            while True:  # same abandonment-aware bounded put for _END
                try:
                    q.put(_END, timeout=0.1)
                    break
                except queue.Full:
                    if stop.is_set():
                        break

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        # consumer closed early (break / exception / GC): unblock and
        # retire the producer, dropping whatever it buffered
        stop.set()
        deadline = 50  # 5 s of 0.1 s producer put timeouts
        while t.is_alive() and deadline > 0:
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.1)
            deadline -= 1
