"""Byte-budgeted thread-safe LRU, the cache behind the fragment caches
(the registrar's device-resident fragments, host fragment IO).

Counterpart of ``gmf_tpu/utils/lru.py``, host Python with the same
behaviour: the reference re-reads and re-computes every pair, and here
fragment-level reuse is an eval-throughput lever, so eviction and byte
accounting live in this one place.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Tuple


class ByteLRU:
    """LRU keyed map with a total byte budget.

    ``get(key, build)`` returns the cached value or calls ``build() ->
    (value, nbytes)`` and inserts it. When two threads race to build the
    same key, the first insert wins and the loser's value is discarded
    (entries must therefore be equivalent for equal keys). Eviction pops
    least-recently-used entries until the budget holds, always keeping
    at least one entry. ``max_bytes <= 0`` disables caching entirely
    (every ``get`` builds).
    """

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._store: "OrderedDict[object, Tuple[object, int]]" = \
            OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key, build: Callable[[], Tuple[object, int]]):
        if self.max_bytes <= 0:
            value, _ = build()
            return value
        with self._lock:
            if key in self._store:
                self._store.move_to_end(key)
                self.hits += 1
                return self._store[key][0]
        value, nbytes = build()
        with self._lock:
            if key in self._store:  # raced with another builder
                self._store.move_to_end(key)
                self.hits += 1
                return self._store[key][0]
            self.misses += 1
            self._store[key] = (value, int(nbytes))
            self._bytes += int(nbytes)
            while self._bytes > self.max_bytes and len(self._store) > 1:
                _, (_, old_nbytes) = self._store.popitem(last=False)
                self._bytes -= old_nbytes
        return value

    def reset(self) -> None:
        """Drop all entries and zero the hit/miss counters."""
        with self._lock:
            self._store.clear()
            self._bytes = 0
            self.hits = 0
            self.misses = 0

    @property
    def nbytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._store


# -- process-wide host IO cache ------------------------------------------
#
# Decoded npz/ply/png/velodyne arrays, shared by every loader and eval
# CLI in the process so the env budget bounds the TOTAL host cache use
# (two independent ByteLRUs reading the same knob could hold 2x it).

_host_io_cache = None
_host_io_lock = threading.Lock()


def host_io_cache() -> ByteLRU:
    """The shared read-only host IO ByteLRU, budgeted by
    ``GMF_FRAG_IO_CACHE_MB`` (default 2048; 0 disables). Resolved lazily
    on first use so tests can set the env var before any IO."""
    global _host_io_cache
    with _host_io_lock:
        if _host_io_cache is None:
            import os

            _host_io_cache = ByteLRU(
                int(os.environ.get("GMF_FRAG_IO_CACHE_MB", "2048")) << 20)
        return _host_io_cache


def cache_host_arrays(key, build):
    """``host_io_cache().get`` for a tuple-of-ndarray (or single ndarray)
    builder. Cached arrays are set READ-ONLY; consumers copy (astype /
    fancy indexing / augmentation), so an accidental in-place write fails
    loudly instead of corrupting neighbouring samples."""
    def build_entry():
        val = build()
        arrs = val if isinstance(val, tuple) else (val,)
        for a in arrs:
            a.setflags(write=False)
        return val, sum(a.nbytes for a in arrs)

    return host_io_cache().get(key, build_entry)
