"""Byte-budgeted, thread-safe LRU.

The plan/matrix caches in ops.fused hold dense f32 weight matrices
whose size varies ~1000x with the (legal) query geometry — a
count-bounded LRU admits adversarial memory use (a 2000x2048 plan is
~16 MB; 8192 of them is not a cache, it's an OOM). Entries here are
charged their actual byte weight and evicted strictly LRU once the
budget is exceeded.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Hashable, Optional


class ByteLRU:
    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._data: "OrderedDict[Hashable, tuple]" = OrderedDict()  # key -> (value, nbytes)
        self._lock = threading.Lock()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return entry[0]

    def put(self, key: Hashable, value: Any, nbytes: int) -> None:
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self.bytes -= old[1]
            self._data[key] = (value, nbytes)
            self.bytes += nbytes
            # an oversized single entry still gets cached (it is the
            # working set); eviction only removes OTHER entries
            while self.bytes > self.max_bytes and len(self._data) > 1:
                _, (_, freed) = self._data.popitem(last=False)
                self.bytes -= freed
                self.evictions += 1

    def __len__(self) -> int:
        return len(self._data)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self.bytes = 0

    def stats(self) -> dict:
        return {
            "entries": len(self._data),
            "bytes": self.bytes,
            "max_bytes": self.max_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }
