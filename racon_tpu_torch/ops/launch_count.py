"""Launch counters of the kernel wrappers.

Each wrapper (poa_kernels, align_kernels, poa_fused_kernels) adds one
where it launches its kernel, and nowhere else. A server launches from
several threads at once (each job's aligner on its worker thread, the
window batcher's iterations on its feeder thread), so a count is a
read-modify-write under a lock, and each thread also keeps its own
count, from which a caller reads the launches of the work it ran.
"""

from __future__ import annotations

import threading


class LaunchCounter:
    """Launches in all (`total`), per launch shape (`by_shape`) and on
    the calling thread (`on_thread()`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.total = 0
        self.by_shape: dict[tuple, int] = {}

    def count(self, key: tuple) -> None:
        """One launch at shape `key`."""
        with self._lock:
            self.total += 1
            self.by_shape[key] = self.by_shape.get(key, 0) + 1
        self._local.n = getattr(self._local, "n", 0) + 1

    def reset(self) -> None:
        """Zero `total` and `by_shape` (the per-thread counts run on:
        callers read them as differences)."""
        with self._lock:
            self.total = 0
            self.by_shape.clear()

    def on_thread(self) -> int:
        """Launches made on the calling thread since it started."""
        return getattr(self._local, "n", 0)
