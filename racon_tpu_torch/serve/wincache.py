"""Content-addressed window consensus cache: skip a dispatch on a hit.

Later polishing rounds converge, so most windows repeat the previous
round's, and a window's consensus bytes are a function of the window
content, the engine parameters and the kernel posture alone (not of the
batch, lane or co-scheduled jobs: the port's tests pin that). So a
consensus can be cached: `WindowCache` keys stored consensus and
polished flag by

    (sha256 over the window content and its type,
     the engine-parameter key,
     the kernel posture, sched/autotune.posture_key)

so a hit can only return bytes an earlier dispatch of the same content
under the same engine identity produced. The properties:

  - bounded: LRU by payload bytes (`max_bytes`, default 64 MiB),
    oldest-used entries evicted first, every eviction counted;
  - thread-safe: one mutex; lookups and stores are dict operations;
  - invalidated as a whole (`invalidate_all`) when the producer's
    identity is no longer trusted (a demoted winner table, a
    quarantined lane);
  - auditable: an entry whose bytes the audit finds wrong is evicted and
    refused for good (`quarantine`).

The server takes the cache's size as a flag; no environment variable
arms it.
"""

from __future__ import annotations

import hashlib
import struct
import threading
from collections import OrderedDict

#: default LRU budget: 64 MiB of consensus payload
DEFAULT_MAX_BYTES = 64 * 1024 * 1024

#: accounting overhead charged per entry on top of the payload (key
#: digest + tuple + OrderedDict slot — an estimate, but it keeps a
#: flood of empty-consensus windows from evading the byte bound)
_ENTRY_OVERHEAD = 120


def window_content_digest(w) -> bytes:
    """SHA-256 over the whole window content: backbone, layers,
    qualities and layer positions (the walk obs/audit.py's sampling
    hashes), and the window type (kNGS and kTGS trim differently: the
    same layers give other bytes)."""
    h = hashlib.sha256()
    h.update(struct.pack("<i", int(w.type.value)))
    for seq, qual, (begin, end) in zip(w.sequences, w.qualities,
                                       w.positions):
        h.update(struct.pack("<Iii", len(seq), begin, end))
        h.update(seq)
        if qual:
            h.update(qual)
    return h.digest()


class WindowCache:
    """Bounded, thread-safe, content-addressed consensus cache (module
    docstring)."""

    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES):
        self.max_bytes = max(1, int(max_bytes))
        self._lock = threading.Lock()
        #: key -> (consensus bytes, polished flag); OrderedDict order
        #: IS the LRU order (lookup moves to end)
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        #: keys the audit condemned: evicted and refused for good (a
        #: faulty producer may try to store them again)
        self._quarantined: set[tuple] = set()
        self.counters = {"hits": 0, "misses": 0, "puts": 0,
                         "evictions": 0, "quarantined": 0,
                         "invalidations": 0, "hit_bytes": 0}
        self._bytes = 0

    # ------------------------------------------------------------ keying
    @staticmethod
    def key(w, engine_key: tuple, posture: tuple) -> tuple:
        """The full cache identity of one window under one engine
        configuration; `posture` is sched/autotune.posture_key of the
        postures that compute it (`Polisher.posture_key`)."""
        return (window_content_digest(w), engine_key, posture)

    # ----------------------------------------------------------- access
    def lookup(self, key: tuple):
        """(consensus, polished) for a hit, None for a miss (counted)."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None or key in self._quarantined:
                self.counters["misses"] += 1
                return None
            self._entries.move_to_end(key)
            self.counters["hits"] += 1
            self.counters["hit_bytes"] += len(ent[0])
            return ent

    def store(self, key: tuple, consensus: bytes,
              polished: bool) -> None:
        """Populate one entry (no-op for quarantined keys), evicting
        LRU entries past the byte budget."""
        size = len(consensus) + _ENTRY_OVERHEAD
        with self._lock:
            if key in self._quarantined:
                return
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= len(old[0]) + _ENTRY_OVERHEAD
            self._entries[key] = (bytes(consensus), bool(polished))
            self._bytes += size
            self.counters["puts"] += 1
            while self._bytes > self.max_bytes and self._entries:
                _k, (cons, _p) = self._entries.popitem(last=False)
                self._bytes -= len(cons) + _ENTRY_OVERHEAD
                self.counters["evictions"] += 1

    # ------------------------------------------------------ invalidation
    def quarantine(self, key: tuple) -> None:
        """The audit's verdict on one entry (a cache-hit window whose
        bytes differ from the oracle's): evict it and refuse the key for
        good."""
        with self._lock:
            ent = self._entries.pop(key, None)
            if ent is not None:
                self._bytes -= len(ent[0]) + _ENTRY_OVERHEAD
                self.counters["evictions"] += 1
            self._quarantined.add(key)
            self.counters["quarantined"] += 1

    def quarantined(self, key: tuple) -> bool:
        with self._lock:
            return key in self._quarantined

    def invalidate_all(self, reason: str = "") -> int:
        """Drop every entry (a demotion, a posture change, a lane
        quarantine: the producer is no longer trusted); quarantined keys
        stay refused. Returns the entry count."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._bytes = 0
            self.counters["invalidations"] += 1
        if n:
            from ..utils.logger import log_info

            log_info(f"[racon_tpu_torch::wincache] invalidated {n} entr"
                     f"{'y' if n == 1 else 'ies'}"
                     + (f" ({reason})" if reason else ""))
        return n

    # --------------------------------------------------------- exposure
    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["entries"] = len(self._entries)
            out["bytes"] = self._bytes
            out["max_bytes"] = self.max_bytes
            total = out["hits"] + out["misses"]
            out["hit_rate"] = (out["hits"] / total) if total else 0.0
        return out
