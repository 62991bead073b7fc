"""Durable event journal: a size-bounded JSONL lifecycle log.

The flight recorder (obs/flight.py) answers "what was the process doing
around the failure", in memory; it forgets. The journal answers "what
happened to job X": one line per lifecycle transition, on disk.

  - One JSON line per transition (received, admitted or rejected,
    started, one `part-streamed` per stitched contig, finished, failed,
    expired, ...), keyed by job id and, where the client minted one,
    trace id, stamped with wall time (`t`).
  - Size-bounded: when the file would pass `max_bytes` (default 8 MiB)
    it rotates to `<path>.1` (one older generation kept), so the journal
    is a constant of about 2 x `max_bytes` on disk. `read_journal()`
    reads both generations in order.
  - Strict at open, best-effort after: the constructor raises on an
    unwritable path, but a later write failure only counts in `dropped`:
    a full disk loses journal lines, never jobs. `fsync=True` syncs each
    line to disk before `record()` returns (off by default: far slower
    than a flush).

`check_consistency()` verifies that every journaled job reaches exactly
one terminal state and that started and terminal events pair up.
`max_bytes` and `fsync` are parameters (no environment variable).
"""

from __future__ import annotations

import json
import os
import threading
import time

DEFAULT_MAX_BYTES = 8 << 20

#: events that end a job's lifecycle; `check_consistency` requires
#: exactly one per journaled job. `deadline-miss` is an annotation on a
#: finished-late job (it still terminates via `finished`), not terminal.
TERMINAL_EVENTS = frozenset((
    "finished", "failed", "expired", "rejected-full",
    "rejected-quota", "rejected-draining", "rejected-ingest"))

#: terminal states that imply the job actually ran (must pair with a
#: `started` event)
RAN_EVENTS = frozenset(("finished", "failed"))

#: every event type the lifecycle checker understands. Anything else
#: (an `alert` line, an event type added later) is an annotation, not a
#: transition: the consistency check ignores it and never fails on it.
LIFECYCLE_EVENTS = TERMINAL_EVENTS | RAN_EVENTS | frozenset((
    "received", "admitted", "started", "deadline-miss", "iterations",
    "part-streamed"))


class Journal:
    """Append-only JSONL event log with one-generation rotation (see
    module docstring). Thread-safe: one lock around write+rotate; every
    line is flushed so a crashed server's journal ends at the last
    completed transition, not mid-buffer."""

    def __init__(self, path: str, max_bytes: int = DEFAULT_MAX_BYTES,
                 fsync: bool = False):
        self.path = path
        self.max_bytes = max_bytes if max_bytes > 0 else DEFAULT_MAX_BYTES
        #: sync each line to disk before record() returns, so a journal
        #: used as a retry ledger survives a power cut with at most its
        #: last line torn (read_journal skips it)
        self.fsync = bool(fsync)
        self.events = 0
        self.dropped = 0
        self._lock = threading.Lock()
        #: lines queued by stage() — encoded but not yet on disk; any
        #: later record()/flush_staged()/close() writes them first, so
        #: relative order is fixed at stage time
        self._staged: list[str] = []
        self._closed = False
        # strict open: a bad path fails the caller now, rather than
        # losing every line later
        self._fh = open(path, "a", encoding="utf-8")
        self._size = self._fh.tell()

    def _encode(self, event: str, job: str | None,
                trace: str | None, fields: dict) -> str | None:
        doc: dict = {"t": round(time.time(), 6), "event": event}
        if job is not None:
            doc["job"] = job
        if trace is not None:
            doc["trace"] = trace
        for k, v in fields.items():
            if v is not None:
                doc[k] = v
        try:
            # ensure_ascii (the json default) is load-bearing: it keeps
            # every line pure ASCII, so len(line) == on-disk bytes and
            # the max_bytes accounting in _write_locked stays exact
            return json.dumps(doc, separators=(",", ":"),
                              default=str) + "\n"
        except ValueError:
            self.dropped += 1
            return None

    def record(self, event: str, job: str | None = None,
               trace: str | None = None, **fields) -> None:
        """Append one lifecycle line (draining any staged lines first,
        in order). Never raises: after a successful open, journal loss
        is accounted (`dropped`), not fatal."""
        line = self._encode(event, job, trace, fields)
        if line is None:
            return
        with self._lock:
            self._write_locked(line)

    def stage(self, event: str, job: str | None = None,
              trace: str | None = None, **fields) -> None:
        """Queue one line without touching the disk, for callers that
        hold a hot lock (a stalled journal device must not stall them).
        Staged lines keep their order and are written by the next
        record(), flush_staged() or close(); until then they live in
        memory only."""
        line = self._encode(event, job, trace, fields)
        if line is None:
            return
        with self._lock:
            self._staged.append(line)

    def flush_staged(self) -> None:
        """Write any staged lines now (from a context that holds no hot
        lock)."""
        with self._lock:
            self._write_locked(None)

    def _write_locked(self, line: str | None) -> None:
        if self._closed:
            self.dropped += len(self._staged) + (1 if line else 0)
            self._staged.clear()
            return
        pending, self._staged = self._staged, []
        if line is not None:
            pending.append(line)
        for ln in pending:
            try:
                if self._fh is None:
                    # a failed rotation or reopen dropped the handle;
                    # write failures are transient by contract, so the
                    # open is retried on every line
                    self._fh = open(self.path, "a", encoding="utf-8")
                    self._size = self._fh.tell()
                if self._size + len(ln) > self.max_bytes:
                    self._rotate_locked()
                self._fh.write(ln)
                self._fh.flush()
                if self.fsync:
                    os.fsync(self._fh.fileno())
                self._size += len(ln)
                self.events += 1
            except OSError:
                self.dropped += 1

    def _rotate_locked(self) -> None:
        # drop the handle first: if replace or reopen raises, _fh is None
        # and the next write retries the open
        try:
            self._fh.close()
        except OSError:
            pass
        self._fh = None
        os.replace(self.path, self.path + ".1")
        self._fh = open(self.path, "a", encoding="utf-8")
        self._size = 0

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                try:
                    self._write_locked(None)
                    if self._fh is not None:
                        self._fh.close()
                except OSError:
                    pass
                self._fh = None
                self._closed = True


def read_journal(path: str) -> list[dict]:
    """Entries from both generations (`<path>.1` first, then `<path>`),
    oldest first. Unparseable lines (a write torn by a crash) are
    skipped."""
    entries: list[dict] = []
    for p in (path + ".1", path):
        if not os.path.isfile(p):
            continue
        with open(p, encoding="utf-8", errors="replace") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    doc = json.loads(line)
                except ValueError:
                    continue
                if isinstance(doc, dict):
                    entries.append(doc)
    return entries


def check_consistency(entries: list[dict]) -> list[str]:
    """Lifecycle invariants over journal entries; returns human-readable
    problem strings (empty = consistent):

      - every job reaches EXACTLY one terminal state;
      - finished/failed jobs have a `started` event (when their start of
        life — `received` — is inside the journal window; rotation may
        have cut older jobs' early events, which is not an error);
      - a `started` job never also terminates as expired/rejected.

    Events outside LIFECYCLE_EVENTS (e.g. `alert`) are annotations and
    are ignored; a job id that appears only on annotation lines is
    skipped.
    """
    jobs: dict[str, list[str]] = {}
    for e in entries:
        job = e.get("job")
        if job:
            jobs.setdefault(str(job), []).append(str(e.get("event")))
    problems: list[str] = []
    for job, all_events in sorted(jobs.items()):
        events = [e for e in all_events if e in LIFECYCLE_EVENTS]
        if not events:
            continue  # annotation-only job id (see docstring)
        terminal = [e for e in events if e in TERMINAL_EVENTS]
        if not terminal:
            problems.append(f"job {job}: no terminal state ({events})")
        elif len(terminal) > 1:
            problems.append(
                f"job {job}: {len(terminal)} terminal states {terminal}")
        started = "started" in events
        if started and terminal and terminal[0] not in RAN_EVENTS:
            problems.append(
                f"job {job}: started but terminated as {terminal[0]}")
        if (not started and terminal
                and terminal[0] in RAN_EVENTS
                and "received" in events):
            problems.append(
                f"job {job}: {terminal[0]} without a started event")
    return problems
