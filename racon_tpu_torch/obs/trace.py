"""Span tracing: Chrome trace-event recording for Perfetto.

`TraceRecorder` records spans (the dispatch pipeline's pack / device /
unpack / fallback stages per chunk, the session engine's dispatch and
commit, the polisher's phases) and instant events, and writes them as
Chrome trace-event JSON loadable in Perfetto (https://ui.perfetto.dev)
or chrome://tracing.

  1. Off by default, one `is None` check per hook when off. The process
     tracer is armed only by `configure(path)` (the CLI's `--cuda-trace
     <file>`); `reset()` disarms it.
  2. Cheap when on: events append to per-thread buffers (the shared lock
     is taken once per thread, when its buffer registers), timestamps
     are the `time.perf_counter` endpoints the pipeline's stage counters
     already charge, so per-stage span sums equal the counters, and
     serialization happens once, at `save()`.
  3. Thread-safe: the pipeline's pack and unpack workers and its
     fallback pool record freely; `events()` snapshots every buffer and
     sorts by timestamp.

Span names and `args` keys are the JAX package's (racon_tpu/obs/trace.py
and its call sites), so one trace reader serves both. For a long-lived
process: `install()` arms a recorder the caller built (the bounded
FlightRecorder of obs/flight.py), `scoped()` arms a fresh per-job
recorder and restores the previous one after (teeing into it when one
was armed), `rebase()` moves a recorder's time zero earlier, and
`rebase_events()` / `trace_matches()` merge and select events of one
distributed trace.
"""

from __future__ import annotations

import json
import os
import threading
import time


class _Span:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("_rec", "_name", "_args", "_t0")

    def __init__(self, rec: "TraceRecorder", name: str, args: dict | None):
        self._rec = rec
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc_info) -> None:
        self._rec.complete(self._name, self._t0, time.perf_counter(),
                           self._args)


class _NullSpan:
    """Shared no-op context for the disabled-tracer path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc_info) -> None:
        pass


_NULL_SPAN = _NullSpan()


class TraceRecorder:
    """Append-only per-thread event buffers with one shared time base."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._pid = os.getpid()
        self._base = time.perf_counter()
        self._lock = threading.Lock()
        self._buffers: list[list] = []
        self._threads: dict[int, str] = {}
        self._next_tid = 1
        self._local = threading.local()

    def _buf(self) -> list:
        buf = getattr(self._local, "buf", None)
        if buf is None:
            # a tid per registration, not threading.get_ident(): the OS
            # reuses idents, so the consensus phase's workers would land
            # on the dead align-phase workers' tracks
            t = threading.current_thread()
            buf = self._local.buf = []
            with self._lock:
                tid = self._next_tid
                self._next_tid += 1
                self._buffers.append(buf)
                self._threads[tid] = t.name
            self._local.tid = tid
        return buf

    def _us(self, t: float) -> float:
        # clamp: a caller-supplied endpoint can predate this recorder
        return round(max(0.0, t - self._base) * 1e6, 3)

    def rebase(self, base: float) -> None:
        """Move the recorder's time zero earlier, to perf_counter `base`,
        so spans that predate its creation (a job's queue wait) keep
        their real offsets instead of clamping to 0. Valid only before
        events are recorded; a later or equal base is ignored."""
        if base < self._base:
            self._base = base

    def complete(self, name: str, t0: float, t1: float,
                 args: dict | None = None) -> None:
        """Record a finished span from its `time.perf_counter` endpoints."""
        buf = self._buf()
        ev = {"name": name, "cat": "racon_tpu_torch", "ph": "X",
              "ts": self._us(t0), "dur": round(max(0.0, t1 - t0) * 1e6, 3),
              "pid": self._pid, "tid": self._local.tid}
        if args:
            ev["args"] = args
        buf.append(ev)

    def instant(self, name: str, args: dict | None = None) -> None:
        buf = self._buf()
        ev = {"name": name, "cat": "racon_tpu_torch", "ph": "i", "s": "t",
              "ts": self._us(time.perf_counter()),
              "pid": self._pid, "tid": self._local.tid}
        if args:
            ev["args"] = args
        buf.append(ev)

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args or None)

    def events(self) -> list[dict]:
        """Timestamp-sorted snapshot of every buffer, prefixed with the
        thread-name metadata events Perfetto uses to label tracks."""
        with self._lock:
            buffers = list(self._buffers)
            threads = dict(self._threads)
        meta = [{"name": "thread_name", "ph": "M", "pid": self._pid,
                 "tid": tid, "args": {"name": tname}}
                for tid, tname in sorted(threads.items())]
        evs: list[dict] = []
        for buf in buffers:
            evs.extend(list(buf))  # list() snapshots concurrent appends
        evs.sort(key=lambda e: e["ts"])
        return meta + evs

    def save(self, path: str | None = None) -> str:
        """Write the Chrome trace-event JSON object form."""
        path = path or self.path
        if not path:
            raise ValueError("TraceRecorder.save: no output path")
        with open(path, "w") as fh:
            json.dump({"traceEvents": self.events(),
                       "displayTimeUnit": "ms"}, fh)
        return path


#: the process tracer: None (every hook is one `is None` check) or the
#: armed recorder
_tracer: TraceRecorder | None = None


def get_tracer() -> TraceRecorder | None:
    return _tracer


def configure(path: str | None = None) -> TraceRecorder:
    """Arm (or re-arm) recording into a fresh recorder that `save()`
    writes to `path`."""
    global _tracer
    _tracer = TraceRecorder(path)
    return _tracer


def install(recorder: TraceRecorder) -> TraceRecorder:
    """Arm a recorder the caller built (such as obs/flight.py's bounded
    FlightRecorder) as the process tracer; every hook feeds it."""
    global _tracer
    _tracer = recorder
    return recorder


def reset() -> None:
    """Disarm the process tracer."""
    global _tracer
    _tracer = None


class _TeeRecorder:
    """A recorder that forwards every event to several recorders: how a
    per-job trace (scoped) coexists with a recorder already armed, which
    keeps recording. Only the recording calls (`complete`, `instant`,
    `span`) fan out; `events` and `save` are the primary's."""

    def __init__(self, primary: TraceRecorder, *others: TraceRecorder):
        self._recs = (primary,) + others
        self.path = primary.path

    def complete(self, name, t0, t1, args=None) -> None:
        for rec in self._recs:
            rec.complete(name, t0, t1, args)

    def instant(self, name, args=None) -> None:
        for rec in self._recs:
            rec.instant(name, args)

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args or None)

    def events(self) -> list[dict]:
        return self._recs[0].events()

    def save(self, path: str | None = None) -> str:
        return self._recs[0].save(path)


class scoped:
    """Context manager arming a fresh in-memory recorder and restoring
    the previous tracer on exit (a job's own trace). The recorder is the
    process's for the duration, so spans of concurrent work land in it
    too. When a recorder is already armed, the scope installs a tee, so
    the outer recorder keeps seeing every span. Scopes serialize on a
    lock: the save and restore of the process tracer is not reentrant."""

    _lock = threading.Lock()

    def __enter__(self) -> TraceRecorder:
        global _tracer
        self._lock.acquire()
        self._prev = _tracer
        rec = TraceRecorder(None)
        _tracer = rec if self._prev is None else _TeeRecorder(rec,
                                                              self._prev)
        return rec

    def __exit__(self, *exc_info) -> None:
        global _tracer
        _tracer = self._prev
        self._lock.release()


def save(path: str | None = None) -> str | None:
    """Write the armed tracer's events to its path (or `path`); None when
    tracing is off or has nowhere to write, so callers use it as an
    unconditional end-of-run hook."""
    tr = get_tracer()
    if tr is None or not (path or tr.path):
        return None
    return tr.save(path)


def rebase_events(events: list[dict], pid: int, shift_us: float = 0.0,
                  name: str | None = None) -> list[dict]:
    """Re-stamp a snapshot of trace events onto process `pid`, shifting
    span and instant timestamps by `shift_us`: how another process's
    events merge into a local timeline as a Perfetto process track of
    their own. Returns fresh dicts (the inputs are not mutated), led by
    a `process_name` metadata event when `name` is given; metadata
    events ("M") keep their timestampless shape."""
    out: list[dict] = []
    if name is not None:
        out.append({"name": "process_name", "ph": "M", "pid": pid,
                    "args": {"name": name}})
    for ev in events:
        ev = dict(ev)
        ev["pid"] = pid
        if ev.get("ph") != "M" and "ts" in ev:
            ev["ts"] = round(max(0.0, ev["ts"] + shift_us), 3)
        out.append(ev)
    return out


def trace_matches(args: dict | None, trace_id: str) -> bool:
    """Whether a span's or instant's args tie it to `trace_id` or to one
    of its children (dotted ids, `<trace>.s<k>`: an exact or dotted-prefix
    match). Args carry either one `trace_id` string or a `trace_ids`
    list (one a co-scheduled job); a match on either counts."""
    if not args:
        return False

    def _hit(t) -> bool:
        return isinstance(t, str) and (
            t == trace_id or t.startswith(trace_id + "."))

    if _hit(args.get("trace_id")):
        return True
    tids = args.get("trace_ids")
    return isinstance(tids, (list, tuple)) and any(_hit(t) for t in tids)


def span(name: str, **args):
    """A recording span when tracing is armed, a shared no-op otherwise."""
    tr = get_tracer()
    return tr.span(name, **args) if tr is not None else _NULL_SPAN


def instant(name: str, **args) -> None:
    tr = get_tracer()
    if tr is not None:
        tr.instant(name, args or None)
