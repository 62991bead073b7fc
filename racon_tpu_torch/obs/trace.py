"""Span tracing: the port's one span API, and Chrome trace-event
recording for Perfetto.

`span(name, into=None, **args)` wraps one region of host work (a
polisher step, a pipeline wait, an engine's batch step). One call feeds
three sinks, each only when it is on:

  (a) `into`: the span's seconds are added to `into[name]`, whether
      tracing is armed or not. This is how `Polisher.span_s` and the
      session engine's `span_s` count per-run totals; keep such spans at
      phase or batch granularity (one perf_counter pair and one dict add
      each), and give each `into` dict to one thread;
  (b) the armed recorder (`configure(path)`, the CLI's `--cuda-trace
      <file>`; `install()`, the server's flight recorder; `scoped()`, a
      job's own trace): a complete ("X") Chrome event on the opening
      thread's track;
  (c) a running `torch.profiler` capture (the benchmark's traced run,
      `--cuda-profile`): a `record_function` range of the same name, on
      the profiler's clock and the opening thread, entered only when
      torch's process-wide profiler flag is set.

With none of them on, a span costs two `is None` checks and the flag's
read, and returns a shared no-op. `complete(...)` on a
recorder records a span from endpoints taken earlier (the pipeline's
stage counters); it feeds (b) only, since a profiler range cannot be
opened after the fact.

`TraceRecorder`:

  1. Off by default, one `is None` check per hook when off. The process
     tracer is armed only by `configure(path)`; `reset()` disarms it.
  2. Cheap when on: events append to per-thread buffers (the shared lock
     is taken once per thread, when its buffer registers), timestamps
     are the `time.perf_counter` endpoints the pipeline's stage counters
     already charge, so per-stage span sums equal the counters, and
     serialization happens once, at `save()`.
  3. Thread-safe: the pipeline's pack and unpack workers and its
     fallback pool record freely; `events()` snapshots every buffer and
     sorts by timestamp.
  4. Laid over a profiler capture by wall clock: `save()` writes
     `baseTimeNanoseconds`, the wall-clock epoch nanoseconds of the
     recorder's time zero, beside `traceEvents`, under the key and in
     the sense of a Kineto (`torch.profiler`) Chrome trace: an event's
     wall time is `baseTimeNanoseconds + ts * 1000` ns in both files.

The JAX package's span names and `args` keys are kept where it has the
span (racon_tpu/obs/trace.py and its call sites), so one trace reader
serves both; the spans it has not got are the port's own (README's
observability section lists them). For a long-lived process:
`install()` arms a recorder the caller built (the bounded
FlightRecorder of obs/flight.py), `scoped()` arms a fresh per-job
recorder and restores the previous one after (teeing into it when one
was armed), `rebase()` moves a recorder's time zero earlier, and
`rebase_events()` / `trace_matches()` merge and select events of one
distributed trace.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

#: torch's `torch.autograd.profiler` module once the process has loaded
#: torch (no profiler records before that); looked up, never imported, so
#: the serve client's commands start without torch
_torch_profiler = None


def _profiler():
    global _torch_profiler
    if _torch_profiler is None:
        _torch_profiler = sys.modules.get("torch.autograd.profiler")
    return _torch_profiler


class _Span:
    """Context manager over one region: feeds the sinks the module
    docstring lists on exit. `set(**args)` adds args known only at the
    region's end."""

    __slots__ = ("_rec", "_name", "_args", "_into", "_range", "_t0")

    def __init__(self, rec, name: str, args: dict | None,
                 into: dict | None = None):
        self._rec = rec
        self._name = name
        self._args = args
        self._into = into
        self._range = None

    def set(self, **args) -> None:
        self._args = dict(self._args or (), **args)

    def __enter__(self) -> "_Span":
        prof = _torch_profiler or _profiler()
        if prof is not None and prof._is_profiler_enabled:
            self._range = prof.record_function(self._name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc_info) -> None:
        t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc_info)
        if self._into is not None:
            self._into[self._name] = (self._into.get(self._name, 0.0)
                                      + (t1 - self._t0))
        if self._rec is not None:
            self._rec.complete(self._name, self._t0, t1, self._args)


class _NullSpan:
    """Shared no-op context for a span with every sink off."""

    __slots__ = ()

    def set(self, **args) -> None:
        pass

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
        #: the wall-clock epoch nanoseconds of `_base` (module docstring,
        #: item 4)
        self.base_ns = time.time_ns()
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
            self.base_ns -= round((self._base - base) * 1e9)
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
                       "displayTimeUnit": "ms",
                       "baseTimeNanoseconds": self.base_ns}, fh)
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
    keeps recording. Only the recording calls (`complete`, `instant`)
    fan out; `events` and `save` are the primary's."""

    def __init__(self, primary: TraceRecorder, *others: TraceRecorder):
        self._recs = (primary,) + others
        self.path = primary.path

    def complete(self, name, t0, t1, args=None) -> None:
        for rec in self._recs:
            rec.complete(name, t0, t1, args)

    def instant(self, name, args=None) -> None:
        for rec in self._recs:
            rec.instant(name, args)

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


def span(name: str, into: dict | None = None, **args):
    """One region's span (module docstring): a shared no-op when no
    recorder is armed, `into` is None and no torch profiler records."""
    tr = _tracer
    if tr is None and into is None:
        prof = _torch_profiler or _profiler()
        if prof is None or not prof._is_profiler_enabled:
            return _NULL_SPAN
    return _Span(tr, name, args or None, into)


def add_totals(into: dict, totals: dict) -> None:
    """Add one `into` dict's span seconds to another's, by name."""
    for name, s in totals.items():
        into[name] = into.get(name, 0.0) + s


def instant(name: str, **args) -> None:
    tr = get_tracer()
    if tr is not None:
        tr.instant(name, args or None)
