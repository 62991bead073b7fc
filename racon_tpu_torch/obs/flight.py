"""Flight recorder: an always-on bounded ring of recent spans.

Span tracing (obs/trace.py) answers "where did the time go", but only
when armed before the run, and its buffers grow without bound, so a
long-lived process cannot leave it on. The flight recorder can stay on:

  - `FlightRecorder` is a `TraceRecorder` whose events land in one
    shared bounded ring (`collections.deque(maxlen=capacity)`: appends
    are atomic under the GIL, so the hot path takes no lock). Every
    instrumentation site feeds it unchanged, spans keep the
    perf_counter endpoints the stage counters charge, and memory is a
    constant (`capacity` events, default 4096). Track ids are keyed by
    thread name, not per registration: a long-lived process spawns
    fresh pipeline threads per job, and per-registration buffers would
    keep one dead buffer per thread forever.
  - `dump()` writes the ring as Chrome trace-event JSON (loadable in
    Perfetto), windowed to a job by `since`, with the job's identity,
    error and stage counters as a top-level `flight` object;
    `trace_events()` windows the ring to one distributed trace.

`dump()` is a function over any TraceRecorder, so a full trace armed
with `--cuda-trace` serves as the flight source too. The capacity and
the pull cap are parameters (no environment variable).
"""

from __future__ import annotations

import json
import threading
from collections import deque

from .trace import TraceRecorder, trace_matches

#: default total ring capacity (events); a span dict is about 200
#: bytes, so the default bounds the recorder near 1 MB
DEFAULT_CAPACITY = 4096

#: default cap on the events one trace pull returns: a routed job needs
#: only its own window of the ring, and the reply rides one frame
DEFAULT_PULL_EVENTS = 2048


class FlightRecorder(TraceRecorder):
    """TraceRecorder with one shared bounded ring (see module
    docstring): constant memory and constant `events()` cost no matter
    how many short-lived threads record into it."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        super().__init__(path=None)
        self.capacity = capacity if capacity > 0 else DEFAULT_CAPACITY
        # deque.append evicts the oldest event once full — O(1) and
        # atomic under the GIL, so concurrent recorders need no lock
        self._ring: deque = deque(maxlen=self.capacity)
        self._buffers.append(self._ring)  # base events() reads it
        self._name_tids: dict[str, int] = {}

    def _buf(self) -> deque:
        # tid keyed by thread name (a small, stable set) instead of the
        # base class's per-registration tid (one dead buffer per thread
        # ever spawned: the leak this class exists to avoid)
        tid = getattr(self._local, "tid", None)
        if tid is None:
            name = threading.current_thread().name
            with self._lock:
                tid = self._name_tids.get(name)
                if tid is None:
                    tid = self._next_tid
                    self._next_tid += 1
                    self._name_tids[name] = tid
                    self._threads[tid] = name
            self._local.tid = tid
        return self._ring


def trace_events(recorder: TraceRecorder,
                 trace_id: str | list[str] | tuple[str, ...],
                 max_events: int | None = None) -> list[dict]:
    """The ring windowed to one distributed trace: spans and instants
    whose args carry `trace_id` (an exact or dotted child `<trace>.s<k>`
    match, `trace_ids` lists included), plus every thread-name metadata
    event, so track labels survive. A list of ids selects the union.
    The oldest matching events are trimmed past `max_events` (default
    DEFAULT_PULL_EVENTS; metadata kept)."""
    cap = (max_events if max_events and max_events > 0
           else DEFAULT_PULL_EVENTS)
    tids = ((trace_id,) if isinstance(trace_id, str) else
            tuple(trace_id))
    meta, hits = [], []
    for ev in recorder.events():
        if ev.get("ph") == "M":
            meta.append(ev)
        elif any(trace_matches(ev.get("args"), t) for t in tids):
            hits.append(ev)
    return meta + hits[-cap:]


def window_events(recorder: TraceRecorder,
                  since: float | None = None) -> list[dict]:
    """The recorder's events, keeping thread-name metadata but dropping
    spans and instants that start before `since` (a perf_counter
    timestamp, the clock every span uses): a job's window for its dump.
    None: everything still in the ring."""
    events = recorder.events()
    if since is None:
        return events
    cut = recorder._us(since)
    return [ev for ev in events
            if ev.get("ph") == "M" or ev.get("ts", 0.0) >= cut]


def dump(recorder: TraceRecorder, path: str,
         since: float | None = None,
         flight: dict | None = None) -> str:
    """Write the ring (windowed to `since` when given) as Chrome
    trace-event JSON. `flight` rides as an extra top-level object (job
    id, reason, error, stage counters); Perfetto ignores unknown
    top-level keys, so the file stays loadable and describes itself."""
    doc = {"traceEvents": window_events(recorder, since),
           "displayTimeUnit": "ms"}
    if flight:
        doc["flight"] = flight
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path
