"""PolishClient: Python and CLI client of the warm polishing server.

One request is one connection (the server multiplexes concurrency across
connections, so a client that wants N jobs in flight opens N sockets).
Errors come back as the protocol's typed error responses and are raised
as the types below, so callers branch on types, not message strings:

    QueueFull       admission control rejected; `retry_after` seconds
    TenantQuota     this tenant's queued-job quota is full (a QueueFull,
                    with the same `retry_after` backoff)
    ServerDraining  the server is shutting down; resubmit elsewhere
    JobFailed       the job ran and failed; `error_type` names the
                    errors.py class (DeviceError, ChunkCorrupt, ...)
    JobCancelled    the job was cancelled (the cancel RPC, or this
                    client's `cancel_on_timeout`) before it finished
    DeadlineDoomed  the server gave the job up as unable to meet its
                    deadline (`predicted_s` / `remaining_s`)
    ServeError      anything else typed (bad-request, bad-frame, ...)

`python -m racon_tpu_torch submit ...` (cli.py) is the CLI face: the
one-shot CLI's three positional inputs, the polished FASTA on stdout,
byte-identical to a one-shot run. `--progress` / `submit(...,
on_progress=cb)` interleaves `progress` frames (queue position while
pending, then phase / done / total); `--stream` / `submit(...,
on_part=cb)` streams each polished contig as a `result_part` frame as
soon as its windows are done, and the parts concatenate to the buffered
FASTA. `submit(..., rounds=N)` / `--rounds N` polishes N rounds in the
server, `fragment=True` / `-f` corrects reads (optionally a `frag_lo` /
`frag_hi` target slice), `ingest` / `subsample` / `normalize` have the
server check or rewrite the inputs on admit, and `request()` sends any
frame, such as a `range_lo` / `range_hi` shard.

The server's observability from the client side:

  - `--trace-out t.json` / `submit_traced(...)`: the client mints a
    `trace_id`, estimates the server's perf_counter offset from
    round-trip-bracketed pings (`clock_sync`), records its own spans
    (connect, submit, wait, receive, and an instant per interleaved
    frame), has the server return the job's own trace, and merges both
    (`merge_trace`) into one Chrome trace: two Perfetto process tracks
    on one timeline;
  - `scrape()` (Prometheus text), `debug()` (the flight ring's recent
    spans and the dumps written), `audit_ack()` (clears the audit
    alert) and `trace_pull(trace_id)` (one trace id's spans from the
    ring).

Pointed at a router (serve/router.py) the same calls work: the result
carries the `router` block (shards, requeues, parts, walls), a traced
job's per-replica traces (`trace_replicas`), which `merge_trace` lays
out as one process track a replica, and `cancel` reaches every shard of
the job.
"""

from __future__ import annotations

import json
import os
import random
import socket
import sys
import time
import uuid

from .protocol import WIRE_LIMIT, recv_frame, send_frame
from .server import default_socket

#: ceiling on one retry sleep: a server advertising a huge retry_after
#: must not park a client for minutes
RETRY_DELAY_CAP_S = 30.0


def _retry_delay(retry_after: float, cap: float = RETRY_DELAY_CAP_S,
                 rng: random.Random | None = None) -> float:
    """Jittered backoff for full-queue retries: the server's hint spread
    by +-25% and capped, so clients waiting out the same hint do not
    resubmit in one burst. 0 <= delay <= cap, and within [0.75, 1.25] x
    the hint when the hint is under the cap."""
    base = min(max(float(retry_after), 0.0), cap)
    r = (rng or random).random()
    return min(base * (0.75 + 0.5 * r), cap)


class ServeError(Exception):
    """Typed error response from the server."""

    def __init__(self, code: str, message: str, response: dict):
        super().__init__(f"[{code}] {message}")
        self.code = code
        self.response = response


class QueueFull(ServeError):
    def __init__(self, code, message, response):
        super().__init__(code, message, response)
        self.retry_after = float(response.get("retry_after", 1.0))


class ServerDraining(ServeError):
    pass


class TenantQuota(QueueFull):
    """Per-tenant admission quota hit; carries `retry_after` like a
    full-queue reject (a QueueFull, so `retries=` covers it)."""

    def __init__(self, code, message, response):
        super().__init__(code, message, response)
        self.tenant = response.get("tenant", "")


class JobFailed(ServeError):
    def __init__(self, code, message, response):
        super().__init__(code, message, response)
        self.error_type = response.get("error_type", "RaconError")


class JobCancelled(ServeError):
    """The job was cancelled before it finished."""


class DeadlineDoomed(ServeError):
    """The server gave the job up: its predicted finish lies past its
    deadline by more than the server's margin."""

    def __init__(self, code, message, response):
        super().__init__(code, message, response)
        self.predicted_s = float(response.get("predicted_s", 0.0))
        self.remaining_s = float(response.get("remaining_s", 0.0))


_ERROR_TYPES = {"queue-full": QueueFull, "draining": ServerDraining,
                "tenant-quota": TenantQuota, "job-failed": JobFailed,
                "cancelled": JobCancelled,
                "deadline-doomed": DeadlineDoomed}


class PolishResult:
    __slots__ = ("job_id", "fasta", "metrics", "serve", "streamed",
                 "parts", "rounds", "trace", "trace_base_mono",
                 "trace_replicas", "router")

    def __init__(self, resp: dict):
        self.job_id = resp.get("job_id")
        #: whether the FASTA came as streamed result_part frames (then
        #: the final frame carries the stats only, and `fasta` is the
        #: parts' concatenation)
        self.streamed = bool(resp.get("streamed"))
        self.parts = resp.get("parts", 0)
        if self.streamed:
            self.fasta = b"".join(p.get("fasta", "").encode("latin-1")
                                  for p in resp.get("_parts") or [])
        else:
            self.fasta = resp.get("fasta", "").encode("latin-1")
        self.metrics = resp.get("metrics") or {}
        #: queue wait, exec and phase walls, and the `batch` block
        #: (iterations, shared iterations, K1 / K2 / K3 launches, ...)
        self.serve = resp.get("serve") or {}
        #: a rounds job's accounting (requested, completed, per_round
        #: walls and cache counts, cache totals); {} for a single pass
        self.rounds = resp.get("rounds") or {}
        #: a traced job's server-side events, and the server recorder's
        #: time zero on the server's perf_counter (merge_trace rebases
        #: the events with it); None for an untraced job
        self.trace = resp.get("trace")
        self.trace_base_mono = resp.get("trace_base_mono")
        #: a traced routed job's per-replica traces: one entry a replica
        #: that finished a shard, {replica, events, base_mono, offset_s
        #: (the replica's clock against the router's), rtt_s}; None
        #: otherwise
        self.trace_replicas = resp.get("trace_replicas")
        #: a routed job's `router` block (shards, replicas, requeues,
        #: parts, wall_s, and range / fragment counts); {} for a job
        #: submitted to a server directly
        self.router = resp.get("router") or {}


class PolishClient:
    def __init__(self, socket_path: str | None = None,
                 port: int | None = None, timeout: float | None = None):
        self.socket_path = socket_path or default_socket()
        self.port = port
        self.timeout = timeout

    def _connect(self) -> socket.socket:
        if self.port:
            return socket.create_connection(("127.0.0.1", self.port),
                                            timeout=self.timeout)
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.settimeout(self.timeout)
            sock.connect(self.socket_path)
        except OSError:
            sock.close()
            raise
        return sock

    def request(self, obj: dict, on_progress=None, on_part=None,
                recorder=None) -> dict:
        """One round trip; raises the ServeError types on a typed error
        response. Interleaved `progress` frames go to `on_progress` and
        `result_part` frames to `on_part` as they arrive; the method
        returns on the first frame that is neither, with the parts
        attached as `_parts` for PolishResult. `recorder` (an
        obs.trace.TraceRecorder) records the client's spans (connect,
        submit, wait, receive) and an instant per interleaved frame; it
        is given per call, so a client shared by threads keeps each
        traced request's spans apart."""
        rec = recorder
        t0 = time.perf_counter()
        sock = self._connect()
        if rec is not None:
            rec.complete("client.connect", t0, time.perf_counter())
        frames = 0
        parts: list[dict] = []
        try:
            t_send = time.perf_counter()
            send_frame(sock, obj)
            t_wait = time.perf_counter()
            if rec is not None:
                rec.complete("client.submit", t_send, t_wait,
                             {"type": obj.get("type")})
            while True:
                # results come from a trusted server: accept up to the
                # wire limit, not the server's request ceiling
                resp = recv_frame(sock, max_frame=WIRE_LIMIT)
                # stamped after the receive: the blocking time belongs
                # to client.wait
                t_frame = time.perf_counter()
                rtype = resp.get("type") if resp is not None else None
                if rtype == "result_part":
                    parts.append(resp)
                    if rec is not None:
                        rec.instant("client.result_part",
                                    {k: resp[k] for k in
                                     ("part", "name", "job_id")
                                     if k in resp})
                    if on_part is not None:
                        on_part(resp)
                    continue
                if rtype != "progress":
                    break
                frames += 1
                if rec is not None:
                    rec.instant("client.progress",
                                {k: resp[k] for k in
                                 ("phase", "done", "total", "position",
                                  "job_id") if k in resp})
                if on_progress is not None:
                    on_progress(resp)
            if rec is not None:
                now = time.perf_counter()
                rec.complete("client.wait", t_wait, t_frame,
                             {"progress_frames": frames,
                              "result_parts": len(parts)})
                rec.complete("client.receive", t_frame, now)
        finally:
            sock.close()
        if resp is None:
            raise ServeError("closed", "server closed the connection", {})
        if resp.get("type") == "error":
            code = resp.get("code", "error")
            raise _ERROR_TYPES.get(code, ServeError)(
                code, resp.get("message", ""), resp)
        if parts:
            resp["_parts"] = parts
        return resp

    def clock_sync(self, samples: int = 3) -> dict:
        """The server's perf_counter offset from round-trip-bracketed
        pings: each sample's offset is the server's `mono_s` less the
        midpoint of the client's round trip, and the sample with the
        shortest round trip wins. Returns {"offset_s", "rtt_s"};
        merge_trace puts server spans on the client's clock with it, to
        within rtt / 2."""
        best = None
        for _ in range(max(1, samples)):
            t0 = time.perf_counter()
            pong = self.request({"type": "ping"})
            t1 = time.perf_counter()
            mono = pong.get("mono_s")
            if mono is None:
                raise ServeError("bad-response", "the server's pong "
                                 "carries no mono_s clock sample", pong)
            cand = {"offset_s": float(mono) - (t0 + t1) / 2.0,
                    "rtt_s": t1 - t0}
            if best is None or cand["rtt_s"] < best["rtt_s"]:
                best = cand
        return best

    def submit(self, sequences: str, overlaps: str, target: str, *,
               options: dict | None = None, priority: int = 0,
               deadline_s: float | None = None,
               fault_plan: str | None = None, tenant: str | None = None,
               trace: bool = False, trace_id: str | None = None,
               rounds: int | None = None,
               fragment: bool = False, frag_lo: int | None = None,
               frag_hi: int | None = None, ingest: bool = False,
               subsample: dict | None = None, normalize: bool = False,
               on_progress=None, on_part=None, stream: bool = False,
               recorder=None, retries: int = 0,
               cancel_on_timeout: bool = False) -> PolishResult:
        """Polish one input triple on the server. Paths are made absolute
        before they cross the wire (the server's working directory is not
        the client's). `options` overrides the server's polish defaults
        (serve.server.ALLOWED_OPTIONS); `fault_plan` arms injected faults
        for this job only; `tenant` names its fair-scheduling bucket;
        `trace_id` names the job so another client can cancel it, and
        tags its journal lines and server spans; `trace` has the server
        return the job's own trace (PolishResult.trace), and `recorder`
        records this client's spans (see submit_traced).
        `rounds=N` polishes N rounds in the server (PolishResult.rounds
        has their accounting); `fragment` corrects reads instead of
        polishing contigs (mode "fragment"), `frag_lo` / `frag_hi`
        bounding the target indices; `ingest` has the server parse the
        inputs on admit, `subsample` ({reference_length, coverage[,
        seed]}) subsample the reads and `normalize` rename paired reads
        first. A range shard (`range_lo` / `range_hi`) goes through
        `request()`.
        `on_progress` turns on progress frames, `on_part` or `stream` the
        streamed contigs. `retries` resubmits after a jittered
        `retry_after` on full-queue rejects. `cancel_on_timeout` (with a
        client `timeout`) sends a cancel for the job on a fresh
        connection when the socket times out, then raises JobCancelled;
        the retry loop also stops once the timeout budget is spent."""
        if cancel_on_timeout and not trace_id:
            # the cancel needs a handle known before the result arrives
            trace_id = uuid.uuid4().hex[:16]
        req = {"type": "submit",
               "sequences": os.path.abspath(sequences),
               "overlaps": os.path.abspath(overlaps),
               "target": os.path.abspath(target)}
        if options:
            req["options"] = options
        if priority:
            req["priority"] = int(priority)
        if deadline_s is not None:
            req["deadline_s"] = float(deadline_s)
        if fault_plan:
            req["fault_plan"] = fault_plan
        if tenant:
            req["tenant"] = str(tenant)
        if trace:
            req["trace"] = True
        if trace_id:
            req["trace_id"] = str(trace_id)
        if rounds is not None:
            req["rounds"] = int(rounds)
        if fragment:
            req["mode"] = "fragment"
        if frag_lo is not None:
            req["frag_lo"] = int(frag_lo)
        if frag_hi is not None:
            req["frag_hi"] = int(frag_hi)
        if ingest:
            req["ingest"] = True
        if subsample is not None:
            req["subsample"] = dict(subsample)
        if normalize:
            req["normalize"] = True
        if on_progress is not None:
            req["progress"] = True
        if stream or on_part is not None:
            req["stream"] = True
        attempt = 0
        t_first = time.perf_counter()
        while True:
            try:
                return PolishResult(self.request(
                    req, on_progress=on_progress, on_part=on_part,
                    recorder=recorder))
            except QueueFull as exc:
                if attempt >= retries:
                    raise
                delay = _retry_delay(exc.retry_after)
                if self.timeout is not None and (
                        time.perf_counter() - t_first + delay
                        > self.timeout):
                    raise
                attempt += 1
                time.sleep(delay)
            except TimeoutError:
                if not cancel_on_timeout:
                    raise
                try:
                    self.cancel(trace_id=trace_id)
                except (ServeError, OSError):
                    pass  # best effort: the job may have just finished
                raise JobCancelled(
                    "cancelled", f"client timeout after {self.timeout}s: "
                                 f"sent cancel for trace {trace_id}",
                    {"trace_id": trace_id}) from None

    def submit_traced(self, sequences: str, overlaps: str, target: str,
                      *, trace_out: str | None = None,
                      **kw) -> tuple[PolishResult, dict]:
        """One traced submit end to end: mint a trace id (unless `kw`
        names one), take the clock handshake, record the client's spans,
        have the server return the job's trace, and merge both into one
        Chrome trace document (written to `trace_out` when given).
        Returns (result, document)."""
        from ..obs.trace import TraceRecorder

        kw.pop("trace", None)
        trace_id = kw.pop("trace_id", None) or uuid.uuid4().hex[:16]
        clock = self.clock_sync()
        rec = TraceRecorder(None)
        result = self.submit(sequences, overlaps, target, trace=True,
                             trace_id=trace_id, recorder=rec, **kw)
        doc = merge_trace(result, rec, clock, trace_id=trace_id)
        if trace_out:
            with open(trace_out, "w") as fh:
                json.dump(doc, fh)
        return result, doc

    def cancel(self, job_id: str | None = None,
               trace_id: str | None = None) -> dict:
        """Cancel a queued or running job by id or trace id, on a fresh
        connection. Returns the server's ok body ({"cancelled": "queued"
        | "running", "job_id"}; a router's adds `shards_cancelled`, the
        shards it sent the cancel on to); raises ServeError code
        `unknown-job` when nothing matches (the job already finished,
        say)."""
        req: dict = {"type": "cancel"}
        if job_id:
            req["job_id"] = job_id
        if trace_id:
            req["trace_id"] = trace_id
        return self.request(req)

    def ping(self) -> dict:
        return self.request({"type": "ping"})

    def stats(self) -> dict:
        return self.request({"type": "stats"})

    def healthz(self) -> dict:
        """{ok, draining, warm, uptime_s, queue_depth, inflight}: `ok` is
        false once the server drains."""
        return self.request({"type": "healthz"})

    def scrape(self) -> str:
        """The server's Prometheus text: the body `--metrics-port` serves
        as /metrics, read at call time."""
        return self.request({"type": "scrape"})["text"]

    def debug(self, max_events: int = 5000) -> dict:
        """The flight ring's most recent events and the dumps written so
        far; with the auditor armed, its snapshot under `audit`."""
        return self.request({"type": "debug", "max_events": max_events})

    def audit_ack(self) -> dict:
        """Acknowledge the identity audit's alert: it clears (gauge and
        journal) until the next mismatch. Returns the debug body, with
        the ack's result under `audit_ack` and the audit's snapshot."""
        return self.request({"type": "debug", "audit_ack": True,
                             "max_events": 0})

    def trace_pull(self, trace_id: str,
                   max_events: int | None = None) -> dict:
        """One trace id's spans from the server's flight ring (an exact
        or a dotted-child match), with the ring's base and a clock
        sample: {trace_id, events, base_mono, mono_s}."""
        req = {"type": "trace_pull", "trace_id": trace_id}
        if max_events is not None:
            req["max_events"] = max_events
        return self.request(req)

    def shutdown(self) -> dict:
        return self.request({"type": "shutdown"})


def merge_trace(result: PolishResult, client_rec, clock: dict,
                trace_id: str | None = None) -> dict:
    """Merge the server's per-job trace (`result.trace`, on the server
    recorder's timeline) with the client recorder's events into one
    Chrome trace document on the client's clock: client spans on pid 1,
    server spans on pid 2, each labelled by a process_name event. A
    server event at ts (microseconds past `result.trace_base_mono`) lands
    at that server time less the handshake's offset on the client's
    perf_counter, then moves onto the client recorder's zero; good to the
    handshake's rtt / 2.

    A routed job: pid 2 is the router (its plan / dispatch / stream /
    merge spans), and each entry of `result.trace_replicas` becomes its
    own process track on pid 3 and up. A replica's clock chains two
    handshakes, replica to router (`offset_s`, taken by the router) and
    router to client (`clock`), so every track lands on the client's
    clock and the hops' round trips add. `trace_context` carries the
    clocks (each replica's too) and the job's `serve`, `router` and
    `rounds` blocks, what a reader checks span sums against."""
    from ..obs.trace import rebase_events

    events = rebase_events(client_rec.events(), pid=1,
                           name="racon_tpu_torch client")
    if result.trace and result.trace_base_mono is not None:
        shift_us = ((result.trace_base_mono - clock["offset_s"])
                    - client_rec._base) * 1e6
        events += rebase_events(
            result.trace, pid=2, shift_us=shift_us,
            name="racon_tpu_torch router" if result.router
            else "racon_tpu_torch server")
    ctx_replicas = []
    for i, rep in enumerate(result.trace_replicas or []):
        base = rep.get("base_mono")
        if base is None:
            continue
        off = float(rep.get("offset_s") or 0.0)
        # replica clock -> router clock (- off) -> client clock (- the
        # client's offset), then onto the client recorder's zero
        shift_us = ((base - off - clock["offset_s"])
                    - client_rec._base) * 1e6
        events += rebase_events(
            rep.get("events") or [], pid=3 + i, shift_us=shift_us,
            name=f"racon_tpu_torch replica {rep.get('replica')}")
        ctx_replicas.append({"replica": rep.get("replica"),
                             "offset_s": rep.get("offset_s"),
                             "rtt_s": rep.get("rtt_s")})
    events.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0.0)))
    ctx = {"trace_id": trace_id, "job_id": result.job_id,
           "clock_offset_s": round(clock["offset_s"], 6),
           "clock_rtt_s": round(clock["rtt_s"], 6)}
    if ctx_replicas:
        ctx["replicas"] = ctx_replicas
    stats: dict = {}
    if result.serve:
        stats["serve"] = result.serve
    if result.router:
        stats["router"] = result.router
    if result.rounds:
        stats["rounds"] = result.rounds
    if stats:
        ctx["stats"] = stats
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "trace_context": ctx}


class _ProgressPrinter:
    """stderr renderer for `submit --progress`: a redrawn status line on
    a terminal, one line per phase change when stderr is a pipe."""

    def __init__(self):
        self._last_phase = None
        self._tty = sys.stderr.isatty()

    def __call__(self, ev: dict) -> None:
        phase = ev.get("phase", "?")
        if phase == "queued":
            text = (f"queued at position {ev.get('position', '?')} "
                    f"(depth {ev.get('depth', '?')})")
        elif ev.get("total"):
            unit = (" windows" if phase in ("consensus", "stitch")
                    else "")  # align counts overlap pairs
            text = f"{phase} {ev.get('done', 0)}/{ev['total']}{unit}"
        else:
            text = phase
        if self._tty:
            sys.stderr.write(f"\r[racon_tpu_torch::submit] {text:<56}")
            sys.stderr.flush()
        elif phase != self._last_phase:
            print(f"[racon_tpu_torch::submit] {text}", file=sys.stderr)
        self._last_phase = phase

    def close(self) -> None:
        if self._tty and self._last_phase is not None:
            sys.stderr.write("\n")
            sys.stderr.flush()


# ------------------------------------------------------------------ CLI
def submit_main(argv: list[str]) -> int:
    """`python -m racon_tpu_torch submit`: send one job to a running
    server; the polished FASTA on stdout."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="racon_tpu_torch submit",
        description="submit a polishing job to a running "
                    "`python -m racon_tpu_torch serve`")
    ap.add_argument("sequences")
    ap.add_argument("overlaps")
    ap.add_argument("target")
    ap.add_argument("--socket", default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--timeout", type=float, default=None,
                    help="socket timeout in seconds (default: none)")
    ap.add_argument("--priority", type=int, default=0)
    ap.add_argument("--deadline", type=float, default=None,
                    help="job deadline in seconds: a job not started in "
                         "time is dropped from the queue "
                         "(deadline-expired); one that finishes late "
                         "still returns its result, counted as a miss")
    ap.add_argument("--retries", type=int, default=0,
                    help="resubmit after retry_after on queue-full")
    ap.add_argument("--cancel-on-timeout", action="store_true",
                    help="with --timeout: when the socket times out, "
                         "cancel the job on a fresh connection")
    ap.add_argument("--progress", action="store_true",
                    help="live progress on stderr")
    ap.add_argument("--stream", action="store_true",
                    help="write each polished contig to stdout as soon as "
                         "it is done; the stream equals the buffered "
                         "output. A job that fails mid-stream leaves the "
                         "streamed contigs on stdout: check the exit "
                         "status, nonzero on any failure")
    ap.add_argument("--tenant", default=None,
                    help="fair-scheduling tenant id (1-64 chars of "
                         "[A-Za-z0-9._-])")
    ap.add_argument("--trace-id", default=None,
                    help="name this job, so `cancel --trace-id ID` from "
                         "another terminal reaches it (also its key in "
                         "the journal and the flight dumps)")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="record the client's spans, fetch the job's "
                         "server-side spans, and write one merged Chrome "
                         "trace (open in Perfetto) with both on one "
                         "handshake-aligned timeline")
    ap.add_argument("--fault-plan", default=None,
                    help="inject faults into this job's pipelines, e.g. "
                         "device:chunk=0:raise (testing)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="polishing rounds in the server: round k's "
                         "contigs are round k+1's draft, the reads "
                         "re-mapped in its process; per-round walls and "
                         "window-cache hits on stderr")
    ap.add_argument("-f", "--fragment-correction", "--fragment",
                    dest="fragment", action="store_true",
                    help="correct reads instead of polishing contigs "
                         "(mode \"fragment\"): the corrected reads, "
                         "byte-identical to the one-shot -f run")
    ap.add_argument("--frag-lo", type=int, default=None,
                    help="with -f: correct only the targets of index "
                         ">= this")
    ap.add_argument("--frag-hi", type=int, default=None,
                    help="with -f: correct only the targets of index "
                         "< this")
    ap.add_argument("--ingest", action="store_true",
                    help="the server parses all three inputs on admit, "
                         "so a malformed file fails the job at the door")
    ap.add_argument("--subsample", nargs=2, type=int, default=None,
                    metavar=("REF_LEN", "COV"),
                    help="the server subsamples the reads to about "
                         "REF_LEN * COV bases on admit (seeded, "
                         "deterministic)")
    ap.add_argument("--subsample-seed", type=int, default=None,
                    help="the subsample's shuffle seed (default: "
                         "rampler's)")
    ap.add_argument("--normalize", action="store_true",
                    help="paired-end header normalization on admit, as "
                         "`python -m racon_tpu_torch.preprocess` does")
    ap.add_argument("-u", "--include-unpolished", action="store_true")
    ap.add_argument("-w", "--window-length", type=int, default=None)
    ap.add_argument("-q", "--quality-threshold", type=float, default=None)
    ap.add_argument("-e", "--error-threshold", type=float, default=None)
    ap.add_argument("--no-trimming", action="store_true")
    ap.add_argument("-m", "--match", type=int, default=None)
    ap.add_argument("-x", "--mismatch", type=int, default=None)
    ap.add_argument("-g", "--gap", type=int, default=None)
    ap.add_argument("-c", "--cudapoa-batches", type=int, default=None)
    ap.add_argument("--cudaaligner-batches", type=int, default=None)
    ap.add_argument("--cuda-engine", choices=("session", "fused"),
                    default=None)
    ap.add_argument("--cuda-fused", choices=("auto", "0", "1"),
                    default=None)
    ap.add_argument("--cuda-dtype", choices=("auto", "int32", "int16"),
                    default=None)
    args = ap.parse_args(argv)

    options: dict = {}
    for key, val in (("include_unpolished",
                      args.include_unpolished or None),
                     ("window_length", args.window_length),
                     ("quality_threshold", args.quality_threshold),
                     ("error_threshold", args.error_threshold),
                     ("trim", False if args.no_trimming else None),
                     ("match", args.match), ("mismatch", args.mismatch),
                     ("gap", args.gap),
                     ("cuda_poa_batches", args.cudapoa_batches),
                     ("cuda_aligner_batches", args.cudaaligner_batches),
                     ("cuda_engine", args.cuda_engine),
                     ("cuda_fused", args.cuda_fused),
                     ("score_dtype", args.cuda_dtype)):
        if val is not None:
            options[key] = val

    client = PolishClient(socket_path=args.socket, port=args.port,
                          timeout=args.timeout)
    on_progress = _ProgressPrinter() if args.progress else None
    on_part = None
    if args.stream:
        def on_part(frame):
            sys.stdout.buffer.write(frame.get("fasta", "").encode("latin-1"))
            sys.stdout.buffer.flush()
    subsample = None
    if args.subsample is not None:
        subsample = {"reference_length": args.subsample[0],
                     "coverage": args.subsample[1]}
        if args.subsample_seed is not None:
            subsample["seed"] = args.subsample_seed
    common = dict(options=options, priority=args.priority,
                  deadline_s=args.deadline, fault_plan=args.fault_plan,
                  tenant=args.tenant, trace_id=args.trace_id,
                  rounds=args.rounds, fragment=args.fragment,
                  frag_lo=args.frag_lo, frag_hi=args.frag_hi,
                  ingest=args.ingest, subsample=subsample,
                  normalize=args.normalize, on_progress=on_progress,
                  on_part=on_part, retries=args.retries,
                  cancel_on_timeout=args.cancel_on_timeout)
    trace_doc = None
    try:
        if args.trace_out:
            # the document is written below, after the FASTA reached
            # stdout: an unwritable trace path must not lose the polish
            result, trace_doc = client.submit_traced(
                args.sequences, args.overlaps, args.target, **common)
        else:
            result = client.submit(args.sequences, args.overlaps,
                                   args.target, **common)
    except (ServeError, OSError) as exc:
        if on_progress is not None:
            on_progress.close()
        print(f"[racon_tpu_torch::serve] error: {exc}", file=sys.stderr)
        return 1
    if on_progress is not None:
        on_progress.close()
    if not result.streamed:
        sys.stdout.buffer.write(result.fasta)
        sys.stdout.buffer.flush()
    serve = result.serve
    if serve:
        print(f"[racon_tpu_torch::serve] job {result.job_id}: queue wait "
              f"{serve.get('queue_wait_s', 0):.3f}s, exec "
              f"{serve.get('exec_s', 0):.3f}s", file=sys.stderr)
    if result.rounds:
        walls = ", ".join(f"r{r['round']}={r['wall_s']:.3f}s"
                          for r in result.rounds.get("per_round", []))
        cache = result.rounds.get("cache")
        tail = (f", cache hits {cache['hits']}/"
                f"{cache['hits'] + cache['misses']}" if cache else "")
        print(f"[racon_tpu_torch::serve] rounds "
              f"{result.rounds.get('completed')}/"
              f"{result.rounds.get('requested')}: {walls}{tail}",
              file=sys.stderr)
    if trace_doc is not None:
        try:
            with open(args.trace_out, "w") as fh:
                json.dump(trace_doc, fh)
            print(f"[racon_tpu_torch::serve] merged client and server "
                  f"trace written to {args.trace_out}", file=sys.stderr)
        except OSError as exc:
            print(f"[racon_tpu_torch::serve] warning: could not write the "
                  f"trace to {args.trace_out} ({exc}); the FASTA is "
                  "unaffected", file=sys.stderr)
    return 0


def cancel_main(argv: list[str]) -> int:
    """`python -m racon_tpu_torch cancel`: cancel a queued or running job
    on a running server by job id or trace id."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="racon_tpu_torch cancel",
        description="cancel a queued or running job on a running "
                    "`python -m racon_tpu_torch serve` by --job-id or "
                    "--trace-id")
    ap.add_argument("--socket", default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--timeout", type=float, default=None,
                    help="socket timeout in seconds (default: none)")
    ap.add_argument("--job-id", default=None)
    ap.add_argument("--trace-id", default=None,
                    help="the id given to `submit --trace-id`")
    args = ap.parse_args(argv)
    if not args.job_id and not args.trace_id:
        print("[racon_tpu_torch::serve] error: cancel needs --job-id or "
              "--trace-id", file=sys.stderr)
        return 1
    client = PolishClient(socket_path=args.socket, port=args.port,
                          timeout=args.timeout)
    try:
        body = client.cancel(job_id=args.job_id, trace_id=args.trace_id)
    except (ServeError, OSError) as exc:
        print(f"[racon_tpu_torch::serve] error: {exc}", file=sys.stderr)
        return 1
    print(f"[racon_tpu_torch::serve] cancelled {body.get('cancelled')} job "
          f"{body.get('job_id', args.trace_id)}", file=sys.stderr)
    return 0
