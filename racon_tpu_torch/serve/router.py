"""Shard-aware serve router: one polishing service over N warm
`PolishServer` replicas that survives the loss of any one of them
mid-job.

`PolishRouter` speaks the same submit frame as a replica (protocol.py),
so `python -m racon_tpu_torch submit` pointed at a router works
unchanged:

  - **Contig shards.** A submit's target FASTA is split by contig into
    `min(routable replicas, contigs)` shards with the wrapper's
    contiguous-block partition (`wrapper.py`: the shards' outputs
    concatenated in shard order are the unsharded output byte for byte,
    since contigs polish independently). Each shard goes to a replica as
    a child job tagged with its parent (the `parent` / `shard` /
    `shards` submit keys, child trace id `<parent>.s<k>`), always with
    `stream: true`, so finished contigs flow back as soon as they land.
  - **Window-range shards.** When routable replicas exceed the contig
    count, the largest contigs split further by target coordinate at
    window-grid boundaries (`_plan_ranges`): the grid follows from
    `window_length`, so every window is owned by exactly one shard.
    Each range child carries `range_lo` / `range_hi`, polishes only its
    slice and streams raw segments with their stitch accounting; the
    merge buffers a contig's segments until all its shards are done and
    re-derives the unsharded run's LN / RC / XC tags. A rounds job falls
    back to contig shards (a redraft round over a segment is not what
    rounds over the contig compute).
  - **Fragment read ranges.** A fragment job's targets are its reads:
    every child shares the target file and carries a contiguous,
    ascending `[frag_lo, frag_hi)` slice of the read index, so the
    shards' outputs in shard order are the reads in order.
  - **Contig-order merge.** Shard k's parts are forwarded (or buffered,
    for a client that does not stream) only once shards 0..k-1 have
    shipped whole, so the client sees one job in target order. The
    result frame sums the shards' stats and carries a `router` block
    (shards, requeues, parts, walls).
  - **Journal-backed requeue.** The router keeps its own journal
    (obs/journal.py; `journal_fsync=True` syncs every line) as the
    retry ledger: the parent's lifecycle lines (received, started,
    finished or failed) and annotations outside the lifecycle events
    (`ROUTER_EVENTS`: `shard-dispatched`, one `part-routed` per part
    forwarded, `shard-finished`, `requeued`, `replica-down` /
    `replica-up`, ...). A replica whose connection drops mid-shard has
    that shard dispatched again to a healthy replica; the parts the
    ledger already routed are deduped by position (a replica's output
    is deterministic, so the rerun streams the same parts), and the
    client sees each contig, segment or read group exactly once.
  - **Health and rolling restarts.** A background `FleetAggregator`
    poll (obs/fleet.py: healthz and scrape) marks replicas routable,
    draining or down, and the router's `scrape` / `/metrics` federates
    the replicas' scrapes behind one endpoint with its own
    `racon_tpu_router_*` families. A draining replica stops taking new
    shards (its in-flight ones finish there), and a restarted one
    rejoins on its first clean healthz. The router's healthz reports
    the routable count throughout.
  - **QoS through the router.** Each child carries the parent's
    priority and tenant, and the parent's deadline as what remains of
    it at each dispatch (a requeued shard never gets a fresh budget). A
    cancel of the parent, or a shard that fails `cancelled` or
    `deadline-doomed`, fans a cancel out to the sibling shards.

  - **The elastic fleet.** `add_replica` / `remove_replica` join and
    leave the routing set live (journaled `replica-added` /
    `replica-removed`; the aggregator polls the new set). An attached
    `Autoscaler` (serve/autoscale.py, `router --autoscale`) drives them:
    it spawns replica processes under sustained pressure and stops the
    newest it spawned after sustained idle. While it is armed and the
    fleet can still grow, a shard whose replicas are all busy holds for
    an idle one for up to `hold_s` (`_scaleup_headroom`,
    `_pick_replica(max_inflight=1)`); a held shard counts as backlog, a
    `hold` journal line and the `held` argument of its `router.dispatch`
    span record it. Healthz's `autoscale` block and the
    `racon_tpu_router_autoscale_*` families appear only once armed.

Every knob is a `RouterConfig` / `AutoscaleConfig` keyword and a `router`
flag; no environment variable sets one. `python -m racon_tpu_torch
router --replicas /tmp/a.sock,/tmp/b.sock [--autoscale ...]` runs one
(README, "Router and fleet").
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import socket
import sys
import tempfile
import threading
import time

from ..errors import RaconError
from ..obs import flight as obs_flight
from ..obs import prom as obs_prom
from ..obs.fleet import FleetAggregator
from ..obs.journal import Journal
from ..utils.logger import log_info
from .client import (JobFailed, PolishClient, QueueFull, ServeError,
                     ServerDraining, _retry_delay)
from .protocol import (DEFAULT_MAX_FRAME, ProtocolError, error_response,
                       recv_frame, send_frame)

#: journal annotation events the router writes beside the parent job's
#: lifecycle lines. Outside obs.journal's LIFECYCLE_EVENTS on purpose:
#: the consistency check ignores them.
ROUTER_EVENTS = frozenset((
    "router-start", "router-stop", "shard-dispatched", "shard-finished",
    "part-routed", "requeued", "replica-down", "replica-up",
    "cancelled", "siblings-cancelled", "range-plan", "frag-plan",
    "replica-added", "replica-removed", "autoscale-up",
    "autoscale-down", "hold"))

#: the trace-id charset (the server's: "." is legal, which keeps the
#: `<parent>.s<k>` child ids valid on the replica)
_TRACE_ID_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_.")


def default_router_socket() -> str:
    """The unix socket a router binds when none is named: in the
    temporary directory (TMPDIR)."""
    return os.path.join(tempfile.gettempdir(),
                        "racon_tpu_torch_router.sock")


class RouterConfig:
    """The router's knobs, keyword arguments only. A bad one raises
    RaconError now, not at the first job."""

    def __init__(self, **kw):
        replicas = kw.pop("replicas", None) or []
        if isinstance(replicas, str):
            replicas = [s.strip() for s in replicas.split(",") if s.strip()]
        self.replicas = list(replicas)
        if not self.replicas:
            raise RaconError("router", "no replicas configured (pass "
                             "replicas= or --replicas)")
        for spec in self.replicas:
            if spec.startswith(("http://", "https://")):
                raise RaconError(
                    "router",
                    f"replica {spec!r} is an http:// metrics base: the "
                    "router submits jobs, so replicas must be RPC "
                    "endpoints (a unix socket path or localhost "
                    "host:port)")
            if "/" not in spec and os.path.sep not in spec:
                host = spec.rpartition(":")[0]
                if host not in ("", "127.0.0.1", "localhost"):
                    raise RaconError(
                        "router",
                        f"replica {spec!r}: TCP replicas must be localhost "
                        "(the serve transport binds 127.0.0.1 only)")
        #: unix socket path; `port` (an int, 0 = ephemeral, the real port
        #: published back here) switches to localhost TCP
        self.socket_path = (kw.pop("socket_path", None)
                            or default_router_socket())
        self.port = kw.pop("port", None)
        #: the retry ledger and lifecycle journal ("" or None: off), and
        #: whether each of its lines is synced to disk
        self.journal_path = kw.pop("journal", None) or ""
        self.journal_fsync = bool(kw.pop("journal_fsync", False))
        #: the federated /metrics and /healthz port (None: off, 0:
        #: ephemeral, published back here)
        self.metrics_port = kw.pop("metrics_port", None)
        if self.metrics_port is not None and int(self.metrics_port) < 0:
            raise RaconError("router", f"invalid metrics_port "
                             f"{self.metrics_port} (expected 0 or more)")
        try:
            #: replica poll interval, shards a job at most (0: one per
            #: routable replica), replica losses a shard survives, how
            #: long a shard waits for a routable replica, probe timeout
            self.health_interval_s = float(kw.pop("health_interval_s", 2.0))
            self.max_shards = int(kw.pop("max_shards", 0))
            self.shard_retries = int(kw.pop("shard_retries", 3))
            self.replica_wait_s = float(kw.pop("replica_wait_s", 60.0))
            self.probe_timeout_s = float(kw.pop("probe_timeout_s", 2.0))
        except (TypeError, ValueError) as exc:
            raise RaconError("router", f"invalid router option: {exc}") \
                from None
        if self.health_interval_s <= 0 or self.probe_timeout_s <= 0:
            raise RaconError("router", "health_interval_s and "
                             "probe_timeout_s must be positive")
        #: where the router's own flight ring (its plan / dispatch /
        #: stream / merge / requeue spans) is written as Chrome-trace
        #: JSON at stop (None: not written)
        self.trace_path = kw.pop("trace_path", None) or None
        #: the largest request frame the router reads
        self.max_frame = int(kw.pop("max_frame", DEFAULT_MAX_FRAME))
        if kw:
            raise RaconError(
                "router", f"unknown router option(s): {', '.join(sorted(kw))}")

    @property
    def address(self) -> str:
        if self.port is not None:
            return f"127.0.0.1:{self.port}"
        return self.socket_path


class ReplicaState:
    """One replica's routing state. `ok` / `draining` come from the fleet
    poll; `down_forced` covers the time between polls once a submit saw
    the replica die, and the next poll clears it."""

    def __init__(self, spec: str):
        self.spec = spec
        self.ok = True  # until the first poll lands
        self.draining = False
        self.down_forced = False
        self.error: str | None = None
        self.inflight = 0  # shards dispatched here now

    @property
    def routable(self) -> bool:
        return self.ok and not self.draining and not self.down_forced

    def client(self, timeout: float | None = None) -> PolishClient:
        if "/" in self.spec or os.path.sep in self.spec:
            return PolishClient(socket_path=self.spec, timeout=timeout)
        port = int(self.spec.rpartition(":")[2])
        return PolishClient(port=port, timeout=timeout)


class _ShardFailure(Exception):
    """A shard (and so its parent job) failed, typed."""

    def __init__(self, code: str, message: str, **extra):
        super().__init__(message)
        self.code = code
        self.extra = extra


class _JobMerge:
    """One job's merge and dedupe ledger: buffers each shard's streamed
    parts, forwards them in global contig order (shard k only once shards
    0..k-1 have shipped whole), and dedupes a requeued shard's parts by
    position (`arrived` counts the current attempt; a part below the
    buffered length is a duplicate and is skipped).

    Range mode (`groups` set): each shard is one (contig, [lo, hi))
    slice that streams one bare-named raw segment with its stitch
    accounting (`seg`); a group is one contig's shards in lo order. A
    group's segments buffer until every member shard is done, then
    assemble into one whole-contig part whose LN / RC / XC tags are
    re-derived from the summed accounting, so the merge gives the
    unsharded run's bytes and the requeue dedupe works per segment."""

    def __init__(self, n_shards: int, emit_part=None, on_routed=None,
                 groups: list[dict] | None = None,
                 fragment_correction: bool = False,
                 drop_unpolished: bool = True):
        self.lock = threading.Lock()
        self.parts: list[list[tuple]] = [[] for _ in range(n_shards)]
        self.arrived = [0] * n_shards
        self.done = [False] * n_shards
        self.results: list[dict | None] = [None] * n_shards
        self.failure: _ShardFailure | None = None
        #: shards in flight: shard k -> (ReplicaState, child trace id),
        #: what the sibling cancel reaches
        self.dispatched: dict[int, tuple] = {}
        #: every replica that ever took a shard of this job (spec ->
        #: ReplicaState), dead ones included: the trace pulls use it
        self.replicas_seen: dict[str, object] = {}
        #: shard k -> (replica spec, child trace id) of the attempt that
        #: completed it: each replica is pulled for exactly the child
        #: traces it finished (replicas in one process share one ring)
        self.shard_owner: dict[int, tuple] = {}
        self._emit_part = emit_part
        self._on_routed = on_routed
        self._cursor_shard = 0
        self._cursor_part = 0
        self.total_routed = 0
        #: range mode: [{"name": contig, "shards": [k, ...]}, ...] in
        #: contig order, member shards in lo order
        self.groups = groups
        self._fragment_correction = fragment_correction
        self._drop_unpolished = drop_unpolished
        self._group_cursor = 0
        self._assembled: list[tuple[str, str]] = []
        #: range segments accepted (after the dedupe)
        self.segments_routed = 0
        #: fragment mode: (shard, buffered position) -> the frame's read
        #: receipt (frag_lo, frag_hi, reads), keyed by buffer position so
        #: a requeued shard's duplicates never record a receipt twice
        self._frag_meta: dict[tuple[int, int], tuple] = {}
        #: corrected reads routed (the accepted groups' `reads`)
        self.reads_routed = 0

    def on_part(self, k: int, frame: dict) -> None:
        with self.lock:
            idx = self.arrived[k]
            self.arrived[k] += 1
            if idx < len(self.parts[k]):
                return  # a requeued rerun's duplicate
            if self.groups is not None:
                seg = frame.get("seg")
                if not isinstance(seg, dict):
                    # a replica that ignored range_lo / range_hi polished
                    # the whole contig: merging it would corrupt the output
                    if self.failure is None:
                        self.failure = _ShardFailure(
                            "replica-incompatible",
                            f"shard {k}: part arrived without range "
                            "segment accounting (replica predates "
                            "range sharding?)")
                    return
                self.parts[k].append(
                    (frame.get("name"), frame.get("fasta", ""), seg))
                self.segments_routed += 1
                if self._on_routed is not None:
                    self._on_routed(k, idx, frame.get("name"),
                                    len(frame.get("fasta", "")),
                                    lo=seg.get("lo"), hi=seg.get("hi"))
                self._pump_locked()
                return
            frag = frame.get("frag")
            if isinstance(frag, (list, tuple)) and len(frag) == 2:
                self._frag_meta[(k, len(self.parts[k]))] = (
                    frag[0], frag[1], frame.get("reads"))
                self.reads_routed += int(frame.get("reads") or 0)
            self.parts[k].append((frame.get("name"), frame.get("fasta", "")))
            self._pump_locked()

    def shard_done(self, k: int, resp: dict) -> None:
        with self.lock:
            self.done[k] = True
            self.results[k] = resp
            self._pump_locked()

    def requeue(self, k: int) -> None:
        with self.lock:
            self.arrived[k] = 0  # the rerun streams from its first part

    def fail(self, failure: _ShardFailure) -> None:
        with self.lock:
            if self.failure is None:
                self.failure = failure

    def _pump_locked(self) -> None:
        if self.groups is not None:
            self._pump_groups_locked()
            return
        n = len(self.parts)
        while self._cursor_shard < n:
            k = self._cursor_shard
            while self._cursor_part < len(self.parts[k]):
                name, fasta = self.parts[k][self._cursor_part]
                meta = self._frag_meta.get((k, self._cursor_part))
                part_index = self.total_routed
                self.total_routed += 1
                self._cursor_part += 1
                if self._on_routed is not None:
                    if meta is not None:
                        self._on_routed(k, part_index, name, len(fasta),
                                        frag_lo=meta[0], frag_hi=meta[1],
                                        reads=meta[2])
                    else:
                        self._on_routed(k, part_index, name, len(fasta))
                if self._emit_part is not None:
                    self._emit_part(k, part_index, name, fasta)
            if not self.done[k]:
                return
            self._cursor_shard += 1
            self._cursor_part = 0

    def _pump_groups_locked(self) -> None:
        """Range mode: a contig ships once all its range shards are done
        and every earlier contig has shipped. `on_routed` fires per
        segment at arrival instead."""
        if self.failure is not None:
            return  # a rejected part may have left a hole: never assemble
        while self._group_cursor < len(self.groups):
            g = self.groups[self._group_cursor]
            if not all(self.done[k] for k in g["shards"]):
                return
            part = self._assemble_locked(g)
            self._group_cursor += 1
            if part is None:
                continue  # dropped as unpolished (the unsharded rule)
            name, fasta = part
            self._assembled.append((name, fasta))
            part_index = self.total_routed
            self.total_routed += 1
            if self._emit_part is not None:
                self._emit_part(g["shards"][0], part_index, name, fasta)

    def _assemble_locked(self, g: dict) -> tuple[str, str] | None:
        """One contig's segments (lo order) as the whole-contig FASTA
        entry an unsharded run writes: body = the segments joined, LN =
        its length, RC = the coverage (every range child parses all
        overlaps, so each reports the same count), XC = sum(polished) /
        the grid's windows, from the same integers as the unsharded ratio
        and so the same `:.6f` text (core/polisher.py `_stitch_contig`)."""
        segs = []
        for k in g["shards"]:
            for _name, fasta, seg in self.parts[k]:
                segs.append((int(seg.get("lo", 0)), fasta, seg))
        segs.sort(key=lambda s: s[0])
        total = max((int(s.get("total_windows", 0)) for _lo, _f, s in segs),
                    default=0)
        if not segs or not total:
            return None
        body = "".join(f for _lo, f, _s in segs)
        polished = sum(int(s.get("polished", 0)) for _lo, _f, s in segs)
        coverage = max(int(s.get("coverage", 0)) for _lo, _f, s in segs)
        ratio = polished / float(total)
        if self._drop_unpolished and ratio <= 0:
            return None
        tags = "r" if self._fragment_correction else ""
        tags += f" LN:i:{len(body)}"
        tags += f" RC:i:{coverage}"
        tags += f" XC:f:{ratio:.6f}"
        name = g["name"] + tags
        return name, f">{name}\n{body}\n"

    def fasta(self) -> str:
        """The merged body (latin-1 text, as it rides the wire)."""
        with self.lock:
            if self.groups is not None:
                return "".join(f for _name, f in self._assembled)
            return "".join(fasta for shard in self.parts
                           for _name, fasta in shard)


def plan_fragment_ranges(n_reads: int, cap: int) -> list[tuple[int, int]]:
    """A fragment job's read-index slices over `min(cap, n_reads)` shards
    (at least one): contiguous and ascending, so the shards' outputs in
    shard order are the reads in order."""
    n_shards = max(1, min(cap, n_reads))
    return [(k * n_reads // n_shards, (k + 1) * n_reads // n_shards)
            for k in range(n_shards)]


class PolishRouter:
    """The replicated serve front end (module docstring). It has the
    server's transport shape (the same frames, accept / handle / dispatch
    and typed errors) but runs nothing itself: every submit fans out to
    replicas."""

    def __init__(self, config: RouterConfig | None = None, **overrides):
        self.config = config if config is not None \
            else RouterConfig(**overrides)
        cfg = self.config
        self.replicas = [ReplicaState(s) for s in cfg.replicas]
        #: the health poller and the source of the federated scrape
        self.fleet = FleetAggregator(cfg.replicas,
                                     timeout_s=cfg.probe_timeout_s)
        self.journal: Journal | None = None
        self._listener: socket.socket | None = None
        self._http = None
        self._threads: list[threading.Thread] = []
        self._conns: set[socket.socket] = set()
        self._conn_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._job_seq = 0
        #: fan-outs in flight: router job id -> (trace id, merge), what a
        #: parent cancel resolves
        self._active: dict[str, tuple] = {}
        self._inflight_jobs = 0
        self._requeued_outstanding = 0
        #: shards holding in `_run_shard` for an idle replica (the
        #: dispatch hold); the autoscaler counts them as backlog
        self._dispatch_waiting = 0
        self._draining = threading.Event()
        self._stopped = threading.Event()
        self._t_start = time.perf_counter()
        self.counters = {"jobs_submitted": 0, "jobs_completed": 0,
                         "jobs_failed": 0, "shards_dispatched": 0,
                         "parts_routed": 0, "requeues": 0}
        #: the attached Autoscaler or None: healthz and the scrape show
        #: its state only when armed, and only then may a shard hold
        self.autoscaler = None
        #: the router's own always-on flight ring: plan / dispatch /
        #: shard / stream / merge / requeue / cancel spans per routed job,
        #: tagged with the parent and `<trace>.s<k>` child ids. Not the
        #: process tracer: that slot belongs to a server's ring, and
        #: routers share processes with replicas in tests
        self.recorder = obs_flight.FlightRecorder()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "PolishRouter":
        cfg = self.config
        if cfg.journal_path:
            try:
                self.journal = Journal(cfg.journal_path,
                                       fsync=cfg.journal_fsync)
            except OSError as exc:
                raise RaconError(
                    "router",
                    f"cannot open router journal {cfg.journal_path!r} "
                    f"({exc}); point journal= / --journal at a writable "
                    "path") from None
        # the first poll before accepting: a replica dead at startup is
        # unroutable when the first submit arrives
        self._apply_poll(self.fleet.poll())
        if cfg.metrics_port is not None:
            self._start_metrics_http()
        if cfg.port is not None:
            lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            lst.bind(("127.0.0.1", max(0, int(cfg.port))))
            if cfg.port <= 0:
                cfg.port = lst.getsockname()[1]
        else:
            with contextlib.suppress(OSError):
                os.unlink(cfg.socket_path)
            lst = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            lst.bind(cfg.socket_path)
        lst.listen(64)
        lst.settimeout(0.2)
        self._listener = lst
        for target, name in ((self._accept_loop, "racon-router-accept"),
                             (self._health_loop, "racon-router-health")):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        if self.journal is not None:
            self.journal.record("router-start", address=cfg.address,
                                pid=os.getpid(), replicas=len(self.replicas))
        log_info(f"[racon_tpu_torch::router] routing on {cfg.address} over "
                 f"{len(self.replicas)} replica(s), "
                 f"{self._routable_count()} routable"
                 + (f", metrics on 127.0.0.1:{cfg.metrics_port}"
                    if self._http is not None else "")
                 + (f", journal {cfg.journal_path}"
                    if self.journal is not None else ""))
        return self

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting, let the fan-outs in flight finish (bounded by
        `timeout`), close the transport and the journal."""
        if self._draining.is_set():
            self._stopped.wait()
            return True
        self._draining.set()
        if self._listener is not None:
            with contextlib.suppress(OSError):
                self._listener.close()
        deadline = time.monotonic() + timeout
        clean = True
        while time.monotonic() < deadline:
            with self._state_lock:
                if self._inflight_jobs == 0:
                    break
            time.sleep(0.05)
        else:
            clean = False
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=2.0)
        if self._http is not None:
            with contextlib.suppress(Exception):
                self._http.shutdown()
                self._http.server_close()
            self._http = None
        with self._conn_lock:
            conns = list(self._conns)
        for c in conns:
            with contextlib.suppress(OSError):
                c.shutdown(socket.SHUT_RDWR)
            with contextlib.suppress(OSError):
                c.close()
        if self.config.port is None:
            with contextlib.suppress(OSError):
                os.unlink(self.config.socket_path)
        self.fleet.close()
        if self.config.trace_path:
            # best effort: a full disk loses the trace, never the drain
            try:
                obs_flight.dump(self.recorder, self.config.trace_path)
                log_info(f"[racon_tpu_torch::router] trace written to "
                         f"{self.config.trace_path}")
            except Exception as exc:  # noqa: BLE001 — see above
                log_info(f"[racon_tpu_torch::router] warning: could not "
                         f"write trace ({type(exc).__name__}: {exc})")
        if self.journal is not None:
            self.journal.record(
                "router-stop", clean=clean,
                completed=self.counters["jobs_completed"],
                failed=self.counters["jobs_failed"],
                requeues=self.counters["requeues"])
            self.journal.close()
        self._stopped.set()
        return clean

    # --------------------------------------------------------------- health
    def _health_loop(self) -> None:
        while not self._draining.is_set():
            self._draining.wait(self.config.health_interval_s)
            if self._draining.is_set():
                return
            with contextlib.suppress(Exception):
                self._apply_poll(self.fleet.poll())

    def _apply_poll(self, snap) -> None:
        by_spec = {rs.endpoint: rs for rs in snap.replicas}
        with self._state_lock:
            for r in self.replicas:
                rs = by_spec.get(r.spec)
                if rs is None:
                    continue
                was = r.routable
                r.ok = rs.ok
                r.draining = rs.draining
                r.error = rs.error
                # the poll probed for real: it overrides a failure a
                # submit saw, either way
                r.down_forced = False
                now = r.routable
                if was == now:
                    continue
                if self.journal is not None:
                    self.journal.record(
                        "replica-up" if now else "replica-down",
                        replica=r.spec, draining=r.draining or None,
                        error=r.error)
                log_info(f"[racon_tpu_torch::router] replica {r.spec} "
                         + ("rejoined" if now else
                            ("draining" if r.draining
                             else f"down ({r.error})")))

    def _routable_count(self) -> int:
        with self._state_lock:
            return sum(1 for r in self.replicas if r.routable)

    # ---------------------------------------------------- elastic fleet
    def add_replica(self, spec: str) -> bool:
        """Join a replica to the live routing set (the autoscaler's
        scale-up; also for an operator). Idempotent; the next poll or a
        submit takes it from there."""
        with self._state_lock:
            if any(r.spec == spec for r in self.replicas):
                return False
            self.replicas.append(ReplicaState(spec))
        self.fleet.add_endpoint(spec)
        if self.journal is not None:
            self.journal.record("replica-added", replica=spec)
        log_info(f"[racon_tpu_torch::router] replica {spec} added "
                 f"({self._routable_count()} routable)")
        return True

    def remove_replica(self, spec: str) -> bool:
        """Take a replica out of the routing set (scale-down, before its
        drain). Its shards in flight finish or requeue as on any loss;
        nothing new routes there. Idempotent."""
        with self._state_lock:
            before = len(self.replicas)
            self.replicas = [r for r in self.replicas if r.spec != spec]
            removed = len(self.replicas) != before
        if not removed:
            return False
        self.fleet.remove_endpoint(spec)
        if self.journal is not None:
            self.journal.record("replica-removed", replica=spec)
        log_info(f"[racon_tpu_torch::router] replica {spec} removed")
        return True

    def _pick_replica(self, exclude: set,
                      max_inflight: int | None = None
                      ) -> ReplicaState | None:
        """The least-loaded routable replica, preferring ones the shard
        has not failed on; claims an inflight slot under the lock. With
        `max_inflight`, only replicas below that load qualify: the
        dispatch hold insists on an idle one."""
        with self._state_lock:
            cands = [r for r in self.replicas
                     if r.routable and r.spec not in exclude]
            if not cands:
                cands = [r for r in self.replicas if r.routable]
            if max_inflight is not None:
                cands = [r for r in cands if r.inflight < max_inflight]
            if not cands:
                return None
            best = min(cands, key=lambda r: r.inflight)
            best.inflight += 1
            return best

    def _scaleup_headroom(self) -> bool:
        """True while an armed autoscaler could still add a replica: the
        only time a shard holds for an idle replica."""
        asc = self.autoscaler
        if asc is None:
            return False
        with self._state_lock:
            total = len(self.replicas)
        return total < asc.config.max_replicas

    def _release_replica(self, r: ReplicaState) -> None:
        with self._state_lock:
            r.inflight = max(0, r.inflight - 1)

    # -------------------------------------------------------------- serving
    def _accept_loop(self) -> None:
        while not self._draining.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(None)
            with self._conn_lock:
                self._conns.add(conn)
            threading.Thread(target=self._handle, args=(conn,),
                             name="racon-router-conn", daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        send_lock = threading.Lock()
        try:
            while True:
                try:
                    req = recv_frame(conn, self.config.max_frame)
                except ProtocolError as exc:
                    with contextlib.suppress(OSError):
                        send_frame(conn, error_response(exc.code, str(exc)))
                    if not exc.resync:
                        return
                    continue
                except OSError:
                    return
                if req is None:
                    return
                try:
                    resp = self._dispatch(req, conn, send_lock)
                except Exception as exc:  # noqa: BLE001 — a typed answer
                    resp = error_response(
                        "internal", f"{type(exc).__name__}: {exc}")
                try:
                    with send_lock:
                        send_frame(conn, resp)
                except ProtocolError as exc:
                    with contextlib.suppress(OSError):
                        send_frame(conn, error_response(exc.code, str(exc)))
                except OSError:
                    return
        finally:
            with self._conn_lock:
                self._conns.discard(conn)
            with contextlib.suppress(OSError):
                conn.close()

    def _dispatch(self, req: dict, conn: socket.socket,
                  send_lock: threading.Lock) -> dict:
        rtype = req.get("type")
        if rtype == "submit":
            return self._submit(req, conn, send_lock)
        if rtype == "ping":
            return {"type": "pong", "router": True,
                    "replicas": len(self.replicas),
                    "routable": self._routable_count(),
                    "uptime_s": round(time.perf_counter() - self._t_start,
                                      3),
                    "mono_s": time.perf_counter()}
        if rtype == "healthz":
            return dict(self.healthz_snapshot(), type="healthz")
        if rtype == "stats":
            return dict(self.stats_snapshot(), type="stats")
        if rtype == "scrape":
            return {"type": "metrics", "content_type": obs_prom.CONTENT_TYPE,
                    "text": self.prometheus_text()}
        if rtype == "cancel":
            return self._cancel_parent(req)
        if rtype == "shutdown":
            threading.Thread(target=self.drain, name="racon-router-drain",
                             daemon=True).start()
            return {"type": "ok", "message": "draining"}
        return error_response("bad-request",
                              f"unknown request type {rtype!r}")

    def healthz_snapshot(self) -> dict:
        with self._state_lock:
            routable = sum(1 for r in self.replicas if r.routable)
            draining = sum(1 for r in self.replicas if r.draining)
            down = sum(1 for r in self.replicas
                       if not r.ok or r.down_forced)
            outstanding = self._requeued_outstanding
            inflight = self._inflight_jobs
        self_draining = self._draining.is_set()
        return {"ok": routable > 0 and not self_draining,
                "draining": self_draining,
                "router": True,
                "replicas": len(self.replicas),
                "routable": routable,
                "replicas_draining": draining,
                "replicas_down": down,
                "requeued_outstanding": outstanding,
                "inflight": inflight,
                "uptime_s": round(time.perf_counter() - self._t_start, 3),
                **({"autoscale": self.autoscaler.snapshot()}
                   if self.autoscaler is not None else {})}

    def stats_snapshot(self) -> dict:
        with self._state_lock:
            replicas = [{"endpoint": r.spec, "ok": r.ok,
                         "draining": r.draining,
                         "down_forced": r.down_forced,
                         "inflight": r.inflight, "error": r.error}
                        for r in self.replicas]
            counters = dict(self.counters)
            counters["requeued_outstanding"] = self._requeued_outstanding
        return {"router": dict(counters, inflight_jobs=self._inflight_jobs,
                               uptime_s=round(
                                   time.perf_counter() - self._t_start, 3)),
                "replicas": replicas}

    def prometheus_text(self) -> str:
        """The router's `/metrics` body: the replicas' scrapes federated
        through the fleet aggregator (counters and gauges summed,
        histogram buckets pooled), then the router's own
        `racon_tpu_router_*` families."""
        body = ""
        with contextlib.suppress(Exception):
            body = self.fleet.prometheus_text()
        with self._state_lock:
            counters = {
                "router.jobs.submitted": self.counters["jobs_submitted"],
                "router.jobs.completed": self.counters["jobs_completed"],
                "router.jobs.failed": self.counters["jobs_failed"],
                "router.shards_dispatched": (
                    self.counters["shards_dispatched"],
                    "child jobs sent to replicas (requeues re-count)"),
                "router.parts_routed": (
                    self.counters["parts_routed"],
                    "contigs forwarded to clients exactly once (the "
                    "requeue dedupe ledger's routed count)"),
                "router.requeues": (
                    self.counters["requeues"],
                    "shards re-dispatched after a replica loss"),
            }
            gauges = {
                "router.replicas": (len(self.replicas),
                                    "configured replicas"),
                "router.replicas_routable": (
                    sum(1 for r in self.replicas if r.routable),
                    "replicas accepting new shards at the last probe"),
                "router.replicas_draining": sum(
                    1 for r in self.replicas if r.draining),
                "router.requeued_outstanding": (
                    self._requeued_outstanding,
                    "requeued shards not yet re-completed"),
                "router.inflight_jobs": self._inflight_jobs,
                "router.uptime_seconds": round(
                    time.perf_counter() - self._t_start, 3),
            }
        if self.autoscaler is not None:
            # armed only: an unarmed router's exposition is unchanged
            snap = self.autoscaler.snapshot()
            counters["router.autoscale.scale_ups"] = (
                snap["scale_ups"], "replicas spawned on pressure")
            counters["router.autoscale.scale_downs"] = (
                snap["scale_downs"], "replicas drained on idle")
            gauges["router.autoscale.spawned"] = (
                snap["spawned"], "autoscaler-owned replicas alive")
            gauges["router.autoscale.pressure"] = (
                snap["pressure"], "queued+inflight jobs per routable "
                "replica at the last poll")
        return body + obs_prom.render(counters, gauges)

    def _start_metrics_http(self) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        router = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                try:
                    path = self.path.split("?", 1)[0]
                    if path in ("/metrics", "/"):
                        body = router.prometheus_text().encode()
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         obs_prom.CONTENT_TYPE)
                    elif path == "/healthz":
                        doc = router.healthz_snapshot()
                        body = (json.dumps(doc, sort_keys=True)
                                + "\n").encode()
                        self.send_response(200 if doc["ok"] else 503)
                        self.send_header("Content-Type", "application/json")
                    else:
                        self.send_error(404)
                        return
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except Exception as exc:  # noqa: BLE001
                    with contextlib.suppress(Exception):
                        self.send_error(500, f"{type(exc).__name__}: {exc}")

            def log_message(self, *args):
                pass

        httpd = ThreadingHTTPServer(
            ("127.0.0.1", max(0, int(self.config.metrics_port))), _Handler)
        httpd.daemon_threads = True
        self.config.metrics_port = httpd.server_address[1]
        self._http = httpd
        threading.Thread(target=httpd.serve_forever,
                         name="racon-router-metrics-http",
                         daemon=True).start()

    # ------------------------------------------------------------------ qos
    def _cancel_parent(self, req: dict) -> dict:
        """A parent's cancel: mark the fan-out failed (the first failure
        wins, so a later shard failure cannot overwrite `cancelled`) and
        fan `cancel` frames out to every shard in flight by child trace
        id."""
        job_id = req.get("job_id")
        trace_id = req.get("trace_id")
        if not job_id and not trace_id:
            return error_response("bad-request",
                                  "cancel needs job_id or trace_id")
        with self._state_lock:
            entry = self._active.get(job_id or "")
            if entry is None and trace_id:
                for jid, (tid, m) in self._active.items():
                    if tid == trace_id:
                        job_id, entry = jid, (tid, m)
                        break
        if entry is None:
            return error_response("unknown-job",
                                  "no active router job matches",
                                  job_id=job_id, trace_id=trace_id)
        tid, merge = entry
        merge.fail(_ShardFailure("cancelled",
                                 f"job {job_id} cancelled by client"))
        if self.journal is not None:
            self.journal.record("cancelled", job=job_id, trace=tid)
        n = self._cancel_siblings(merge, job_id, tid, cause_shard=None,
                                  code="cancelled")
        return {"type": "ok", "cancelled": "running", "job_id": job_id,
                "shards_cancelled": n}

    def _cancel_siblings(self, merge: _JobMerge, job_id: str,
                         trace_id: str | None, cause_shard: int | None,
                         code: str) -> int:
        """A best-effort cancel to every other shard in flight (by child
        trace id): a parent doomed by one shard, or cancelled by its
        client, stops its siblings within an iteration."""
        with merge.lock:
            targets = [(k, rep, ctid)
                       for k, (rep, ctid) in merge.dispatched.items()
                       if k != cause_shard]
        tc0 = time.perf_counter()
        for _k, replica, child_trace in targets:
            try:
                replica.client(timeout=self.config.probe_timeout_s).cancel(
                    trace_id=child_trace)
            except (ServeError, ProtocolError, OSError):
                continue  # already finished, or the replica is gone
        if targets:
            self.recorder.complete(
                "router.cancel", tc0, time.perf_counter(),
                {"job": job_id, "trace_id": trace_id or job_id,
                 "by_shard": cause_shard, "code": code,
                 "cancelled": len(targets)})
            if self.journal is not None:
                self.journal.record("siblings-cancelled", job=job_id,
                                    trace=trace_id, by_shard=cause_shard,
                                    code=code, cancelled=len(targets))
        return len(targets)

    # --------------------------------------------------------------- submit
    def _read_target_contigs(self, path: str) -> list:
        from ..io.parsers import create_sequence_parser

        contigs: list = []
        create_sequence_parser(path, "router").parse(contigs, -1)
        return contigs

    @staticmethod
    def _write_records(path: str, contigs: list, fastq: bool) -> None:
        with open(path, "wb") as fh:
            for c in contigs:
                if fastq:
                    qual = c.quality or b"!" * len(c.data)
                    fh.write(b"@" + c.name.encode() + b"\n" + c.data
                             + b"\n+\n" + qual + b"\n")
                else:
                    fh.write(b">" + c.name.encode() + b"\n" + c.data + b"\n")

    @staticmethod
    def _write_shard_targets(contigs: list, n_shards: int,
                             workdir: str) -> list[str]:
        """The wrapper's contiguous-block partition over whole contigs
        (the shards' outputs in shard order are the unsharded output)."""
        fastq = any(c.quality for c in contigs)
        ext = "fastq" if fastq else "fasta"
        paths = []
        for k in range(n_shards):
            lo = k * len(contigs) // n_shards
            hi = (k + 1) * len(contigs) // n_shards
            path = os.path.join(workdir, f"shard_{k}.{ext}")
            PolishRouter._write_records(path, contigs[lo:hi], fastq)
            paths.append(path)
        return paths

    @staticmethod
    def _write_contig_targets(contigs: list, workdir: str) -> list[str]:
        """Range mode: one whole-contig target file per contig, shared by
        that contig's range shards (a child polishes only its slice, with
        the ranks and windows of the whole contig)."""
        fastq = any(c.quality for c in contigs)
        ext = "fastq" if fastq else "fasta"
        paths = []
        for ci, c in enumerate(contigs):
            path = os.path.join(workdir, f"contig_{ci}.{ext}")
            PolishRouter._write_records(path, [c], fastq)
            paths.append(path)
        return paths

    @staticmethod
    def _plan_ranges(contigs: list, cap: int,
                     wl: int) -> list[tuple[int, int, int]]:
        """The sub-contig shard plan: contigs split by target coordinate
        at window-grid boundaries (every window owned by exactly one
        shard). Each contig gets at least one shard; the rest of the
        budget goes greedily to the contig with the most windows per
        shard, and no contig splits into more shards than it has windows.
        Returns [(contig index, lo, hi), ...] in contig order, lo
        ascending within a contig."""
        W = [max(1, (len(c.data) + wl - 1) // wl) for c in contigs]
        budget = min(cap, sum(W))
        s = [1] * len(W)
        for _ in range(max(0, budget - len(W))):
            cands = [i for i in range(len(W)) if s[i] < W[i]]
            if not cands:
                break
            i = max(cands, key=lambda i: W[i] / s[i])
            s[i] += 1
        plan: list[tuple[int, int, int]] = []
        for ci, (w_c, s_c) in enumerate(zip(W, s)):
            for j in range(s_c):
                plan.append((ci, (j * w_c // s_c) * wl,
                             ((j + 1) * w_c // s_c) * wl))
        return plan

    def _submit(self, req: dict, conn: socket.socket,
                send_lock: threading.Lock) -> dict:
        for key in ("sequences", "overlaps", "target"):
            path = req.get(key)
            if not isinstance(path, str) or not path:
                return error_response("bad-request",
                                      f"missing input path {key!r}")
            if not os.path.isfile(path):
                return error_response("bad-request",
                                      f"{key} file not found: {path}")
        trace_id = req.get("trace_id")
        if trace_id is not None and (
                not isinstance(trace_id, str)
                or not 0 < len(trace_id) <= 64
                or not set(trace_id) <= _TRACE_ID_OK):
            return error_response(
                "bad-request", "trace_id must be 1-64 chars of [A-Za-z0-9._-]")
        if self._draining.is_set():
            return error_response("draining", "router is draining")
        with self._state_lock:
            self._job_seq += 1
            job_id = f"r{self._job_seq}"
            self.counters["jobs_submitted"] += 1
            self._inflight_jobs += 1
        want_stream = bool(req.get("stream"))
        want_progress = bool(req.get("progress"))
        t0 = time.perf_counter()
        # the parent's deadline, pinned absolute here: each dispatch
        # (first or requeued) gives its child what remains of it
        deadline_t = None
        if req.get("deadline_s") is not None:
            try:
                deadline_t = t0 + float(req["deadline_s"])
            except (TypeError, ValueError):
                deadline_t = None
        if self.journal is not None:
            self.journal.record("received", job=job_id, trace=trace_id,
                                tenant=req.get("tenant"),
                                target=req.get("target"))
            # started at once: parsing the target is the router's work,
            # and any failure from here on pairs started -> failed
            self.journal.record("started", job=job_id, trace=trace_id)
        workdir = None
        try:
            try:
                contigs = self._read_target_contigs(req["target"])
            except (RaconError, OSError) as exc:
                if self.journal is not None:
                    self.journal.record("failed", job=job_id, trace=trace_id,
                                        code="bad-request",
                                        message="unreadable target")
                with self._state_lock:
                    self.counters["jobs_failed"] += 1
                return error_response("bad-request",
                                      f"cannot parse target: {exc}",
                                      job_id=job_id)
            n_routable = self._routable_count()
            cap = n_routable
            if self.config.max_shards > 0:
                cap = min(cap, self.config.max_shards)
            opts_in = req.get("options")
            if not isinstance(opts_in, dict):
                opts_in = {}
            groups: list[dict] | None = None
            shard_ranges: list[tuple[int, int] | None]
            frag_ranges: list[tuple[int, int]] | None = None
            # three planners: fragment read ranges (a fragment job's
            # targets are its reads: every child shares the target file
            # and corrects a [frag_lo, frag_hi) slice), window ranges
            # when routable replicas exceed the contigs (not for rounds:
            # a redraft round over a segment is not the contig's), and
            # whole-contig shards
            fragment = req.get("mode") == "fragment"
            if fragment:
                n_reads = len(contigs)
                plan = plan_fragment_ranges(n_reads, cap)
                n_shards = len(plan)
                shard_ranges = [None] * n_shards
                shard_targets = [req["target"]] * n_shards
                if n_shards > 1:
                    frag_ranges = plan
                    if self.journal is not None:
                        self.journal.record("frag-plan", job=job_id,
                                            trace=trace_id, shards=n_shards,
                                            reads=n_reads)
            elif cap > len(contigs) and req.get("rounds") is None:
                try:
                    wl = max(1, int(opts_in.get("window_length", 500)))
                except (TypeError, ValueError):
                    wl = 500
                plan = self._plan_ranges(contigs, cap, wl)
                n_shards = len(plan)
                workdir = tempfile.mkdtemp(prefix=f"racon_router_{job_id}_")
                contig_paths = self._write_contig_targets(contigs, workdir)
                shard_targets = [contig_paths[ci] for ci, _, _ in plan]
                shard_ranges = [(lo, hi) for _, lo, hi in plan]
                groups = []
                for k, (ci, _lo, _hi) in enumerate(plan):
                    if not groups or groups[-1]["ci"] != ci:
                        groups.append({"ci": ci, "name": contigs[ci].name,
                                       "shards": []})
                    groups[-1]["shards"].append(k)
                if self.journal is not None:
                    self.journal.record("range-plan", job=job_id,
                                        trace=trace_id, shards=n_shards,
                                        contigs=len(contigs),
                                        window_length=wl)
            else:
                n_shards = max(1, min(cap, len(contigs)))
                shard_ranges = [None] * n_shards
                if n_shards > 1:
                    workdir = tempfile.mkdtemp(
                        prefix=f"racon_router_{job_id}_")
                    shard_targets = self._write_shard_targets(
                        contigs, n_shards, workdir)
                else:
                    shard_targets = [req["target"]]
            n_contigs = len(contigs)
            del contigs  # the shard files hold the bytes now
            # the plan span: the target's parse, the planning and the
            # shard files, from the submit's t0
            self.recorder.complete(
                "router.plan", t0, time.perf_counter(),
                {"job": job_id, "trace_id": trace_id or job_id,
                 "mode": ("fragment" if fragment
                          else "range" if groups is not None else "contig"),
                 "shards": n_shards, "contigs": n_contigs})
            requeues_before = self.counters["requeues"]
            emit_part = None
            if want_stream:
                def emit_part(k, part_index, name, fasta):
                    frame = {"type": "result_part", "job_id": job_id,
                             "part": part_index, "name": name,
                             "fasta": fasta, "shard": k}
                    if trace_id:
                        frame["trace_id"] = trace_id
                    try:
                        with send_lock:
                            send_frame(conn, frame)
                    except (ProtocolError, OSError):
                        pass  # the client left: the shards still finish

            def on_routed(k, part_index, name, nbytes, **extra):
                with self._state_lock:
                    self.counters["parts_routed"] += 1
                self.recorder.instant(
                    "router.stream",
                    {"job": job_id, "trace_id": trace_id or job_id,
                     "shard": k, "part": part_index, "bytes": nbytes})
                if self.journal is not None:
                    # range mode adds lo / hi: one line per accepted
                    # segment; fragment mode frag_lo / frag_hi / reads
                    self.journal.record("part-routed", job=job_id,
                                        trace=trace_id, shard=k,
                                        part=part_index, name=name,
                                        bytes=nbytes, **extra)

            merge = _JobMerge(
                n_shards, emit_part=emit_part, on_routed=on_routed,
                groups=groups,
                fragment_correction=bool(opts_in.get("fragment_correction")),
                drop_unpolished=not opts_in.get("include_unpolished", False))
            with self._state_lock:
                self._active[job_id] = (trace_id, merge)
            threads = []
            for k in range(n_shards):
                t = threading.Thread(
                    target=self._run_shard,
                    args=(req, job_id, trace_id, k, n_shards,
                          shard_targets[k], merge, conn, send_lock,
                          want_progress, deadline_t, shard_ranges[k],
                          frag_ranges[k] if frag_ranges is not None
                          else None),
                    name=f"racon-router-{job_id}-s{k}", daemon=True)
                t.start()
                threads.append(t)
            for t in threads:
                t.join()

            if merge.failure is not None:
                f = merge.failure
                if self.journal is not None:
                    self.journal.record("failed", job=job_id, trace=trace_id,
                                        code=f.code, message=str(f))
                with self._state_lock:
                    self.counters["jobs_failed"] += 1
                return error_response(f.code, str(f), job_id=job_id,
                                      **f.extra)
            out = self._result(req, merge, job_id, trace_id, t0,
                               n_routable, requeues_before, want_stream,
                               fragment)
            if self.journal is not None:
                self.journal.record(
                    "finished", job=job_id, trace=trace_id, shards=n_shards,
                    parts=merge.total_routed,
                    segments=(merge.segments_routed
                              if groups is not None else None),
                    requeues=out["router"]["requeues"],
                    wall_s=out["router"]["wall_s"])
            with self._state_lock:
                self.counters["jobs_completed"] += 1
            return out
        finally:
            with self._state_lock:
                self._active.pop(job_id, None)
                self._inflight_jobs = max(0, self._inflight_jobs - 1)
            if workdir is not None:
                shutil.rmtree(workdir, ignore_errors=True)

    def _result(self, req: dict, merge: _JobMerge, job_id: str,
                trace_id: str | None, t0: float, n_routable: int,
                requeues_before: int, want_stream: bool,
                fragment: bool) -> dict:
        """The parent's result frame from its shards' responses: the
        longest queue wait and exec, the metrics summed, a rounds block
        (requested and completed agree across shards; cache counts sum),
        the `router` block, and the FASTA or the streamed part count."""
        n_shards = len(merge.parts)
        wall_s = time.perf_counter() - t0
        tm0 = time.perf_counter()
        queue_wait = exec_max = 0.0
        metrics: dict = {}
        rounds_req = rounds_comp = cache_hits = cache_misses = 0
        rounds_cached = False
        for resp in merge.results:
            serve = (resp or {}).get("serve") or {}
            queue_wait = max(queue_wait, float(serve.get("queue_wait_s",
                                                         0.0)))
            exec_max = max(exec_max, float(serve.get("exec_s", 0.0)))
            for mk, mv in ((resp or {}).get("metrics") or {}).items():
                if isinstance(mv, (int, float)):
                    metrics[mk] = metrics.get(mk, 0) + mv
            rb = (resp or {}).get("rounds") or {}
            if rb:
                rounds_req = max(rounds_req, int(rb.get("requested", 0)))
                rounds_comp = max(rounds_comp, int(rb.get("completed", 0)))
                cache = rb.get("cache")
                if cache:
                    rounds_cached = True
                    cache_hits += int(cache.get("hits", 0))
                    cache_misses += int(cache.get("misses", 0))
        out = {"type": "result", "job_id": job_id,
               "serve": {"queue_wait_s": round(queue_wait, 4),
                         "exec_s": round(exec_max, 4)},
               "router": {"shards": n_shards, "replicas": n_routable,
                          "requeues": self.counters["requeues"]
                          - requeues_before,
                          "parts": merge.total_routed,
                          "wall_s": round(wall_s, 4),
                          "shard_exec_max_s": round(exec_max, 4)}}
        if merge.groups is not None:
            out["router"]["range"] = True
            out["router"]["range_shards"] = n_shards
            out["router"]["segments"] = merge.segments_routed
        if fragment:
            out["router"]["fragment"] = True
            out["router"]["frag_shards"] = n_shards
            out["router"]["reads"] = merge.reads_routed
        if trace_id:
            out["trace_id"] = trace_id
        if metrics:
            out["metrics"] = metrics
        if rounds_req:
            # no merged per_round: the shards' rounds overlap in time
            out["rounds"] = {"requested": rounds_req,
                             "completed": rounds_comp}
            if rounds_cached:
                out["rounds"]["cache"] = {"hits": cache_hits,
                                          "misses": cache_misses}
        if want_stream:
            out["streamed"] = True
            out["parts"] = merge.total_routed
        else:
            out["fasta"] = merge.fasta()
        # the merge span: the stats, the assembly and the result frame
        self.recorder.complete(
            "router.merge", tm0, time.perf_counter(),
            {"job": job_id, "trace_id": trace_id or job_id,
             "shards": n_shards, "parts": merge.total_routed})
        if req.get("trace"):
            self._attach_trace(out, merge, job_id, trace_id)
        return out

    def _attach_trace(self, out: dict, merge: _JobMerge, job_id: str,
                      trace_id: str | None) -> None:
        """A traced routed job's trace: clock-sync and `trace_pull` every
        replica that completed a shard, then put the router's spans and
        each replica's in the result frame, for the client to merge on
        its own clock (client.merge_trace: one process track a replica).

        The child submits carry no `trace: true` (a traced job runs under
        a module-wide scope, which would serialize shards on one replica):
        the replica's always-on flight ring supplies the spans, which
        carry the child trace ids. Each replica is pulled for exactly the
        child ids it finished (`merge.shard_owner`): a lost attempt's
        spans would skew the sums, and replicas in one process share one
        ring. Best effort per replica. `offset_s` is the replica's clock
        against the router's; the client chains it with its own."""
        tid = trace_id or job_id
        pulls = []
        tp0 = time.perf_counter()
        with merge.lock:
            owners = dict(merge.shard_owner)
            seen = dict(merge.replicas_seen)
        per_rep: dict[str, list[str]] = {}
        for k in sorted(owners):
            spec, ctid = owners[k]
            per_rep.setdefault(spec, []).append(ctid)
        for spec in sorted(per_rep):
            replica = seen.get(spec)
            if replica is None:
                continue
            try:
                cl = replica.client(timeout=self.config.probe_timeout_s)
                sync = cl.clock_sync()
                resp = cl.request({"type": "trace_pull", "trace_id": tid,
                                   "trace_ids": per_rep[spec]})
            except (ServeError, ProtocolError, OSError):
                continue
            if resp.get("base_mono") is None:
                continue  # no flight ring on that replica
            pulls.append({"replica": spec,
                          "events": resp.get("events") or [],
                          "base_mono": resp["base_mono"],
                          "offset_s": round(float(sync["offset_s"]), 6),
                          "rtt_s": round(float(sync["rtt_s"]), 6)})
        self.recorder.complete(
            "router.trace_pull", tp0, time.perf_counter(),
            {"job": job_id, "trace_id": tid, "replicas": len(pulls)})
        out["trace"] = obs_flight.trace_events(self.recorder, tid)
        out["trace_base_mono"] = self.recorder._base
        if pulls:
            out["trace_replicas"] = pulls
        # the shards' serve stats ride along on a traced job only, so a
        # reader can hold span sums against each shard's numbers
        out["router"]["shards_detail"] = [
            {"shard": kk,
             "queue_wait_s": ((resp or {}).get("serve") or {}).get(
                 "queue_wait_s"),
             "exec_s": ((resp or {}).get("serve") or {}).get("exec_s"),
             "batch": ((resp or {}).get("serve") or {}).get("batch")}
            for kk, resp in enumerate(merge.results)]

    def _run_shard(self, req: dict, job_id: str, trace_id: str | None,
                   k: int, n_shards: int, shard_target: str,
                   merge: _JobMerge, conn: socket.socket,
                   send_lock: threading.Lock, want_progress: bool,
                   deadline_t: float | None = None,
                   rng: tuple[int, int] | None = None,
                   frng: tuple[int, int] | None = None) -> None:
        """One shard's dispatch loop: submit to the least-loaded routable
        replica, stream its parts into the merge, and on a replica's loss
        requeue to a healthy one (journaled, deduped by the merge ledger)
        up to `shard_retries` times. `deadline_t` is the parent's
        absolute deadline: each dispatch gives the child what remains of
        it. A child that fails `cancelled` or `deadline-doomed` cancels
        its siblings."""
        child: dict = {"type": "submit",
                       "sequences": req["sequences"],
                       "overlaps": req["overlaps"],
                       "target": shard_target,
                       "stream": True,
                       "parent": job_id, "shard": k, "shards": n_shards,
                       "trace_id": f"{trace_id or job_id}.s{k}"}
        for key in ("options", "priority", "fault_plan", "strict",
                    "tenant", "rounds", "mode", "ingest", "subsample",
                    "normalize"):
            if req.get(key) is not None:
                child[key] = req[key]
        if rng is not None:
            # a window-range shard: the child polishes the windows whose
            # grid start lies in [lo, hi) and streams raw segments
            child["range_lo"], child["range_hi"] = rng
        if frng is not None:
            # a fragment read range: the child corrects the reads whose
            # index lies in [frag_lo, frag_hi); its groups come back with
            # global `frag` receipts
            child["frag_lo"], child["frag_hi"] = frng
        if want_progress:
            child["progress"] = True

        def on_progress(frame):
            fwd = dict(frame, job_id=job_id, shard=k)
            try:
                with send_lock:
                    send_frame(conn, fwd)
            except (ProtocolError, OSError):
                pass

        losses = 0
        busy_waits = 0
        requeued_pending = False
        exclude: set[str] = set()
        wait_deadline = time.monotonic() + self.config.replica_wait_s
        # the dispatch hold: while the fleet can still grow, insist on an
        # idle replica for up to hold_s before settling for a busy one. A
        # held shard counts as backlog, so the hold summons the replica
        # it waits for; the first replica to go idle takes it within one
        # 0.1 s poll
        asc = self.autoscaler
        hold_deadline = (time.monotonic() + asc.config.hold_s
                         if asc is not None and asc.config.hold_s > 0
                         else None)
        waiting_flagged = False

        def set_waiting(on: bool):
            nonlocal waiting_flagged
            if on == waiting_flagged:
                return
            with self._state_lock:
                self._dispatch_waiting = max(
                    0, self._dispatch_waiting + (1 if on else -1))
            waiting_flagged = on

        def settle():
            nonlocal requeued_pending
            set_waiting(False)
            if requeued_pending:
                requeued_pending = False
                with self._state_lock:
                    self._requeued_outstanding = max(
                        0, self._requeued_outstanding - 1)

        #: each attempt's `router.dispatch` span runs from here to the
        #: pick, so a wait for a replica (busy or held) shows as its width
        attempt_t0 = time.perf_counter()
        held = False  # the hold engaged on this attempt
        while True:
            if merge.failure is not None:
                # another shard, or a parent cancel, doomed the job: no
                # more device work for it
                settle()
                return
            if deadline_t is not None:
                remaining = deadline_t - time.perf_counter()
                if remaining <= 0:
                    merge.fail(_ShardFailure(
                        "deadline-doomed",
                        f"shard {k}: parent deadline budget exhausted "
                        f"before dispatch", remaining_s=round(remaining, 3)))
                    self._cancel_siblings(merge, job_id, trace_id, k,
                                          "deadline-doomed")
                    settle()
                    return
                child["deadline_s"] = round(remaining, 4)
            hold = (hold_deadline is not None
                    and time.monotonic() < hold_deadline
                    and not self._draining.is_set()
                    and self._scaleup_headroom())
            replica = self._pick_replica(
                exclude, max_inflight=1 if hold else None)
            if replica is None:
                if hold or (time.monotonic() < wait_deadline
                            and not self._draining.is_set()):
                    held = held or hold
                    set_waiting(True)
                    time.sleep(0.1)
                    continue
                merge.fail(_ShardFailure(
                    "no-replica",
                    f"shard {k}: no routable replica within "
                    f"{self.config.replica_wait_s:g}s"))
                settle()
                return
            set_waiting(False)
            picked_t = time.perf_counter()
            held_s = picked_t - attempt_t0
            self.recorder.complete(
                "router.dispatch", attempt_t0, picked_t,
                {"job": job_id, "trace_id": child["trace_id"], "shard": k,
                 "replica": replica.spec, "held_s": round(held_s, 4),
                 "held": held, "attempt": losses + busy_waits})
            with self._state_lock:
                self.counters["shards_dispatched"] += 1
            if self.journal is not None:
                self.journal.record("shard-dispatched", job=job_id,
                                    trace=trace_id, shard=k,
                                    replica=replica.spec,
                                    attempt=losses + busy_waits)
                if held:
                    # the span's twin: obsreport's timelines read it
                    self.journal.record("hold", job=job_id, trace=trace_id,
                                        shard=k, held_s=round(held_s, 4))
            with merge.lock:
                merge.dispatched[k] = (replica, child["trace_id"])
                merge.replicas_seen[replica.spec] = replica
            lost = False
            try:
                resp = replica.client().request(
                    child, on_part=lambda f: merge.on_part(k, f),
                    on_progress=on_progress if want_progress else None)
                # the shard span: the child request's whole wall
                self.recorder.complete(
                    "router.shard", picked_t, time.perf_counter(),
                    {"job": job_id, "trace_id": child["trace_id"],
                     "shard": k, "replica": replica.spec, "outcome": "ok",
                     "parts": len(resp.get("_parts") or ())})
                with merge.lock:
                    merge.shard_owner[k] = (replica.spec, child["trace_id"])
                merge.shard_done(k, resp)
                if self.journal is not None:
                    self.journal.record(
                        "shard-finished", job=job_id, trace=trace_id,
                        shard=k, replica=replica.spec,
                        parts=len(resp.get("_parts") or ()))
                settle()
                return
            except JobFailed as exc:
                merge.fail(_ShardFailure("job-failed", f"shard {k}: {exc}",
                                         error_type=exc.error_type))
                settle()
                return
            except ServerDraining:
                # a rolling restart: this replica stopped admitting, so
                # the shard goes elsewhere, no loss
                exclude.add(replica.spec)
                attempt_t0 = time.perf_counter()
                held = False
                continue
            except QueueFull as exc:
                busy_waits += 1
                if busy_waits > 50:
                    merge.fail(_ShardFailure(
                        "queue-full", f"shard {k}: replicas stayed full"))
                    settle()
                    return
                attempt_t0 = time.perf_counter()
                held = False
                time.sleep(_retry_delay(exc.retry_after))
                continue
            except ServeError as exc:
                if exc.code == "closed":
                    lost = True
                else:
                    merge.fail(_ShardFailure(exc.code, f"shard {k}: {exc}"))
                    if exc.code in ("cancelled", "deadline-doomed"):
                        # a doomed or cancelled child dooms the parent:
                        # its siblings stop within an iteration
                        self._cancel_siblings(merge, job_id, trace_id, k,
                                              exc.code)
                    settle()
                    return
            except (ProtocolError, OSError):
                lost = True
            finally:
                with merge.lock:
                    merge.dispatched.pop(k, None)
                self._release_replica(replica)
            if not lost:
                return
            # ---- the replica was lost: mark it down, requeue the shard
            self.recorder.complete(
                "router.shard", picked_t, time.perf_counter(),
                {"job": job_id, "trace_id": child["trace_id"], "shard": k,
                 "replica": replica.spec, "outcome": "lost"})
            with self._state_lock:
                replica.down_forced = True
            if self.journal is not None:
                self.journal.record("replica-down", replica=replica.spec,
                                    job=job_id, shard=k)
            log_info(f"[racon_tpu_torch::router] replica {replica.spec} "
                     f"lost mid-shard ({job_id} shard {k})")
            losses += 1
            if losses > self.config.shard_retries:
                merge.fail(_ShardFailure(
                    "replica-lost",
                    f"shard {k}: lost {losses} replicas (retry limit "
                    f"{self.config.shard_retries})"))
                settle()
                return
            with self._state_lock:
                self.counters["requeues"] += 1
                if not requeued_pending:
                    self._requeued_outstanding += 1
                    requeued_pending = True
            if self.journal is not None:
                self.journal.record("requeued", job=job_id, trace=trace_id,
                                    shard=k, from_replica=replica.spec)
            merge.requeue(k)
            self.recorder.instant(
                "router.requeue",
                {"job": job_id, "trace_id": child["trace_id"], "shard": k,
                 "from": replica.spec, "losses": losses})
            exclude.add(replica.spec)
            wait_deadline = time.monotonic() + self.config.replica_wait_s
            attempt_t0 = time.perf_counter()
            held = False


# ------------------------------------------------------------------ CLI
def router_main(argv: list[str]) -> int:
    """`python -m racon_tpu_torch router`: run a PolishRouter until
    SIGTERM or SIGINT, then drain."""
    import argparse
    import signal

    ap = argparse.ArgumentParser(
        prog="racon_tpu_torch router",
        description="shard-aware front end over N warm `python -m "
                    "racon_tpu_torch serve` replicas: contig, window-range "
                    "and fragment read-range shards, journal-backed "
                    "requeue on a replica's loss, rolling restarts "
                    "without job loss")
    ap.add_argument("--replicas", default="",
                    help="comma-separated replica RPC endpoints: unix "
                         "socket paths or localhost host:port")
    ap.add_argument("--socket", default=None,
                    help="the router's unix socket (default "
                         "racon_tpu_torch_router.sock in TMPDIR)")
    ap.add_argument("--port", type=int, default=None,
                    help="listen on localhost TCP instead (0 = ephemeral)")
    ap.add_argument("--journal", default=None,
                    help="JSONL retry ledger and lifecycle journal (an "
                         "unwritable path fails the start)")
    ap.add_argument("--journal-fsync", action="store_true",
                    help="sync each journal line to disk before going on")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="federated /metrics and /healthz over the "
                         "replicas plus the racon_tpu_router_* families "
                         "(0 = ephemeral)")
    ap.add_argument("--health-interval", type=float, default=2.0,
                    help="replica healthz and scrape poll seconds "
                         "(default 2)")
    ap.add_argument("--probe-timeout", type=float, default=2.0,
                    help="per-replica probe timeout seconds (default 2)")
    ap.add_argument("--max-shards", type=int, default=0,
                    help="shards a job at most (default 0 = one per "
                         "routable replica)")
    ap.add_argument("--shard-retries", type=int, default=3,
                    help="replica losses a shard survives before its job "
                         "fails (default 3)")
    ap.add_argument("--replica-wait", type=float, default=60.0,
                    help="seconds a shard waits for a routable replica "
                         "before its job fails (default 60)")
    ap.add_argument("--max-frame", type=int, default=DEFAULT_MAX_FRAME,
                    help="the largest request frame read, in bytes")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write the router's own flight ring (plan, "
                         "dispatch, stream, merge and requeue spans per "
                         "routed job) as Chrome-trace JSON at stop")
    ap.add_argument("--autoscale", action="store_true",
                    help="arm the elastic fleet: spawn warm replicas on "
                         "sustained backlog pressure or a firing deadline "
                         "burn-rate alert, stop the newest spawned one "
                         "after sustained idle, and hold a shard for an "
                         "idle replica while the fleet can grow")
    ap.add_argument("--autoscale-min", default=None,
                    help="fleet floor (default 1)")
    ap.add_argument("--autoscale-max", default=None,
                    help="fleet ceiling (default 4)")
    ap.add_argument("--autoscale-interval", default=None,
                    help="decision loop seconds (default 1)")
    ap.add_argument("--autoscale-up-pressure", default=None,
                    help="queued + inflight jobs per routable replica that "
                         "count as pressure (default 2)")
    ap.add_argument("--autoscale-up-sustain", default=None,
                    help="seconds pressure must last before a scale-up "
                         "(default 2)")
    ap.add_argument("--autoscale-down-idle", default=None,
                    help="seconds of a fully idle fleet before a "
                         "scale-down (default 10)")
    ap.add_argument("--autoscale-cooldown", default=None,
                    help="least seconds between two actions (default 3)")
    ap.add_argument("--autoscale-dir", default=None,
                    help="socket directory of spawned replicas (default a "
                         "new temporary directory)")
    ap.add_argument("--autoscale-ready-timeout", default=None,
                    help="seconds a spawned replica may take to its first "
                         "clean healthz (default 20)")
    ap.add_argument("--autoscale-hold", default=None,
                    help="seconds a shard may hold out for an idle or new "
                         "replica (default 5; 0 = no hold); to reach a new "
                         "replica the hold must outlast its start, 9-12 s "
                         "measured on an H100")
    ap.add_argument("--autoscale-replica-args", default="",
                    metavar="ARGS",
                    help="`serve` flags for every spawned replica, one "
                         "string split like a shell command, given with "
                         "'=' (--autoscale-replica-args=\"-c 1 "
                         "--cudaaligner-batches 1 -m 5 -x -4 -g -8\"); "
                         "never --socket or --port")
    args = ap.parse_args(argv)

    from .autoscale import AutoscaleConfig, Autoscaler

    # the autoscale values go to AutoscaleConfig as typed, so that it is
    # their one strict parser: a bad one exits 1 before anything starts
    given = {key: getattr(args, "autoscale_" + flag) for key, flag in (
        ("min_replicas", "min"), ("max_replicas", "max"),
        ("interval_s", "interval"), ("up_pressure", "up_pressure"),
        ("up_sustain_s", "up_sustain"), ("down_idle_s", "down_idle"),
        ("cooldown_s", "cooldown"), ("socket_dir", "dir"),
        ("ready_timeout_s", "ready_timeout"), ("hold_s", "hold"),
        ("replica_args", "replica_args"))}
    try:
        scale_cfg = AutoscaleConfig(**given) if args.autoscale else None
        router = PolishRouter(
            replicas=args.replicas, socket_path=args.socket,
            port=args.port, journal=args.journal,
            journal_fsync=args.journal_fsync,
            metrics_port=args.metrics_port,
            health_interval_s=args.health_interval,
            probe_timeout_s=args.probe_timeout,
            max_shards=args.max_shards, shard_retries=args.shard_retries,
            replica_wait_s=args.replica_wait, max_frame=args.max_frame,
            trace_path=args.trace).start()
    except (RaconError, OSError, ValueError) as exc:
        print(f"[racon_tpu_torch::router] error: {exc}", file=sys.stderr)
        return 1
    scaler = (Autoscaler(router, scale_cfg).start()
              if scale_cfg is not None else None)

    stop = threading.Event()

    def _on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    while not stop.is_set() and not router._stopped.is_set():
        stop.wait(0.2)
    if scaler is not None:
        scaler.close()
    router.drain()
    return 0
