"""Continuous cross-job window batching: iteration-level dispatch.

A window's consensus depends only on the window (backbone and layers)
and the engine parameters, never on the windows that share its device
batch. `WindowBatcher` uses that across jobs: the windows of concurrent
polish requests pool per engine-parameter key, and one device FEEDER
thread drains the pools in bounded, shape-homogeneous ITERATIONS, one
engine pass each, so a job that arrives mid-flight joins the next
dispatch. Each job's windows come back carrying the consensus a solo
run would have given them (tests/test_torch_serve.py). The port of the
JAX package's racon_tpu/serve/batcher.py.

Worker lanes (`worker_lanes`, default 1): the device list (`devices`,
default the first job's polisher's lanes) is cut into contiguous lanes
(parallel/mesh.partition_devices; the count clamps to the devices). Each
lane has its own BatchRunner, feeder thread, lock, engines, scheduler
with its occupancy counters, and PipelineStats, so iterations of two
lanes (of one key or of two) run at once; one lane keeps the batcher's
own scheduler and stats. A list may repeat a device: `[cuda:0, cuda:0]`
gives two lanes on one card, and `[cpu] * 2` two on the CPU.

Packing: the feeder always serves the key that holds the globally
oldest pending window (no starvation), sorts that key's pool by window
shape (depth, backbone length: what the engines' ladders bucket on) and
takes the shape-sorted slab of at most `iteration_windows` windows that
contains the oldest one (sched.pack_iteration). `max_wait_s` (default 0:
dispatch at once) lets a sparse pool coalesce briefly before a short
iteration; a full iteration pending under any key never waits.

Delivery: a job's windows complete an iteration at a time.
`consensus(polisher, on_windows=...)` hands each iteration's finished
windows to the job's own thread, which stitches them there (the
polisher's ContigStreamer), so finished targets can stream before the
job ends and no stitching runs on the feeder thread.

The device: PyTorch's current device and stream are per thread. A
feeder builds each key's engine and runs every iteration inside
`torch.cuda.device` of the key's device, on its lane's own CUDA stream
(made at the lane's first iteration and kept), and inside the engine's
dispatch pipeline, and synchronizes that stream before it delivers, so
two lanes on one card neither share a stream nor wait for each other's
work (the fused engine keeps its own streams per pass, and its pass
waits for them). Each lane keeps one (DispatchPipeline, BatchPOA) pair
per key, built at the lane's first iteration that needs it (the
persistent dispatch loop) on the lane's runner; its autotuner is the
first job's, whose table path is part of the key. `host_s`, an
iteration's wall minus its pipeline's device seconds, is summed in the
counters, rides the `serve.iteration` span and fills the
`serve.iteration_host` histogram.
Each iteration's K1 and K3 launches (read on its feeder thread under the
lane lock, before the audit, the cache store and any re-probe launch
there) are billed to every job with windows in it.

Isolation: a job that carries its own fault plan never shares an
iteration. It runs its polisher's own `_consensus_pass()` (its own
pipeline and faults) alone on the least busy healthy lane, under that
lane's lock and on its runner, so its injected errors fail that job
only while the other lanes go on. A failure inside a shared iteration
fails the jobs with windows in it (their other pooled windows are
dropped); the feeder carries on.

Window cache (`wincache`, a serve/wincache.WindowCache, None = off):
`consensus` looks each window up before pooling, keyed by its content,
the engine key and the polisher's kernel posture; a hit gets the stored
consensus and goes straight to the job's thread, never to an iteration
(`polisher.serve_cache` counts the hits and misses). Each iteration's
windows are stored once it ends and its audit is done. Isolation jobs
neither consult nor store. A demotion or a lane quarantine invalidates
the whole cache.

Identity audit (`auditor`, an obs/audit.WindowAuditor, None = off): each
iteration's finished windows, shared or solo, are audited on the feeder
(or the job's) thread after the lane lock is released and before
delivery, so a caught corruption is repaired before any job stitches it;
a job's cache hits are audited on its own thread before delivery, and a
poisoned entry takes the blame. An audit failure is logged and never
fails production; its wall is summed as `audit_s`. A mismatch demotes the
winner table and calls `flush_lane_engines` (every lane rebuilds its
engines at its next iteration) and `quarantine_lane`: the lane stops
extracting, and its feeder re-probes it with the auditor's latest
mismatched window (`probe()`) on rebuilt engines until the bytes equal
the oracle's; then it rejoins at health 1.0. A lane whose probe fails
stays quarantined while another lane serves; the last serving lane
rejoins degraded at health 0.5. Nothing moves a lane to the CPU or to a
plain kernel.

QoS: `withdraw_job` parks a running job's pooled windows between
iterations (the entries keep their arrival sequence; windows the job
pools later park directly) and `resume_job` returns them, so the resumed
job keeps its place and its bytes. With `abort_margin` set (None = off)
the job's thread checks after each delivered batch whether the job's
remaining windows, at its observed rate, can still finish by its
deadline (`polisher.serve_deadline`) and raises `queue.DeadlineDoomed`
when they overshoot by more than the margin. Each iteration's wall is
prorated over the tenants whose windows rode it, by window count (the
session engine charges no pipeline device seconds, so the wall is the
device-busy time the feeder holds); `tenant_device_seconds()` gives the
per-tenant sums once a named tenant has one.

`cancel_job` kills a running job's tickets with a typed
`queue.JobCancelledError`; the feeder drops their pooled windows at its
next scan and the job's thread raises. `hold` / `release` pause the
feeder before its next extraction (tests and the chip smoke use them to
pool several jobs deterministically).

Lock order: a lane lock, then `_cond`; never the other way round.
`close()` takes each lane lock with a timeout.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

from ..errors import RaconError
from ..obs import trace
from ..utils.logger import log_info
from .queue import DeadlineDoomed, DeliveryQueue, JobCancelledError


class _Ticket:
    """One job's consensus request in the pool. The feeder delivers
    each iteration's finished windows through a DeliveryQueue; the job's
    own thread consumes them (and runs the stitch callback)."""

    __slots__ = ("polisher", "key", "error", "total", "remaining", "done",
                 "iterations", "iteration_ids", "shared_iterations",
                 "compiles", "compile_s", "device_s", "device_share_s",
                 "host_s", "k1_launches", "k3_launches", "_delivery",
                 "event")

    def __init__(self, polisher, key):
        self.polisher = polisher
        self.key = key
        self.error: BaseException | None = None
        self.total = len(polisher.windows)
        self.remaining = self.total
        self.done = 0
        self.iterations = 0
        self.iteration_ids: list[int] = []
        self.shared_iterations = 0
        self.compiles = 0
        self.compile_s = 0.0
        #: the iterations' walls, each billed in full to every rider
        self.device_s = 0.0
        #: this job's window share of those walls (the tenant's cost)
        self.device_share_s = 0.0
        self.host_s = 0.0
        self.k1_launches = 0
        self.k3_launches = 0
        self._delivery = DeliveryQueue()
        self.event = self._delivery.event

    def deliver(self, windows: list) -> None:
        self._delivery.push(windows)

    def finish(self) -> None:
        self._delivery.finish()

    def take(self, timeout: float | None = None) -> list | None:
        return self._delivery.take(timeout)

    def batch_info(self, solo: bool = False) -> dict:
        info = {"iterations": self.iterations,
                "iteration_ids": list(self.iteration_ids),
                "shared_iterations": self.shared_iterations,
                "windows": self.total, "solo": solo,
                "compiles": self.compiles,
                "compile_s": round(self.compile_s, 3),
                "device_s": round(self.device_s, 4),
                "host_s": round(self.host_s, 4),
                "k1_launches": self.k1_launches,
                "k3_launches": self.k3_launches}
        tenant = self.polisher.serve_tenant
        if tenant:
            # a tenanted job carries its prorated share; an untenanted
            # response keeps its shape
            info["tenant"] = tenant
            info["device_share_s"] = round(self.device_share_s, 4)
        return info


class _IterProgress:
    """The engine's logger for one iteration: its bar ticks fan out to
    each rider's progress hook, scaled to the rider's share of this
    iteration and offset by the windows it completed before, so a
    client's consensus bar advances across iterations
    (Polisher.emit_progress keeps it monotone). Prints nothing."""

    def __init__(self, parts, iteration: int):
        #: (polisher, done before, windows in this iteration, job total)
        self._parts = [(t.polisher, t.done, n, t.total)
                       for t, n in parts
                       if t.polisher.progress_hook is not None]
        self._iter = iteration
        self._total = 1
        self._count = 0
        self._bins = 0
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        return bool(self._parts)

    def bar_total(self, total: int) -> None:
        with self._lock:
            self._total = max(1, int(total))
            self._count = 0
            self._bins = 0

    def bar(self, msg: str) -> None:
        with self._lock:
            self._count += 1
            bins = min(20 * self._count // self._total, 20)
            if bins == self._bins:
                return
            self._bins = bins
            frac = min(1.0, self._count / self._total)
        for polisher, before, n, total in self._parts:
            polisher.emit_progress(before + int(frac * n), total,
                                   phase="consensus", iteration=self._iter)


def _engine_key(p) -> tuple:
    """Engine-parameter identity: jobs share an iteration only when every
    knob that can change a window's consensus bytes, or the kernel that
    computes them, matches."""
    return (p.match, p.mismatch, p.gap, p.window_length, p.trim,
            p.num_threads, p.cuda_poa_batches, p.cuda_banded_alignment,
            p.cuda_aligner_band_width, p.cuda_engine, p.cuda_fused,
            p.fused_fallback, p.score_dtype, p.pack_bases,
            p.pipeline_depth, str(p.device), p.autotuner.path)


def _shape_key(window) -> tuple[int, int]:
    """Layer depth and backbone length: sorting the pool by them keeps
    each iteration's batch in few ladder buckets."""
    return (len(window.sequences), len(window.sequences[0]))


def _trace_ids(tickets) -> list[str]:
    """The client-minted trace ids of an iteration's jobs (the server
    sets `serve_trace_id` on each job's polisher), tagged onto the
    iteration's span so a merged client and server trace, or a trace
    pull, can attribute a shared iteration."""
    return [tid for tid in (t.polisher.serve_trace_id for t in tickets)
            if tid]


class _Lane:
    """One worker lane: its runner, its lock (the feeder and any
    isolation pass routed here serialize on it), its scheduler and
    PipelineStats (per-iteration deltas stay exact beside other lanes),
    its telemetry and health, its CUDA stream, and its engines (engine
    key -> (DispatchPipeline, BatchPOA)). Counters and health are
    guarded by the batcher's `_cond`; `engines` and `stream` by the lane
    lock."""

    __slots__ = ("index", "runner", "scheduler", "pipeline_stats", "lock",
                 "busy", "iterations", "busy_s", "engines", "health",
                 "quarantined", "reprobes", "flush_engines", "stream")

    def __init__(self, index: int, runner, scheduler, pipeline_stats):
        self.index = index
        self.runner = runner
        self.scheduler = scheduler
        self.pipeline_stats = pipeline_stats
        self.lock = threading.Lock()
        self.busy = False
        self.iterations = 0
        self.busy_s = 0.0
        self.engines: dict = {}
        #: 1.0 healthy, 0.0 quarantined, 0.5 degraded (its re-probe
        #: failed but it is the last serving lane)
        self.health = 1.0
        self.quarantined = False
        self.reprobes = 0
        #: set by a demotion or a quarantine: the lane's next iteration
        #: (or re-probe) rebuilds its engines
        self.flush_engines = False
        self.stream = None


@contextlib.contextmanager
def _on_lane(lane: _Lane, dev):
    """Run the body on `dev` and, for a card, on the lane's own CUDA
    stream (made on the lane's device at first use, kept for the lane's
    life); yields that stream, or None on the CPU. Caller holds the
    lane lock."""
    if dev.type != "cuda":
        yield None
        return
    import torch

    if lane.stream is None:
        home = lane.runner.devices[0]
        lane.stream = torch.cuda.Stream(home if home.type == "cuda"
                                        else dev)
    with torch.cuda.stream(lane.stream), torch.cuda.device(dev):
        yield lane.stream


def _kernel_launches() -> tuple[int, int]:
    """K1's and K3's launches on the calling thread so far."""
    from ..ops import poa_fused_kernels, poa_kernels

    return (poa_kernels.counter.on_thread(),
            poa_fused_kernels.counter.on_thread())


def _book_audit_launches(polisher, before: tuple[int, int]) -> None:
    """Book the K1 / K3 launches an audit made on a job's own thread
    since `before` on its polisher (`serve_audit_launches`), which the
    server takes out of the job's launches."""
    now = _kernel_launches()
    for i in range(2):
        polisher.serve_audit_launches[i] += now[i] - before[i]


class WindowBatcher:
    """Continuous batching core (see the module docstring).
    `iteration_windows` bounds an iteration's batch; `max_wait_s` lets a
    sparse pool coalesce before a short iteration; `scheduler` (a
    sched.BatchScheduler; default a non-adaptive one) is the engines'
    scheduler and the occupancy counters of a single lane (several lanes
    take its `adaptive` posture and keep their own counters);
    `worker_lanes` and `devices` partition the device list into lanes
    (None: the first job's polisher's lanes)."""

    def __init__(self, iteration_windows: int = 256,
                 max_wait_s: float = 0.0, scheduler=None,
                 worker_lanes: int = 1, devices=None):
        from ..pipeline import PipelineStats
        from ..sched import BatchScheduler

        self.iteration_windows = max(1, int(iteration_windows))
        self.max_wait_s = max(0.0, float(max_wait_s))
        self.scheduler = (scheduler if scheduler is not None
                          else BatchScheduler())
        self.pipeline_stats = PipelineStats()
        self.worker_lanes = max(1, int(worker_lanes))
        self._devices = None if devices is None else list(devices)
        #: built at the first consensus (`_lanes_locked`)
        self._lanes: list[_Lane] | None = None
        #: optional obs.hist.HistogramSet (a server's lifetime set)
        self.hists = None
        self._cond = threading.Condition()
        #: engine key -> pending pool of [arrival seq, arrival t, ticket,
        #: window]
        self._pools: dict[tuple, list] = {}
        self._entry_seq = itertools.count()
        self._iter_seq = itertools.count()
        #: one feeder thread per lane (None: not started yet; a dead one
        #: is restarted at the next pooling)
        self._feeders: list[threading.Thread | None] = []
        self._stop = False
        self._held = False
        #: serve job id -> its live tickets (cancel_job's handle)
        self._job_tickets: dict[str, list] = {}
        #: preemption: the withdrawn jobs' ids (windows they pool later
        #: park directly) and their parked (engine key, pool entry) pairs
        self._withdrawn: set[str] = set()
        self._parked: dict[str, list] = {}
        #: the deadline-abort margin in seconds (None: off)
        self.abort_margin: float | None = None
        #: the window cache (serve/wincache.WindowCache) or None
        self.wincache = None
        #: the identity auditor (obs/audit.WindowAuditor) or None
        self.auditor = None
        #: tenant -> prorated iteration seconds ("" = untenanted)
        self._tenant_device: dict[str, float] = {}
        self.counters = {"iterations": 0, "solo_iterations": 0,
                         "shared_iterations": 0, "jobs": 0, "windows": 0,
                         "max_jobs_in_iteration": 0,
                         "max_windows_in_iteration": 0,
                         #: the most lanes inside an iteration at once
                         "max_concurrent_iterations": 0,
                         #: summed iteration wall minus device-stage
                         #: seconds; isolation passes are not included
                         "host_s": 0.0,
                         #: wall seconds spent auditing, and the lanes'
                         #: health transitions
                         "audit_s": 0.0, "lane_quarantines": 0,
                         "lane_rejoins": 0, "lane_reprobes": 0}

    def _accrue_tenant_device(self, tenant: str | None,
                              share_s: float) -> None:
        with self._cond:
            key = tenant or ""
            self._tenant_device[key] = (self._tenant_device.get(key, 0.0)
                                        + share_s)

    # ------------------------------------------------------------ entry
    def consensus(self, polisher, on_windows=None) -> None:
        """Run the consensus pass for `polisher.windows` merged into the
        iteration stream with concurrent jobs' windows. `on_windows`, when
        given, is called on this thread with each batch of this job's
        windows as its iteration completes. On return every window
        carries its consensus; the iteration accounting is left on
        `polisher.serve_batch`."""
        if polisher.faults is not None:
            self._isolated(polisher, on_windows)
            return
        ticket = _Ticket(polisher, _engine_key(polisher))
        if ticket.total == 0:
            polisher.serve_batch = ticket.batch_info()
            return
        pend = polisher.windows
        cache = self.wincache
        if cache is not None:
            # a hit carries bytes an earlier dispatch of the same content
            # under the same engine key and posture produced: it goes to
            # this job's thread and never into the pool
            posture = polisher.posture_key
            hits: list = []
            hit_keys: dict[int, tuple] = {}
            pend = []
            for w in polisher.windows:
                ck = cache.key(w, ticket.key, posture)
                ent = cache.lookup(ck)
                if ent is None:
                    pend.append(w)
                else:
                    w.consensus, w.polished = ent
                    hits.append(w)
                    hit_keys[id(w)] = ck
            polisher.serve_cache = {"hits": len(hits),
                                    "misses": len(pend)}
            if hits:
                # a poisoned entry is caught and repaired before this job
                # stitches it
                self._audit_cache_hits(polisher, hits, hit_keys)
                ticket.done += len(hits)
                ticket.remaining -= len(hits)
                ticket.deliver(hits)
                if ticket.remaining <= 0:
                    ticket.finish()
        now = time.monotonic()
        job_id = polisher.serve_job_id
        if pend:
            with self._cond:
                if self._stop:
                    raise RaconError("WindowBatcher",
                                     "batcher is closed (server draining)")
                self._ensure_feeder_locked(polisher)
                if job_id is not None:
                    self._job_tickets.setdefault(job_id, []).append(ticket)
                entries = [[next(self._entry_seq), now, ticket, w]
                           for w in pend]
                if job_id is not None and job_id in self._withdrawn:
                    # a preempted job's later windows (its next round)
                    # park at once, never reaching an extraction
                    self._parked.setdefault(job_id, []).extend(
                        (ticket.key, e) for e in entries)
                else:
                    self._pools.setdefault(ticket.key, []).extend(entries)
                self._cond.notify_all()
        # deliveries are consumed on this thread: the stitch callback
        # bills to this job, never to a feeder, and its exception fails
        # this job
        deadline = polisher.serve_deadline
        t_run0 = time.perf_counter()
        try:
            try:
                while True:
                    ws = ticket.take(timeout=0.1)
                    if ws is not None:
                        if on_windows is not None:
                            on_windows(ws)
                        self._doomed_check(ticket, deadline, t_run0)
                        continue
                    if ticket.event.is_set():
                        break
                while True:  # the feeder finished after its last delivery
                    ws = ticket.take()
                    if ws is None:
                        break
                    if on_windows is not None:
                        on_windows(ws)
            except BaseException as exc:
                # a dead ticket's pooled windows are dropped at a
                # feeder's next scan
                with self._cond:
                    if ticket.error is None:
                        ticket.error = exc
                raise
        finally:
            if job_id is not None:
                with self._cond:
                    ts = self._job_tickets.get(job_id)
                    if ts is not None and ticket in ts:
                        ts.remove(ticket)
                        if not ts:
                            del self._job_tickets[job_id]
                    # a ticket that dies while parked strands its entries
                    # (nothing resumes a dead job): drop them
                    parked = self._parked.get(job_id)
                    if parked:
                        parked[:] = [pe for pe in parked
                                     if pe[1][2] is not ticket]
                        if not parked:
                            del self._parked[job_id]
                            self._withdrawn.discard(job_id)
        if ticket.error is not None:
            raise ticket.error
        polisher.serve_batch = ticket.batch_info()

    def _doomed_check(self, ticket: _Ticket, deadline: float | None,
                      t0: float) -> None:
        """The iteration-boundary deadline abort, on the job's thread
        after each delivered batch: the remaining windows at this job's
        observed rate per window (the work queued ahead is ignored, so
        the estimate is optimistic) against the time left to the
        deadline. Raises DeadlineDoomed when the estimate overshoots by
        more than `abort_margin`."""
        margin = self.abort_margin
        if deadline is None or margin is None:
            return
        done, remaining = ticket.done, ticket.remaining
        if done <= 0 or remaining <= 0:
            return
        now = time.perf_counter()
        predicted_s = (now - t0) / done * remaining
        remaining_s = deadline - now
        if predicted_s > remaining_s + margin:
            raise DeadlineDoomed(predicted_s, remaining_s, phase="mid-run")

    def _isolated(self, polisher, on_windows) -> None:
        """A fault-plan job's consensus: its polisher's own pass, alone
        on the least busy healthy lane, under that lane's lock and on its
        runner (its launches are on this thread), then audited. The pass
        counts as a solo iteration whether or not it raises."""
        with self._cond:
            lanes = self._lanes_locked(polisher)
            # a quarantined lane takes no new work while another serves
            healthy = [ln for ln in lanes if not ln.quarantined]
            lane = min(healthy or lanes, key=lambda ln: (ln.busy, ln.index))
        it = next(self._iter_seq)
        polisher.device_runner = lane.runner
        with lane.lock:
            # the clock starts inside the lock: waiting behind a running
            # iteration is not this pass's busy time
            t0 = time.perf_counter()
            self._lane_busy(lane, True)
            try:
                with _on_lane(lane, polisher.device):
                    polisher._consensus_pass()
            finally:
                t1 = time.perf_counter()
                self._lane_busy(lane, False, t1 - t0)
                tr = trace.get_tracer()
                if tr is not None:
                    tid = polisher.serve_trace_id
                    tr.complete("serve.iteration", t0, t1,
                                {"iteration": it, "lane": lane.index,
                                 "jobs": 1,
                                 "windows": len(polisher.windows),
                                 "solo": True, "host_s": 0.0,
                                 "trace_ids": [tid] if tid else []})
                if self.hists is not None:
                    self.hists.observe("serve.iteration", t1 - t0)
                self._account(1, len(polisher.windows), solo=True)
        # a fault plan is where injected silent corruption lives: a
        # caught window is repaired before delivery
        before = _kernel_launches()
        self._audit([(w, polisher) for w in polisher.windows], lane, it)
        _book_audit_launches(polisher, before)
        ticket = _Ticket(polisher, None)
        ticket.iterations = 1
        ticket.iteration_ids = [it]
        # one rider: the whole wall is its share
        ticket.device_s = ticket.device_share_s = t1 - t0
        self._accrue_tenant_device(polisher.serve_tenant, t1 - t0)
        polisher.serve_batch = ticket.batch_info(solo=True)
        if on_windows is not None:
            on_windows(list(polisher.windows))

    # ------------------------------------------------------------ lanes
    def _lanes_locked(self, p0=None) -> list[_Lane]:
        """The lanes, built at first use (caller holds `_cond`) over
        `devices`, or `p0`'s polisher lanes when none were given: one lane
        keeps the batcher's own scheduler and stats; several get one
        runner over a contiguous slice of the list each, with their own
        scheduler (the batcher's posture) and stats."""
        if self._lanes is None:
            from ..parallel.mesh import BatchRunner, partition_devices
            from ..pipeline import PipelineStats
            from ..sched import BatchScheduler, OccupancyStats

            devices = (self._devices if self._devices is not None
                       else p0.device_runner.devices)
            groups = partition_devices(devices, self.worker_lanes)
            if len(groups) == 1:
                self._lanes = [_Lane(0, BatchRunner(groups[0]),
                                     self.scheduler, self.pipeline_stats)]
            else:
                lanes = []
                for i, group in enumerate(groups):
                    sched = BatchScheduler(adaptive=self.scheduler.adaptive,
                                           stats=OccupancyStats())
                    sched.stats.hists = self.scheduler.stats.hists
                    lanes.append(_Lane(
                        i, BatchRunner(group), sched,
                        PipelineStats(hists=self.pipeline_stats.hists)))
                self._lanes = lanes
        return self._lanes

    @property
    def _engines(self) -> dict:
        """Every lane's engines: (lane index, engine key) -> (pipeline,
        engine)."""
        with self._cond:
            lanes = list(self._lanes or ())
        return {(ln.index, k): v for ln in lanes
                for k, v in ln.engines.items()}

    def _lane_busy(self, lane: _Lane, busy: bool, dt: float = 0.0) -> None:
        """Flip a lane's busy flag; on release, charge the pass to the
        lane. Keeps the most lanes busy at once."""
        with self._cond:
            lane.busy = busy
            if busy:
                n = sum(1 for ln in (self._lanes or ()) if ln.busy)
                self.counters["max_concurrent_iterations"] = max(
                    self.counters["max_concurrent_iterations"], n)
            else:
                lane.iterations += 1
                lane.busy_s += dt

    # ----------------------------------------------------------- feeder
    def _ensure_feeder_locked(self, p0) -> None:
        """Start one feeder thread per lane, and restart any that died
        (caller holds `_cond` and checked `_stop`)."""
        lanes = self._lanes_locked(p0)
        if len(self._feeders) < len(lanes):
            self._feeders += [None] * (len(lanes) - len(self._feeders))
        for lane in lanes:
            t = self._feeders[lane.index]
            if t is not None and t.is_alive():
                continue
            t = threading.Thread(target=self._feeder_loop, args=(lane,),
                                 name=f"racon-torch-serve-feeder-"
                                      f"{lane.index}",
                                 daemon=True)
            self._feeders[lane.index] = t
            t.start()

    def close(self, timeout: float = 5.0) -> None:
        """Stop the feeders once the pools are empty (pooled jobs finish;
        later consensus() calls are refused) and close the cached
        pipelines. A lane still inside an iteration after `timeout`
        keeps its pipelines."""
        with self._cond:
            self._stop = True
            self._held = False
            self._cond.notify_all()
            feeders = list(self._feeders)
            lanes = list(self._lanes or ())
        for feeder in feeders:
            if feeder is not None and feeder.is_alive() \
                    and feeder is not threading.current_thread():
                feeder.join(timeout)
        for lane in lanes:
            if not lane.lock.acquire(timeout=timeout):
                continue
            try:
                pipelines = [p for p, _ in lane.engines.values()]
            finally:
                lane.lock.release()
            for pipeline in pipelines:
                pipeline.close()

    def _feeder_loop(self, lane: _Lane) -> None:
        while True:
            with self._cond:
                quarantined = lane.quarantined
                stop = self._stop
            if quarantined:
                # a suspect lane extracts nothing: it re-probes, and after
                # a failed probe backs off while other lanes serve
                if not self._reprobe_lane(lane):
                    if stop:
                        return
                    with self._cond:
                        if lane.quarantined:
                            self._cond.wait(
                                min(5.0, 0.25 * max(1, lane.reprobes)))
                    continue
            batch = None
            with self._cond:
                while True:
                    if lane.quarantined:
                        break
                    if self._held and not self._stop:
                        self._cond.wait(0.1)
                        continue
                    key = self._oldest_key_locked()
                    if key is None:
                        if self._stop:
                            return
                        self._cond.wait(0.5)
                        continue
                    pool = self._pools[key]
                    if (self.max_wait_s > 0.0 and not self._stop
                            and len(pool) < self.iteration_windows):
                        # a full iteration pending under another key
                        # dispatches at once
                        full = next(
                            (k for k, p in self._pools.items()
                             if len(p) >= self.iteration_windows), None)
                        if full is not None:
                            batch = self._extract_locked(full, lane)
                            break
                        left = (min(e[1] for e in pool) + self.max_wait_s
                                - time.monotonic())
                        if left > 0:
                            self._cond.wait(min(left, 0.5))
                            continue
                    batch = self._extract_locked(key, lane)
                    break
            if not batch:
                continue
            try:
                self._run_iteration(batch, lane)
            except BaseException as exc:  # noqa: BLE001 — the feeder
                # outlives an iteration: fail its riders, keep feeding
                self._fail_tickets({e[2] for e in batch}, exc)

    def _oldest_key_locked(self) -> tuple | None:
        """The key holding the globally oldest pending window (dead
        tickets' windows are dropped here)."""
        best, best_seq = None, None
        for key, pool in list(self._pools.items()):
            pool[:] = [e for e in pool if e[2].error is None]
            if not pool:
                del self._pools[key]
                continue
            seq = min(e[0] for e in pool)
            if best_seq is None or seq < best_seq:
                best, best_seq = key, seq
        return best

    def _extract_locked(self, key: tuple, lane: _Lane) -> list:
        """One iteration's entries: the shape-sorted slab of at most
        `iteration_windows` that holds the oldest entry, rounded to the
        extracting lane's device count when the pool is deep enough."""
        from ..sched import pack_iteration

        batch, rest = pack_iteration(
            self._pools[key], self.iteration_windows,
            shape_key=lambda e: _shape_key(e[3]),
            age_key=lambda e: e[0],
            lane_multiple=lane.runner.n_devices)
        if rest:
            self._pools[key] = rest
        else:
            del self._pools[key]
        return batch

    # -------------------------------------------------------- execution
    def _merged_stats(self):
        """One OccupancyStats over the batcher's own and every lane's
        (a scratch merge)."""
        from ..sched import OccupancyStats

        with self._cond:
            lanes = list(self._lanes or ())
        parts = [self.scheduler.stats] + [
            ln.scheduler.stats for ln in lanes
            if ln.scheduler is not self.scheduler]
        if len(parts) == 1:
            return self.scheduler.stats
        merged = OccupancyStats()
        for part in parts:
            merged.merge_from(part)
        return merged

    def _merged_pipeline(self) -> dict:
        """One PipelineStats snapshot summed over the batcher's own and
        every lane's."""
        with self._cond:
            lanes = list(self._lanes or ())
        snaps = [self.pipeline_stats.snapshot()] + [
            ln.pipeline_stats.snapshot() for ln in lanes
            if ln.pipeline_stats is not self.pipeline_stats]
        out = snaps[0]
        for snap in snaps[1:]:
            for k, v in snap.items():
                out[k] = out.get(k, 0) + v
        return out

    def _compile_totals(self, stats=None) -> tuple[int, float]:
        """First dispatches of a launch shape, and their seconds, in
        `stats` (one lane's, for an iteration's delta) or in the merged
        view."""
        snap = (stats if stats is not None
                else self._merged_stats()).snapshot()
        return (sum(e.get("compiles", 0) for e in snap.values()),
                sum(e.get("compile_s", 0.0) for e in snap.values()))

    def _lane_engine(self, lane: _Lane, key: tuple, p0):
        """The lane's persistent (pipeline, engine) pair of `key`, built
        from the first job's polisher on the lane's runner, scheduler and
        stats (caller holds the lane lock and is on the key's device)."""
        from ..ops.poa import BatchPOA
        from ..pipeline import DispatchPipeline

        ent = lane.engines.get(key)
        if ent is None:
            pipeline = DispatchPipeline(
                depth=p0.pipeline_depth, stats=lane.pipeline_stats,
                fallback_workers=max(1, min(4, p0.num_threads)))
            engine = BatchPOA(
                p0.match, p0.mismatch, p0.gap, p0.window_length,
                num_threads=p0.num_threads,
                device_batches=p0.cuda_poa_batches,
                banded=p0.cuda_banded_alignment, device=p0.device,
                score_dtype=p0.score_dtype, pack_bases=p0.pack_bases,
                pipeline=pipeline, engine=p0.cuda_engine,
                fused=p0.cuda_fused, fused_fallback=p0.fused_fallback,
                scheduler=lane.scheduler, runner=lane.runner,
                autotuner=p0.autotuner)
            ent = lane.engines[key] = (pipeline, engine)
        return ent

    def _run_iteration(self, batch: list, lane: _Lane) -> None:
        windows = [e[3] for e in batch]
        per_ticket: dict = {}
        for e in batch:
            per_ticket.setdefault(e[2], []).append(e[3])
        tickets = list(per_ticket)
        p0 = tickets[0].polisher
        it = next(self._iter_seq)
        progress = _IterProgress(
            [(t, len(ws)) for t, ws in per_ticket.items()], it)
        with lane.lock:
            self._lane_busy(lane, True)
            # a demotion flagged the lane's engines stale: the demoted
            # table takes effect from this iteration on
            self._fresh_engines_locked(lane)
            pre_c, pre_s = self._compile_totals(lane.scheduler.stats)
            pre_dev = lane.pipeline_stats.snapshot()["device_s"]
            pre_k1, pre_k3 = _kernel_launches()
            t0 = time.perf_counter()
            try:
                with _on_lane(lane, p0.device) as stream:
                    pipeline, engine = self._lane_engine(
                        lane, tickets[0].key, p0)
                    # only the logger varies per iteration; the key pins
                    # the rest of the engine
                    engine.logger = progress if progress.active else None
                    with pipeline:
                        engine.generate_consensus(windows, p0.trim)
                    if stream is not None:
                        stream.synchronize()
            finally:
                t1 = time.perf_counter()
                self._lane_busy(lane, False, t1 - t0)
            post_c, post_s = self._compile_totals(lane.scheduler.stats)
            post_dev = lane.pipeline_stats.snapshot()["device_s"]
            post_k1, post_k3 = _kernel_launches()
        host_s = max(0.0, (t1 - t0) - (post_dev - pre_dev))
        tr = trace.get_tracer()
        if tr is not None:
            tr.complete("serve.iteration", t0, t1,
                        {"iteration": it, "lane": lane.index,
                         "jobs": len(tickets), "windows": len(windows),
                         "host_s": round(host_s, 4),
                         "trace_ids": _trace_ids(tickets)})
        if self.hists is not None:
            self.hists.observe("serve.iteration", t1 - t0)
            self.hists.observe("serve.iteration_host", host_s)
        self._account(len(tickets), len(windows), solo=False,
                      host_s=host_s)
        # off the lane lock and before delivery: a caught corruption is
        # repaired before any job stitches it
        self._audit([(w, t.polisher) for t, ws in per_ticket.items()
                     for w in ws], lane, it)
        # stored after the audit, so the cache never holds a caught
        # corruption
        cache = self.wincache
        if cache is not None:
            for t, ws in per_ticket.items():
                posture = t.polisher.posture_key
                for w in ws:
                    cache.store(cache.key(w, t.key, posture), w.consensus,
                                w.polished)
        shared = len(tickets) > 1
        for ticket, ws in per_ticket.items():
            ticket.iterations += 1
            ticket.iteration_ids.append(it)
            if shared:
                ticket.shared_iterations += 1
            ticket.compiles += post_c - pre_c
            ticket.compile_s += post_s - pre_s
            ticket.device_s += t1 - t0
            # the job's window share of the wall: the shares of one
            # iteration sum to its wall
            share = (t1 - t0) * len(ws) / len(windows)
            ticket.device_share_s += share
            self._accrue_tenant_device(ticket.polisher.serve_tenant, share)
            ticket.host_s += host_s
            ticket.k1_launches += post_k1 - pre_k1
            ticket.k3_launches += post_k3 - pre_k3
            ticket.done += len(ws)
            ticket.remaining -= len(ws)
            ticket.polisher.emit_progress(ticket.done, ticket.total,
                                          phase="consensus", iteration=it)
            # the finish comes last, so the consumer's drain after the
            # event sees every delivery
            ticket.deliver(ws)
            if ticket.remaining <= 0:
                ticket.finish()

    def _fail_tickets(self, tickets, exc: BaseException) -> None:
        """An iteration raised: fail each rider (their pooled windows are
        dropped at the next scan) and keep feeding."""
        with self._cond:
            for t in tickets:
                t.error = exc
        for t in tickets:
            t.finish()

    def _account(self, jobs: int, windows: int, solo: bool,
                 host_s: float = 0.0) -> None:
        with self._cond:
            c = self.counters
            c["iterations"] += 1
            c["jobs"] += jobs
            c["windows"] += windows
            c["host_s"] += host_s
            if solo:
                c["solo_iterations"] += 1
            if jobs > 1:
                c["shared_iterations"] += 1
            c["max_jobs_in_iteration"] = max(c["max_jobs_in_iteration"],
                                             jobs)
            c["max_windows_in_iteration"] = max(
                c["max_windows_in_iteration"], windows)

    # ------------------------------------------------------------ audit
    def _audit(self, pairs, lane: _Lane, iteration: int) -> None:
        """The armed auditor over one iteration's finished windows. An
        audit failure is logged; the delivery goes on."""
        auditor = self.auditor
        if auditor is None or not auditor.armed or not pairs:
            return
        t0 = time.perf_counter()
        try:
            auditor.audit_windows(pairs, lane_index=lane.index,
                                  iteration=iteration, batcher=self)
        except Exception as exc:  # noqa: BLE001 — see docstring
            log_info(f"[racon_tpu_torch::audit] warning: audit pass "
                     f"failed ({type(exc).__name__}: {exc})")
        with self._cond:
            self.counters["audit_s"] += time.perf_counter() - t0

    def _audit_cache_hits(self, polisher, windows: list,
                          hit_keys: dict) -> None:
        """The armed auditor over one job's cache hits, on the job's
        thread: a mismatch blames the entry (evicted, its key
        quarantined), not a lane or an engine. Never fails the job."""
        auditor = self.auditor
        if auditor is None or not auditor.armed or not windows:
            return
        t0 = time.perf_counter()
        before = _kernel_launches()
        try:
            auditor.audit_windows([(w, polisher) for w in windows],
                                  lane_index=-1, iteration=-1,
                                  batcher=self, wincache=self.wincache,
                                  cache_keys=hit_keys)
        except Exception as exc:  # noqa: BLE001 — see _audit
            log_info(f"[racon_tpu_torch::audit] warning: cache-hit audit "
                     f"pass failed ({type(exc).__name__}: {exc})")
        _book_audit_launches(polisher, before)
        with self._cond:
            self.counters["audit_s"] += time.perf_counter() - t0

    def flush_lane_engines(self) -> None:
        """Flag every lane's engines stale (each lane rebuilds them at
        its next iteration or re-probe) and invalidate the window cache:
        the auditor calls this after a demotion, since the engines cached
        plans from the old table and the cache holds its bytes."""
        with self._cond:
            for lane in (self._lanes or ()):
                lane.flush_engines = True
        if self.wincache is not None:
            self.wincache.invalidate_all("winner-table demotion")

    def _fresh_engines_locked(self, lane: _Lane) -> None:
        """Drop the lane's engines if flagged stale (caller holds the
        lane lock)."""
        with self._cond:
            flush, lane.flush_engines = lane.flush_engines, False
        if flush:
            for pipeline, _ in lane.engines.values():
                pipeline.close()
            lane.engines.clear()

    def quarantine_lane(self, index: int) -> None:
        """Take a lane out of service (the auditor calls this on a
        mismatch): health 0, no more extractions, engines flagged stale,
        the window cache invalidated (the lane may have stored windows
        nobody sampled); its feeder re-probes it (`_reprobe_lane`)."""
        with self._cond:
            lanes = self._lanes or []
            if not 0 <= index < len(lanes):
                return
            lane = lanes[index]
            if lane.quarantined:
                return
            lane.quarantined = True
            lane.health = 0.0
            lane.flush_engines = True
            self.counters["lane_quarantines"] += 1
            if not self._stop:
                # an isolation pass may have built the lanes before any
                # feeder started: the re-probe needs this lane's
                self._ensure_feeder_locked(None)
            self._cond.notify_all()
        if self.wincache is not None:
            self.wincache.invalidate_all(f"lane {index} quarantined")
        if self.auditor is not None:
            self.auditor.lane_event(index, "quarantined")

    def _reprobe_lane(self, lane: _Lane) -> bool:
        """One re-probe of a quarantined lane: the auditor's latest
        mismatched window through the lane's rebuilt engine, its bytes
        compared with the oracle's. True when the lane rejoined (a clean
        probe, or the last serving lane rejoining degraded), False when it
        stays quarantined."""
        from ..ops.oracle import rebuild_window

        auditor = self.auditor
        probe = auditor.probe() if auditor is not None else None
        ok = None
        if probe is not None:
            p0, snap, expect_cons, expect_pol = probe
            try:
                w = rebuild_window(snap)
                with lane.lock:
                    self._fresh_engines_locked(lane)
                    with _on_lane(lane, p0.device) as stream:
                        pipeline, engine = self._lane_engine(
                            lane, _engine_key(p0), p0)
                        engine.logger = None
                        with pipeline:
                            engine.generate_consensus([w], p0.trim)
                        if stream is not None:
                            stream.synchronize()
                ok = w.consensus == expect_cons and w.polished == expect_pol
            except Exception:  # noqa: BLE001 — a raising probe fails
                ok = False
        with self._cond:
            lane.reprobes += 1
            self.counters["lane_reprobes"] += 1
            reprobes = lane.reprobes
            if ok:
                lane.quarantined = False
                lane.health = 1.0
                self.counters["lane_rejoins"] += 1
            else:
                # the last serving lane rejoins degraded rather than
                # leaving the pools to nobody
                alone = not any(ln is not lane and not ln.quarantined
                                for ln in (self._lanes or ()))
                if alone:
                    lane.quarantined = False
                    lane.health = 0.5
            self._cond.notify_all()
        if ok:
            if auditor is not None:
                auditor.lane_event(lane.index, "rejoined",
                                   reprobes=reprobes)
            return True
        if alone:
            if auditor is not None:
                auditor.lane_event(
                    lane.index, "degraded",
                    reason=("re-probe failed with no healthy sibling"
                            if ok is False else "no known-good probe"))
            return True
        if auditor is not None and ok is False:
            auditor.lane_event(lane.index, "reprobe-failed",
                               reprobes=reprobes)
        return False

    # ------------------------------------------------------------ control
    def withdraw_job(self, job_id: str) -> int:
        """Preempt a running job: move its pooled windows (not yet in an
        iteration) to the parked store, entries unchanged, and mark the
        job so windows it pools later park directly. Windows already in
        an iteration finish and deliver. Returns the entries parked."""
        with self._cond:
            self._withdrawn.add(job_id)
            parked = self._parked.setdefault(job_id, [])
            n = 0
            for key, pool in list(self._pools.items()):
                keep = []
                for e in pool:
                    if e[2].polisher.serve_job_id == job_id:
                        parked.append((key, e))
                        n += 1
                    else:
                        keep.append(e)
                if len(keep) != len(pool):
                    if keep:
                        self._pools[key] = keep
                    else:
                        del self._pools[key]
            if not parked:
                del self._parked[job_id]
            return n

    def resume_job(self, job_id: str) -> int:
        """Return a preempted job's parked windows to their pools and
        clear its mark. The entries keep their arrival sequence, so the
        job is served at the age it had. Returns the entries returned."""
        with self._cond:
            self._withdrawn.discard(job_id)
            parked = self._parked.pop(job_id, [])
            for key, e in parked:
                self._pools.setdefault(key, []).append(e)
            if parked:
                self._cond.notify_all()
            return len(parked)

    def cancel_job(self, job_id: str) -> bool:
        """Cancel a running job: its live tickets die with a typed
        JobCancelledError, which its thread raises; the feeders drop
        their pooled windows. False when the job has no live ticket
        (an isolation pass never pools)."""
        with self._cond:
            tickets = list(self._job_tickets.get(job_id) or ())
            if not tickets:
                return False
            exc = JobCancelledError("running")
            for t in tickets:
                if t.error is None:
                    t.error = exc
            self._parked.pop(job_id, None)
            self._withdrawn.discard(job_id)
            self._cond.notify_all()
        for t in tickets:
            t.finish()
        return True

    def tenant_device_seconds(self) -> dict:
        """Tenant -> its prorated iteration seconds ("" untenanted),
        empty until a named tenant has some."""
        with self._cond:
            if not any(t for t in self._tenant_device):
                return {}
            return {t: round(v, 4)
                    for t, v in sorted(self._tenant_device.items())}

    def hold(self) -> None:
        """Pause the feeders before their next extraction."""
        with self._cond:
            self._held = True

    def release(self) -> None:
        with self._cond:
            self._held = False
            self._cond.notify_all()

    def snapshot(self) -> dict:
        with self._cond:
            out = dict(self.counters)
            out["host_s"] = round(out["host_s"], 4)
            out["audit_s"] = round(out["audit_s"], 4)
            lanes = list(self._lanes or ())
            out["busy"] = any(ln.busy for ln in lanes)
            out["busy_s"] = round(sum(ln.busy_s for ln in lanes), 4)
            out["worker_lanes"] = (len(lanes) if self._lanes is not None
                                   else self.worker_lanes)
            out["lanes"] = [
                {"lane": ln.index, "n_devices": ln.runner.n_devices,
                 "iterations": ln.iterations, "busy": ln.busy,
                 "busy_s": round(ln.busy_s, 4),
                 "health": round(ln.health, 3),
                 "quarantined": ln.quarantined, "reprobes": ln.reprobes}
                for ln in lanes]
            out["pending_windows"] = sum(len(p) for p in
                                         self._pools.values())
            # shown only while a preemption holds windows
            if self._withdrawn or self._parked:
                out["withdrawn_jobs"] = len(self._withdrawn)
                out["parked_windows"] = sum(len(v) for v in
                                            self._parked.values())
        stats = self._merged_stats()
        compiles, compile_s = self._compile_totals(stats)
        out["compiles"] = compiles
        out["compile_s"] = round(compile_s, 3)
        out["occupancy"] = stats.snapshot()
        out["pipeline"] = self._merged_pipeline()
        if self.wincache is not None:
            out["wincache"] = self.wincache.snapshot()
        return out
