"""Bounded job queue with admission control and per-tenant fairness.

The admission surface is where a warm server defends itself: a queue
that grows without bound converts overload into unbounded latency for
EVERYONE (and eventually an OOM), so `JobQueue` is bounded and a submit
against a full queue is REJECTED immediately with a `retry_after` hint —
the client backs off instead of camping on a socket. The hint is derived
from observed service time (EMA) times the work ahead of the would-be
job, so it tracks the actual drain rate rather than a constant.

Ordering is WEIGHTED FAIR within priority: higher `priority` classes
pop first; within a class, jobs are grouped by the submit frame's
`tenant` id and served by weighted deficit round-robin — each active
tenant accrues `weight` credits per scheduler rotation and spends one
per popped job, so a tenant with weight 4 gets ~4x the pop rate of a
weight-1 tenant UNDER CONTENTION while an uncontended queue stays pure
FIFO (a single tenant's jobs pop in submission order, and an absent
tenant accrues nothing — credit never banks across idle periods). This
is what keeps one heavy client from monopolizing the continuous
batcher's feeder: the light tenant's next job is at most ~weight pops
away regardless of how deep the heavy tenant's backlog is. Weights come
from the server config (`ServeConfig(tenant_weights=)`, `serve
--tenant-weights`, e.g. "gold=4,free=1,default=1"); unknown tenants get the `default` weight
(1.0). Jobs without a tenant id share the "" tenant. TRUST BOUNDARY:
tenant ids are client-asserted and unauthenticated — fairness is
meaningful among COOPERATING clients (the localhost/unix-socket
deployment shape this server targets); an adversarial client minting a
fresh tenant per job gets one DRR slot per job, so binding tenant
identity to an authenticated transport is a deployment concern, not
this queue's.

Per-job deadlines are enforced at POP time: a job whose deadline passed
while queued is never handed to a worker — it is marked expired, its
waiter is woken with a typed error, and the `expired` counter bumps.
(Jobs already executing are not preempted; one process, shared device.)

Draining (`drain()`) flips admission off atomically: every later submit
raises `Draining`, while already-admitted jobs keep flowing to workers —
the SIGTERM half of graceful shutdown.

SLO accounting rides the same completion path: `task_done` records each
job's service seconds into BOTH the admission EMA and a rolling window
(last `ROLLING_JOBS` jobs), and classifies deadline-carrying jobs as
`deadline_hit` / `deadline_miss` (finished after the deadline it was
admitted under — distinct from `expired`, which never ran). The
retry-after hint and the stats/scrape SLO view therefore come from the
same numbers, by construction. With a `hists` HistogramSet attached the
queue also observes every popped job's queue wait (`job.queue_wait`).
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque


def nearest_rank(sorted_vals, q: float):
    """Nearest-rank percentile: value at rank ceil(q*n) (1-based) of an
    ascending list — `int(n*q)` overshoots by one whole rank whenever
    n*q is integral, reporting the max as p99 for n=100."""
    n = len(sorted_vals)
    return sorted_vals[max(0, min(n - 1, math.ceil(q * n) - 1))]


class AdmissionError(Exception):
    """Base: the queue refused the job at the door."""


class QueueFull(AdmissionError):
    def __init__(self, retry_after: float):
        super().__init__(
            f"job queue full; retry in {retry_after:.2f}s")
        self.retry_after = retry_after


class TenantQuotaExceeded(AdmissionError):
    """Hard per-tenant admission quota (ServeConfig(tenant_quota=)):
    the tenant already has `quota` jobs QUEUED. Weights alone only shape
    service ORDER — without this cap one tenant can still fill the whole
    queue depth and every other tenant eats full-queue rejects."""

    def __init__(self, tenant: str, quota: int, retry_after: float):
        super().__init__(
            f"tenant {tenant or '<anonymous>'!r} has {quota} job(s) "
            f"queued (per-tenant quota {quota}); retry in "
            f"{retry_after:.2f}s")
        self.tenant = tenant
        self.quota = quota
        self.retry_after = retry_after


class Draining(AdmissionError):
    def __init__(self):
        super().__init__("server is draining; not admitting jobs")


class DeadlineDoomed(AdmissionError):
    """Speculative deadline-abort (JobQueue(abort_margin=)): the
    service-time EMA predicts this job cannot finish inside its own
    deadline (plus the configured margin), so it is failed FAST at the
    door — a typed `deadline-doomed` error instead of queue time plus
    device time that the deadline would throw away anyway. Raised again
    mid-run (by the batcher's iteration-boundary estimate) when the
    remaining-work projection says an admitted job's deadline is lost."""

    def __init__(self, predicted_s: float, remaining_s: float,
                 phase: str = "admission"):
        super().__init__(
            f"deadline doomed at {phase}: predicted finish in "
            f"{predicted_s:.2f}s exceeds the {remaining_s:.2f}s left "
            "before the deadline")
        self.predicted_s = predicted_s
        self.remaining_s = remaining_s
        self.phase = phase


class JobCancelledError(Exception):
    """A client (or the router, on behalf of a doomed parent) cancelled
    this job via the `cancel` RPC. For a QUEUED job the queue consumes
    it directly; for a RUNNING job the batcher's withdrawal seam raises
    this through the job's consensus loop within one iteration."""

    def __init__(self, state: str = "running"):
        super().__init__(f"job cancelled while {state}")
        self.state = state


class DeadlineExpired(Exception):
    def __init__(self, waited: float):
        super().__init__(
            f"job deadline expired after {waited:.2f}s in queue")
        self.waited = waited


class DeliveryQueue:
    """Single-consumer handoff queue with a completion flag — the one
    shape both the job outbox (progress/result_part frames -> handler
    thread) and the batcher's window delivery (finished windows -> job
    thread) need. The wakeup discipline lives HERE, once:

      - `push` notifies under the cv;
      - `finish` sets `event` and notifies under the cv — a bare
        event.set() would strand a consumer mid-timed-wait;
      - `take` never starts a timed wait once `event` is set (the
        set happens-before the check, so a consumer that was busy
        when `finish`'s notify fired — the dropped-notify case —
        still returns immediately instead of burning its timeout:
        a silent per-job latency floor otherwise)."""

    __slots__ = ("_items", "_cv", "event")

    def __init__(self):
        self._items: deque = deque()
        self._cv = threading.Condition()
        self.event = threading.Event()

    def push(self, item) -> None:
        with self._cv:
            self._items.append(item)
            self._cv.notify()

    def finish(self) -> None:
        self.event.set()
        with self._cv:
            self._cv.notify()

    def take(self, timeout: float | None = None):
        """The oldest pending item, or None (immediately when complete
        or `timeout` is falsy, else after waiting up to `timeout`)."""
        with self._cv:
            if not self._items and timeout and not self.event.is_set():
                self._cv.wait(timeout)
            return self._items.popleft() if self._items else None


class Job:
    """One polish request in flight. The handler thread that admitted it
    blocks on `event`; the worker that executes it fills `response` (a
    protocol response dict) before setting the event. Jobs that asked
    for live progress and/or streamed results relay frames through the
    `_outbox` DeliveryQueue, drained by the handler thread while it
    waits."""

    __slots__ = ("id", "sequences", "overlaps", "target", "options",
                 "priority", "deadline", "fault_plan", "strict",
                 "want_trace", "enqueued_t", "started_t", "response",
                 "event", "stats_ref", "trace_id", "want_progress",
                 "want_stream", "tenant", "rounds", "cancelled",
                 "range_lo", "range_hi", "fragment", "frag_lo",
                 "frag_hi", "_outbox")

    def __init__(self, id_: str, sequences: str, overlaps: str,
                 target: str, options: dict, priority: int = 0,
                 deadline_s: float | None = None,
                 fault_plan: str | None = None,
                 strict: bool | None = None, want_trace: bool = False,
                 trace_id: str | None = None,
                 want_progress: bool = False,
                 want_stream: bool = False, tenant: str = "",
                 rounds: int | None = None,
                 range_lo: int | None = None,
                 range_hi: int | None = None,
                 fragment: bool = False,
                 frag_lo: int | None = None,
                 frag_hi: int | None = None):
        self.id = id_
        self.sequences = sequences
        self.overlaps = overlaps
        self.target = target
        self.options = options
        self.priority = int(priority)
        self.enqueued_t = time.perf_counter()
        self.deadline = (self.enqueued_t + float(deadline_s)
                         if deadline_s else None)
        self.fault_plan = fault_plan
        self.strict = strict
        self.want_trace = bool(want_trace)
        #: client-minted trace-context id: rides every progress frame,
        #: journal line and serve-side span for this job, so a client
        #: artifact and the server's telemetry correlate by construction
        self.trace_id = trace_id
        self.want_progress = bool(want_progress)
        #: stream per-contig `result_part` frames before the result
        self.want_stream = bool(want_stream)
        #: fair-scheduling identity ("" = the anonymous shared tenant)
        self.tenant = tenant or ""
        #: serve-native polishing rounds (None = unspecified = 1): the
        #: worker loops round k's stitched contigs back in as round
        #: k+1's draft without leaving the warm process (server.py
        #: `_run_job`, core/polisher.redraft). The response carries a
        #: `rounds` accounting block only when the request asked.
        self.rounds = rounds if rounds is None else max(1, int(rounds))
        #: sub-contig window-range shard slice (router fan-out,
        #: serve/protocol.py "Child-job fields"): the worker polishes
        #: only the target windows whose grid start falls in
        #: [range_lo, range_hi) and streams bare-named SEGMENTS; None =
        #: classic whole-target job. Mutually exclusive with `rounds`
        #: (enforced at submit validation).
        self.range_lo = range_lo
        self.range_hi = range_hi
        #: fragment traffic class (`mode: "fragment"` on the submit
        #: frame, protocol.py "Fragment jobs"): the worker runs
        #: PolisherType.kF and streams corrected reads in bounded
        #: GROUPS through the read-order FragmentStreamer instead of
        #: one part per target. Mutually exclusive with range_lo/hi
        #: and with rounds > 1 (enforced at submit validation).
        self.fragment = bool(fragment)
        #: fragment read-range shard slice (router fan-out, protocol.py
        #: "Fragment child jobs"): the worker corrects only the reads
        #: whose TARGET-FILE index falls in [frag_lo, frag_hi); None =
        #: the whole read set. Requires `fragment`.
        self.frag_lo = frag_lo
        self.frag_hi = frag_hi
        #: cancel-RPC flag for RUNNING jobs the batcher cannot reach
        #: (isolation/solo paths never pool): the worker checks it at
        #: round boundaries and fails the job typed `cancelled`
        self.cancelled = False
        self._outbox = DeliveryQueue()
        self.started_t: float | None = None
        self.response: dict | None = None
        #: completion flag; set it via finish() — a bare set() would
        #: leave a handler blocked in next_frame's timed wait
        self.event = self._outbox.event
        #: live PipelineStats of the polisher executing this job (set by
        #: the worker) — the flight-recorder dump snapshots it so a
        #: failed job's artifact carries the stage stats its spans pin to
        self.stats_ref = None

    @property
    def queue_wait_s(self) -> float:
        return (self.started_t or time.perf_counter()) - self.enqueued_t

    @property
    def relaying(self) -> bool:
        """Whether the handler thread must pump the outbox while
        waiting (progress frames, streamed parts, or both)."""
        return self.want_progress or self.want_stream

    # -------------------------------------------------- frame relay
    def notify_progress(self, ev: dict) -> None:
        """Queue one progress event for the handler thread streaming
        this job's connection (server.py). Worker/pipeline/feeder
        threads call it (via the polisher's progress hook); a no-op
        unless the client asked for progress, so the clean path stays
        free."""
        if self.want_progress:
            self._outbox.push(ev)

    def notify_part(self, frame: dict) -> None:
        """Queue one ready-to-send `result_part` frame; a no-op unless
        the client asked for streamed results."""
        if self.want_stream:
            self._outbox.push(frame)

    def next_frame(self, timeout: float | None = None) -> dict | None:
        """Pop the oldest pending outbox entry, waiting up to `timeout`
        for one; None when nothing arrived."""
        return self._outbox.take(timeout)

    def finish(self) -> None:
        """Mark the job complete and wake the handler immediately
        (see DeliveryQueue: event.set() alone leaves the handler
        burning out a timed wait before it sends the result frame)."""
        self._outbox.finish()


class _PriorityClass:
    """One priority level's per-tenant queues + DRR rotation state."""

    __slots__ = ("tenants", "rr", "deficit", "count")

    def __init__(self):
        self.tenants: dict[str, deque] = {}
        self.rr: deque = deque()
        self.deficit: dict[str, float] = {}
        self.count = 0


class JobQueue:
    """Thread-safe bounded weighted-fair queue (see module docstring)."""

    #: retry_after clamp (seconds)
    RETRY_MIN, RETRY_MAX = 0.05, 60.0
    #: rolling service-time window size (jobs) behind the SLO view
    ROLLING_JOBS = 64
    #: floor for configured weights (0/negative would stall the DRR)
    MIN_WEIGHT = 0.01
    #: distinct tenants tracked in the lifetime counters (tenant ids
    #: are client-controlled: without a cap, a client minting a fresh
    #: id per job would grow server memory and scrape cardinality
    #: forever); overflow folds into the "~other" bucket. Scheduling
    #: itself is unaffected — only the per-tenant accounting caps.
    MAX_TRACKED_TENANTS = 64

    def __init__(self, maxsize: int, workers: int = 1, hists=None,
                 tenant_weights: dict | None = None,
                 tenant_quota: int = 0, tenant_burst: int = 0,
                 abort_margin: float | None = None):
        self.maxsize = max(1, int(maxsize))
        self.workers = max(1, int(workers))
        self.tenant_weights = dict(tenant_weights or {})
        #: hard cap on QUEUED jobs per tenant (0 = off): admission-time
        #: protection weights cannot give — see TenantQuotaExceeded
        self.tenant_quota = max(0, int(tenant_quota))
        #: burst-token bucket capacity per tenant (0 = off): lets a
        #: tenant briefly exceed `tenant_quota` by spending banked
        #: tokens, refilled at its DRR weight in tokens/second — so a
        #: gold tenant re-earns burst headroom faster than a free one
        self.tenant_burst = max(0, int(tenant_burst))
        #: tenant -> [tokens, last_refill_monotonic]
        self._burst: dict[str, list] = {}
        self.burst_admits = 0
        #: speculative deadline-abort margin in seconds (None = off):
        #: a deadline-carrying submit whose EMA-predicted finish
        #: overshoots its deadline by more than this is rejected typed
        #: (`deadline-doomed`) instead of admitted to die later
        self.abort_margin = (None if abort_margin is None
                             else max(0.0, float(abort_margin)))
        #: live queued count per tenant (quota enforcement; jobs leave
        #: the count at pop time, expired included)
        self._queued_by_tenant: dict[str, int] = {}
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        #: priority -> _PriorityClass; scheduling pops the highest
        #: priority first, weighted-DRR across tenants within it
        self._classes: dict[int, _PriorityClass] = {}
        self._count = 0
        #: bumped on every push/pop: progress streamers poll queue
        #: position while their job is pending, and the version lets
        #: them skip the O(depth) position() simulation (and its lock
        #: acquisition) when nothing moved
        self._version = 0
        self._draining = False
        #: EMA of job service seconds, seeded pessimistically so the
        #: first rejections before any completion still back off
        self._ema_service_s = 1.0
        #: the same service seconds the EMA eats, kept verbatim for the
        #: rolling SLO percentiles — one stream, two views
        self._recent: deque = deque(maxlen=self.ROLLING_JOBS)
        #: optional obs.hist.HistogramSet (the server's lifetime set)
        self.hists = hists
        #: optional callable(event: str, job: Job, **fields) fired on
        #: queue-side lifecycle transitions (`admitted`, `started`,
        #: `expired`) — the server wires its event journal
        #: (obs/journal.py) and the progress relay here. `admitted` and
        #: `expired` fire UNDER the queue lock (admitted must
        #: happen-before the popping worker's started): the callback
        #: must not call back into the queue; `started` fires on the
        #: worker thread after pop releases the lock, keeping the
        #: per-job disk write off the hot lock. Exceptions are
        #: swallowed — accounting must never strand a job.
        self.on_event = None
        #: optional callable(job, hit_total, miss_total) fired OUTSIDE
        #: the lock after each deadline-carrying job is accounted — the
        #: server's SLO burn-rate tracker samples the cumulative
        #: counters here. Exceptions are swallowed:
        #: alerting must never strand a job.
        self.on_slo = None
        self.counters = {"submitted": 0, "admitted": 0, "rejected_full": 0,
                         "rejected_draining": 0, "rejected_quota": 0,
                         "expired": 0, "completed": 0, "failed": 0,
                         "deadline_hit": 0, "deadline_miss": 0}
        #: per-tenant lifetime counters (admitted/completed/failed) —
        #: the fairness story's receipt in stats/scrape
        self.tenant_counters: dict[str, dict] = {}

    def weight(self, tenant: str) -> float:
        w = self.tenant_weights.get(
            tenant, self.tenant_weights.get("default", 1.0))
        try:
            return max(float(w), self.MIN_WEIGHT)
        except (TypeError, ValueError):
            return 1.0

    # -------------------------------------------------------- admission
    def _retry_after_locked(self) -> float:
        """Backoff for a rejected submit (caller holds the lock):
        estimated time until a slot frees = work ahead / drain rate,
        from the service-time EMA."""
        est = (self._ema_service_s * max(1, self._count)
               / self.workers)
        return min(max(est, self.RETRY_MIN), self.RETRY_MAX)

    def _tenant_counter_locked(self, tenant: str) -> dict:
        if (tenant not in self.tenant_counters
                and len(self.tenant_counters)
                >= self.MAX_TRACKED_TENANTS):
            tenant = "~other"
        return self.tenant_counters.setdefault(
            tenant, {"admitted": 0, "completed": 0, "failed": 0,
                     "expired": 0})

    def _burst_take_locked(self, tenant: str) -> bool:
        """Spend one burst token for `tenant` if its bucket (capacity
        `tenant_burst`, refilled at the tenant's DRR weight per second,
        starting full) holds one; caller holds the lock."""
        now = time.monotonic()
        bucket = self._burst.get(tenant)
        if bucket is None:
            bucket = self._burst[tenant] = [float(self.tenant_burst),
                                            now]
        tokens = min(float(self.tenant_burst),
                     bucket[0] + (now - bucket[1]) * self.weight(tenant))
        bucket[1] = now
        if tokens >= 1.0:
            bucket[0] = tokens - 1.0
            self.burst_admits += 1
            return True
        bucket[0] = tokens
        return False

    def _doomed_check_locked(self, job: Job) -> None:
        """Speculative deadline-abort at admission: with `abort_margin`
        armed, reject a deadline-carrying job whose EMA-predicted
        finish (work at-or-above its priority class ahead of it, plus
        itself, over the worker drain rate) overshoots the deadline by
        more than the margin. Priority-aware on purpose: a gold job is
        never doomed by a lower-class flood it would pop past."""
        if self.abort_margin is None or job.deadline is None:
            return
        ahead = sum(c.count for p, c in self._classes.items()
                    if p >= job.priority)
        predicted_s = (self._ema_service_s * (ahead + 1) / self.workers)
        remaining_s = job.deadline - time.perf_counter()
        if predicted_s > remaining_s + self.abort_margin:
            raise DeadlineDoomed(predicted_s, remaining_s)

    def submit(self, job: Job) -> None:
        with self._lock:
            self.counters["submitted"] += 1
            if self._draining:
                self.counters["rejected_draining"] += 1
                raise Draining()
            if self._count >= self.maxsize:
                self.counters["rejected_full"] += 1
                raise QueueFull(self._retry_after_locked())
            queued = self._queued_by_tenant.get(job.tenant, 0)
            if (self.tenant_quota and queued >= self.tenant_quota
                    and not (self.tenant_burst
                             and self._burst_take_locked(job.tenant))):
                self.counters["rejected_quota"] += 1
                # backoff until one of THIS tenant's queued jobs drains,
                # from the same service-time EMA the full-queue hint uses
                est = (self._ema_service_s * max(1, queued)
                       / self.workers)
                raise TenantQuotaExceeded(
                    job.tenant, self.tenant_quota,
                    min(max(est, self.RETRY_MIN), self.RETRY_MAX))
            self._doomed_check_locked(job)
            self._queued_by_tenant[job.tenant] = queued + 1
            self.counters["admitted"] += 1
            self._tenant_counter_locked(job.tenant)["admitted"] += 1
            cls = self._classes.setdefault(job.priority,
                                           _PriorityClass())
            q = cls.tenants.get(job.tenant)
            if q is None:
                # a (re)joining tenant starts with zero credit: absence
                # banks nothing
                q = cls.tenants[job.tenant] = deque()
                cls.rr.append(job.tenant)
                cls.deficit[job.tenant] = 0.0
            q.append(job)
            cls.count += 1
            self._count += 1
            self._version += 1
            # fired UNDER the lock deliberately: a worker can pop this
            # job the instant the lock releases, and the journal's
            # `admitted` line must happen-before its `started` line.
            # The on_event contract keeps under-lock callbacks disk-
            # free (the server STAGES this event; see its sink)
            self._notify("admitted", job, depth=self._count)
            self._not_empty.notify()

    # ------------------------------------------------------------- pop
    @staticmethod
    def _retire_tenant(tenants: dict, rr: deque, deficit: dict,
                       tenant: str) -> None:
        try:
            rr.remove(tenant)
        except ValueError:
            pass
        tenants.pop(tenant, None)
        deficit.pop(tenant, None)

    def _drr_select(self, tenants: dict, rr: deque,
                    deficit: dict) -> str:
        """ONE weighted-DRR decision over a (tenants, rr, deficit)
        state triple: retire drained tenants, rotate accruing credit,
        return the tenant to serve (its deficit already debited). The
        SINGLE copy of the scheduling algorithm — the live pop path
        passes the class's state, position()'s simulation passes a
        copy, so the two can never diverge. Precondition: at least one
        tenant has a job. Terminates: every full rotation adds at
        least MIN_WEIGHT to some non-empty tenant's deficit."""
        while True:
            tenant = rr[0]
            q = tenants.get(tenant)
            if not q:
                self._retire_tenant(tenants, rr, deficit, tenant)
                continue
            if deficit.get(tenant, 0.0) >= 1.0:
                deficit[tenant] -= 1.0
                return tenant
            deficit[tenant] = (deficit.get(tenant, 0.0)
                               + self.weight(tenant))
            rr.rotate(-1)

    def _pop_next_locked(self) -> Job | None:
        """One scheduling decision (caller holds the lock); None when
        empty: highest non-empty priority class, weighted DRR across
        its tenants."""
        if self._count == 0:
            return None
        prio = max(p for p, c in self._classes.items() if c.count > 0)
        cls = self._classes[prio]
        tenant = self._drr_select(cls.tenants, cls.rr, cls.deficit)
        q = cls.tenants[tenant]
        job = q.popleft()
        cls.count -= 1
        self._count -= 1
        # quota ledger: expired jobs pop through here too, so a tenant
        # whose jobs all expired regains its quota slots
        left = self._queued_by_tenant.get(job.tenant, 0) - 1
        if left > 0:
            self._queued_by_tenant[job.tenant] = left
        else:
            self._queued_by_tenant.pop(job.tenant, None)
        if not q:
            self._retire_tenant(cls.tenants, cls.rr, cls.deficit,
                                tenant)
        if cls.count == 0:
            del self._classes[prio]
        return job

    def pop(self, timeout: float | None = None) -> Job | None:
        """Next runnable job, or None on timeout. Deadline-expired jobs
        are consumed here: their waiters get a typed error and workers
        never see them."""
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        popped: Job | None = None
        with self._not_empty:
            while popped is None:
                while self._count:
                    job = self._pop_next_locked()
                    if job is None:
                        break
                    self._version += 1
                    now = time.perf_counter()
                    if job.deadline is not None and now > job.deadline:
                        self.counters["expired"] += 1
                        # the tenant's ledger must balance: admitted ==
                        # completed + failed + expired + queued
                        self._tenant_counter_locked(job.tenant)[
                            "expired"] += 1
                        exc = DeadlineExpired(now - job.enqueued_t)
                        job.response = {
                            "type": "error", "code": "deadline-expired",
                            "message": str(exc), "job_id": job.id}
                        self._notify("expired", job,
                                     waited_s=round(exc.waited, 4))
                        job.finish()
                        continue
                    job.started_t = now
                    if self.hists is not None:
                        self.hists.observe("job.queue_wait",
                                           now - job.enqueued_t)
                    popped = job
                    break
                if popped is not None:
                    break
                if deadline is not None:
                    left = deadline - time.monotonic()
                    if left <= 0 or not self._not_empty.wait(left):
                        if not self._count:
                            return None
                else:
                    self._not_empty.wait()
        # fired OUTSIDE the lock: `started` triggers a journal write
        # (disk) on the per-job hot path, and the admitted->started
        # ordering is already guaranteed by `admitted` firing under the
        # submit lock that this pop had to wait out
        self._notify("started", popped,
                     queue_wait_s=round(
                         popped.started_t - popped.enqueued_t, 4))
        return popped

    def task_done(self, job: Job, ok: bool, service_s: float,
                  exemplar: dict | None = None) -> bool:
        """Account a finished job. Returns True when the job carried a
        deadline and finished PAST it (the SLO miss the server's flight
        recorder dumps on) — expired-in-queue jobs never reach here.
        `exemplar` (trace id / flight-dump path, built by the serve
        worker) rides the job-latency observation so the scrape's
        latency buckets name a representative job."""
        missed = (job.deadline is not None
                  and time.perf_counter() > job.deadline)
        with self._lock:
            self.counters["completed" if ok else "failed"] += 1
            self._tenant_counter_locked(job.tenant)[
                "completed" if ok else "failed"] += 1
            if job.deadline is not None:
                self.counters["deadline_miss" if missed
                              else "deadline_hit"] += 1
                hit = self.counters["deadline_hit"]
                miss = self.counters["deadline_miss"]
            else:
                hit = None
            # EMA over the last ~8 jobs: adapts to workload shifts
            # without a rejection spike swinging the hint wildly
            self._ema_service_s += (service_s - self._ema_service_s) / 8.0
            self._recent.append(service_s)
        if self.hists is not None:
            self.hists.observe("job.service", service_s)
            self.hists.observe("job.latency",
                               time.perf_counter() - job.enqueued_t,
                               exemplar=exemplar)
        if hit is not None and self.on_slo is not None:
            try:
                self.on_slo(job, hit, miss)
            except Exception:  # noqa: BLE001 — see on_slo contract
                pass
        return missed

    def _notify(self, event: str, job: Job, **fields) -> None:
        cb = self.on_event
        if cb is None:
            return
        try:
            cb(event, job, **fields)
        except Exception:  # noqa: BLE001 — see on_event contract
            pass

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def _simulated_order_locked(self) -> list[Job]:
        """Predicted pop order of every queued job — the SAME
        `_drr_select` the live pop path runs, over copied state (caller
        holds the lock; O(depth) with the queue's bounded depth)."""
        order: list[Job] = []
        sim = {}
        for prio, cls in self._classes.items():
            if cls.count:
                sim[prio] = (dict((t, deque(q))
                                  for t, q in cls.tenants.items() if q),
                             deque(cls.rr), dict(cls.deficit))
        while sim:
            prio = max(sim)
            tenants, rr, deficit = sim[prio]
            if not tenants:
                del sim[prio]
                continue
            tenant = self._drr_select(tenants, rr, deficit)
            q = tenants[tenant]
            order.append(q.popleft())
            if not q:
                self._retire_tenant(tenants, rr, deficit, tenant)
        return order

    def position(self, job: Job) -> int | None:
        """0-based count of queued jobs that would pop before `job`, or
        None once the job is no longer queued (started / expired) — the
        live queue-position number the progress stream reports while a
        job is pending."""
        with self._lock:
            for i, j in enumerate(self._simulated_order_locked()):
                if j is job:
                    return i
        return None

    # ---------------------------------------------------------- cancel
    def cancel(self, job_id: str | None = None,
               trace_id: str | None = None) -> Job | None:
        """Remove a QUEUED job by id (or client-minted trace id — the
        handle a router holds for its child shards), wake its waiter
        with a typed `cancelled` error, and free its queue + quota
        slots immediately. Returns the job, or None when nothing queued
        matches (already running, finished, or unknown — the caller
        distinguishes). Accounted like an expiry: the job left the
        queue without running, so the tenant ledger stays balanced."""
        with self._lock:
            job: Job | None = None
            for j in self._iter_queued_locked():
                if ((job_id is not None and j.id == job_id)
                        or (trace_id is not None
                            and j.trace_id == trace_id)):
                    job = j
                    break
            if job is None:
                return None
            cls = self._classes[job.priority]
            q = cls.tenants[job.tenant]
            q.remove(job)
            cls.count -= 1
            self._count -= 1
            self._version += 1
            left = self._queued_by_tenant.get(job.tenant, 0) - 1
            if left > 0:
                self._queued_by_tenant[job.tenant] = left
            else:
                self._queued_by_tenant.pop(job.tenant, None)
            if not q:
                self._retire_tenant(cls.tenants, cls.rr, cls.deficit,
                                    job.tenant)
            if cls.count == 0:
                del self._classes[job.priority]
            self.counters["expired"] += 1
            self._tenant_counter_locked(job.tenant)["expired"] += 1
            exc = JobCancelledError("queued")
            job.response = {"type": "error", "code": "cancelled",
                            "message": str(exc), "job_id": job.id}
            self._notify("cancelled", job, state="queued",
                         waited_s=round(
                             time.perf_counter() - job.enqueued_t, 4))
            job.finish()
            return job

    def highest_queued_priority(self) -> int | None:
        """Highest priority class with queued work, or None when empty
        — the resume gate for preempted jobs (server.py): a parked job
        resumes only when nothing strictly above it is still waiting."""
        with self._lock:
            prios = [p for p, c in self._classes.items() if c.count > 0]
            return max(prios) if prios else None

    # ----------------------------------------------------------- drain
    def drain(self) -> None:
        """Stop admitting; queued jobs keep flowing to workers."""
        with self._lock:
            self._draining = True
            self._not_empty.notify_all()

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def __len__(self) -> int:
        with self._lock:
            return self._count

    def _iter_queued_locked(self):
        for cls in self._classes.values():
            for q in cls.tenants.values():
                yield from q

    def snapshot(self) -> dict:
        with self._lock:
            recent = sorted(self._recent)
            queued = list(self._iter_queued_locked())
            oldest = min((j.enqueued_t for j in queued), default=None)
            tenants: dict[str, dict] = {}
            for t, c in self.tenant_counters.items():
                tenants[t] = dict(c, weight=self.weight(t), queued=0)
            for j in queued:
                tenants.setdefault(
                    j.tenant, {"admitted": 0, "completed": 0,
                               "failed": 0, "expired": 0,
                               "weight": self.weight(j.tenant),
                               "queued": 0})
                tenants[j.tenant]["queued"] += 1
            # live DRR credit (accrued deficit across priority classes)
            # — the fairness dial a live view renders per tenant
            credit: dict[str, float] = {}
            for cls in self._classes.values():
                for t, d in cls.deficit.items():
                    credit[t] = credit.get(t, 0.0) + d
            for t, tc in tenants.items():
                tc["credit"] = round(credit.get(t, 0.0), 3)
            out = dict(self.counters, depth=self._count,
                       maxsize=self.maxsize,
                       draining=self._draining,
                       oldest_wait_s=(
                           round(time.perf_counter() - oldest, 4)
                           if oldest is not None else 0.0),
                       ema_service_s=round(self._ema_service_s, 4),
                       tenants=tenants)
            # armed-only keys: an unconfigured server's stats payload
            # stays byte-identical to the pre-QoS shape
            if self.tenant_burst:
                out["tenant_burst"] = self.tenant_burst
                out["burst_admits"] = self.burst_admits
            if self.abort_margin is not None:
                out["abort_margin_s"] = self.abort_margin
        if recent:
            n = len(recent)
            out["recent"] = {
                "jobs": n,
                "p50_s": round(nearest_rank(recent, 0.50), 4),
                "p95_s": round(nearest_rank(recent, 0.95), 4),
                "p99_s": round(nearest_rank(recent, 0.99), 4),
                "mean_s": round(sum(recent) / n, 4)}
        return out
