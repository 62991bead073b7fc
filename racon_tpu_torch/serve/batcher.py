"""Continuous cross-job window batching: iteration-level dispatch.

A window's consensus depends only on the window (backbone and layers)
and the engine parameters, never on the windows that share its device
batch. `WindowBatcher` uses that across jobs: the windows of concurrent
polish requests pool per engine-parameter key, and one device FEEDER
thread drains the pools in bounded, shape-homogeneous ITERATIONS, one
engine pass each, so a job that arrives mid-flight joins the next
dispatch. Each job's windows come back carrying the consensus a solo
run would have given them (tests/test_torch_serve.py). The port of the
JAX package's racon_tpu/serve/batcher.py with one worker lane.

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

The device: PyTorch's current device and stream are per thread. The
feeder builds each key's engine and runs every iteration inside
`torch.cuda.device` of the key's device and inside the engine's
dispatch pipeline, and synchronizes the device before it delivers, as
the polisher's own consensus pass does. Each key's (DispatchPipeline,
BatchPOA) pair is built at the first iteration that needs it and kept
(the persistent dispatch loop); its autotuner is the first job's, whose
table path is part of the key. `host_s`, an iteration's wall minus its
pipeline's device seconds, is summed in the counters, rides the
`serve.iteration` span and fills the `serve.iteration_host` histogram.
Each iteration's K1 and K3 launches (read on the feeder thread, which
alone launches them outside isolation passes) are billed to every job
with windows in it.

Isolation: a job that carries its own fault plan never shares an
iteration. It runs its polisher's own `_consensus_pass()` (its own
pipeline and faults) alone under the feeder's execution lock, so its
injected errors fail that job only. A failure inside a shared iteration
fails the jobs with windows in it (their other pooled windows are
dropped); the feeder carries on.

Window cache (`wincache`, a serve/wincache.WindowCache, None = off):
`consensus` looks each window up before pooling, keyed by its content,
the engine key and the polisher's kernel posture; a hit gets the stored
consensus and goes straight to the job's thread, never to an iteration
(`polisher.serve_cache` counts the hits and misses). Each iteration's
windows are stored once it ends. Isolation jobs neither consult nor
store.

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

Not ported here: more than one worker lane (with lane quarantine and
re-probes, whose callers invalidate the window cache) and the
identity-audit hooks.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

from ..errors import RaconError
from ..obs import trace
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


def _on_device(dev):
    """`torch.cuda.device(dev)` for a card, nothing for the CPU."""
    if dev.type != "cuda":
        return contextlib.nullcontext()
    import torch

    return torch.cuda.device(dev)


def _kernel_launches() -> tuple[int, int]:
    """K1's and K3's launches on the calling thread so far."""
    from ..ops import poa_fused_kernels, poa_kernels

    return (poa_kernels.counter.on_thread(),
            poa_fused_kernels.counter.on_thread())


class WindowBatcher:
    """Continuous batching core with one worker lane (see the module
    docstring). `iteration_windows` bounds an iteration's batch;
    `max_wait_s` lets a sparse pool coalesce before a short iteration;
    `scheduler` (a sched.BatchScheduler; default a non-adaptive one) is
    the engines' scheduler and the lane's occupancy counters."""

    def __init__(self, iteration_windows: int = 256,
                 max_wait_s: float = 0.0, scheduler=None):
        from ..pipeline import PipelineStats
        from ..sched import BatchScheduler

        self.iteration_windows = max(1, int(iteration_windows))
        self.max_wait_s = max(0.0, float(max_wait_s))
        self.scheduler = (scheduler if scheduler is not None
                          else BatchScheduler())
        self.pipeline_stats = PipelineStats()
        #: optional obs.hist.HistogramSet (a server's lifetime set)
        self.hists = None
        self._cond = threading.Condition()
        #: the execution lock: one iteration or isolation pass at a time
        self._exec = threading.Lock()
        #: engine key -> (DispatchPipeline, BatchPOA); touched only under
        #: the execution lock
        self._engines: dict = {}
        #: engine key -> pending pool of [arrival seq, arrival t, ticket,
        #: window]
        self._pools: dict[tuple, list] = {}
        self._entry_seq = itertools.count()
        self._iter_seq = itertools.count()
        self._feeder: threading.Thread | None = None
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
        #: tenant -> prorated iteration seconds ("" = untenanted)
        self._tenant_device: dict[str, float] = {}
        self._busy = False
        self._busy_s = 0.0
        self.counters = {"iterations": 0, "solo_iterations": 0,
                         "shared_iterations": 0, "jobs": 0, "windows": 0,
                         "max_jobs_in_iteration": 0,
                         "max_windows_in_iteration": 0,
                         #: summed iteration wall minus device-stage
                         #: seconds; isolation passes are not included
                         "host_s": 0.0}

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
            pend = []
            for w in polisher.windows:
                ent = cache.lookup(cache.key(w, ticket.key, posture))
                if ent is None:
                    pend.append(w)
                else:
                    w.consensus, w.polished = ent
                    hits.append(w)
            polisher.serve_cache = {"hits": len(hits),
                                    "misses": len(pend)}
            if hits:
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
                self._ensure_feeder_locked()
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
        # bills to this job, never to the feeder, and its exception fails
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
                # a dead ticket's pooled windows are dropped at the
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
        under the execution lock (its launches are on this thread). The
        pass counts as a solo iteration whether or not it raises."""
        it = next(self._iter_seq)
        with self._exec:
            # the clock starts inside the lock: waiting behind a running
            # iteration is not this pass's busy time
            t0 = time.perf_counter()
            self._set_busy(True)
            try:
                polisher._consensus_pass()
            finally:
                t1 = time.perf_counter()
                self._set_busy(False, t1 - t0)
                tr = trace.get_tracer()
                if tr is not None:
                    tr.complete("serve.iteration", t0, t1,
                                {"iteration": it, "jobs": 1,
                                 "windows": len(polisher.windows),
                                 "solo": True, "host_s": 0.0})
                if self.hists is not None:
                    self.hists.observe("serve.iteration", t1 - t0)
                self._account(1, len(polisher.windows), solo=True)
        ticket = _Ticket(polisher, None)
        ticket.iterations = 1
        ticket.iteration_ids = [it]
        # one rider: the whole wall is its share
        ticket.device_s = ticket.device_share_s = t1 - t0
        self._accrue_tenant_device(polisher.serve_tenant, t1 - t0)
        polisher.serve_batch = ticket.batch_info(solo=True)
        if on_windows is not None:
            on_windows(list(polisher.windows))

    # ----------------------------------------------------------- feeder
    def _set_busy(self, busy: bool, dt: float = 0.0) -> None:
        with self._cond:
            self._busy = busy
            self._busy_s += dt

    def _ensure_feeder_locked(self) -> None:
        """Start the feeder thread, or restart it if it died (caller
        holds `_cond` and checked `_stop`)."""
        if self._feeder is not None and self._feeder.is_alive():
            return
        self._feeder = threading.Thread(target=self._feeder_loop,
                                        name="racon-torch-serve-feeder",
                                        daemon=True)
        self._feeder.start()

    def close(self, timeout: float = 5.0) -> None:
        """Stop the feeder once the pools are empty (pooled jobs finish;
        later consensus() calls are refused) and close the cached
        pipelines. A feeder still inside an iteration after `timeout`
        keeps its pipelines."""
        with self._cond:
            self._stop = True
            self._held = False
            self._cond.notify_all()
        feeder = self._feeder
        if feeder is not None and feeder.is_alive() \
                and feeder is not threading.current_thread():
            feeder.join(timeout)
        if not self._exec.acquire(timeout=timeout):
            return
        try:
            pipelines = [p for p, _ in self._engines.values()]
        finally:
            self._exec.release()
        for pipeline in pipelines:
            pipeline.close()

    def _feeder_loop(self) -> None:
        while True:
            batch = None
            with self._cond:
                while True:
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
                            batch = self._extract_locked(full)
                            break
                        left = (min(e[1] for e in pool) + self.max_wait_s
                                - time.monotonic())
                        if left > 0:
                            self._cond.wait(min(left, 0.5))
                            continue
                    batch = self._extract_locked(key)
                    break
            if not batch:
                continue
            try:
                self._run_iteration(batch)
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

    def _extract_locked(self, key: tuple) -> list:
        """One iteration's entries: the shape-sorted slab of at most
        `iteration_windows` that holds the oldest entry, rounded to the
        key's lane count when the pool is deep enough."""
        from ..sched import pack_iteration

        pool = self._pools[key]
        batch, rest = pack_iteration(
            pool, self.iteration_windows,
            shape_key=lambda e: _shape_key(e[3]),
            age_key=lambda e: e[0],
            lane_multiple=pool[0][2].polisher.device_runner.n_devices)
        if rest:
            self._pools[key] = rest
        else:
            del self._pools[key]
        return batch

    # -------------------------------------------------------- execution
    def _compile_totals(self) -> tuple[int, float]:
        """First dispatches of a launch shape (and their seconds) in the
        lane's occupancy counters."""
        snap = self.scheduler.stats.snapshot()
        return (sum(e.get("compiles", 0) for e in snap.values()),
                sum(e.get("compile_s", 0.0) for e in snap.values()))

    def _engine(self, key: tuple, p0):
        """The persistent (pipeline, engine) pair of `key`, built from the
        first job's polisher (caller holds the execution lock and is on
        the key's device)."""
        from ..ops.poa import BatchPOA
        from ..parallel.mesh import BatchRunner
        from ..pipeline import DispatchPipeline

        ent = self._engines.get(key)
        if ent is None:
            pipeline = DispatchPipeline(
                depth=p0.pipeline_depth, stats=self.pipeline_stats,
                fallback_workers=max(1, min(4, p0.num_threads)))
            engine = BatchPOA(
                p0.match, p0.mismatch, p0.gap, p0.window_length,
                num_threads=p0.num_threads,
                device_batches=p0.cuda_poa_batches,
                banded=p0.cuda_banded_alignment, device=p0.device,
                score_dtype=p0.score_dtype, pack_bases=p0.pack_bases,
                pipeline=pipeline, engine=p0.cuda_engine,
                fused=p0.cuda_fused, fused_fallback=p0.fused_fallback,
                scheduler=self.scheduler,
                runner=BatchRunner(p0.device_runner.devices),
                autotuner=p0.autotuner)
            ent = self._engines[key] = (pipeline, engine)
        return ent

    def _run_iteration(self, batch: list) -> None:
        windows = [e[3] for e in batch]
        per_ticket: dict = {}
        for e in batch:
            per_ticket.setdefault(e[2], []).append(e[3])
        tickets = list(per_ticket)
        p0 = tickets[0].polisher
        it = next(self._iter_seq)
        progress = _IterProgress(
            [(t, len(ws)) for t, ws in per_ticket.items()], it)
        with self._exec:
            self._set_busy(True)
            pre_c, pre_s = self._compile_totals()
            pre_dev = self.pipeline_stats.snapshot()["device_s"]
            pre_k1, pre_k3 = _kernel_launches()
            t0 = time.perf_counter()
            try:
                with _on_device(p0.device):
                    pipeline, engine = self._engine(tickets[0].key, p0)
                    # only the logger varies per iteration; the key pins
                    # the rest of the engine
                    engine.logger = progress if progress.active else None
                    with pipeline:
                        engine.generate_consensus(windows, p0.trim)
                    if p0.device.type == "cuda":
                        import torch

                        torch.cuda.synchronize(p0.device)
            finally:
                t1 = time.perf_counter()
                self._set_busy(False, t1 - t0)
            post_c, post_s = self._compile_totals()
            post_dev = self.pipeline_stats.snapshot()["device_s"]
            post_k1, post_k3 = _kernel_launches()
        host_s = max(0.0, (t1 - t0) - (post_dev - pre_dev))
        tr = trace.get_tracer()
        if tr is not None:
            tr.complete("serve.iteration", t0, t1,
                        {"iteration": it, "jobs": len(tickets),
                         "windows": len(windows),
                         "host_s": round(host_s, 4)})
        if self.hists is not None:
            self.hists.observe("serve.iteration", t1 - t0)
            self.hists.observe("serve.iteration_host", host_s)
        self._account(len(tickets), len(windows), solo=False,
                      host_s=host_s)
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
        JobCancelledError, which its thread raises; the feeder drops
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
        """Pause the feeder before its next extraction."""
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
            out["busy"] = self._busy
            out["busy_s"] = round(self._busy_s, 4)
            out["pending_windows"] = sum(len(p) for p in
                                         self._pools.values())
            # shown only while a preemption holds windows
            if self._withdrawn or self._parked:
                out["withdrawn_jobs"] = len(self._withdrawn)
                out["parked_windows"] = sum(len(v) for v in
                                            self._parked.values())

        compiles, compile_s = self._compile_totals()
        out["compiles"] = compiles
        out["compile_s"] = round(compile_s, 3)
        out["occupancy"] = self.scheduler.stats.snapshot()
        out["pipeline"] = self.pipeline_stats.snapshot()
        if self.wincache is not None:
            out["wincache"] = self.wincache.snapshot()
        return out
