"""Double-buffered async dispatch pipeline.

The reference keeps the GPU busy by running several batch objects per
device off a shared work index, so the host-side fill and fetch of one
batch overlaps the device compute of another (cudapolisher.cpp:165-199,
228-345). `DispatchPipeline` is the port of the JAX package's
counterpart (racon_tpu/pipeline/__init__.py):

  - a PACK worker thread builds chunk k+1's operands (and starts their
    host-to-device copies) while
  - the caller's thread DISPATCHES chunk k (a CUDA launch returns as
    soon as it is enqueued) while
  - an UNPACK worker thread waits for chunk k-1's results and finishes
    them on the host while
  - a small FALLBACK thread pool runs host-only work (pairs the device
    rejects) as soon as it is known instead of after the device pass.

`depth` bounds how many chunks sit packed-but-undispatched and
dispatched-but-unwaited (double buffering at the default depth 2);
`depth=0` is the synchronous single-threaded path, byte-identical, in
which `submit_fallback` also runs inline.

The pipeline itself is device-agnostic: the callers give each chunk in
flight its own CUDA stream (ops/align.py), because the current stream
is per thread and one stream would serialise every stage.

Stage wall-clock goes into a `PipelineStats` (shareable across phases):
pack / device / unpack / fallback seconds plus chunk, launch and error
counts, with the same keys as the JAX package's. "device seconds" is
time charged to the compute stage: the dispatch call plus the unpack
worker's wait for results. With real overlap, pack + device + unpack
exceed the phase's wall; in a dead (synchronous) pipeline they add up
to it. The caller's thread's own waits on the workers are spans
(obs/trace.py): pipeline.wait_pack (for a packed chunk),
pipeline.wait_unpack (for room in the unpack worker's queue) and
pipeline.join (for both workers to finish the run).

Errors: without `on_error`, the first stage exception aborts the run and
re-raises in the caller. With `on_error(item, exc)` the failed chunk is
skipped and the run continues; `on_error` raising aborts the run with
that exception. No caller in the port passes a handler: a failed device
chunk is never re-run on the host.

Fault injection (resilience/faults.py): a pipeline given a `FaultPlan`
fires it as each of the pack, device (dispatch) and unpack stages starts
its N-th item of a run, and as the N-th fallback job starts; a fired
fault is counted as `faults`. Without a plan the stage callbacks run as
they are. The JAX pipeline's watchdog (its retry and deadline policy) is
not ported; its counters (retries, timeouts, ...) stay in
`PipelineStats` at zero so the snapshot keys match.

Simulated device latency (`device_latency_s`, `device_latency_x`, both
0 by default): a fixed sleep after each chunk's result wait, and a sleep
of `x` times each chunk's dispatch time after the dispatch. Both are
slept off the CPU and charged to `device_s`; the output does not change.
The serve benchmark's fleet modes arm them in their replicas to measure
a regime where the device round trip, not the host, sets the pace.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

from ..errors import RaconError
from ..obs import trace

_STOP = object()


def _latency(name: str, value) -> float:
    """A simulated-latency knob as a float >= 0, or RaconError."""
    try:
        lat = float(value)
    except (TypeError, ValueError):
        raise RaconError("pipeline.DispatchPipeline",
                         f"invalid {name} {value!r} (expected a "
                         "float)!") from None
    if not lat >= 0:
        raise RaconError("pipeline.DispatchPipeline",
                         f"{name} must be >= 0!")
    return lat

#: the degradation counters of the JAX package's resilience layer (its
#: REPORT_KEYS): kept in the snapshot, reported apart from `pipeline`
REPORT_KEYS = ("faults", "retries", "timeouts", "backoff_s",
               "breaker_trips", "quarantined", "cancelled")

#: PipelineStats keys whose bumps are events, mirrored as trace instants
_INSTANT_KEYS = frozenset(("faults", "retries", "timeouts",
                           "breaker_trips", "quarantined", "cancelled"))

#: stage-seconds keys mirrored into latency histograms: each bump is one
#: chunk's stage duration. device_s is bumped twice a chunk (dispatch and
#: wait), so the run loops observe `pipeline.device` themselves, once a
#: chunk, as the sum
_HIST_KEYS = {"pack_s": "pipeline.pack",
              "unpack_s": "pipeline.unpack",
              "fallback_s": "pipeline.fallback"}


class PipelineStats:
    """Thread-safe per-stage counters, shareable across pipeline phases."""

    _FLOAT_KEYS = ("pack_s", "device_s", "unpack_s", "fallback_s",
                   "backoff_s")
    _INT_KEYS = ("launches", "chunks", "errors",
                 "faults", "retries", "timeouts", "breaker_trips",
                 "quarantined", "cancelled")
    KEYS = _FLOAT_KEYS + _INT_KEYS

    def __init__(self, hists=None):
        self._lock = threading.Lock()
        self._v = {k: 0.0 for k in self._FLOAT_KEYS}
        self._v.update({k: 0 for k in self._INT_KEYS})
        #: optional obs.hist.HistogramSet for per-chunk stage durations
        self.hists = hists

    def bump(self, key: str, amount=1) -> None:
        with self._lock:
            self._v[key] += amount
        if self.hists is not None:
            name = _HIST_KEYS.get(key)
            if name is not None:
                self.hists.observe(name, amount)
        if key in _INSTANT_KEYS:
            tr = trace.get_tracer()
            if tr is not None:
                tr.instant(f"resilience.{key}", {"n": amount})

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._v)


class DispatchPipeline:
    """Runs the stages of one device-batched loop (see module docstring).

    run(items, pack, dispatch, wait, unpack):
      pack(item) -> operands            host work, pack worker thread
      dispatch(item, operands) -> h     caller's thread (async launch)
      wait(h) -> result                 blocks on the device, unpack thread
      unpack(item, result) -> None      host work, unpack worker thread

    Items flow through the stages in order; unpack order equals dispatch
    order (FIFO), so result assembly is deterministic. Every launch stays
    on the caller's thread, so the launch counters are bumped there.
    """

    def __init__(self, depth: int = 2, fallback_workers: int = 2,
                 stats: PipelineStats | None = None, faults=None,
                 device_latency_s: float = 0.0,
                 device_latency_x: float = 0.0):
        self.depth = max(0, int(depth))
        self.fallback_workers = max(1, int(fallback_workers))
        self.stats = stats if stats is not None else PipelineStats()
        #: a resilience.FaultPlan fired at the stages, or None
        self.faults = faults
        #: the simulated device latency (module docstring)
        self.device_latency_s = _latency("device_latency_s",
                                         device_latency_s)
        self.device_latency_x = _latency("device_latency_x",
                                         device_latency_x)
        self._fb_counter = itertools.count()
        self._executor: ThreadPoolExecutor | None = None
        self._futures: list[Future] = []

    def run(self, items, pack, dispatch, wait, unpack, on_error=None,
            label: str | None = None, describe=None) -> None:
        """`label` names this loop in the trace (aligner / host_poa);
        `describe(item) -> dict` supplies per-chunk span args. Both cost
        nothing when tracing is off."""
        items = list(items)
        # the simulated latency wraps the stages before the fault plan,
        # so a stall is charged to the device stage as a real round trip
        if self.device_latency_x > 0.0:
            inner_dispatch, x = dispatch, self.device_latency_x

            def dispatch(item, ops, _d=inner_dispatch, _x=x):
                t0 = time.perf_counter()
                handle = _d(item, ops)
                time.sleep((time.perf_counter() - t0) * _x)
                return handle
        if self.device_latency_s > 0.0:
            inner_wait, lat = wait, self.device_latency_s

            def wait(handle, _w=inner_wait, _lat=lat):
                res = _w(handle)
                time.sleep(_lat)
                return res
        if self.faults is not None:
            pack, dispatch, unpack = self._armed(pack, dispatch, unpack)
        tr = trace.get_tracer()
        args_of = None
        if tr is not None:
            def args_of(idx, item):
                a = {"chunk": idx}
                if label:
                    a["loop"] = label
                if describe is not None:
                    a.update(describe(item))
                return a
        if self.depth == 0:
            self._run_sync(items, pack, dispatch, wait, unpack, on_error,
                           tr, args_of)
            return
        self._run_async(items, pack, dispatch, wait, unpack, on_error,
                        tr, args_of)

    def _armed(self, pack, dispatch, unpack):
        """The stage callbacks with the fault plan fired as each starts
        its N-th item of this run (each stage runs on one thread, so a
        counter per stage is the submission order)."""
        fire, stats = self.faults.fire, self.stats
        counters = {s: itertools.count() for s in ("pack", "device",
                                                   "unpack")}

        def pack_f(item):
            fire("pack", next(counters["pack"]), stats)
            return pack(item)

        def dispatch_f(item, ops):
            fire("device", next(counters["device"]), stats)
            return dispatch(item, ops)

        def unpack_f(item, res):
            fire("unpack", next(counters["unpack"]), stats)
            return unpack(item, res)

        return pack_f, dispatch_f, unpack_f

    def _run_sync(self, items, pack, dispatch, wait, unpack, on_error,
                  tr=None, args_of=None):
        # spans reuse the perf_counter endpoints the stats bumps charge,
        # so per-stage span sums equal the stage counters
        stats = self.stats
        for idx, item in enumerate(items):
            try:
                t0 = time.perf_counter()
                ops = pack(item)
                t1 = time.perf_counter()
                stats.bump("pack_s", t1 - t0)
                if tr is not None:
                    tr.complete("pipeline.pack", t0, t1, args_of(idx, item))
                t0 = time.perf_counter()
                handle = dispatch(item, ops)
                t1 = time.perf_counter()
                disp_dt = t1 - t0
                stats.bump("device_s", disp_dt)
                stats.bump("chunks")
                if tr is not None:
                    tr.complete("pipeline.device", t0, t1,
                                dict(args_of(idx, item), seg="dispatch"))
                t0 = time.perf_counter()
                res = wait(handle)
                t1 = time.perf_counter()
                stats.bump("device_s", t1 - t0)
                if stats.hists is not None:
                    stats.hists.observe("pipeline.device",
                                        disp_dt + (t1 - t0))
                if tr is not None:
                    tr.complete("pipeline.device", t0, t1,
                                dict(args_of(idx, item), seg="wait"))
                t0 = time.perf_counter()
                unpack(item, res)
                t1 = time.perf_counter()
                stats.bump("unpack_s", t1 - t0)
                if tr is not None:
                    tr.complete("pipeline.unpack", t0, t1,
                                args_of(idx, item))
            except Exception as exc:
                stats.bump("errors")
                if on_error is None:
                    raise
                on_error(item, exc)

    def _run_async(self, items, pack, dispatch, wait, unpack, on_error,
                   tr=None, args_of=None):
        stats = self.stats
        fatal: list[BaseException] = []
        abort = threading.Event()

        def guard(item, exc):
            stats.bump("errors")
            if on_error is None:
                fatal.append(exc)
                abort.set()
                return
            try:
                on_error(item, exc)
            except BaseException as handler_exc:
                fatal.append(handler_exc)
                abort.set()

        packed_q: queue.Queue = queue.Queue(maxsize=self.depth)
        waiting_q: queue.Queue = queue.Queue(maxsize=self.depth)

        def packer():
            try:
                for idx, item in enumerate(items):
                    if abort.is_set():
                        break
                    try:
                        t0 = time.perf_counter()
                        ops = pack(item)
                        t1 = time.perf_counter()
                        stats.bump("pack_s", t1 - t0)
                        if tr is not None:
                            tr.complete("pipeline.pack", t0, t1,
                                        args_of(idx, item))
                    except Exception as exc:
                        guard(item, exc)
                        continue
                    packed_q.put((idx, item, ops))
            finally:
                packed_q.put(_STOP)

        def unpacker():
            while True:
                entry = waiting_q.get()
                if entry is _STOP:
                    return
                if abort.is_set():
                    continue
                idx, item, handle, disp_dt = entry
                try:
                    t0 = time.perf_counter()
                    res = wait(handle)
                    t1 = time.perf_counter()
                    stats.bump("device_s", t1 - t0)
                    if stats.hists is not None:
                        stats.hists.observe("pipeline.device",
                                            disp_dt + (t1 - t0))
                    if tr is not None:
                        tr.complete("pipeline.device", t0, t1,
                                    dict(args_of(idx, item), seg="wait"))
                    t0 = time.perf_counter()
                    unpack(item, res)
                    t1 = time.perf_counter()
                    stats.bump("unpack_s", t1 - t0)
                    if tr is not None:
                        tr.complete("pipeline.unpack", t0, t1,
                                    args_of(idx, item))
                except Exception as exc:
                    guard(item, exc)

        def drain(q):
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    return

        t_pack = threading.Thread(target=packer, name="racon-torch-pack",
                                  daemon=True)
        t_unpack = threading.Thread(target=unpacker,
                                    name="racon-torch-unpack", daemon=True)
        t_pack.start()
        t_unpack.start()
        try:
            # the dispatch loop always drains packed_q to its sentinel and
            # waiting_q always gets one, so neither worker can deadlock on
            # a bounded-queue put even when abort fires mid-stream
            while True:
                with trace.span("pipeline.wait_pack"):
                    entry = packed_q.get()
                if entry is _STOP:
                    break
                if abort.is_set():
                    continue
                idx, item, ops = entry
                try:
                    t0 = time.perf_counter()
                    handle = dispatch(item, ops)
                    t1 = time.perf_counter()
                    stats.bump("device_s", t1 - t0)
                    stats.bump("chunks")
                    if tr is not None:
                        tr.complete("pipeline.device", t0, t1,
                                    dict(args_of(idx, item),
                                         seg="dispatch"))
                except Exception as exc:
                    guard(item, exc)
                    continue
                with trace.span("pipeline.wait_unpack"):
                    waiting_q.put((idx, item, handle, t1 - t0))
        except BaseException:
            # exceptional exit (KeyboardInterrupt is the real case): the
            # workers may be blocked on the bounded queues, so a plain
            # join would deadlock. Set abort, keep the queues draining
            # while the packer winds down, and never block indefinitely:
            # an unpacker stuck in a hung wait() is a daemon thread and
            # is abandoned rather than hanging the caller
            abort.set()
            while t_pack.is_alive():
                drain(packed_q)
                t_pack.join(timeout=0.1)
            drain(waiting_q)
            try:
                waiting_q.put_nowait(_STOP)
            except queue.Full:
                pass
            t_unpack.join(timeout=2.0)
            raise
        with trace.span("pipeline.join"):
            waiting_q.put(_STOP)
            t_unpack.join()
            t_pack.join()
        if fatal:
            raise fatal[0]

    def submit_fallback(self, fn, *args, **kwargs) -> Future:
        """Schedule host-only work concurrently with the device stages
        (inline at depth 0). Returns a Future; collect with `.result()`
        after `drain_fallback()`."""
        stats, faults = self.stats, self.faults
        idx = next(self._fb_counter)

        def timed():
            t0 = time.perf_counter()
            try:
                if faults is not None:
                    faults.fire("fallback", idx, stats)
                return fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                stats.bump("fallback_s", t1 - t0)
                tr = trace.get_tracer()
                if tr is not None:
                    tr.complete("pipeline.fallback", t0, t1, {"job": idx})

        if self.depth == 0:
            fut: Future = Future()
            try:
                fut.set_result(timed())
            except BaseException as exc:
                fut.set_exception(exc)
        else:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self.fallback_workers,
                    thread_name_prefix="racon-torch-fallback")
            fut = self._executor.submit(timed)
        self._futures.append(fut)
        return fut

    def map_fallback(self, idxs, fn, chunk: int = 256) -> list:
        """Submit `fn(sub)` for successive `chunk`-sized slices of `idxs`.
        Returns [(sub, future), ...]; collect each future's result (one
        entry per index in `sub`) after drain_fallback()."""
        out = []
        for s in range(0, len(idxs), chunk):
            sub = list(idxs[s:s + chunk])
            out.append((sub, self.submit_fallback(fn, sub)))
        return out

    def drain_fallback(self, ignore_errors: bool = False) -> None:
        """Block until every submitted fallback job finished; re-raises
        the first failure unless `ignore_errors`."""
        futures, self._futures = self._futures, []
        first: BaseException | None = None
        for fut in futures:
            try:
                fut.result()
            except BaseException as exc:
                if first is None:
                    first = exc
        if first is not None and not ignore_errors:
            raise first

    def cancel_fallback(self) -> tuple[int, int]:
        """Abandon the fallback queue: cancel every job not yet started
        and block until the running ones finish (their results and
        errors are discarded). Returns (cancelled, drained) counts. The
        polisher calls it when the device pass raises, so no fallback
        thread outlives the phase it belonged to."""
        futures, self._futures = self._futures, []
        cancelled = sum(1 for fut in futures if fut.cancel())
        drained = 0
        for fut in futures:
            if fut.cancelled():
                continue
            try:
                fut.result()
            except BaseException:
                pass
            drained += 1
        if cancelled:
            self.stats.bump("cancelled", cancelled)
        return cancelled, drained

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    def __enter__(self) -> "DispatchPipeline":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
