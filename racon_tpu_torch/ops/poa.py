"""Batched POA consensus over windows.

The consensus role spoa (CPU) and GenomeWorks cudapoa (GPU) play in the
reference. The engines:

  - host: the native C++ POA graph engine (racon_tpu_torch/native),
    threaded over windows — the spoa-equivalent path;
  - device (`device_batches > 0`), `engine="session"` (the default): the
    evolving-graph session engine (ops/poa_graph.DeviceGraphPOA): the
    graph DP of every layer runs on the device while the graph
    bookkeeping stays in the C++ session; the consensus is
    byte-identical to the host engine's. Windows outside the kernel's
    shape envelope are built by the host engine inside the session and
    counted. The device engine runs each bucket at the score dtype
    `score_dtype` resolves to under its overflow proof, and ships
    all-ACGT batches 2-bit packed unless `pack_bases` is False;
  - device, `engine="fused"`: the whole-window engine
    (ops/poa_fused.FusedPOA, the JAX package's `--tpu-engine fused`):
    every layer of a chunk of windows in one device program, at the
    chunk posture `fused` ('auto', '0' split, '1' one launch per chunk).
    The windows it leaves (its envelope, or a window that failed on the
    device) go to the session engine, or with `fused_fallback="host"` to
    the host engine, and are counted and logged.

Both device engines take the run's occupancy scheduler (sched/), batch
runner (parallel/mesh) and autotuner winner table (sched/autotune.py,
consulted under the `auto` postures); the windows the fused engine
leaves go through a session engine whose scheduler is not adaptive but
shares the run's counters.

The host engine runs its chunks through the dispatch pipeline
(pipeline/): a pack worker builds chunk k+1's window lists while the
native POA call (GIL released) computes chunk k and the unpack worker
trims chunk k-1. The session engine keeps its own in-flight deque.

Windows with fewer than 3 sequences keep their backbone (reference
window.cpp:68-71); TGS windows are coverage-trimmed (window.cpp:118-139).
A device failure raises; nothing re-runs the windows on the host. When
the pipeline carries a fault plan (resilience/faults.py), its `sdc`
faults are consumed after the pass, whichever engine ran.
"""

from __future__ import annotations

import torch

from ..device import resolve
from ..errors import RaconError
from ..native import poa_batch
from ..pipeline import DispatchPipeline
from ..utils.logger import Logger, log_info


class BatchPOA:
    #: windows per host batch call by default (bounds peak packed-buffer
    #: memory); `host_chunk` sets it per engine (None: this default). The chunk never changes
    #: the output (windows are independent), only the pipeline's batching:
    #: the serve benchmark's fleet modes shrink it so a simulated
    #: per-chunk device latency paces in proportion to a job's windows
    HOST_CHUNK = 4096

    def __init__(self, match: int, mismatch: int, gap: int,
                 window_length: int, num_threads: int = 1,
                 device_batches: int = 0, banded: bool = False,
                 logger: Logger | None = None,
                 device: str | torch.device = "cuda",
                 score_dtype: str = "auto", pack_bases: bool = True,
                 pipeline=None, engine: str = "session",
                 fused: str = "auto", fused_fallback: str = "session",
                 scheduler=None, runner=None, autotuner=None,
                 host_chunk: int | None = None):
        if engine not in ("session", "fused"):
            raise ValueError(f"device engine {engine!r}: want 'session' or "
                             f"'fused'")
        if fused_fallback not in ("session", "host"):
            raise ValueError(f"fused fallback {fused_fallback!r}: want "
                             f"'session' or 'host'")
        try:
            self.host_chunk = int(self.HOST_CHUNK if host_chunk is None
                                  else host_chunk)
        except (TypeError, ValueError):
            self.host_chunk = 0
        if self.host_chunk <= 0:
            raise RaconError("BatchPOA",
                             f"invalid host chunk {host_chunk!r} (expected "
                             "a positive integer)!")
        self.match = match
        self.mismatch = mismatch
        self.gap = gap
        self.window_length = window_length
        self.num_threads = num_threads
        self.device_batches = device_batches
        # the reference's -b / cuda-banded-alignment flag: the device
        # session trusts banded DP results (skips the clipped -> full-DP
        # retry), trading byte-identity with the host engine for speed
        self.banded_only = banded
        self.logger = logger
        self.device = resolve(device) if device_batches > 0 else None
        self.score_dtype = score_dtype
        self.pack_bases = pack_bases
        #: the host chunk loop's and the fused engine's DispatchPipeline
        #: (None: synchronous)
        self.pipeline = pipeline
        self.engine_name = engine
        self.fused = fused
        self.fused_fallback = fused_fallback
        #: the occupancy-aware batch scheduler (sched/) threaded into
        #: whichever device engine runs, and the lanes (parallel/mesh)
        #: their batches are split over; None lets each engine make its
        #: own (a non-adaptive scheduler, one lane on `device`)
        self.scheduler = scheduler
        self.runner = runner
        #: the winner table both device engines consult (None: none)
        self.autotuner = autotuner
        #: per-window outcome counts of the last pass: on the device (the
        #: fused engine's and the session engine's), on the host, and
        #: backbone-only; n_fused of n_device came from the fused engine
        self.n_device = 0
        self.n_host = 0
        self.n_backbone = 0
        self.n_fused = 0
        #: the device engine of the last pass (the fused engine when it
        #: ran, else the session engine)
        self.engine = None

    def generate_consensus(self, windows, trim: bool) -> None:
        """Fill `window.consensus` / `window.polished` for every window,
        whichever engine runs; then consume the pipeline's fault plan's
        armed `sdc` faults against the finished windows
        (resilience/faults.py). Without a plan that costs one check."""
        self._generate_consensus(windows, trim)
        plan = self.pipeline.faults if self.pipeline is not None else None
        if plan is not None:
            plan.corrupt_consensus(windows, stats=self.pipeline.stats)

    def _generate_consensus(self, windows, trim: bool) -> None:
        todo = []
        for w in windows:
            if len(w.sequences) < 3:
                w.backbone_fallback()
            else:
                todo.append(w)
        self.n_backbone = len(windows) - len(todo)
        if not todo:
            return
        if self.device_batches > 0:
            self._device_consensus(todo, trim)
            return
        bar = self.logger.bar if self.logger is not None else None
        if self.logger is not None:
            self.logger.bar_total(len(todo))
        pl = (self.pipeline if self.pipeline is not None
              else DispatchPipeline(depth=0))
        chunks = [todo[s:s + self.host_chunk]
                  for s in range(0, len(todo), self.host_chunk)]

        def pack(chunk):
            return [_pack(w) for w in chunk]

        def dispatch(chunk, packed):
            results = poa_batch(packed, self.match, self.mismatch, self.gap,
                                n_threads=self.num_threads)
            pl.stats.bump("launches")
            return results

        def wait(results):
            return results

        def unpack(chunk, results):
            for w, (cons, cov) in zip(chunk, results):
                w.apply_trim(cons, cov, trim)
                if bar is not None:
                    bar("[racon_tpu_torch::Polisher.polish] generating "
                        "consensus")

        pl.run(chunks, pack, dispatch, wait, unpack, label="host_poa",
               describe=lambda c: {"engine": "host", "jobs": len(c)})
        self.n_host = len(todo)

    def _session(self, scheduler=None):
        from .poa_graph import DeviceGraphPOA

        return DeviceGraphPOA(
            self.match, self.mismatch, self.gap, device=self.device,
            num_threads=self.num_threads, logger=self.logger,
            banded_only=self.banded_only, score_dtype=self.score_dtype,
            pack_bases=self.pack_bases,
            scheduler=scheduler or self.scheduler, runner=self.runner,
            autotuner=self.autotuner)

    def _device_consensus(self, todo, trim) -> None:
        from .poa_graph import log_session_stats

        packed = [_pack(w) for w in todo]
        if self.engine_name == "fused":
            results, statuses = self._fused_consensus(packed)
        else:
            self.engine = self._session()
            results, statuses = self.engine.consensus(packed)
            log_session_stats(self.engine.last_stats, statuses,
                              self.engine.batches_by_plan)
        for w, (cons, cov) in zip(todo, results):
            w.apply_trim(cons, cov, trim)
        self.n_device = int((statuses == 0).sum())
        self.n_host = int((statuses == 1).sum())

    def _fused_consensus(self, packed):
        """The fused engine over every window, then the windows it left
        through the session engine (or, with fused_fallback="host", the
        host engine inside the fused engine)."""
        from .poa_fused import FusedPOA
        from .poa_graph import log_session_stats

        to_host = self.fused_fallback == "host"
        fused = self.engine = FusedPOA(
            self.match, self.mismatch, self.gap, device=self.device,
            num_threads=self.num_threads, logger=self.logger,
            banded_only=self.banded_only, fused=self.fused,
            score_dtype=self.score_dtype, scheduler=self.scheduler,
            runner=self.runner, autotuner=self.autotuner)
        results, statuses = fused.consensus(packed, fallback=to_host,
                                            pipeline=self.pipeline)
        self.n_fused = int((statuses == 0).sum())
        fs = fused.last_stats
        log_info(f"[racon_tpu_torch::BatchPOA] fused engine built "
                 f"{self.n_fused} windows at {fused.score_dtype} "
                 f"({fs['chunks']} chunks, {fs['launches']} device "
                 f"launches, {fs['fused_chunks']} of them one launch per "
                 f"chunk; pack {fs['pack_s']:.2f}s, device "
                 f"{fs['device_s']:.2f}s, finalize {fs['unpack_s']:.2f}s); "
                 f"{fused.n_fallback} to {'host' if to_host else 'session'}"
                 f" engine")
        rest = [i for i, r in enumerate(results) if r is None]
        if rest:
            # the leftover windows are a handful of envelope-tail cases: no
            # grid is derived from them (the session engine keeps the
            # static grid), while its occupancy still flows into the run's
            # shared counters
            from ..sched import BatchScheduler

            session = self._session(BatchScheduler(
                adaptive=False, stats=(self.scheduler.stats
                                       if self.scheduler is not None
                                       else None)))
            sub_res, sub_st = session.consensus([packed[i] for i in rest])
            log_session_stats(session.last_stats, sub_st,
                              session.batches_by_plan)
            for i, r, st in zip(rest, sub_res, sub_st):
                results[i] = r
                statuses[i] = st
        return results, statuses


def _pack(w):
    return [(w.sequences[i], w.qualities[i], w.positions[i][0],
             w.positions[i][1]) for i in range(len(w.sequences))]
