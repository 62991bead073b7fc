"""Oracle re-execution: the ground-truth consensus the audit compares to.

The port of the JAX package's racon_tpu/ops/oracle.py. Every posture of
the port is held byte-identical to one ORACLE posture: int32 scores,
unpacked (int8) operands and, for the fused engine, the split posture's
chained calls. The autotuner's veto compares against that posture when
it profiles (sched/autotune.py `_pick`); `OracleExecutor` re-executes
sampled production windows at it, so the auditor (obs/audit.py) can
compare bytes after a run.

`OracleExecutor` keeps one BatchPOA per engine-parameter key, built at
the oracle posture by its constructor arguments: `score_dtype="int32"`,
`pack_bases=False`, `fused="0"`, a synchronous DispatchPipeline and a
non-adaptive BatchScheduler with the executor's own stage and occupancy
counters (so shadow runs never reach the polisher's `pipeline` and
`sched` counters), and no autotuner (a poisoned table entry cannot
poison its own audit). The JAX package needs `oracle_scope`, a
thread-local override of its four process-wide posture reads; the port's
postures are constructor arguments, so a production engine and the
oracle run side by side on two threads without one.

On a card the oracle runs the same hand kernels as production (K1 and K3
at their int32 / int8 / split instantiations; consensus only, so K2 is
not on its path). It catches a fault in the int16, packed or
single-launch instantiations, not one in the oracle instantiation
itself: that one is held against the plain versions by `chip_smoke.py`
and the `gpu` tests. On the CPU both sides run the plain versions.
"""

from __future__ import annotations

import threading


# ------------------------------------------------------------ snapshots
def snapshot_window(w) -> tuple:
    """An immutable content snapshot of one production window: the bytes
    its consensus is a function of (references to immutable `bytes`,
    not copies)."""
    return (w.id, w.rank, w.type, tuple(w.sequences),
            tuple(w.qualities), tuple(w.positions))


def rebuild_window(snap):
    """A fresh Window carrying exactly the snapshot's content, with no
    consensus yet."""
    from ..core.window import Window

    wid, rank, wtype, seqs, quals, positions = snap
    w = Window(wid, rank, wtype, seqs[0], quals[0])
    w.sequences = list(seqs)
    w.qualities = list(quals)
    w.positions = list(positions)
    return w


def engine_params_key(p) -> tuple:
    """The consensus-engine identity of a polisher's parameters: every
    knob that can change a window's consensus bytes (the leftover
    windows' builder of the fused engine included)."""
    return (p.match, p.mismatch, p.gap, p.window_length,
            p.cuda_poa_batches, p.cuda_banded_alignment,
            p.cuda_aligner_band_width, p.cuda_engine or "session",
            getattr(p, "fused_fallback", "session"))


class OracleExecutor:
    """Cached oracle engines on `device`, one per engine-parameter key
    (module docstring). `consensus()` serializes on one lock and runs
    every stage inline on the calling thread."""

    def __init__(self, device="cuda"):
        from ..pipeline import PipelineStats
        from ..sched import BatchScheduler, OccupancyStats

        self.device = device
        #: the `audit` view's counters: the oracle's own stage counters
        #: and first dispatches, never mixed into production's
        self.pipeline_stats = PipelineStats()
        self.scheduler = BatchScheduler(adaptive=False,
                                        stats=OccupancyStats())
        self._engines: dict = {}
        self._lock = threading.Lock()

    def _engine(self, key: tuple, p):
        from ..pipeline import DispatchPipeline
        from .poa import BatchPOA

        ent = self._engines.get(key)
        if ent is None:
            ent = self._engines[key] = BatchPOA(
                p.match, p.mismatch, p.gap, p.window_length,
                num_threads=getattr(p, "num_threads", 1),
                device_batches=p.cuda_poa_batches,
                banded=p.cuda_banded_alignment, device=self.device,
                score_dtype="int32", pack_bases=False,
                pipeline=DispatchPipeline(depth=0,
                                          stats=self.pipeline_stats),
                engine=p.cuda_engine or "session", fused="0",
                fused_fallback=getattr(p, "fused_fallback", "session"),
                scheduler=self.scheduler, autotuner=None)
        return ent

    def consensus(self, p, snaps: list) -> list:
        """Re-execute the snapshotted windows at the oracle posture for
        polisher parameters `p`; returns the rebuilt windows, each with
        its ground-truth `consensus` / `polished`."""
        key = engine_params_key(p)
        clones = [rebuild_window(s) for s in snaps]
        with self._lock:
            self._engine(key, p).generate_consensus(clones, p.trim)
        return clones

    def stats(self) -> dict:
        """The `audit` view: the oracle's own stage counters and first
        dispatches."""
        snap = self.pipeline_stats.snapshot()
        occ = self.scheduler.stats.snapshot()
        return {"launches": snap["launches"],
                "chunks": snap["chunks"],
                "device_s": round(snap["device_s"], 4),
                "compiles": sum(e.get("compiles", 0)
                                for e in occ.values()),
                "compile_s": round(sum(e.get("compile_s", 0.0)
                                       for e in occ.values()), 3)}

    def close(self) -> None:
        with self._lock:
            engines, self._engines = self._engines, {}
        for engine in engines.values():
            if engine.pipeline is not None:
                engine.pipeline.close()
