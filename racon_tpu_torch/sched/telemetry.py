"""Occupancy telemetry: per-bucket padding-waste counters.

The port's copy of the JAX package's racon_tpu/sched/telemetry.py, with
the same counters and snapshot keys. `OccupancyStats` makes padding waste
a tracked metric: every dispatched batch records its bucket, lane count
and useful-vs-total cells (cells = DP area for the aligner and the
session engine, layers for the fused engine — each engine's natural unit
of padded compute), plus the per-engine "compile" count and seconds.

What "compile" means here: the port's kernels take their shapes at run
time and are built once per process by _build.py, so there is no per-
shape program to compile. A compile is the FIRST DISPATCH of a new launch
shape (the same keys the JAX engines use: bucket, batch rows, score
dtype, operand form, ...), and compile_s is that dispatch's wall: host
packing of the operands is not in it, the launch and the first
allocation of its buffers at that shape are. The keys stay the JAX
package's so that `compiles` counts compare across the packages.

The snapshot flows through `Polisher.occupancy_stats` and the metrics
registry's `sched` namespace, so a ladder change shows up as a measured
occupancy delta, not an anecdote.

Invariant the tests pin: per bucket, useful_cells + padded_cells ==
lanes * capacity(bucket) — the counters sum to exactly the cells the
device was asked to process.
"""

from __future__ import annotations

import threading

#: launch shapes already charged to compile telemetry. Process-wide by
#: design, as in the JAX package: a second engine instance (or a second
#: polisher) dispatching a shape this process already launched is not
#: charged again.
_seen_shapes: set = set()


def _copy_bucket(b: dict) -> dict:
    """Deep-enough bucket copy for reads escaping the lock: the
    shard_useful LIST must be copied under the lock too, or a
    concurrent record() mutates it mid-read and exports torn per-shard
    sums."""
    return {k: (list(v) if isinstance(v, list) else v)
            for k, v in b.items()}


def accumulate_cells(acc: list, vals) -> list:
    """Element-wise accumulate `vals` into `acc`, extending past the
    end — THE shard-list accumulation, shared by record()/merge_from()/
    snapshot() (one copy, so the semantics cannot drift between
    them)."""
    for i, v in enumerate(vals):
        if i < len(acc):
            acc[i] += int(v)
        else:
            acc.append(int(v))
    return acc


class OccupancyStats:
    """Thread-safe per-(engine, bucket) occupancy counters.

    Counter semantics per bucket:
      jobs          real (non-pad) jobs dispatched
      batches       device batches dispatched
      lanes         total batch rows incl. round-up padding lanes
      useful_cells  cells covered by real job shapes
      padded_cells  cells burned on padding (bucket edge - job shape,
                    plus whole padding lanes)
    Per engine:
      compiles      distinct launch shapes first dispatched this process
      compile_s     wall seconds spent in those shapes' first dispatch
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._buckets: dict[tuple[str, str], dict] = {}
        self._compiles: dict[str, dict] = {}
        #: optional obs.hist.HistogramSet: per-engine first-dispatch wall
        #: time observed as a latency distribution (`compile.<engine>`);
        #: None when nothing is watching
        self.hists = None

    def record(self, engine: str, bucket, jobs: int, lanes: int,
               useful_cells: int, total_cells: int,
               kernel: str | None = None, dtype: str | None = None,
               n_devices: int | None = None,
               shard_useful=None,
               full_mesh_cells: int | None = None) -> None:
        """Account one dispatched batch. `bucket` is any hashable shape
        descriptor (stringified for the snapshot); `total_cells` is the
        batch's full dispatched capacity (>= useful_cells). `kernel`
        ('cuda' where the hand kernel ran, 'plain' where its plain
        PyTorch version ran on the CPU) and `dtype` ('int32' | 'int16')
        record the bucket's dispatched kernel and score width (constant
        per bucket within a run; last write wins).

        The lane view (all optional, so host-only engines stay
        unchanged): `n_devices` is the dispatching runner's lane count
        (parallel/mesh.BatchRunner), `shard_useful` the per-lane useful-
        cell split of this batch (accumulated element-wise — the per-lane
        balance), and `full_mesh_cells` what the batch WOULD have
        dispatched under the full runner's `round_batch` rounding — the
        baseline the sub-runner tail dispatch is measured against (equal
        to `total_cells` when no sub-runner was taken)."""
        key = (engine, str(bucket))
        with self._lock:
            b = self._buckets.get(key)
            if b is None:
                b = self._buckets[key] = {
                    "jobs": 0, "batches": 0, "lanes": 0,
                    "useful_cells": 0, "padded_cells": 0}
            b["jobs"] += int(jobs)
            b["batches"] += 1
            b["lanes"] += int(lanes)
            b["useful_cells"] += int(useful_cells)
            b["padded_cells"] += int(total_cells) - int(useful_cells)
            if kernel is not None:
                b["kernel"] = kernel
            if dtype is not None:
                b["dtype"] = dtype
            if n_devices is not None:
                b["n_devices"] = int(n_devices)
            if shard_useful is not None:
                accumulate_cells(b.setdefault("shard_useful", []),
                                 shard_useful)
            if full_mesh_cells is not None:
                b["full_mesh_cells"] = (b.get("full_mesh_cells", 0)
                                        + int(full_mesh_cells))

    def record_compile(self, engine: str, seconds: float,
                       count: int = 1) -> None:
        with self._lock:
            c = self._compiles.setdefault(
                engine, {"compiles": 0, "compile_s": 0.0})
            c["compiles"] += count
            c["compile_s"] += float(seconds)
        if self.hists is not None:
            self.hists.observe(f"compile.{engine}", float(seconds))

    def record_compile_once(self, engine: str, key,
                            seconds: float) -> bool:
        """Charge `seconds` as compile wall iff `key` (the FULL launch
        identity, including the batch dimension, as the JAX engines key
        it) is new to this process. The shared first-dispatch idiom of
        all three engines: time the dispatch, call this, and the first
        occurrence of each shape is charged."""
        k = (engine, key)
        with self._lock:
            if k in _seen_shapes:
                return False
            _seen_shapes.add(k)
        self.record_compile(engine, seconds)
        # trace the first dispatch as a span ending now (the charge is
        # made right after it returned, so now - seconds is its start)
        from ..obs import trace

        tr = trace.get_tracer()
        if tr is not None:
            import time

            now = time.perf_counter()
            tr.complete("sched.first_dispatch", now - float(seconds), now,
                        {"engine": engine, "shape": str(key)})
        return True

    def merge_from(self, other: "OccupancyStats") -> None:
        """Fold another instance's counters into this one (counters add,
        per-lane lists add element-wise, descriptors: last write wins) —
        one instance per worker keeps each worker's deltas exact, and a
        scratch instance merges them for the lifetime view."""
        with other._lock:
            buckets = {k: _copy_bucket(v)
                       for k, v in other._buckets.items()}
            compiles = {k: dict(v) for k, v in other._compiles.items()}
        with self._lock:
            for key, b in buckets.items():
                mine = self._buckets.get(key)
                if mine is None:
                    self._buckets[key] = b
                    continue
                for k, v in b.items():
                    if k == "n_devices" or isinstance(v, str):
                        mine[k] = v  # descriptors: last write wins
                    elif isinstance(v, list):
                        accumulate_cells(mine.setdefault(k, []), v)
                    else:
                        mine[k] = mine.get(k, 0) + v
            for engine, c in compiles.items():
                mine = self._compiles.setdefault(
                    engine, {"compiles": 0, "compile_s": 0.0})
                mine["compiles"] += c["compiles"]
                mine["compile_s"] += c["compile_s"]

    def snapshot(self) -> dict:
        """{engine: {"buckets": {bucket: {..., "occupancy_pct"}},
                     "occupancy_pct", "compiles", "compile_s"}} —
        JSON-ready; empty dict when nothing was dispatched."""
        with self._lock:
            buckets = {k: _copy_bucket(v)
                       for k, v in self._buckets.items()}
            compiles = {k: dict(v) for k, v in self._compiles.items()}
        out: dict = {}
        for (engine, bucket), b in sorted(buckets.items()):
            e = out.setdefault(engine, {"buckets": {}})
            total = b["useful_cells"] + b["padded_cells"]
            e["buckets"][bucket] = dict(
                b, occupancy_pct=round(100.0 * b["useful_cells"] / total, 2)
                if total else 0.0)
        for engine, e in out.items():
            useful = sum(b["useful_cells"] for b in e["buckets"].values())
            total = useful + sum(b["padded_cells"]
                                 for b in e["buckets"].values())
            e["occupancy_pct"] = (round(100.0 * useful / total, 2)
                                  if total else 0.0)
            # the lane view, aggregated across buckets that carry it:
            # per-lane useful-cell balance (max/min over the engine's
            # element-wise lane sums) and the padded-cell fraction vs
            # what the full runner's round_batch rounding would have
            # dispatched. RAW sums (useful/total/full-mesh cells) ride
            # along so consumers can combine fractions across engines
            # without re-walking buckets.
            shards: list[int] = []
            fm_cells = fm_useful = 0
            for b in e["buckets"].values():
                accumulate_cells(shards, b.get("shard_useful", ()))
                if "full_mesh_cells" in b:
                    fm_cells += b["full_mesh_cells"]
                    fm_useful += b["useful_cells"]
            if shards:
                e["shard_useful"] = shards
                if min(shards) > 0:
                    e["shard_balance"] = round(
                        max(shards) / min(shards), 4)
            if total:
                e["useful_cells"] = useful
                e["total_cells"] = total
                e["padded_frac"] = round((total - useful) / total, 6)
            if fm_cells:
                e["full_mesh_cells"] = fm_cells
                e["full_mesh_useful"] = fm_useful
                e["padded_frac_full_mesh"] = round(
                    (fm_cells - fm_useful) / fm_cells, 6)
        for engine, c in compiles.items():
            e = out.setdefault(engine, {"buckets": {}})
            e["compiles"] = c["compiles"]
            e["compile_s"] = round(c["compile_s"], 3)
        return out

    def summary(self) -> str | None:
        """One-line per-engine occupancy report for stderr, or None when
        nothing was dispatched (the host-only case: silence)."""
        snap = self.snapshot()
        parts = []
        for engine, e in snap.items():
            if not e.get("buckets"):
                continue
            jobs = sum(b["jobs"] for b in e["buckets"].values())
            batches = sum(b["batches"] for b in e["buckets"].values())
            s = (f"{engine} {e['occupancy_pct']:.1f}% "
                 f"({jobs} jobs / {batches} batches"
                 f" / {len(e['buckets'])} shapes")
            if "compiles" in e:
                s += f", {e['compiles']} compiles {e['compile_s']:.1f}s"
            parts.append(s + ")")
        return "; ".join(parts) if parts else None
