"""Occupancy-aware batch scheduler shared by all three device engines.

The port of the JAX package's racon_tpu/sched/__init__.py. Every device
hot path pads jobs up to a shape ladder: the overlap aligner
(`ops/align.BatchAligner.BUCKETS`, 8 length edges), the session POA
engine (`ops/poa_graph.BUCKETS`, a 4-entry (nodes, len) grid) and the
fused POA engine (`ops/poa_fused.DEPTH_BUCKETS`, 4 depth buckets). The
static ladders are sized for the worst case, so easy inputs burn the
worst case's DP cells — the occupancy problem cudapoa solves with its
add_windows-until-full batch sizing (cudabatch.cpp:77-270).
`BatchScheduler` packages three answers:

  1. ADAPTIVE LADDERS (`--cuda-adaptive-buckets`, `create_polisher(...,
     adaptive_buckets=True)`; default OFF — the static ladders remain
     the default): at run start each engine hands the scheduler its
     actual job-shape histogram and gets back a ladder of at most K
     shapes (K = the static ladder's size, so adaptive mode never
     launches at more shapes than static mode) minimizing total padded
     cells — the exact DPs in `ladder.py`. The kernels take their shapes
     at run time, so a data-derived shape costs no build.

  2. LENGTH-SORTED PACKING: with the scheduler enabled, jobs are sorted
     by shape before chunking, so each dispatched batch is
     shape-homogeneous instead of inheriting arrival order. Results are
     committed back by original index, so output stays byte-identical
     (tests/test_torch_sched.py pins this on all three engines).

  3. OCCUPANCY TELEMETRY (`telemetry.OccupancyStats`, always on — a few
     adds per dispatched batch): per-bucket jobs / batches / lanes /
     useful-vs-padded cells / occupancy % and per-engine first-dispatch
     count + seconds, flowing through `Polisher.occupancy_stats` and the
     metrics registry's `sched` namespace.

The posture comes from arguments and flags only (no environment
mirror), and the JAX package's persistent XLA compile cache has nothing
to cache here. The serve feeder's `pack_iteration` comes with the serve
slice.
"""

from __future__ import annotations

from .ladder import ladder_1d, ladder_2d, padded_cost_1d, round_up
from .telemetry import OccupancyStats

__all__ = ["BatchScheduler", "OccupancyStats", "ladder_1d", "ladder_2d",
           "padded_cost_1d", "round_up", "shard_interleave"]


def shard_interleave(items: list, n_devices: int) -> list:
    """Strided round-robin of a shape-sorted row list across `n` lanes:
    lane s receives items s, s+n, s+2n, ... — so a sorted batch's large
    rows spread evenly over the lanes instead of piling the heaviest work
    onto the last one (a contiguous split of a sorted list is
    systematically imbalanced). Pure permutation: per-row results are
    position-independent, so the caller's output bytes cannot change."""
    n = int(n_devices)
    if n <= 1 or len(items) <= n:
        return list(items)
    out: list = []
    for s in range(n):
        out.extend(items[s::n])
    return out


class BatchScheduler:
    """Shared scheduler handle threaded from the polisher into every
    engine: the adaptive on/off posture, the occupancy counters, and the
    per-engine ladder derivations (thin wrappers over ladder.py with
    each engine's quanta and cost model).

    One instance per polisher run; engines constructed standalone
    (tests, tools) get a non-adaptive one of their own.
    """

    def __init__(self, adaptive: bool = False,
                 stats: OccupancyStats | None = None):
        self.adaptive = bool(adaptive)
        self.stats = stats if stats is not None else OccupancyStats()

    # ------------------------------------------------- ladder derivation
    #: shape quanta: aligner edges land on multiples of 256 (the
    #: wavefront count is 2*edge+1, and K2's packed operands need edge
    #: % 4 == 0), session grids on 64s (node rows / layer columns; K1's
    #: packed layer needs len % 4 == 0), depth buckets on exact integers
    ALIGNER_QUANTUM = 256
    POA_QUANTUM = 64

    def aligner_ladder(self, lengths, k: int,
                       max_length: int) -> tuple[int, ...] | None:
        """Length-bucket edges for BatchAligner from a pair-length
        histogram (max(len(q), len(t)) per pair; the aligner calls this
        once per occupied static bucket with a split budget, so bands —
        which follow the static rule — stay constant per derived group).
        Cost model: within one derivation call the band is a constant,
        so per-lane DP area is proportional to the wavefront count
        2e+1 — exactly what the kernel executes at edge e."""
        if not self.adaptive:
            return None
        eligible = [v for v in lengths if 0 < v <= max_length]
        edges = ladder_1d(eligible, k, quantum=self.ALIGNER_QUANTUM,
                          cost=lambda e: 2 * e + 1)
        return tuple(edges) or None

    def poa_grid(self, shapes, k: int, max_nodes: int,
                 max_len: int) -> tuple[tuple[int, int], ...] | None:
        """(nodes, len) bucket grid for the session engine from predicted
        job shapes (poa_graph derives the prediction from the window
        set). Shapes beyond the envelope are dropped (those jobs are
        host-built and never dispatch); the caller appends the envelope
        bucket itself, its existing safety-net discipline."""
        if not self.adaptive:
            return None
        fit = [(n, l) for n, l in shapes if n <= max_nodes and l <= max_len]
        grid = ladder_2d(fit, k, quantum_a=self.POA_QUANTUM,
                         quantum_b=self.POA_QUANTUM,
                         area=lambda ea, eb: ea * (eb + 1))
        return tuple(grid) or None

    def depth_ladder(self, depths, k: int) -> tuple[int, ...] | None:
        """Depth buckets for the fused engine from the actual chunk-max
        depths (known exactly at run start: windows are depth-sorted
        before chunking). Every chained call of depth D costs B * D
        layer steps regardless of real layer count, so the cost of an
        edge is the edge itself."""
        if not self.adaptive:
            return None
        edges = ladder_1d(depths, k, quantum=1)
        return tuple(edges) or None

    def order(self, idxs, key):
        """Length-sorted packing: a stable shape-sort of job indices
        before chunking (identity when the scheduler is off, preserving
        arrival-order packing exactly)."""
        if not self.adaptive:
            return list(idxs)
        return sorted(idxs, key=key)
