"""Polisher: whole-pipeline orchestration for contig polishing (kC) and
fragment (read) error correction (kF).

parse -> filter -> align overlaps -> window -> POA consensus -> stitch.

Mirrors the reference pipeline (src/polisher.cpp:192-548) and the JAX
package's Polisher, with both hot spots on the GPU:

  - overlap CIGARs: ops/align.BatchAligner (the cudaaligner role) when
    `cuda_aligner_batches > 0`, else the host Myers aligner; pairs the
    device rejects are aligned on the host and counted;
  - window consensus: ops/poa.BatchPOA (the cudapoa role) when
    `cuda_poa_batches > 0`, else the host POA engine.

Both phases run through the dispatch pipeline (pipeline/), at depth 2
by default as in the JAX CLI: the aligner's pack / launch / decode
stages overlap, and pairs the device rejects are host-aligned in the
pipeline's fallback pool while the device pass runs. One PipelineStats,
a HistogramSet, a BatchScheduler (sched/: occupancy counters, and with
`adaptive_buckets` data-derived shape ladders) and a MetricsRegistry
(namespaces `pipeline`, `sched`, `latency`, `aligner`) cover the run;
the phases are trace spans (obs/trace.py). Both device phases split
their batches over the lanes of one BatchRunner (parallel/mesh.py) and
consult one autotuner winner table (sched/autotune.py) under the `auto`
postures.

The two types differ in two places only, as in the reference and the
JAX package: kC keeps just the longest overlap per query, kF every valid
one (the reads correct each other, so the overlaps must be dual); kF
names its output reads with an `r` suffix.

Library hooks for a long-lived caller (the JAX package's, which its
serve layer uses; the one-shot CLI has no flags for them):

  - `rebind(reads, overlaps, target)` points a polisher at a new triple
    and resets its per-run state; the kernel and host libraries, the
    lanes' streams and the winner table stay warm, and the next run
    writes a fresh polisher's bytes;
  - `redraft(polished, workdir, tag)` re-maps the original reads onto a
    round's contigs in-process (core/remap.py) and rebinds: the next run
    is the next polishing round;
  - `window_range` (target coordinates) and `target_range` (target file
    indices) restrict a run to a shard; a window-range run writes
    bare-named segments and their accounting (`segment_meta`);
  - `progress_hook` receives per-phase progress events (emit_progress);
  - `polish()` is `_consensus_pass()` then `_stitch()`; ContigStreamer
    and FragmentStreamer stitch windows delivered in any order into the
    same output, which is how `polish(batcher=...)` stitches the windows
    a server's window batcher (serve/batcher.py) hands back;
  - `fault_plan` arms injected faults at the pipelines' stages
    (resilience/faults.py).
"""

from __future__ import annotations

import enum
import threading
import time

import numpy as np

from ..device import resolve
from ..errors import RaconError
from ..io.parsers import create_sequence_parser, create_overlap_parser
from ..obs import torch_profile, trace
from ..obs.hist import HistogramSet
from ..obs.metrics import MetricsRegistry
from ..ops.dtypes import plan_split
from ..pipeline import REPORT_KEYS, DispatchPipeline, PipelineStats
from ..utils.cigar import cigar_from_ops
from ..utils.logger import (DEBUG, Logger, flush_dedup, log_info, log_level,
                            reset_dedup, set_log_level)
from .sequence import Sequence, create_sequence
from .window import Window, WindowType, create_window

KCHUNK_SIZE = 1024 * 1024 * 1024  # reference polisher.cpp:26


class PolisherType(enum.Enum):
    kC = 0  # contig polishing
    kF = 1  # fragment (read) error correction


def create_polisher(sequences_path: str, overlaps_path: str, target_path: str,
                    type_: PolisherType, window_length: int,
                    quality_threshold: float, error_threshold: float,
                    trim: bool = True, match: int = 3, mismatch: int = -5,
                    gap: int = -4, num_threads: int = 1,
                    cuda_poa_batches: int = 0,
                    cuda_banded_alignment: bool = True,
                    cuda_aligner_batches: int = 0,
                    cuda_aligner_band_width: int = 0,
                    device: str = "cuda", score_dtype: str = "auto",
                    pack_bases: bool = True, pipeline_depth: int = 2,
                    trace_path: str | None = None,
                    metrics_path: str | None = None,
                    log_level: str | None = None,
                    profile_dir: str | None = None,
                    cuda_engine: str = "session", cuda_fused: str = "auto",
                    fused_fallback: str = "session",
                    adaptive_buckets: bool = False,
                    devices=None,
                    autotune_table: str | None = None,
                    fault_plan=None, aligner_max_length: int | None = None,
                    device_latency_s: float = 0.0,
                    device_latency_x: float = 0.0,
                    host_poa_chunk: int | None = None) -> "Polisher":
    """Factory mirroring reference createPolisher (polisher.cpp:55-160).
    The defaults match the JAX package's create_polisher, banded device
    POA included; the CLI defaults -b off. `score_dtype` (auto, int32 or
    int16) and `pack_bases` set both device engines' kernel posture
    (ops/dtypes.py, ops/encode.py). `pipeline_depth` is the dispatch
    pipeline's depth (0: synchronous). The observability knobs, all off
    by default: `trace_path` arms the process tracer, saved at the end
    of polish(); `metrics_path` receives the metrics snapshot as JSON;
    `log_level` sets the stderr level (quiet, info, debug); `profile_dir`
    receives a torch.profiler capture of each device phase. `cuda_engine`
    picks the device consensus engine (session, or fused: the
    whole-window engine), `cuda_fused` the fused engine's chunk posture
    (auto, 0 split, 1 one launch per chunk) and `fused_fallback` who
    builds the windows the fused engine leaves (session or host).
    `adaptive_buckets` arms the occupancy-aware scheduler (sched/:
    data-derived shape ladders and shape-sorted packing; the same bytes
    either way). `devices` lists the lanes the device engines split
    their batches over (parallel/mesh.BatchRunner; a device may repeat);
    None takes every visible CUDA device for a bare 'cuda'
    (CUDA_VISIBLE_DEVICES narrows it), the named card alone for
    'cuda:N', and one lane on the CPU. `autotune_table` is the path of
    the autotuner's winner table (sched/autotune.py; None: its default
    path), which the engines consult under `score_dtype="auto"` and
    `cuda_fused="auto"`; a cold table changes nothing. `fault_plan` (a
    resilience.FaultPlan or its spec string; None: none) arms injected
    faults at this polisher's pipeline stages (resilience/faults.py).
    `aligner_max_length` is the device aligner's length envelope (pairs
    beyond the largest bucket edge within it align on the host; None:
    BatchAligner's default, its largest bucket edge).
    `device_latency_s` / `device_latency_x` simulate a device round trip
    in both phases' pipelines, and `host_poa_chunk` is the host POA
    engine's windows per chunk (pipeline/, ops/poa.py; None:
    BatchPOA.HOST_CHUNK); none of the three changes the output."""
    if log_level is not None:
        set_log_level(log_level)
    if trace_path:
        trace.configure(trace_path)
    if not isinstance(type_, PolisherType):
        raise RaconError("createPolisher", "invalid polisher type!")
    if window_length == 0:
        raise RaconError("createPolisher", "invalid window length!")
    dev = resolve(device)
    if dev.type == "cuda":
        from ..device import card_info

        log_info(f"[racon_tpu_torch::createPolisher] device {dev}: "
                 f"{card_info()}")

    sparser = create_sequence_parser(sequences_path, "createPolisher")
    oparser = create_overlap_parser(overlaps_path, "createPolisher")
    tparser = create_sequence_parser(target_path, "createPolisher")

    return Polisher(sparser, oparser, tparser, type_, window_length,
                    quality_threshold, error_threshold, trim, match, mismatch,
                    gap, num_threads, cuda_poa_batches, cuda_banded_alignment,
                    cuda_aligner_batches, cuda_aligner_band_width, device,
                    score_dtype, pack_bases, pipeline_depth, metrics_path,
                    profile_dir, cuda_engine, cuda_fused, fused_fallback,
                    adaptive_buckets, devices, autotune_table, fault_plan,
                    aligner_max_length, device_latency_s, device_latency_x,
                    host_poa_chunk)


class Polisher:
    def __init__(self, sparser, oparser, tparser, type_: PolisherType,
                 window_length: int, quality_threshold: float,
                 error_threshold: float, trim: bool, match: int, mismatch: int,
                 gap: int, num_threads: int = 1, cuda_poa_batches: int = 0,
                 cuda_banded_alignment: bool = True,
                 cuda_aligner_batches: int = 0,
                 cuda_aligner_band_width: int = 0, device="cuda",
                 score_dtype: str = "auto", pack_bases: bool = True,
                 pipeline_depth: int = 2, metrics_path: str | None = None,
                 profile_dir: str | None = None,
                 cuda_engine: str = "session", cuda_fused: str = "auto",
                 fused_fallback: str = "session",
                 adaptive_buckets: bool = False, devices=None,
                 autotune_table: str | None = None, fault_plan=None,
                 aligner_max_length: int | None = None,
                 device_latency_s: float = 0.0,
                 device_latency_x: float = 0.0,
                 host_poa_chunk: int | None = None):
        import torch

        from ..parallel.mesh import BatchRunner
        from ..resilience import FaultPlan
        from ..sched import BatchScheduler
        from ..sched.autotune import get_autotuner

        self.sparser = sparser
        self.oparser = oparser
        self.tparser = tparser
        self.type = type_
        self.window_length = window_length
        self.quality_threshold = quality_threshold
        self.error_threshold = error_threshold
        self.trim = trim
        self.match = match
        self.mismatch = mismatch
        self.gap = gap
        self.num_threads = num_threads
        self.cuda_poa_batches = cuda_poa_batches
        self.cuda_banded_alignment = cuda_banded_alignment
        self.cuda_aligner_batches = cuda_aligner_batches
        self.cuda_aligner_band_width = cuda_aligner_band_width
        self.device = resolve(device)
        self.score_dtype = score_dtype
        self.pack_bases = pack_bases
        self.pipeline_depth = max(0, pipeline_depth)
        self.metrics_path = metrics_path
        self.profile_dir = profile_dir
        self.cuda_engine = cuda_engine
        self.cuda_fused = cuda_fused
        self.fused_fallback = fused_fallback
        self.aligner_max_length = aligner_max_length
        #: the simulated device latency and the host POA chunk (neither
        #: changes the output)
        self.device_latency_s = device_latency_s
        self.device_latency_x = device_latency_x
        self.host_poa_chunk = host_poa_chunk
        #: this polisher's injected faults (one-shot, shared by its
        #: phases' pipelines), or None
        self.faults = (FaultPlan.parse(fault_plan)
                       if isinstance(fault_plan, str) else fault_plan)
        # per-chunk pipeline stage seconds and phase seconds as latency
        # distributions, and the stage counters both phases' pipelines
        # share
        self.hists = HistogramSet()
        self.pipeline_stats = PipelineStats(hists=self.hists)
        # the occupancy-aware batch scheduler (sched/), shared by the
        # aligner and whichever consensus engine runs: adaptive ladders
        # and sorted packing when armed, per-bucket occupancy telemetry
        # always, its first-dispatch walls in the run's histograms
        self.scheduler = BatchScheduler(adaptive=adaptive_buckets)
        self.scheduler.stats.hists = self.hists
        #: the lanes the device engines split their batches over
        if devices is None and (self.device.type == "cpu"
                                or torch.device(device).index is not None):
            devices = [self.device]
        self.device_runner = BatchRunner(devices)
        #: the winner table the aligner and the consensus engine consult
        #: (the process's handle for the path, shared with later polishers
        #: and demotions), and its consult counts when this run began
        self.autotuner = get_autotuner(autotune_table)
        self._consults_base = self.autotuner.consults_snapshot()
        #: completed initialize() + polish() cycles: a reused polisher
        #: resets its per-run counters at the next initialize()
        self._runs_completed = 0

        self.sequences: list[Sequence] = []
        self.windows: list[Window] = []
        self.targets_coverages: list[int] = []
        #: window-range shard: (lo, hi) target coordinates. initialize()
        #: keeps only the windows whose grid start j satisfies
        #: lo <= j < hi (`rank` stays the window's global grid rank), and
        #: the stitch emits bare-named segments with their accounting in
        #: `segment_meta` instead of tagged contigs. None: the whole
        #: target.
        self.window_range: tuple[int, int] | None = None
        #: target-range shard (fragment correction): (lo, hi) indices
        #: into the target file. initialize() keeps only those targets;
        #: overlaps onto the others resolve to no target and are skipped.
        #: None: every target.
        self.target_range: tuple[int, int] | None = None
        #: per-contig accounting of a window-range run: {name: {polished,
        #: windows, total_windows, coverage, lo, hi}}, from which the
        #: whole contig's LN / RC / XC tags are re-derived
        self.segment_meta: dict[str, dict] = {}
        #: per target, the grid rank of its first kept window (all zeros
        #: outside range mode)
        self._range_first_rank: list[int] = []
        self.dummy_quality = b"!" * window_length
        self.logger = Logger()
        #: live progress: callable(event dict) or None (the default).
        #: Events carry phase / done / total (emit_progress).
        self.progress_hook = None
        self._progress_phase: str | None = None
        self._progress_hwm: tuple[str, int, int] = ("", 0, 0)
        # built eagerly: two concurrent bar ticks (the pipeline's unpack
        # worker and its fallback pool) must share one lock
        self._progress_lock = threading.Lock()
        #: alignment-phase accounting (reference cudapolisher.cpp:204-206)
        self.n_aligner_pairs = 0
        self.n_aligner_device = 0
        self.n_aligner_host_fallback = 0
        #: the engines of the last run, for their counters
        self.aligner = None
        self.poa = None
        #: wall seconds per phase of the last run
        self.phase_s: dict[str, float] = {}
        #: targets loaded, and those dropped as unpolished, by the last run
        self.n_targets = 0
        self.n_dropped = 0
        #: a server's job identity, read by its window batcher and by
        #: the server (serve/): the job id, the client's trace id, the
        #: tenant, the job's absolute perf_counter deadline, the batcher's
        #: iteration accounting of the last batched pass
        #: (_Ticket.batch_info), its window cache's hits and misses there
        #: (None: no cache consulted), and the K1 / K3 launches the
        #: identity audit made on the job's own thread (not the job's)
        self.serve_job_id: str | None = None
        self.serve_trace_id: str | None = None
        self.serve_audit_launches = [0, 0]
        self.serve_tenant: str | None = None
        self.serve_deadline: float | None = None
        self.serve_batch: dict | None = None
        self.serve_cache: dict | None = None
        self.metrics = MetricsRegistry()
        self.metrics.register(
            "pipeline", lambda: {k: v for k, v in self.stage_stats.items()
                                 if k not in REPORT_KEYS})
        # late-bound lambdas: a reused polisher swaps in fresh counters
        # per run and the registry must follow them
        self.metrics.register("sched",
                              lambda: self.scheduler.stats.snapshot())
        self.metrics.register("latency", lambda: self.hists.snapshot())
        self.metrics.register(
            "aligner", lambda: {
                "pairs": self.n_aligner_pairs,
                "device_pairs": self.n_aligner_device,
                "host_fallbacks": self.n_aligner_host_fallback,
                "band_width": self.cuda_aligner_band_width})

    def _make_pipeline(self) -> DispatchPipeline:
        """One DispatchPipeline per phase, all feeding the shared stage
        counters; depth 0 is the synchronous path."""
        return DispatchPipeline(depth=self.pipeline_depth,
                                stats=self.pipeline_stats,
                                fallback_workers=max(
                                    1, min(4, self.num_threads)),
                                faults=self.faults,
                                device_latency_s=self.device_latency_s,
                                device_latency_x=self.device_latency_x)

    @property
    def stage_stats(self) -> dict:
        """Snapshot of the pipeline stage counters (both phases)."""
        return self.pipeline_stats.snapshot()

    @property
    def occupancy_stats(self) -> dict:
        """Snapshot of the scheduler's per-bucket occupancy counters
        (jobs / batches / lanes / useful vs padded cells / occupancy %
        per engine, plus first-dispatch count and seconds)."""
        return self.scheduler.stats.snapshot()

    @property
    def autotune_decisions(self) -> dict:
        """The winner-table decisions of the current run: (engine,
        kernel, dtype) -> count, kernel "none" for a cold bucket."""
        now = self.autotuner.consults_snapshot()
        return {k: n - self._consults_base.get(k, 0)
                for k, n in sorted(now.items())
                if n > self._consults_base.get(k, 0)}

    @property
    def posture_key(self) -> tuple:
        """This polisher's kernel posture (sched/autotune.posture_key):
        what can change which kernel computes a window's consensus."""
        from ..sched.autotune import posture_key

        return posture_key(self.device, self.score_dtype, self.pack_bases,
                           self.cuda_engine, self.cuda_fused)

    # ------------------------------------------------------- progress
    def emit_progress(self, done, total, phase: str | None = None,
                      **extra) -> None:
        """Push one progress event at the armed hook. Per phase, `done`
        and `total` never decrease (a bar re-armed smaller inside the
        same phase cannot run the client's bar backwards), and emission
        never raises: progress is decoration on a run."""
        hook = self.progress_hook
        if hook is None:
            return
        ph = phase or self._progress_phase or "run"
        # the hook runs inside the lock: two ticks that computed done 5
        # and 6 could otherwise deliver 6, then 5
        with self._progress_lock:
            hwm_phase, hwm_done, hwm_total = self._progress_hwm
            if ph != hwm_phase:
                hwm_done = hwm_total = 0
            d = max(int(done), hwm_done)
            t = max(int(total), hwm_total)
            self._progress_hwm = (ph, d, t)
            ev = {"phase": ph, "done": min(d, t), "total": t}
            ev.update(extra)
            try:
                hook(ev)
            except Exception:  # noqa: BLE001 — see docstring
                pass

    def _progress_tick(self, count: int, total: int) -> None:
        """Logger.on_bar adapter: a bar's bin transitions become progress
        events of the phase that runs."""
        self.emit_progress(min(count, total), total)

    def _arm_progress(self) -> None:
        """Wire the run's logger's bar ticks into the progress hook (at
        each phase start: _reset_run_state swaps the logger)."""
        if self.progress_hook is not None:
            self.logger.on_bar = self._progress_tick

    # ------------------------------------------------------- warm reuse
    def _reset_run_state(self) -> None:
        """Fresh per-run state for a reused polisher: a second
        initialize() + polish() cycle reports its own stage seconds,
        occupancy, aligner counts and phase walls, not a running total,
        and writes the same bytes as a fresh polisher. The process-level
        state (the kernel and host libraries, the lanes' streams, the
        winner table) stays warm."""
        from ..sched import OccupancyStats

        self.hists = HistogramSet()
        self.pipeline_stats = PipelineStats(hists=self.hists)
        self.scheduler.stats = OccupancyStats()
        self.scheduler.stats.hists = self.hists
        self.n_aligner_pairs = 0
        self.n_aligner_device = 0
        self.n_aligner_host_fallback = 0
        self.logger = Logger()
        self.targets_coverages = []
        self.segment_meta = {}
        self._range_first_rank = []
        self.phase_s = {}
        self.n_targets = 0
        self.n_dropped = 0
        self._progress_phase = None
        self._progress_hwm = ("", 0, 0)

    def rebind(self, sequences_path: str, overlaps_path: str,
               target_path: str) -> "Polisher":
        """Point this polisher at a new input triple: parsers rebuilt,
        per-run state reset, the process-level state kept. The next
        initialize() parses the new inputs."""
        if self.windows:
            raise RaconError("Polisher.rebind",
                             "cannot rebind mid-run (windows pending)!")
        self.sparser = create_sequence_parser(sequences_path,
                                              "Polisher.rebind")
        self.oparser = create_overlap_parser(overlaps_path,
                                             "Polisher.rebind")
        self.tparser = create_sequence_parser(target_path,
                                              "Polisher.rebind")
        self._reset_run_state()
        return self

    def redraft(self, polished, workdir: str,
                tag: str = "round") -> tuple[str, str]:
        """The next polishing round in-process: write round k's stitched
        contigs as round k+1's draft, re-map the original reads onto them
        (core/remap.py), and rebind this polisher to the new triple; the
        next initialize() + polish() is round k+1 on the same engines.
        Returns the (draft FASTA, overlaps PAF) paths written under
        `workdir` as `<tag>_draft.fasta` and `<tag>_ovl.paf`. The reads
        are parsed again from the original reads path."""
        import os

        from .remap import remap_overlaps, write_fasta, write_paf

        if not polished:
            raise RaconError("Polisher.redraft",
                             "no polished sequences to re-draft from!")
        reads_path = self.sparser.path
        fasta_path = write_fasta(
            polished, os.path.join(workdir, f"{tag}_draft.fasta"))
        reads: list[Sequence] = []
        rparser = create_sequence_parser(reads_path, "Polisher.redraft")
        rparser.reset()
        rparser.parse(reads, -1)
        rows = remap_overlaps(reads, polished)
        if not rows:
            raise RaconError("Polisher.redraft",
                             "no reads re-mapped onto the new draft!")
        paf_path = write_paf(rows, os.path.join(workdir, f"{tag}_ovl.paf"))
        self.rebind(reads_path, paf_path, fasta_path)
        return fasta_path, paf_path

    # ------------------------------------------------------------------ init
    def initialize(self) -> None:
        if self.windows:
            log_info("[racon_tpu_torch::Polisher.initialize] warning: "
                     "object already initialized!")
            return
        reset_dedup()
        if self._runs_completed:
            self._reset_run_state()
        self._arm_progress()
        t_init = time.perf_counter()
        self._consults_base = self.autotuner.consults_snapshot()
        log = self.logger
        log.log()

        # -- targets (loaded whole; reference polisher.cpp:202-217)
        self.tparser.reset()
        self.tparser.parse(self.sequences, -1)
        target_base = 0
        if self.target_range is not None:
            # keep the targets whose file index lies in [lo, hi); the
            # id_to_id keys below keep the file index, so id-keyed
            # overlaps (MHAP) resolve as name-keyed ones do, and overlaps
            # onto dropped targets resolve to nothing and are skipped
            lo, hi = self.target_range
            total = len(self.sequences)
            lo, hi = max(0, int(lo)), min(int(hi), total)
            if hi <= lo:
                raise RaconError(
                    "Polisher.initialize",
                    f"target_range [{self.target_range[0]}, "
                    f"{self.target_range[1]}) selects no targets out of "
                    f"{total}!")
            del self.sequences[hi:]
            del self.sequences[:lo]
            target_base = lo
        targets_size = len(self.sequences)
        if targets_size == 0:
            raise RaconError("Polisher.initialize", "empty target sequences set!")
        self.n_targets = targets_size

        name_to_id: dict[str, int] = {}
        id_to_id: dict[int, int] = {}
        for i in range(targets_size):
            name_to_id[self.sequences[i].name + "t"] = i
            id_to_id[(target_base + i) << 1 | 1] = i

        has_name = [True] * targets_size
        has_data = [True] * targets_size
        has_reverse_data = [False] * targets_size

        log.log("[racon_tpu_torch::Polisher.initialize] loaded target sequences")
        log.log()

        # -- reads streamed in chunks; duplicates of targets share storage
        #    (reference polisher.cpp:228-264)
        sequences_size = 0
        total_sequences_length = 0
        self.sparser.reset()
        more = True
        while more:
            start = len(self.sequences)
            more = self.sparser.parse(self.sequences, KCHUNK_SIZE)
            kept: list[Sequence] = []
            for seq in self.sequences[start:]:
                total_sequences_length += len(seq.data)
                tgt = name_to_id.get(seq.name + "t")
                if tgt is not None:
                    dup = self.sequences[tgt]
                    if len(seq.data) != len(dup.data) or \
                       len(seq.quality) != len(dup.quality):
                        raise RaconError(
                            "Polisher.initialize",
                            f"duplicate sequence {seq.name} with unequal data")
                    name_to_id[seq.name + "q"] = tgt
                    id_to_id[sequences_size << 1 | 0] = tgt
                else:
                    gid = start + len(kept)
                    name_to_id[seq.name + "q"] = gid
                    id_to_id[sequences_size << 1 | 0] = gid
                    kept.append(seq)
                sequences_size += 1
            del self.sequences[start:]
            self.sequences.extend(kept)

        if sequences_size == 0:
            raise RaconError("Polisher.initialize", "empty sequences set!")

        n_seqs = len(self.sequences)
        has_name += [False] * (n_seqs - targets_size)
        has_data += [False] * (n_seqs - targets_size)
        has_reverse_data += [False] * (n_seqs - targets_size)

        window_type = (WindowType.kNGS
                       if total_sequences_length / sequences_size <= 1000
                       else WindowType.kTGS)

        log.log("[racon_tpu_torch::Polisher.initialize] loaded sequences")
        log.log()

        # -- overlaps streamed; per-query filtering (polisher.cpp:284-355)
        overlaps = self._load_overlaps(name_to_id, id_to_id,
                                       has_data, has_reverse_data)
        if not overlaps and self.target_range is None:
            # a target-range shard may hold only targets without overlaps
            # (they come back unpolished and drop as in a whole run)
            raise RaconError("Polisher.initialize", "empty overlap set!")

        log.log("[racon_tpu_torch::Polisher.initialize] loaded overlaps")
        log.log()

        # -- free unneeded storage; build revcomps where needed
        for i, seq in enumerate(self.sequences):
            seq.transmute(has_name[i], has_data[i], has_reverse_data[i])

        self._progress_phase = "align"
        t_align = time.perf_counter()
        with trace.span("polisher.align_overlaps"):
            self.find_overlap_breaking_points(overlaps)
        self.phase_s["align"] = time.perf_counter() - t_align

        log.log()

        # -- windows (polisher.cpp:384-399); in range mode only the grid
        #    starts lo <= j < hi materialize, and `rank` stays the global
        #    grid rank, so a window's output does not depend on its shard
        rng = self.window_range
        id_to_first_window_id = [0] * (targets_size + 1)
        self._range_first_rank = [0] * targets_size
        for i in range(targets_size):
            data = self.sequences[i].data
            quality = self.sequences[i].quality
            k = 0
            kept = 0
            for j in range(0, len(data), self.window_length):
                if rng is None or rng[0] <= j < rng[1]:
                    length = min(j + self.window_length, len(data)) - j
                    q = quality[j:j + length] if quality \
                        else self.dummy_quality[:length]
                    self.windows.append(create_window(
                        i, k, window_type, data[j:j + length], q))
                    if kept == 0:
                        self._range_first_rank[i] = k
                    kept += 1
                k += 1
            id_to_first_window_id[i + 1] = id_to_first_window_id[i] + kept

        self.targets_coverages = [0] * targets_size

        # -- layer assignment (polisher.cpp:403-457)
        wl = self.window_length
        for o in overlaps:
            self.targets_coverages[o.t_id] += 1
            seq = self.sequences[o.q_id]
            bps = o.breaking_points
            if bps is None:
                continue
            qual_fwd = seq.quality
            has_qual = bool(qual_fwd) or bool(seq._reverse_quality)
            if o.strand:
                data_src = seq.reverse_complement
                qual_src = seq.reverse_quality if has_qual else None
            else:
                data_src = seq.data
                qual_src = qual_fwd if has_qual else None
            qual_arr = (np.frombuffer(qual_src, dtype=np.uint8)
                        if qual_src else None)

            for t_first, q_first, t_last1, q_last1 in bps:
                if q_last1 - q_first < 0.02 * wl:
                    continue
                if qual_arr is not None:
                    avg = float(qual_arr[q_first:q_last1].mean()) - 33.0
                    if avg < self.quality_threshold:
                        continue
                window_start = (t_first // wl) * wl
                if rng is not None and \
                        not rng[0] <= window_start < rng[1]:
                    continue
                window_id = (id_to_first_window_id[o.t_id]
                             + t_first // wl
                             - self._range_first_rank[o.t_id])
                data = data_src[q_first:q_last1]
                qual = (qual_src[q_first:q_last1] if qual_src else None)
                self.windows[window_id].add_layer(
                    data, qual, int(t_first - window_start),
                    int(t_last1 - window_start - 1))
            o.breaking_points = None

        log.log("[racon_tpu_torch::Polisher.initialize] transformed data "
                "into windows")
        # the window total as consensus progress zero: the client's bar
        # knows its denominator before the first batch
        self.emit_progress(0, len(self.windows), phase="consensus")
        t_end = time.perf_counter()
        self.phase_s["initialize"] = t_end - t_init
        self.hists.observe("phase.initialize", t_end - t_init)
        tr = trace.get_tracer()
        if tr is not None:
            tr.complete("polisher.initialize", t_init, t_end,
                        {"windows": len(self.windows),
                         "targets": targets_size})
        flush_dedup()

    def _load_overlaps(self, name_to_id, id_to_id, has_data, has_reverse_data):
        overlaps: list = []
        error_threshold = self.error_threshold
        is_kc = self.type == PolisherType.kC

        def filter_group(group: list) -> list:
            """Drop high-error/self overlaps; for contig polishing keep
            only the longest overlap per query, with the reference's exact
            pass structure (polisher.cpp:284-308): the error check runs
            when the outer scan reaches an overlap, so a high-error
            overlap can still knock out a longer-or-equal earlier one
            before being removed itself, and length ties keep the LATER
            overlap."""
            arr: list = list(group)
            for i in range(len(arr)):
                o = arr[i]
                if o is None:
                    continue
                if o.error > error_threshold or o.q_id == o.t_id:
                    arr[i] = None
                    continue
                if is_kc:
                    for j in range(i + 1, len(arr)):
                        if arr[j] is None:
                            continue
                        if o.length > arr[j].length:
                            arr[j] = None
                        else:
                            arr[i] = None
                            break
            return [o for o in arr if o is not None]

        def keep(group: list) -> None:
            for f in filter_group(group):
                overlaps.append(f)
                if f.strand:
                    has_reverse_data[f.q_id] = True
                else:
                    has_data[f.q_id] = True

        self.oparser.reset()
        pending: list = []   # current same-q_id run
        more = True
        while more:
            chunk: list = []
            more = self.oparser.parse(chunk, KCHUNK_SIZE)
            for o in chunk:
                o.transmute(self.sequences, name_to_id, id_to_id)
                if not o.is_valid:
                    continue
                if pending and pending[0].q_id != o.q_id:
                    keep(pending)
                    pending = []
                pending.append(o)
        keep(pending)
        return overlaps

    # ------------------------------------------------------- alignment phase
    def find_overlap_breaking_points(self, overlaps: list) -> None:
        """Align CIGAR-less overlaps, then walk all CIGARs into per-window
        breaking points (reference polisher.cpp:462-484 /
        cudapolisher.cpp:74-214).

        With cuda_aligner_batches > 0 the device aligner takes every pair
        it can and the host aligns the rest — the reference's GPU->CPU
        fallback (cudapolisher.cpp:203-213): no overlap is ever dropped.
        """
        from ..native import nw_cigar_batch

        need = [o for o in overlaps
                if not o.cigar and o.is_valid and self._range_keeps(o)]
        if need:
            pairs = []
            for o in need:
                q_span = o.aligned_query_span(self.sequences)
                t_span = self.sequences[o.t_id].data[o.t_begin:o.t_end]
                pairs.append((q_span, t_span))

            self.logger.bar_total(len(pairs))
            bar_msg = "[racon_tpu_torch::Polisher.initialize] aligning overlaps"

            def bar_n(n):
                for _ in range(n):
                    self.logger.bar(bar_msg)

            runs = [None] * len(pairs)
            self.n_aligner_pairs = len(pairs)
            handled: set[int] = set()
            if self.cuda_aligner_batches > 0:
                from ..ops.align import BatchAligner

                self.aligner = BatchAligner(
                    band_width=self.cuda_aligner_band_width,
                    device=self.device, score_dtype=self.score_dtype,
                    pack_bases=self.pack_bases, scheduler=self.scheduler,
                    runner=self.device_runner, autotuner=self.autotuner,
                    max_length=self.aligner_max_length)
                pipeline = self._make_pipeline()
                fb: list[tuple[list[int], object]] = []
                # concurrent fallback jobs split the thread budget; at
                # depth 0 they run inline and keep all of it
                fb_threads = (self.num_threads if pipeline.depth == 0
                              else max(1, self.num_threads
                                       // pipeline.fallback_workers))

                def on_reject(idxs):
                    # rejected pairs (unbucketable or band-clipped) start
                    # host-aligning the moment they are known, beside the
                    # device pass (cudapolisher.cpp:203-213)
                    fb.extend(pipeline.map_fallback(
                        idxs,
                        lambda sub: nw_cigar_batch(
                            [pairs[i] for i in sub], n_threads=fb_threads,
                            progress=bar_n),
                        chunk=512))

                try:
                    with torch_profile(self.profile_dir, "align"):
                        runs = self.aligner.align(pairs, progress=bar_n,
                                                  pipeline=pipeline,
                                                  on_reject=on_reject)
                        pipeline.drain_fallback()
                except BaseException:
                    # no fallback thread outlives the failed phase
                    pipeline.cancel_fallback()
                    raise
                finally:
                    pipeline.close()
                for sub, fut in fb:
                    for i, c in zip(sub, fut.result()):
                        need[i].cigar = c
                    handled.update(sub)

            rest = [i for i, r in enumerate(runs)
                    if r is None and i not in handled]
            if rest:
                cigars = nw_cigar_batch([pairs[i] for i in rest],
                                        n_threads=self.num_threads,
                                        progress=bar_n)
                for i, c in zip(rest, cigars):
                    need[i].cigar = c
            for o, r in zip(need, runs):
                if r is not None:
                    o.cigar = cigar_from_ops(r).encode()
            self.n_aligner_host_fallback = (
                len(rest) + len(handled)
                if self.cuda_aligner_batches > 0 else 0)
            self.n_aligner_device = (
                len(pairs) - self.n_aligner_host_fallback
                if self.cuda_aligner_batches > 0 else 0)
            if self.cuda_aligner_batches > 0:
                a = self.aligner
                log_info(f"[racon_tpu_torch::Polisher.initialize] aligned "
                         f"{self.n_aligner_device} overlaps on device, "
                         f"{self.n_aligner_host_fallback} on host "
                         f"({a.n_unbucketed} unbucketable, "
                         f"{a.n_band_rejects} band-clipped or over the "
                         "cost limit); batches by score dtype and operand "
                         f"form: {plan_split(a.batches_by_plan)}")

        for o in overlaps:
            if o.is_valid and o.cigar and self._range_keeps(o):
                o.find_breaking_points(self.sequences, self.window_length)

        self.logger.log("[racon_tpu_torch::Polisher.initialize] aligned "
                        "overlaps")

    def _range_keeps(self, o) -> bool:
        """Whether an overlap can give layers to this run's kept windows
        (always outside range mode). Coverage (RC) counts every overlap
        whatever this says: the layer loop counts it before it reads the
        breaking points, so skipping the aligner and the breaking-point
        walk here saves work and changes no byte."""
        rng = self.window_range
        if rng is None:
            return True
        wl = self.window_length
        length = len(self.sequences[o.t_id].data)
        lo, hi = rng
        # the kept windows' region: window starts are multiples of wl,
        # so membership does not depend on the split points' alignment
        first_start = -(-max(lo, 0) // wl) * wl
        cap = min(hi, length)
        if first_start >= cap:
            return False
        last_start = ((cap - 1) // wl) * wl
        region_hi = min(length, last_start + wl)
        return o.t_begin < region_hi and o.t_end > first_start

    # ---------------------------------------------------------------- polish
    def polish(self, drop_unpolished_sequences: bool = True, batcher=None,
               on_part=None, on_group=None,
               group_size: int = 64) -> list[Sequence]:
        """Per-window consensus + stitch (reference polisher.cpp:486-548).

        `batcher` (a server's serve/batcher.WindowBatcher) takes the
        consensus pass instead of this polisher's own engine: the windows
        join the batcher's device iterations beside other jobs' windows
        and come back an iteration at a time, and each target is stitched
        as soon as its windows are all back (ContigStreamer, or with
        `on_group` FragmentStreamer). `on_part(Sequence)` sees each
        finished target, `on_group(seqs, lo, hi)` each group of
        `group_size` targets. A window's consensus does not depend on the
        windows beside it, so the output equals a run without a
        batcher."""
        if batcher is not None:
            if on_group is not None:
                streamer = FragmentStreamer(self, drop_unpolished_sequences,
                                            on_group, group_size)
            else:
                streamer = ContigStreamer(self, drop_unpolished_sequences,
                                          on_part)
            self.poa = None
            t_c = time.perf_counter()
            batcher.consensus(self, on_windows=streamer.on_windows)
            dst = streamer.finish()
            self.phase_s["consensus"] = (time.perf_counter() - t_c
                                         - streamer.stitch_s)
            t1 = time.perf_counter()
            t0 = t1 - streamer.stitch_s
        else:
            self._consensus_pass()
            t0 = time.perf_counter()
            dst = self._stitch(drop_unpolished_sequences)
            t1 = time.perf_counter()
        self.phase_s["stitch"] = t1 - t0
        self.emit_progress(len(self.windows), len(self.windows),
                           phase="stitch", sequences=len(dst))
        self.hists.observe("phase.stitch", t1 - t0)
        tr = trace.get_tracer()
        if tr is not None:
            tr.complete("polisher.stitch", t0, t1, {"sequences": len(dst)})
        self.logger.log("[racon_tpu_torch::Polisher.polish] generated "
                        "consensus")
        self.logger.total("[racon_tpu_torch::Polisher.] total =")
        self.windows = []
        self.sequences = []
        self._runs_completed += 1
        self.emit_observability()
        return dst

    def _consensus_pass(self) -> None:
        """Run the consensus engine over this run's windows (each window
        ends up with its `consensus` and `polished` set) and log the
        phase's reports."""
        from ..ops.poa import BatchPOA

        self.logger.log()
        self._progress_phase = "consensus"
        self._arm_progress()
        self.emit_progress(0, len(self.windows))
        pipeline = self._make_pipeline()
        # the stage counters accumulate across phases; the line below
        # describes this phase only
        stats_base = self.pipeline_stats.snapshot()
        self.poa = BatchPOA(self.match, self.mismatch, self.gap,
                            self.window_length, num_threads=self.num_threads,
                            device_batches=self.cuda_poa_batches,
                            banded=self.cuda_banded_alignment,
                            logger=self.logger, device=self.device,
                            score_dtype=self.score_dtype,
                            pack_bases=self.pack_bases, pipeline=pipeline,
                            engine=self.cuda_engine, fused=self.cuda_fused,
                            fused_fallback=self.fused_fallback,
                            scheduler=self.scheduler,
                            runner=self.device_runner,
                            autotuner=self.autotuner,
                            host_chunk=self.host_poa_chunk)
        t0 = time.perf_counter()
        with torch_profile(self.profile_dir if self.cuda_poa_batches > 0
                           else None, "consensus"), pipeline:
            self.poa.generate_consensus(self.windows, self.trim)
            if self.device.type == "cuda":
                import torch

                torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        dt = t1 - t0
        self.phase_s["consensus"] = dt
        if self.progress_hook is not None:
            snap = self.scheduler.stats.snapshot()
            self.emit_progress(
                len(self.windows), len(self.windows),
                occupancy={e: round(v["occupancy_pct"], 1)
                           for e, v in snap.items()
                           if "occupancy_pct" in v} or None)
        self.hists.observe("phase.consensus", dt)
        tr = trace.get_tracer()
        if tr is not None:
            tr.complete("polisher.consensus", t0, t1,
                        {"windows": len(self.windows),
                         "engine": self.cuda_engine
                         if self.cuda_poa_batches > 0 else "host"})
        if dt > 0 and self.windows:
            log_info(f"[racon_tpu_torch::Polisher.polish] consensus "
                     f"throughput: {len(self.windows) / dt:.1f} windows/s")
        ss = {k: v - stats_base[k] for k, v in self.stage_stats.items()}
        # overlap evidence: with the pipeline live, pack + device +
        # unpack exceed the phase wall; additive means dead
        log_info(f"[racon_tpu_torch::Polisher.polish] pipeline stages "
                 f"(depth {self.pipeline_depth}): pack {ss['pack_s']:.2f}s "
                 f"device {ss['device_s']:.2f}s unpack {ss['unpack_s']:.2f}s "
                 f"fallback {ss['fallback_s']:.2f}s, {ss['chunks']} chunks / "
                 f"{ss['launches']} launches")
        # occupancy report: how much of the dispatched device shapes was
        # real work (silent on host-only runs)
        occ = self.scheduler.stats.summary()
        if occ:
            log_info(f"[racon_tpu_torch::Polisher.polish] batch occupancy "
                     f"(adaptive={'on' if self.scheduler.adaptive else 'off'})"
                     f": {occ}")
        # the winner table's share of the run's bucket decisions (silent
        # when no posture consulted it)
        dec = self.autotune_decisions
        if dec:
            cold = sum(n for (_, k, _), n in dec.items() if k == "none")
            log_info(f"[racon_tpu_torch::Polisher.polish] autotuner "
                     f"{self.autotuner.path}: {sum(dec.values()) - cold} "
                     f"bucket decisions from the table, {cold} cold ("
                     + ", ".join(f"{e} {k}{':' + d if d else ''} {n}"
                                 for (e, k, d), n in dec.items()) + ")")

    def emit_observability(self) -> None:
        """End-of-run emission, each part a no-op when its knob is off:
        report suppressed duplicate warnings, dump the metrics snapshot
        (`metrics_path`), render the stderr metrics table (when metrics
        are dumped or at debug level), and write the armed trace. An
        unwritable path loses the artifact, not the polished output."""
        flush_dedup()
        if self.metrics_path:
            try:
                self.metrics.dump(self.metrics_path)
                log_info(f"[racon_tpu_torch::obs] metrics written to "
                         f"{self.metrics_path}")
            except OSError as exc:
                log_info(f"[racon_tpu_torch::obs] warning: could not write "
                         f"metrics to {self.metrics_path} ({exc})")
        if self.metrics_path or log_level() >= DEBUG:
            log_info("[racon_tpu_torch::obs] end-of-run metrics:\n"
                     + self.metrics.table())
        try:
            saved = trace.save()
        except OSError as exc:
            saved = None
            log_info(f"[racon_tpu_torch::obs] warning: could not write "
                     f"trace ({exc})")
        if saved:
            log_info(f"[racon_tpu_torch::obs] trace written to {saved} "
                     "(open in https://ui.perfetto.dev)")

    def _contig_slices(self) -> list[tuple[int, int]]:
        """[start, end) window-index ranges, one per target, in target
        order: a target ends where the next window belongs to another
        target id (a range shard's first window has a rank above 0)."""
        slices: list[tuple[int, int]] = []
        start = 0
        for i in range(len(self.windows)):
            if (i == len(self.windows) - 1
                    or self.windows[i + 1].id != self.windows[i].id):
                slices.append((start, i + 1))
                start = i + 1
        return slices

    def _stitch_contig(self, windows: list[Window],
                       drop_unpolished_sequences: bool) -> Sequence | None:
        """Stitch one target's windows (rank-ascending) into a polished
        sequence with the reference's LN/RC/XC tagging
        (polisher.cpp:506-545), `r` before the tags for kF; None (and
        counted in n_dropped) when it is dropped as unpolished."""
        polished_data = bytearray()
        num_polished_windows = 0
        for window in windows:
            num_polished_windows += 1 if window.polished else 0
            polished_data += window.consensus
        last = windows[-1]
        if self.window_range is not None:
            # a range segment: bare name, never dropped; the whole
            # contig's tags and drop rule come from the segments'
            # accounting
            name = self.sequences[last.id].name
            data_len = len(self.sequences[last.id].data)
            wl = self.window_length
            self.segment_meta[name] = {
                "polished": num_polished_windows,
                "windows": len(windows),
                "total_windows": (data_len + wl - 1) // wl,
                "coverage": self.targets_coverages[last.id],
                "lo": self.window_range[0],
                "hi": self.window_range[1],
            }
            return create_sequence(name, bytes(polished_data))
        ratio = num_polished_windows / float(last.rank + 1)
        if drop_unpolished_sequences and ratio <= 0:
            self.n_dropped += 1
            return None
        tags = "r" if self.type == PolisherType.kF else ""
        tags += f" LN:i:{len(polished_data)}"
        tags += f" RC:i:{self.targets_coverages[last.id]}"
        tags += f" XC:f:{ratio:.6f}"
        return create_sequence(self.sequences[last.id].name + tags,
                               bytes(polished_data))

    def _stitch(self, drop_unpolished_sequences: bool) -> list[Sequence]:
        """Stitch per-window consensus back into whole sequences, one
        target at a time."""
        dst: list[Sequence] = []
        self.n_dropped = 0
        for start, end in self._contig_slices():
            seq = self._stitch_contig(self.windows[start:end],
                                      drop_unpolished_sequences)
            if seq is not None:
                dst.append(seq)
        return dst


class ContigStreamer:
    """Incremental stitcher: feed completed windows in any order
    (`on_windows`), receive finished targets in target order. A target
    ships once its last window lands and every earlier target has
    shipped, so the emitted parts concatenate to `Polisher._stitch`'s
    output. `on_part` (callable(Sequence) or None) sees each stitched
    target as it completes; its exceptions are swallowed (streaming is
    decoration on the polish)."""

    def __init__(self, polisher: Polisher, drop_unpolished: bool,
                 on_part=None):
        self._polisher = polisher
        self._drop = drop_unpolished
        self._on_part = on_part
        self._slices = polisher._contig_slices()
        self._remaining = [end - start for start, end in self._slices]
        self._contig_of: dict[int, int] = {}
        for ci, (start, end) in enumerate(self._slices):
            for w in polisher.windows[start:end]:
                self._contig_of[id(w)] = ci
        self._next = 0
        self._out: list[Sequence] = []
        polisher.n_dropped = 0
        #: stitch seconds summed over the deliveries
        self.stitch_s = 0.0

    def _ready(self, windows: list[Window]):
        """Count `windows` delivered, then yield each target that is
        complete in order, stitched (None when dropped)."""
        for w in windows:
            self._remaining[self._contig_of[id(w)]] -= 1
        while (self._next < len(self._slices)
               and self._remaining[self._next] == 0):
            start, end = self._slices[self._next]
            t0 = time.perf_counter()
            seq = self._polisher._stitch_contig(
                self._polisher.windows[start:end], self._drop)
            self.stitch_s += time.perf_counter() - t0
            self._next += 1
            yield seq

    def on_windows(self, windows: list[Window]) -> None:
        for seq in self._ready(windows):
            if seq is None:
                continue
            self._out.append(seq)
            if self._on_part is not None:
                try:
                    self._on_part(seq)
                except Exception:  # noqa: BLE001 — see docstring
                    pass

    def finish(self) -> list[Sequence]:
        """The whole stitched output, equal to `_stitch`'s list, once
        every window was delivered."""
        return self._out


class FragmentStreamer(ContigStreamer):
    """ContigStreamer for fragment correction, where every target is a
    read: corrected reads ship in groups, `on_group(seqs, lo, hi)` once
    per `group_size` consecutive targets, [lo, hi) being the local
    target-index range the group covers. Dropped reads still advance the
    range (a group may be empty), so the groups' ranges tile the targets.
    finish() flushes the last partial group; its list equals `_stitch`'s.
    `on_group`'s exceptions are swallowed."""

    def __init__(self, polisher: Polisher, drop_unpolished: bool,
                 on_group=None, group_size: int = 64):
        super().__init__(polisher, drop_unpolished, on_part=None)
        self._on_group = on_group
        self._group_size = max(1, int(group_size))
        self._pend: list[Sequence] = []
        self._group_lo = 0

    def on_windows(self, windows: list[Window]) -> None:
        for seq in self._ready(windows):
            if seq is not None:
                self._out.append(seq)
                self._pend.append(seq)
            if self._next - self._group_lo >= self._group_size:
                self._flush_group()

    def _flush_group(self) -> None:
        if self._next == self._group_lo:
            return
        group, lo, hi = self._pend, self._group_lo, self._next
        self._pend = []
        self._group_lo = self._next
        if self._on_group is not None:
            try:
                self._on_group(group, lo, hi)
            except Exception:  # noqa: BLE001 — see docstring
                pass

    def finish(self) -> list[Sequence]:
        self._flush_group()
        return self._out
