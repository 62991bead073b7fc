"""PolishServer: a long-lived, warm polishing job server.

The one-shot CLI pays the kernel and host-library loads, engine
construction and the first dispatch of every launch shape on every run.
`PolishServer` keeps one process warm and multiplexes polish requests
through it (the port of the JAX package's racon_tpu/serve/server.py,
first part):

  - one warm engine set: `start()` runs a synthetic job through the full
    path at the server's posture before it accepts;
  - requests flow through a bounded `JobQueue` (admission control with
    retry-after, FIFO within a priority, weighted fair order across
    tenants, per-job deadlines) to a small worker pool; each worker
    parses, aligns (K2 on the device with `cuda_aligner_batches`) and
    windows its job on its own thread;
  - the jobs' windows pool into the continuous `WindowBatcher`, whose
    feeder thread merges them into shared device iterations (K1, or K3
    with the fused engine); finished contigs stitch on the job's thread
    and can stream to the client as `result_part` frames before the job
    ends; the bytes equal a one-shot run's;
  - a job with its own fault plan runs its consensus alone, so its
    injected errors fail that job with a typed error while the server,
    its warm engines and the other jobs go on;
  - SIGTERM (or a `shutdown` request) drains: admission stops, queued
    and running jobs finish, the transport closes.

Jobs share one process and one device: a hard crash (an out-of-memory
kill, a native fault) takes every job in flight down.

Every knob is a `ServeConfig` keyword (and a `serve` flag); no
environment variable sets one. `device` defaults to "cuda": without a
card `start()` raises, and only an explicit "cpu" runs the kernels'
plain versions.

Transport: a unix socket (default) or localhost TCP, length-prefixed
JSON frames (serve/protocol.py). `python -m racon_tpu_torch serve` is
the CLI surface, `serve.client.PolishClient` the Python one.

What a submit may ask for beyond the triple and its options:

  - `rounds: N` (1-64): round k's contigs become round k+1's draft, the
    reads re-mapped in this process (Polisher.redraft); only the last
    round streams, and the response's `rounds` block has each round's
    wall and, with the window cache armed, its hits and misses;
  - `range_lo` / `range_hi`: a window-range shard; its result_part
    frames carry the raw segment and its `seg` accounting;
  - `mode: "fragment"` (read correction, the polisher's kF) with
    optional `frag_lo` / `frag_hi` target-index bounds: corrected reads
    stream in groups of `frag_group`, each frame's `frag` range on the
    whole read set;
  - `ingest` / `subsample` / `normalize`: the inputs parsed (and
    subsampled or pair-normalized) on admit; a file that does not parse
    fails the job there, `bad-request` with `terminal:
    "rejected-ingest"`, and the server goes on.

With `wincache` the batcher answers repeated windows from the window
cache; with `preempt` a higher-priority job parks a lower one's pooled
windows; with `abort_margin` a job that cannot meet its deadline fails
typed `deadline-doomed`.

Worker lanes and the identity audit: `worker_lanes` cuts the batcher's
device list (`devices`, a library keyword with no flag; default the
first job's polisher's lanes, one device for "cuda:N" or "cpu") into
lanes, each with its own feeder (serve/batcher.py); `devices=["cuda:0",
"cuda:0"]` gives two lanes on one card, `[cpu] * 2` two on the CPU.
With `audit_rate` above 0 a WindowAuditor (obs/audit.py) on the
server's device samples every iteration's finished windows and the
window cache's hits; a mismatch is repaired, demotes the winner table
(unless `audit_demote=False`), quarantines the lane that produced it
until a re-probe brings it back (unless `lane_quarantine=False`), and
writes its dual-stream dump into `flight_dir`. `stats_snapshot()` has
the auditor's snapshot under `audit` (None when off).

Observability (each a keyword and a `serve` flag):

  - `scrape` answers Prometheus text (obs/prom.py) over the socket, and
    `metrics_port` (0: ephemeral, published back) serves the same body
    on 127.0.0.1 HTTP as `/metrics`, with `/healthz` (503 while
    draining) beside it;
  - `journal` writes one JSONL line per job transition (obs/journal.py,
    rotated at `journal_max_bytes`); the auditor's lines land in it too;
  - a bounded flight ring (obs/flight.py, `flight_events` spans) is the
    process tracer while the server runs; every failed job and every job
    that misses its deadline gets the ring, windowed to it, dumped into
    `flight_dir` before its waiter wakes, and `debug` lists the dumps
    (with the audit's snapshot and `audit_ack` when the auditor is
    armed); `trace_pull` returns one trace id's spans (at most
    `trace_pull_events`);
  - a job submitted with `trace: true` runs under its own recorder
    (obs/trace.scoped, one such job at a time) and gets its spans back
    with the recorder's base, which the client maps onto its clock
    through `ping`'s `mono_s`;
  - the SLO burn-rate tracker (obs/fleet.py, `slo_*`) journals an
    `alert` line on each change of state, and the job-latency histogram
    carries exemplars (`exemplars=False` drops them);
  - `trace_path` / `metrics_path` write the armed recorder and the stats
    snapshot at drain (the one-shot CLI's `--cuda-trace` /
    `--cuda-metrics`).

The scrape keeps the JAX server's family names. Where the port has no
counterpart of what a family counts, it renders its own: `serve.compiles`
and the occupancy `compiles` count first dispatches of a launch shape
(nothing is compiled per shape); `audit.shadow_compiles` is the oracle's
first dispatches; `serve.aborted_doomed` sums the port's
`doomed_at_admission` and `doomed_mid_run`; `serve.cancelled` is the
server's cancel count; `sched.autotune.consults` carries the port's
kernel plane names. `stats_snapshot()` shows `journal` only when the
journal is armed and `flight` only once a dump was written, the port's
armed-only rule for its blocks.

A router's child jobs (serve/router.py) carry `parent` / `shard` /
`shards`, journaled on their `received` line, and every progress and
`result_part` frame of a job with a trace id carries that id.

Not here: the autoscaler, and the tools that read these artifacts.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import random
import socket
import sys
import tempfile
import threading
import time
from collections import deque

from ..errors import RaconError
from ..obs import fleet as obs_fleet
from ..obs import flight as obs_flight
from ..obs import prom as obs_prom
from ..obs import trace as obs_trace
from ..obs.hist import HistogramSet
from ..obs.journal import DEFAULT_MAX_BYTES as JOURNAL_MAX_BYTES
from ..obs.journal import Journal
from ..utils.logger import log_info
from .batcher import WindowBatcher
from .protocol import (DEFAULT_MAX_FRAME, ProtocolError, error_response,
                       recv_frame, send_frame)
from .queue import (DeadlineDoomed, Draining, Job, JobCancelledError,
                    JobQueue, QueueFull, TenantQuotaExceeded)
from .wincache import DEFAULT_MAX_BYTES

#: request option keys a submit may carry; anything else is rejected
#: with `bad-request` (a typo'd knob must not polish with defaults)
ALLOWED_OPTIONS = frozenset((
    "window_length", "quality_threshold", "error_threshold", "trim",
    "match", "mismatch", "gap", "include_unpolished", "cuda_poa_batches",
    "cuda_aligner_batches", "cuda_aligner_band_width",
    "cuda_banded_alignment", "cuda_engine", "cuda_fused",
    "pipeline_depth", "score_dtype", "pack_bases", "fragment_correction"))

#: the most polishing rounds one submit may ask for
MAX_ROUNDS = 64

#: option key -> the type its value is converted with
_OPTION_TYPES = {"window_length": int, "quality_threshold": float,
                 "error_threshold": float, "trim": bool, "match": int,
                 "mismatch": int, "gap": int, "cuda_poa_batches": int,
                 "cuda_aligner_batches": int,
                 "cuda_aligner_band_width": int,
                 "cuda_banded_alignment": bool, "cuda_engine": str,
                 "cuda_fused": str, "pipeline_depth": int,
                 "score_dtype": str, "pack_bases": bool,
                 "fragment_correction": bool}

#: the options whose value is one of a few words
_OPTION_CHOICES = {"cuda_engine": ("session", "fused"),
                   "cuda_fused": ("auto", "0", "1"),
                   "score_dtype": ("auto", "int32", "int16")}

#: ids that come from clients (trace ids, tenants) ride logs and stats:
#: a boring charset
_ID_OK = frozenset("abcdefghijklmnopqrstuvwxyz"
                   "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_.")


def default_socket() -> str:
    """The unix socket path a server binds and a client dials when none
    is named: in the temporary directory (TMPDIR)."""
    return os.path.join(tempfile.gettempdir(), "racon_tpu_torch_serve.sock")


def default_flight_dir() -> str:
    """Where a server writes its flight dumps when no directory is named:
    in the temporary directory (TMPDIR), used best-effort."""
    return os.path.join(tempfile.gettempdir(), "racon_tpu_torch_flight")


def _parse_tenant_weights(raw) -> dict:
    """Tenant weight table from a dict or a "a=4,b=1,default=1" string;
    malformed entries fail ServeConfig."""
    if not raw:
        return {}
    if isinstance(raw, dict):
        items = list(raw.items())
    else:
        items = []
        for part in str(raw).split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise RaconError("ServeConfig",
                                 f"invalid tenant weight entry {part!r} "
                                 "(expected tenant=weight)")
            items.append(part.split("=", 1))
    out: dict = {}
    for tenant, weight in items:
        try:
            w = float(weight)
        except (TypeError, ValueError):
            raise RaconError("ServeConfig",
                             f"invalid tenant weight {weight!r} for tenant "
                             f"{tenant!r} (expected a number)") from None
        if w <= 0:
            raise RaconError("ServeConfig", f"tenant weight for {tenant!r} "
                                            f"must be positive, got {w}")
        out[str(tenant)] = w
    return out


def _int_or_none(raw) -> int | None:
    return None if raw is None else int(raw)


class ServeConfig:
    """The server's posture: transport, capacity, the feeder's knobs and
    the polish defaults a job inherits where its request names no
    option. Keyword arguments only; an unknown one raises."""

    def __init__(self, **kw):
        #: unix socket path; `port` (an int, 0 = ephemeral, the real
        #: port published back here) switches to localhost TCP
        self.socket_path = kw.pop("socket_path", None) or default_socket()
        self.port = kw.pop("port", None)
        self.workers = max(1, int(kw.pop("workers", 2)))
        self.queue_depth = max(1, int(kw.pop("queue_depth", 16)))
        self.drain_timeout_s = float(kw.pop("drain_timeout_s", 30.0))
        #: the feeder: windows per device iteration at most, and how long
        #: a sparse pool may coalesce before a short iteration
        self.iteration_windows = max(1, int(kw.pop("iteration_windows",
                                                   256)))
        self.max_wait_s = max(0.0, float(kw.pop("max_wait_s", 0.0)))
        #: weighted fair order across tenants ("gold=4,free=1,default=1"),
        #: a hard cap on each tenant's queued jobs (0: off) and burst
        #: tokens above that cap (0: off)
        self.tenant_weights = _parse_tenant_weights(
            kw.pop("tenant_weights", None))
        self.tenant_quota = max(0, int(kw.pop("tenant_quota", 0)))
        self.tenant_burst = max(0, int(kw.pop("tenant_burst", 0)))
        self.warmup = bool(kw.pop("warmup", True))
        #: the largest request frame the server reads
        self.max_frame = int(kw.pop("max_frame", DEFAULT_MAX_FRAME))
        # polish defaults (a request may override each but job_threads:
        # host threads are a server resource)
        self.window_length = kw.pop("window_length", 500)
        self.quality_threshold = kw.pop("quality_threshold", 10.0)
        self.error_threshold = kw.pop("error_threshold", 0.3)
        self.trim = kw.pop("trim", True)
        self.match = kw.pop("match", 3)
        self.mismatch = kw.pop("mismatch", -5)
        self.gap = kw.pop("gap", -4)
        self.job_threads = max(1, int(kw.pop("job_threads", 2)))
        self.device = kw.pop("device", "cuda")
        self.cuda_poa_batches = kw.pop("cuda_poa_batches", 0)
        self.cuda_aligner_batches = kw.pop("cuda_aligner_batches", 0)
        self.cuda_aligner_band_width = kw.pop("cuda_aligner_band_width", 0)
        self.cuda_banded_alignment = kw.pop("cuda_banded_alignment", False)
        self.cuda_engine = kw.pop("cuda_engine", "session")
        self.cuda_fused = kw.pop("cuda_fused", "auto")
        self.score_dtype = kw.pop("score_dtype", "auto")
        self.pack_bases = kw.pop("pack_bases", True)
        self.pipeline_depth = kw.pop("pipeline_depth", 2)
        self.adaptive_buckets = bool(kw.pop("adaptive_buckets", False))
        self.autotune_table = kw.pop("autotune_table", None)
        #: every job's device-aligner length envelope, simulated device
        #: latency and host POA chunk (create_polisher's knobs of the same
        #: names; none changes a job's bytes)
        #: (None: the engines' own defaults)
        self.aligner_max_length = _int_or_none(
            kw.pop("aligner_max_length", None))
        self.device_latency_s = float(kw.pop("device_latency_s", 0.0))
        self.device_latency_x = float(kw.pop("device_latency_x", 0.0))
        self.host_poa_chunk = _int_or_none(kw.pop("host_poa_chunk", None))
        #: the content-addressed window cache (off by default): a window
        #: whose content, engine key and kernel posture were polished
        #: before skips the device (serve/wincache.py), LRU-bounded by
        #: payload bytes
        self.wincache = bool(kw.pop("wincache", False))
        self.wincache_max_bytes = int(kw.pop("wincache_max_bytes",
                                             DEFAULT_MAX_BYTES))
        if self.wincache_max_bytes <= 0:
            raise RaconError("ServeConfig",
                             f"invalid wincache_max_bytes "
                             f"{self.wincache_max_bytes} (expected a "
                             "positive integer)")
        #: corrected reads a fragment job streams per result_part frame
        self.frag_group = int(kw.pop("frag_group", 64))
        if self.frag_group <= 0:
            raise RaconError("ServeConfig",
                             f"invalid frag_group {self.frag_group} "
                             "(expected a positive integer)")
        #: QoS, off by default: a newly admitted job of a higher priority
        #: preempts a running lower one (its pooled windows park between
        #: iterations), and a job whose predicted finish lies past its
        #: deadline by more than `abort_margin` seconds fails typed, at
        #: admission and at iteration boundaries (None: off)
        self.preempt = bool(kw.pop("preempt", False))
        margin = kw.pop("abort_margin", None)
        self.abort_margin = None if margin is None else max(0.0,
                                                            float(margin))
        #: worker lanes over `devices` (None: the first job's polisher's
        #: lanes); the count clamps to the devices
        self.worker_lanes = max(1, int(kw.pop("worker_lanes", 1)))
        devices = kw.pop("devices", None)
        self.devices = None
        if devices is not None:
            import torch

            self.devices = [torch.device(d) for d in devices]
            if not self.devices:
                raise RaconError("ServeConfig", "empty device list")
        #: the identity audit (off at 0): the sampled fraction of finished
        #: windows, whether a mismatch demotes the winner table and
        #: quarantines its lane, and where its dual-stream dumps go
        self.audit_rate = min(1.0, max(0.0, float(kw.pop("audit_rate",
                                                         0.0))))
        self.audit_demote = bool(kw.pop("audit_demote", True))
        self.lane_quarantine = bool(kw.pop("lane_quarantine", True))
        #: the metrics HTTP port: None serves none (the scrape RPC always
        #: answers), an int (0: ephemeral, the real port published back
        #: here) serves Prometheus text on 127.0.0.1
        metrics_port = kw.pop("metrics_port", None)
        self.metrics_port = (None if metrics_port is None
                             else int(metrics_port))
        if self.metrics_port is not None and self.metrics_port < 0:
            raise RaconError("ServeConfig",
                             f"invalid metrics port {self.metrics_port} "
                             "(expected >= 0; 0 = ephemeral)")
        #: where failed and late jobs' flight dumps (and the audit's
        #: dual-stream dumps) go; "" or None writes none (the ring stays
        #: on). Only a directory the caller chose is checked strictly at
        #: start(): the default is used best-effort, dump by dump
        self.flight_dir_explicit = "flight_dir" in kw
        self.flight_dir = kw.pop("flight_dir", default_flight_dir())
        #: the flight ring's capacity (spans) and the most spans one
        #: trace_pull returns
        self.flight_events = int(kw.pop("flight_events",
                                        obs_flight.DEFAULT_CAPACITY))
        self.trace_pull_events = int(kw.pop("trace_pull_events",
                                            obs_flight.DEFAULT_PULL_EVENTS))
        #: the JSONL lifecycle journal (None: off), rotated past
        #: `journal_max_bytes`; an unwritable path fails start()
        self.journal_path = kw.pop("journal", None) or None
        self.journal_max_bytes = int(kw.pop("journal_max_bytes",
                                            JOURNAL_MAX_BYTES))
        #: job-latency exemplars (trace id, flight dump) in the scrape
        self.exemplars = bool(kw.pop("exemplars", True))
        #: the SLO burn-rate tracker: allowed deadline-miss rate, the
        #: fast and slow windows in seconds, the burn multiple that fires
        self.slo_budget = float(kw.pop("slo_budget",
                                       obs_fleet.DEFAULT_BUDGET))
        self.slo_burn_fast_s = float(kw.pop("slo_burn_fast_s",
                                            obs_fleet.DEFAULT_FAST_S))
        self.slo_burn_slow_s = float(kw.pop("slo_burn_slow_s",
                                            obs_fleet.DEFAULT_SLOW_S))
        self.slo_burn_threshold = float(kw.pop(
            "slo_burn_threshold", obs_fleet.DEFAULT_THRESHOLD))
        #: written at drain: the armed recorder's Chrome trace (the ring
        #: is then a full recorder) and the stats snapshot as JSON
        self.trace_path = kw.pop("trace_path", None) or None
        self.metrics_path = kw.pop("metrics_path", None) or None
        if kw:
            raise RaconError("ServeConfig",
                             f"unknown option(s): {', '.join(sorted(kw))}")

    @property
    def address(self) -> str:
        return (f"127.0.0.1:{self.port}" if self.port is not None
                else self.socket_path)


def make_synth_dataset(dirname: str, seed: int = 11,
                       genome_len: int = 2000, read_len: int = 400,
                       step: int = 100,
                       contigs: int = 1) -> tuple[str, str, str]:
    """Tiny deterministic ONT-shaped dataset (reads / PAF / draft, gzip):
    the warm-up job's input, also used by the serve tests. Overlength
    pairs are included so the device aligner's host fallback warms too.
    `contigs` > 1 writes that many independent draft contigs, each with
    its own reads and PAF rows. The same files as the JAX package's
    function of the same name at the same arguments."""
    from ..synth import ACGT, mutate

    rng = random.Random(seed)
    reads, paf, drafts = [], [], []
    for c in range(max(1, contigs)):
        cname = "draft" if contigs <= 1 else f"ctg{c:02d}"
        truth = bytes(rng.choice(ACGT) for _ in range(genome_len))
        draft = mutate(rng, truth, 0.04)
        jobs = [(start, read_len)
                for start in range(0, genome_len - read_len, step)]
        jobs += [(0, genome_len - 700), (600, genome_len - 700)]
        for k, (start, length) in enumerate(jobs):
            read = mutate(rng, truth[start:start + length], 0.05)
            rname = f"r{k}" if contigs <= 1 else f"r{c:02d}_{k}"
            reads.append((rname, read))
            t_end = min(start + length, len(draft))
            paf.append(f"{rname}\t{len(read)}\t0\t{len(read)}\t+\t"
                       f"{cname}\t{len(draft)}\t{start}\t{t_end}\t"
                       f"{length}\t{length}\t60")
        drafts.append((cname, draft))
    paths = (os.path.join(dirname, "reads.fasta.gz"),
             os.path.join(dirname, "ovl.paf.gz"),
             os.path.join(dirname, "draft.fasta.gz"))
    with gzip.open(paths[0], "wb") as f:
        for name, read in reads:
            f.write(b">" + name.encode() + b"\n" + read + b"\n")
    with gzip.open(paths[1], "wb") as f:
        f.write(("\n".join(paf) + "\n").encode())
    with gzip.open(paths[2], "wb") as f:
        for cname, draft in drafts:
            f.write(b">" + cname.encode() + b"\n" + draft + b"\n")
    return paths


def make_fragment_dataset(dirname: str, seed: int = 13,
                          genome_len: int = 2000, read_len: int = 400,
                          step: int = 100) -> tuple[str, str, str]:
    """Tiny deterministic read-correction dataset for fragment jobs:
    staggered noisy reads off one truth genome and their all-vs-all PAF
    rows between reads that share at least a quarter read of truth.
    Returns (sequences, overlaps, target) where sequences and target are
    the same reads file, the shape of `python -m racon_tpu_torch -f
    reads ava.paf reads`. The same files as the JAX package's function
    of the same name at the same arguments."""
    from ..synth import ACGT, mutate

    rng = random.Random(seed)
    truth = bytes(rng.choice(ACGT) for _ in range(genome_len))
    reads: list[tuple[str, bytes, int, int]] = []
    for k, start in enumerate(range(0, genome_len - read_len + 1, step)):
        end = min(start + read_len, genome_len)
        reads.append((f"f{k}", mutate(rng, truth[start:end], 0.05), start,
                      end))
    paf = []
    for qn, qd, qs0, qe0 in reads:
        for tn, td, ts0, te0 in reads:
            if qn == tn:
                continue
            ov0, ov1 = max(qs0, ts0), min(qe0, te0)
            if ov1 - ov0 < read_len // 4:
                continue
            # the truth overlap on each noisy read, clamped to its length
            qlo = min(max(0, ov0 - qs0), len(qd))
            qhi = min(ov1 - qs0, len(qd))
            tlo = min(max(0, ov0 - ts0), len(td))
            thi = min(ov1 - ts0, len(td))
            if qhi <= qlo or thi <= tlo:
                continue
            paf.append(f"{qn}\t{len(qd)}\t{qlo}\t{qhi}\t+\t"
                       f"{tn}\t{len(td)}\t{tlo}\t{thi}\t"
                       f"{qhi - qlo}\t{qhi - qlo}\t60")
    reads_path = os.path.join(dirname, "frags.fasta.gz")
    ovl_path = os.path.join(dirname, "frags_ava.paf.gz")
    with gzip.open(reads_path, "wb") as f:
        for name, data, _s, _e in reads:
            f.write(b">" + name.encode() + b"\n" + data + b"\n")
    with gzip.open(ovl_path, "wb") as f:
        f.write(("\n".join(paf) + "\n").encode())
    return reads_path, ovl_path, reads_path


def _good_id(val) -> bool:
    """Whether a client id (trace id, tenant) is 1-64 chars of the
    boring charset."""
    return (isinstance(val, str) and 0 < len(val) <= 64
            and set(val) <= _ID_OK)


def _bad_bounds(lo, hi) -> bool:
    """Whether a request's [lo, hi) is not two integers (booleans
    refused) with 0 <= lo < hi."""
    return (any(isinstance(v, bool) or not isinstance(v, int)
                for v in (lo, hi)) or lo < 0 or hi <= lo)


def _job_launches(polisher=None) -> tuple[int, int, int]:
    """K1's, K2's and K3's launches on the calling thread so far, less
    those the identity audit made there for `polisher`'s job."""
    from ..ops import align_kernels, poa_fused_kernels, poa_kernels

    a1, a3 = polisher.serve_audit_launches if polisher is not None \
        else (0, 0)
    return (poa_kernels.counter.on_thread() - a1,
            align_kernels.counter.on_thread(),
            poa_fused_kernels.counter.on_thread() - a3)


class PolishServer:
    def __init__(self, config: ServeConfig | None = None, **overrides):
        from ..sched import BatchScheduler

        self.config = (config if config is not None
                       else ServeConfig(**overrides))
        cfg = self.config
        #: lifetime latency histograms: job latency, queue wait, device
        #: iterations, pipeline stages, first dispatches
        self.hists = HistogramSet()
        self.queue = JobQueue(cfg.queue_depth, workers=cfg.workers,
                              hists=self.hists,
                              tenant_weights=cfg.tenant_weights,
                              tenant_quota=cfg.tenant_quota,
                              tenant_burst=cfg.tenant_burst,
                              abort_margin=cfg.abort_margin)
        self.batcher = WindowBatcher(
            iteration_windows=cfg.iteration_windows,
            max_wait_s=cfg.max_wait_s,
            scheduler=BatchScheduler(adaptive=cfg.adaptive_buckets),
            worker_lanes=cfg.worker_lanes, devices=cfg.devices)
        self.batcher.abort_margin = cfg.abort_margin
        if cfg.wincache:
            from .wincache import WindowCache

            self.batcher.wincache = WindowCache(
                max_bytes=cfg.wincache_max_bytes)
        self.batcher.hists = self.hists
        self.batcher.pipeline_stats.hists = self.hists
        self.batcher.scheduler.stats.hists = self.hists
        #: the identity auditor, built only when armed
        self.auditor = None
        if cfg.audit_rate > 0.0:
            from ..obs.audit import WindowAuditor

            self.auditor = WindowAuditor(
                cfg.audit_rate, flight_dir=cfg.flight_dir or None,
                on_alert=self._on_audit_alert, device=cfg.device,
                demote=cfg.audit_demote, quarantine=cfg.lane_quarantine,
                hists=self.hists)
            self.batcher.auditor = self.auditor
        #: running jobs by id (the cancel RPC's lookup) and the lifetime
        #: count of cancelled jobs, under `_run_lock`
        self._run_lock = threading.Lock()
        self._running: dict[str, Job] = {}
        self.cancelled = 0
        #: QoS, under `_run_lock`: the running jobs parked by preemption,
        #: and the lifetime counters (stats show them once armed or
        #: counted)
        self._preempted: dict[str, Job] = {}
        self.qos = {"preemptions": 0, "resumes": 0,
                    "doomed_at_admission": 0, "doomed_mid_run": 0}
        #: rounds jobs seen, rounds completed, rounds jobs running
        self._rounds_lock = threading.Lock()
        self._rounds = {"jobs": 0, "completed": 0, "inflight": 0}
        #: admit-time ingest's rewritten inputs: one directory per
        #: server, made at the first ingest job, removed by drain()
        self._ingest_dir: str | None = None
        self._ingest_lock = threading.Lock()
        self._listener: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._conns: set[socket.socket] = set()
        self._conn_lock = threading.Lock()
        self._job_seq = 0
        self._job_seq_lock = threading.Lock()
        self._inflight = 0
        self._idle = threading.Condition()
        self._stop_workers = threading.Event()
        self._draining = threading.Event()
        self._stopped = threading.Event()
        self._drained_clean = False
        self._t_start = time.perf_counter()
        #: wall-clock start: the scrape's start_time gauge tells a
        #: restarted server from a quiet one
        self._t_wall_start = time.time()
        self._warm: dict | None = None
        #: the lifecycle journal, opened by start() when configured
        self.journal: Journal | None = None
        #: the flight source: the ring start() installs (or the full
        #: recorder of `trace_path`), the dumps written so far
        self._flight: obs_trace.TraceRecorder | None = None
        self._flight_installed = False
        self._dumps: deque = deque(maxlen=8)
        self._http = None
        #: the SLO burn-rate tracker, sampled on every deadline-carrying
        #: job; this process's counters are born with it (seed_zero)
        self.burn = obs_fleet.BurnRateTracker(
            budget=cfg.slo_budget, fast_s=cfg.slo_burn_fast_s,
            slow_s=cfg.slo_burn_slow_s, threshold=cfg.slo_burn_threshold,
            seed_zero=True)
        self.queue.on_slo = self._on_slo
        self.queue.on_event = self._on_queue_event
        #: the scrape's self-metered cost: bodies rendered and the
        #: seconds spent rendering them
        self._scrape_count = 0
        self._scrape_render_s = 0.0
        self._scrape_lock = threading.Lock()

    def _ingest_workdir(self) -> str:
        with self._ingest_lock:
            if self._ingest_dir is None:
                self._ingest_dir = tempfile.mkdtemp(
                    prefix="racon_torch_ingest_")
            return self._ingest_dir

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "PolishServer":
        """Check the device, warm up (unless disabled), bind the
        transport, start the workers and the accept loop. Returns self,
        accepting."""
        from ..device import resolve

        cfg = self.config
        # a card that is not there fails the start, warm-up or not, before
        # anything below is armed
        resolve(cfg.device)
        for d in cfg.devices or ():
            resolve(d)
        # an operator who chose a dump directory or a journal learns now
        # that the path is unusable, not at the first failed job
        if cfg.flight_dir and cfg.flight_dir_explicit:
            try:
                os.makedirs(cfg.flight_dir, exist_ok=True)
                probe = os.path.join(cfg.flight_dir,
                                     f".probe_{os.getpid()}")
                with open(probe, "w"):
                    pass
                os.unlink(probe)
            except OSError as exc:
                raise RaconError(
                    "PolishServer.start",
                    f"flight dump directory {cfg.flight_dir!r} is not "
                    f"writable ({exc}); point --flight-dir at a writable "
                    "directory, or '' to write no dumps") from None
        if cfg.journal_path:
            try:
                self.journal = Journal(cfg.journal_path,
                                       max_bytes=cfg.journal_max_bytes)
            except OSError as exc:
                raise RaconError(
                    "PolishServer.start",
                    f"cannot open serve journal {cfg.journal_path!r} "
                    f"({exc}); point --journal at a writable path") \
                    from None
        if self.auditor is not None:
            # the auditor's mismatch, lane and alert lines join the
            # server's journal, keyed by the owning job
            self.auditor.journal = self.journal
        # the flight ring is the process tracer while the server runs, so
        # every span hook feeds it; with `trace_path` a full recorder
        # takes its place and doubles as the flight source
        if cfg.trace_path:
            self._flight = obs_trace.configure(cfg.trace_path)
        else:
            self._flight = obs_trace.install(
                obs_flight.FlightRecorder(cfg.flight_events))
            self._flight_installed = True
        try:
            self._bind_and_serve()
        except BaseException:
            self._disarm_observability()
            if self.journal is not None:
                self.journal.close()
            raise
        if self.journal is not None:
            self.journal.record("serve-start", address=cfg.address,
                                pid=os.getpid(), workers=cfg.workers,
                                queue_depth=cfg.queue_depth)
        log_info(f"[racon_tpu_torch::serve] listening on {cfg.address} "
                 f"({cfg.workers} workers, queue depth {cfg.queue_depth}, "
                 f"device {cfg.device}"
                 + (f", warm in {self._warm['warmup_s']:.2f}s"
                    if self._warm else "")
                 + (f", metrics on 127.0.0.1:{cfg.metrics_port}"
                    if self._http is not None else "")
                 + (f", journal {cfg.journal_path}"
                    if self.journal is not None else "") + ")")
        return self

    def _bind_and_serve(self) -> None:
        """start()'s second half: warm up, open the metrics port, bind the
        transport, start the workers and the accept loop."""
        cfg = self.config
        if cfg.warmup:
            self.warmup()
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
        for i in range(cfg.workers):
            t = threading.Thread(target=self._worker,
                                 name=f"racon-torch-serve-worker-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._accept_loop,
                             name="racon-torch-serve-accept", daemon=True)
        t.start()
        self._threads.append(t)

    def _disarm_observability(self) -> None:
        """Close the metrics port and uninstall the recorder start()
        armed (only if it is still the process tracer): a later server or
        one-shot run in this process finds no tracer armed."""
        if self._http is not None:
            with contextlib.suppress(Exception):
                self._http.shutdown()
                self._http.server_close()
            self._http = None
        if (self._flight is not None
                and obs_trace.get_tracer() is self._flight):
            obs_trace.reset()

    def _on_queue_event(self, event: str, job: Job, **fields) -> None:
        """The queue's on_event sink: journal the transition. `admitted`,
        `expired` and `cancelled` arrive under the queue mutex, so they
        are staged (kept in memory, in order) rather than written: a slow
        disk must not serialize every submit behind it; the handler
        flushes them once its job resolves."""
        if self.journal is None:
            return
        if event == "cancelled":
            # a queued job cancelled never started: it leaves as an
            # expiry with the reason pinned, after the typed annotation
            self.journal.stage(event, job=job.id, trace=job.trace_id,
                               **fields)
            self.journal.stage("expired", job=job.id, trace=job.trace_id,
                               reason="cancelled")
        elif event in ("admitted", "expired"):
            self.journal.stage(event, job=job.id, trace=job.trace_id,
                               **fields)
        else:
            self.journal.record(event, job=job.id, trace=job.trace_id,
                                **fields)

    def _on_slo(self, job: Job, hit: int, miss: int) -> None:
        """The queue's on_slo sink: sample the burn-rate tracker with the
        cumulative deadline counters; a change of state journals a typed
        `alert` line naming the job that tripped or cleared it."""
        res = self.burn.sample(hit, miss)
        if not res["changed"]:
            return
        if self.journal is not None:
            self.journal.record(
                "alert", job=job.id, trace=job.trace_id, kind="slo-burn",
                state="firing" if res["firing"] else "clear",
                burn_fast=res["fast"], burn_slow=res["slow"],
                threshold=res["threshold"], deadline_hit=hit,
                deadline_miss=miss)
        log_info(f"[racon_tpu_torch::serve] SLO burn alert "
                 f"{'FIRING' if res['firing'] else 'clear'}: fast "
                 f"{res['fast']:g}x / slow {res['slow']:g}x of budget "
                 f"(threshold {res['threshold']:g}x, {miss} deadline "
                 f"misses)")

    def _start_metrics_http(self) -> None:
        """Serve Prometheus text and the health body on 127.0.0.1 HTTP
        (standard library only). A port that cannot be bound fails
        start(); once up, a handler error answers 500 and never reaches
        the server."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        polish_server = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                try:
                    path = self.path.split("?", 1)[0]
                    if path in ("/metrics", "/"):
                        body = polish_server.prometheus_text().encode()
                        code, ctype = 200, obs_prom.CONTENT_TYPE
                    elif path == "/healthz":
                        # a draining server answers 503 so a balancer
                        # stops routing to it; the body says why
                        doc = polish_server.healthz_snapshot()
                        body = (json.dumps(doc, sort_keys=True)
                                + "\n").encode()
                        code = 200 if doc["ok"] else 503
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except Exception as exc:  # noqa: BLE001 — see docstring
                    with contextlib.suppress(Exception):
                        self.send_error(500,
                                        f"{type(exc).__name__}: {exc}")

            def log_message(self, *args):  # scrapes do not log
                pass

        httpd = ThreadingHTTPServer(("127.0.0.1", self.config.metrics_port),
                                    _Handler)
        httpd.daemon_threads = True
        self.config.metrics_port = httpd.server_address[1]
        self._http = httpd
        threading.Thread(target=httpd.serve_forever,
                         name="racon-torch-serve-metrics-http",
                         daemon=True).start()

    def _polisher(self, paths, opts: dict, fault_plan=None):
        """A job's polisher: the request's options over the server's
        defaults."""
        from ..core.polisher import PolisherType, create_polisher

        cfg = self.config

        def opt(key):
            val = opts.get(key, getattr(cfg, key))
            conv = _OPTION_TYPES.get(key)
            return conv(val) if conv is not None else val

        kind = (PolisherType.kF if opts.get("fragment_correction")
                else PolisherType.kC)
        return create_polisher(
            *paths, kind, opt("window_length"),
            opt("quality_threshold"), opt("error_threshold"), opt("trim"),
            opt("match"), opt("mismatch"), opt("gap"),
            num_threads=cfg.job_threads,
            cuda_poa_batches=opt("cuda_poa_batches"),
            cuda_banded_alignment=opt("cuda_banded_alignment"),
            cuda_aligner_batches=opt("cuda_aligner_batches"),
            cuda_aligner_band_width=opt("cuda_aligner_band_width"),
            device=cfg.device, score_dtype=opt("score_dtype"),
            pack_bases=opt("pack_bases"),
            pipeline_depth=opt("pipeline_depth"),
            cuda_engine=opt("cuda_engine"), cuda_fused=opt("cuda_fused"),
            adaptive_buckets=cfg.adaptive_buckets,
            autotune_table=cfg.autotune_table, fault_plan=fault_plan,
            aligner_max_length=cfg.aligner_max_length,
            device_latency_s=cfg.device_latency_s,
            device_latency_x=cfg.device_latency_x,
            host_poa_chunk=cfg.host_poa_chunk)

    def warmup(self, paths: tuple[str, str, str] | None = None) -> dict:
        """Run one job end to end through the batcher at the server's
        posture (synthetic by default, or the caller's triple), so the
        libraries load and the engines' launch shapes are first
        dispatched before the first request."""
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if paths is None:
                tmp = stack.enter_context(tempfile.TemporaryDirectory(
                    prefix="racon_torch_serve_warm_"))
                paths = make_synth_dataset(tmp)
            polisher = self._polisher(paths, {})
            polisher.initialize()
            polisher.polish(True, batcher=self.batcher)
        compiles, compile_s = self.batcher._compile_totals()
        self._warm = {"warmup_s": round(time.perf_counter() - t0, 3),
                      "compiles": compiles,
                      "compile_s": round(compile_s, 3)}
        return self._warm

    def healthz_snapshot(self) -> dict:
        draining = self._draining.is_set()
        return {"ok": not draining, "draining": draining,
                "warm": self._warm is not None,
                "uptime_s": round(time.perf_counter() - self._t_start, 3),
                "queue_depth": len(self.queue),
                "inflight": self._inflight_count()}

    def drain(self, timeout: float | None = None) -> bool:
        """Graceful shutdown: stop admitting, finish queued and running
        jobs (bounded by `timeout`, default config.drain_timeout_s),
        close the transport. True when everything finished in time; a
        second call waits for the first and returns its result."""
        if self._draining.is_set():
            self._stopped.wait()
            return self._drained_clean
        self._draining.set()
        budget = (timeout if timeout is not None
                  else self.config.drain_timeout_s)
        if self.journal is not None:
            self.journal.record("drain", queued=len(self.queue),
                                inflight=self._inflight_count(),
                                budget_s=round(budget, 1))
        log_info(f"[racon_tpu_torch::serve] draining: {len(self.queue)} "
                 f"queued, {self._inflight_count()} in flight (budget "
                 f"{budget:.0f}s)")
        self.queue.drain()
        if self._listener is not None:
            with contextlib.suppress(OSError):
                self._listener.close()
        deadline = time.monotonic() + budget
        clean = True
        with self._idle:
            while len(self.queue) or self._inflight:
                left = deadline - time.monotonic()
                if left <= 0:
                    clean = False
                    break
                self._idle.wait(min(left, 0.2))
        self._stop_workers.set()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=2.0)
        # no straggler iteration once the jobs are done (or over budget)
        self.batcher.close()
        if self.auditor is not None:
            self.auditor.close()
        # the trace and metrics artifacts are written before the
        # connections drop, then the port closes and the ring goes
        self._flush_observability()
        self._disarm_observability()
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
        if self._ingest_dir is not None:
            import shutil

            shutil.rmtree(self._ingest_dir, ignore_errors=True)
            self._ingest_dir = None
        q = self.queue.counters
        b = self.batcher.snapshot()
        log_info(f"[racon_tpu_torch::serve] drained "
                 f"{'cleanly' if clean else 'OVER BUDGET'}: jobs "
                 f"admitted {q['admitted']}, completed {q['completed']}, "
                 f"failed {q['failed']}, expired or cancelled in queue "
                 f"{q['expired']}, full-queue rejects {q['rejected_full']}; "
                 f"device iterations {b['iterations']} (shared "
                 f"{b['shared_iterations']})")
        if self.journal is not None:
            self.journal.record("serve-stop", clean=clean,
                                completed=q["completed"], failed=q["failed"])
            self.journal.close()
        self._drained_clean = clean
        self._stopped.set()
        return clean

    def _flush_observability(self) -> None:
        """Write `metrics_path` (the stats snapshot) and `trace_path` (the
        armed recorder) when configured. An unwritable path loses the
        artifact, not the drain."""
        cfg = self.config
        if cfg.metrics_path:
            try:
                with open(cfg.metrics_path, "w") as fh:
                    json.dump(self.stats_snapshot(), fh, indent=2,
                              sort_keys=True)
                log_info(f"[racon_tpu_torch::serve] metrics written to "
                         f"{cfg.metrics_path}")
            except OSError as exc:
                log_info(f"[racon_tpu_torch::serve] warning: could not "
                         f"write metrics ({exc})")
        if cfg.trace_path and self._flight is not None:
            try:
                self._flight.save(cfg.trace_path)
                log_info(f"[racon_tpu_torch::serve] trace written to "
                         f"{cfg.trace_path}")
            except OSError as exc:
                log_info(f"[racon_tpu_torch::serve] warning: could not "
                         f"write trace ({exc})")

    # ----------------------------------------------------------- serving
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
                             name="racon-torch-serve-conn",
                             daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
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
                    resp = self._dispatch(req, conn)
                except Exception as exc:  # noqa: BLE001 — a handler bug
                    # answers typed and the server keeps serving
                    resp = error_response("internal",
                                          f"{type(exc).__name__}: {exc}")
                try:
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

    def _dispatch(self, req: dict, conn: socket.socket) -> dict:
        rtype = req.get("type")
        if rtype == "submit":
            return self._submit(req, conn)
        if rtype == "ping":
            # mono_s is the clock handshake's sample: a tracing client
            # brackets it by the round trip to estimate this process's
            # perf_counter offset (client.clock_sync)
            return {"type": "pong", "warm": self._warm is not None,
                    "uptime_s": round(
                        time.perf_counter() - self._t_start, 3),
                    "mono_s": time.perf_counter()}
        if rtype == "stats":
            return dict(self.stats_snapshot(), type="stats")
        if rtype == "healthz":
            return dict(self.healthz_snapshot(), type="healthz")
        if rtype == "scrape":
            return {"type": "metrics", "content_type": obs_prom.CONTENT_TYPE,
                    "text": self.prometheus_text()}
        if rtype == "debug":
            max_events = req.get("max_events", 5000)
            if isinstance(max_events, bool) or not isinstance(max_events,
                                                              int):
                return error_response("bad-request",
                                      "max_events must be an integer")
            resp = self.debug_snapshot(max_events)
            if self.auditor is not None:
                # the operator's acknowledgement clears the audit alert
                # (gauge and journal) until the next mismatch
                if req.get("audit_ack"):
                    resp["audit_ack"] = self.auditor.ack()
                resp["audit"] = self.auditor.snapshot()
            return resp
        if rtype == "trace_pull":
            return self._trace_pull(req)
        if rtype == "cancel":
            return self._cancel(req)
        if rtype == "shutdown":
            threading.Thread(target=self.drain,
                             name="racon-torch-serve-drain",
                             daemon=True).start()
            return {"type": "ok", "message": "draining"}
        return error_response("bad-request",
                              f"unknown request type {rtype!r}")

    def _submit(self, req: dict, conn: socket.socket) -> dict:
        from ..resilience import FaultPlan

        for key in ("sequences", "overlaps", "target"):
            path = req.get(key)
            if not isinstance(path, str) or not path:
                return error_response("bad-request",
                                      f"missing input path {key!r}")
            if not os.path.isfile(path):
                return error_response("bad-request",
                                      f"{key} file not found: {path}")
        options = req.get("options") or {}
        if not isinstance(options, dict):
            return error_response("bad-request", "options must be an object")
        unknown = set(options) - ALLOWED_OPTIONS
        if unknown:
            return error_response(
                "bad-request",
                f"unknown option(s): {', '.join(sorted(unknown))}")
        for key, conv in _OPTION_TYPES.items():
            if key not in options:
                continue
            try:
                conv(options[key])
            except (TypeError, ValueError):
                return error_response(
                    "bad-request", f"option {key}: {options[key]!r} is "
                                   f"not a {conv.__name__}")
            if options[key] not in _OPTION_CHOICES.get(key, (options[key],)):
                return error_response(
                    "bad-request", f"option {key}: {options[key]!r} is not "
                                   f"one of {_OPTION_CHOICES[key]}")
        # the trace id is the client's handle on its job (cancel by trace
        # id); the tenant names its fair-scheduling bucket
        for key in ("trace_id", "tenant"):
            val = req.get(key)
            if val is not None and not _good_id(val):
                return error_response(
                    "bad-request", f"{key} must be 1-64 chars of "
                                   "[A-Za-z0-9._-]")
        priority = req.get("priority", 0)
        deadline_s = req.get("deadline_s")
        if isinstance(priority, bool) or not isinstance(priority, int) or (
                deadline_s is not None
                and (isinstance(deadline_s, bool)
                     or not isinstance(deadline_s, (int, float))
                     or deadline_s <= 0)):
            return error_response("bad-request",
                                  "priority must be an integer and "
                                  "deadline_s a positive number")
        fault_plan = req.get("fault_plan")
        if fault_plan is not None:
            if not isinstance(fault_plan, str):
                return error_response("bad-request",
                                      "fault_plan must be a string")
            try:
                FaultPlan.parse(fault_plan)
            except RaconError as exc:
                return error_response("bad-request", str(exc))
        rounds = req.get("rounds")
        if rounds is not None and (
                isinstance(rounds, bool) or not isinstance(rounds, int)
                or not 1 <= rounds <= MAX_ROUNDS):
            return error_response(
                "bad-request",
                f"rounds must be an integer in [1, {MAX_ROUNDS}]")
        # a window-range shard of the targets (a router's child job)
        range_lo = req.get("range_lo")
        range_hi = req.get("range_hi")
        if range_lo is not None or range_hi is not None:
            if _bad_bounds(range_lo, range_hi):
                return error_response(
                    "bad-request",
                    "range_lo/range_hi must be integers with "
                    "0 <= range_lo < range_hi")
            if rounds is not None:
                # round 2 would re-map the reads onto a segment, which is
                # not what rounds on the whole contig compute
                return error_response(
                    "bad-request",
                    "rounds cannot be combined with range_lo/range_hi")
        mode = req.get("mode")
        if mode is not None and mode not in ("contig", "fragment"):
            return error_response(
                "bad-request", 'mode must be "contig" or "fragment"')
        fragment = mode == "fragment"
        if fragment:
            if range_lo is not None or range_hi is not None:
                # fragment jobs shard the target index (frag_lo/frag_hi)
                return error_response(
                    "bad-request",
                    'mode "fragment" cannot be combined with '
                    "range_lo/range_hi")
            if rounds is not None and rounds > 1:
                # corrected reads have no draft to re-map onto
                return error_response(
                    "bad-request",
                    'rounds > 1 cannot be combined with mode '
                    '"fragment"')
            options = dict(options)
            options["fragment_correction"] = True
        # a target-index shard of a fragment job
        frag_lo = req.get("frag_lo")
        frag_hi = req.get("frag_hi")
        if frag_lo is not None or frag_hi is not None:
            if _bad_bounds(frag_lo, frag_hi):
                return error_response(
                    "bad-request",
                    "frag_lo/frag_hi must be integers with "
                    "0 <= frag_lo < frag_hi")
            if not fragment:
                return error_response(
                    "bad-request",
                    'frag_lo/frag_hi require mode "fragment"')
            if rounds is not None:
                return error_response(
                    "bad-request",
                    "rounds cannot be combined with frag_lo/frag_hi")
        # admit-time ingest: the shapes are checked here, the files
        # parsed once the job has its id
        ingest_spec = None
        if (req.get("ingest") is not None or req.get("subsample")
                is not None or req.get("normalize") is not None):
            from .ingest import IngestError, IngestSpec

            try:
                ingest_spec = IngestSpec.from_request(req)
            except IngestError as exc:
                return error_response("bad-request", str(exc))
            if not (req.get("ingest") or ingest_spec.subsample
                    or ingest_spec.normalize):
                ingest_spec = None
        with self._job_seq_lock:
            self._job_seq += 1
            job_id = f"j{self._job_seq}"
        job = Job(job_id, req["sequences"], req["overlaps"], req["target"],
                  options, priority=priority, deadline_s=deadline_s,
                  fault_plan=fault_plan, trace_id=req.get("trace_id"),
                  want_trace=bool(req.get("trace")),
                  want_progress=bool(req.get("progress")),
                  want_stream=bool(req.get("stream")),
                  tenant=req.get("tenant") or "", rounds=rounds,
                  range_lo=range_lo, range_hi=range_hi, fragment=fragment,
                  frag_lo=frag_lo, frag_hi=frag_hi)
        # a router's child job (serve/router.py): `parent` is the
        # router's parent job id, `shard` / `shards` this child's slot in
        # the fan-out. Journaled only, so the replica's lines correlate
        # with the router's ledger; ignored when absent or malformed
        parent = req.get("parent") if _good_id(req.get("parent")) else None
        shard = req.get("shard") if isinstance(req.get("shard"), int) \
            else None
        shards = req.get("shards") if isinstance(req.get("shards"), int) \
            else None
        journal = self.journal
        trace_id = job.trace_id
        if journal is not None:
            journal.record("received", job=job.id, trace=trace_id,
                           priority=job.priority or None,
                           tenant=job.tenant or None, deadline_s=deadline_s,
                           rounds=job.rounds, parent=parent, shard=shard,
                           shards=shards, range_lo=job.range_lo,
                           range_hi=job.range_hi,
                           mode="fragment" if job.fragment else None,
                           frag_lo=job.frag_lo, frag_hi=job.frag_hi)
        if ingest_spec is not None:
            # a file that does not parse fails this job at the door,
            # typed, before it takes queue or device time
            from .ingest import IngestError, prepare

            try:
                done = prepare(job.sequences, job.overlaps, job.target,
                               ingest_spec, self._ingest_workdir(), job.id,
                               trace_id=trace_id, journal=journal)
            except IngestError as exc:
                if journal is not None:
                    journal.record("rejected-ingest", job=job.id,
                                   trace=trace_id, error=exc.stage,
                                   detail=str(exc))
                return error_response("bad-request", str(exc),
                                      job_id=job_id,
                                      terminal="rejected-ingest",
                                      stage=exc.stage)
            job.sequences, job.overlaps, job.target = done
        try:
            self.queue.submit(job)
        except TenantQuotaExceeded as exc:
            if journal is not None:
                journal.record("rejected-quota", job=job.id, trace=trace_id,
                               tenant=job.tenant or None,
                               retry_after=round(exc.retry_after, 3))
            return error_response("tenant-quota", str(exc),
                                  retry_after=round(exc.retry_after, 3),
                                  tenant=job.tenant, job_id=job_id)
        except QueueFull as exc:
            if journal is not None:
                journal.record("rejected-full", job=job.id, trace=trace_id,
                               retry_after=round(exc.retry_after, 3))
            return error_response("queue-full", str(exc),
                                  retry_after=round(exc.retry_after, 3),
                                  job_id=job_id)
        except DeadlineDoomed as exc:
            # the service-time estimate says the job cannot meet its
            # deadline: it fails before it costs queue or device time,
            # and leaves the journal as an expiry with the reason pinned
            with self._run_lock:
                self.qos["doomed_at_admission"] += 1
            if journal is not None:
                journal.record("deadline-doomed", job=job.id,
                               trace=trace_id, phase="admission",
                               predicted_s=round(exc.predicted_s, 3),
                               remaining_s=round(exc.remaining_s, 3))
                journal.record("expired", job=job.id, trace=trace_id,
                               reason="deadline-doomed")
            return error_response(
                "deadline-doomed", str(exc), job_id=job_id,
                predicted_s=round(exc.predicted_s, 3),
                remaining_s=round(exc.remaining_s, 3))
        except Draining as exc:
            if journal is not None:
                journal.record("rejected-draining", job=job.id,
                               trace=trace_id)
            return error_response("draining", str(exc), job_id=job_id)
        self._maybe_preempt(job)
        if job.relaying:
            self._stream_frames(job, conn)
        else:
            job.event.wait()
        # the `admitted` (and an in-queue expiry's) lines were staged
        # under the queue mutex; they reach the disk here
        if journal is not None:
            journal.flush_staged()
        return job.response

    def _stream_frames(self, job: Job, conn: socket.socket) -> None:
        """Forward the job's outbox (`progress` events, `result_part`
        frames, and queue-position updates while it is pending) on the
        submitting connection until the job ends; the handler then sends
        the result last. A client that stops reading loses only its
        interleaved frames: the job runs to its end either way."""
        seq = 0
        last_pos = None
        last_version = None
        send_ok = True

        def push(ev: dict) -> None:
            nonlocal seq, send_ok
            if not send_ok:
                return
            if ev.get("type") == "result_part":
                frame = ev
            else:
                seq += 1
                frame = {"type": "progress", "job_id": job.id, "seq": seq}
                frame.update(ev)
            if job.trace_id:
                frame.setdefault("trace_id", job.trace_id)
            try:
                send_frame(conn, frame)
            except (OSError, ProtocolError):
                send_ok = False

        while True:
            ev = job.next_frame(timeout=0.05)
            if ev is not None:
                push(ev)
                continue
            if job.event.is_set():
                break
            # the position is recomputed only when the queue moved
            if job.started_t is None and send_ok and job.want_progress:
                version = self.queue.version
                if version != last_version:
                    last_version = version
                    pos = self.queue.position(job)
                    if pos is not None and pos != last_pos:
                        last_pos = pos
                        push({"phase": "queued", "position": pos,
                              "depth": len(self.queue)})
        while True:  # the worker finished after its last notify
            ev = job.next_frame()
            if ev is None:
                break
            push(ev)

    # ------------------------------------------------------------ workers
    def _worker(self) -> None:
        while True:
            job = self.queue.pop(timeout=0.2)
            if job is None:
                if self._stop_workers.is_set() and not len(self.queue):
                    return
                continue
            self._process_one(job)

    def _process_one(self, job: Job) -> None:
        with self._idle:
            self._inflight += 1
        with self._run_lock:
            self._running[job.id] = job
        if job.want_progress:
            job.notify_progress({"phase": "start",
                                 "queue_wait_s": round(job.queue_wait_s,
                                                       4)})
        t0 = time.perf_counter()
        ok = False
        journal = self.journal
        try:
            resp = self._run_job(job)
            ok = True
        except JobCancelledError as exc:
            if journal is not None:
                journal.record("cancelled", job=job.id, trace=job.trace_id,
                               state="running")
            resp = error_response("cancelled", str(exc), job_id=job.id,
                                  error_type=type(exc).__name__,
                                  queue_wait_s=round(job.queue_wait_s, 4))
        except DeadlineDoomed as exc:
            # the iteration-boundary estimate gave the deadline up
            with self._run_lock:
                self.qos["doomed_mid_run"] += 1
            if journal is not None:
                journal.record("deadline-doomed", job=job.id,
                               trace=job.trace_id, phase=exc.phase,
                               predicted_s=round(exc.predicted_s, 3),
                               remaining_s=round(exc.remaining_s, 3))
            resp = error_response("deadline-doomed", str(exc),
                                  job_id=job.id,
                                  error_type=type(exc).__name__,
                                  predicted_s=round(exc.predicted_s, 3),
                                  remaining_s=round(exc.remaining_s, 3),
                                  queue_wait_s=round(job.queue_wait_s, 4))
        except Exception as exc:  # noqa: BLE001 — per-job isolation: the
            # job answers typed, the server and its engines go on
            resp = error_response("job-failed", str(exc), job_id=job.id,
                                  error_type=type(exc).__name__,
                                  queue_wait_s=round(job.queue_wait_s, 4))
        job.response = resp
        try:
            self._account_job(job, ok, resp, time.perf_counter() - t0)
        except Exception as exc:  # noqa: BLE001 — telemetry never kills
            # the worker nor strands the waiter on job.event
            log_info(f"[racon_tpu_torch::serve] warning: post-job "
                     f"telemetry failed ({type(exc).__name__}: {exc})")
        finally:
            job.finish()
            self._qos_job_done(job)
            with self._idle:
                self._inflight -= 1
                self._idle.notify_all()

    def _account_job(self, job: Job, ok: bool, resp: dict,
                     service_s: float) -> None:
        """A finished job's accounting, before its waiter wakes: its own
        histograms merge into the server's (a failed job's too: the
        pathological jobs are the ones the tails must not drop), the
        queue counts it with its latency exemplar, the journal gets its
        iterations, a deadline miss and its terminal line, and a failed
        or late job its flight dump, so a client reacting to the error
        finds the dump already listed by `debug`."""
        if job.stats_ref is not None and job.stats_ref.hists is not None:
            self.hists.merge(job.stats_ref.hists)
        exemplar = None
        if self.config.exemplars:
            # the job-latency bucket this job lands in names it, and a
            # failed or late job's flight dump (its path is the one
            # _flight_dump writes below)
            exemplar = {"trace_id": job.trace_id or job.id, "job": job.id}
            late = (job.deadline is not None
                    and time.perf_counter() > job.deadline)
            if (not ok or late) and self.config.flight_dir:
                exemplar["flight"] = self._dump_path(
                    job, "job-failed" if not ok else "deadline-miss")
        missed = self.queue.task_done(job, ok, service_s, exemplar=exemplar)
        journal = self.journal
        if journal is not None:
            batch = ((resp.get("serve") or {}).get("batch")
                     if ok else None) or {}
            if batch:
                journal.record("iterations", job=job.id, trace=job.trace_id,
                               iterations=batch.get("iterations"),
                               shared=batch.get("shared_iterations"),
                               windows=batch.get("windows"))
            if missed:
                journal.record("deadline-miss", job=job.id,
                               trace=job.trace_id)
            journal.record("finished" if ok else "failed", job=job.id,
                           trace=job.trace_id, service_s=round(service_s, 4),
                           sequences=resp.get("sequences"),
                           error_type=resp.get("error_type"))
        if not ok or missed:
            self._flight_dump(job, "job-failed" if not ok
                              else "deadline-miss", resp)

    # ---------------------------------------------------------------- qos
    def _surge_worker(self) -> None:
        """A one-job worker started by a preemption: the victim's worker
        stays blocked on its parked windows, so the freed capacity needs
        a thread, which the queue's priority order gives the new job."""
        job = self.queue.pop(timeout=1.0)
        if job is not None:
            self._process_one(job)

    def _qos_job_done(self, job: Job) -> None:
        """Drop a finished job from the running set, free any windows it
        left parked (a job may end while preempted), then give the freed
        capacity to the highest parked job."""
        with self._run_lock:
            self._running.pop(job.id, None)
            if not self.config.preempt:
                return
            was_parked = self._preempted.pop(job.id, None) is not None
        if was_parked:
            self.batcher.resume_job(job.id)
            if self.journal is not None:
                self.journal.record("resumed", job=job.id,
                                    trace=job.trace_id, reason="terminal")
        self._maybe_resume()

    def _maybe_preempt(self, job: Job) -> None:
        """A newly admitted job preempts the lowest-priority running job
        of a strictly lower priority when every worker is busy: the
        victim's pooled windows park between iterations and a surge
        worker runs the new job. Fault-plan jobs run alone and are never
        victims."""
        if not self.config.preempt:
            return
        with self._run_lock:
            active = [j for jid, j in self._running.items()
                      if jid not in self._preempted]
            if len(active) < self.config.workers:
                return
            victims = [j for j in active if j.priority < job.priority
                       and j.fault_plan is None]
            if not victims:
                return
            victim = min(victims, key=lambda j: j.priority)
            self._preempted[victim.id] = victim
            self.qos["preemptions"] += 1
        parked = self.batcher.withdraw_job(victim.id)
        if self.journal is not None:
            self.journal.record("preempted", job=victim.id,
                                trace=victim.trace_id, by=job.id,
                                priority=victim.priority,
                                by_priority=job.priority, windows=parked)
        log_info(f"[racon_tpu_torch::serve] preempted job {victim.id} "
                 f"(priority {victim.priority}) for {job.id} (priority "
                 f"{job.priority}): {parked} windows parked")
        threading.Thread(target=self._surge_worker,
                         name="racon-torch-serve-surge",
                         daemon=True).start()

    def _maybe_resume(self) -> None:
        """Resume the highest parked job once a worker is free, unless a
        strictly higher priority still waits in the queue."""
        top = self.queue.highest_queued_priority()
        with self._run_lock:
            if not self._preempted:
                return
            active = len(self._running) - len(self._preempted)
            if active >= self.config.workers:
                return
            cand = max(self._preempted.values(), key=lambda j: j.priority)
            if top is not None and top > cand.priority:
                return
            del self._preempted[cand.id]
            self.qos["resumes"] += 1
        n = self.batcher.resume_job(cand.id)
        if self.journal is not None:
            self.journal.record("resumed", job=cand.id, trace=cand.trace_id,
                                windows=n)
        log_info(f"[racon_tpu_torch::serve] resumed job {cand.id}: {n} "
                 f"windows back in the pool")

    def _cancel(self, req: dict) -> dict:
        """Dequeue a queued job (its submitter gets a typed `cancelled`
        error) or kill a running one (the batcher fails its tickets; a
        fault-plan job, whose pass never pools, is refused its result
        when the pass ends)."""
        job_id = req.get("job_id")
        trace_id = req.get("trace_id")
        if not job_id and not trace_id:
            return error_response("bad-request",
                                  "cancel needs job_id or trace_id")
        job = self.queue.cancel(job_id=job_id, trace_id=trace_id)
        if job is not None:
            with self._run_lock:
                self.cancelled += 1
            if self.journal is not None:
                self.journal.flush_staged()
            return {"type": "ok", "cancelled": "queued", "job_id": job.id}
        with self._run_lock:
            running = self._running.get(job_id or "")
            if running is None and trace_id:
                running = next((j for j in self._running.values()
                                if j.trace_id == trace_id), None)
            if running is not None:
                self.cancelled += 1
                running.cancelled = True
        if running is None:
            return error_response("unknown-job",
                                  "no queued or running job matches",
                                  job_id=job_id, trace_id=trace_id)
        pooled = self.batcher.cancel_job(running.id)
        return {"type": "ok", "cancelled": "running", "job_id": running.id,
                "pooled": pooled}

    def _run_job(self, job: Job) -> dict:
        """Run one job. A job submitted with `trace: true` runs under its
        own recorder (obs/trace.scoped: one such job at a time, and it
        sees every thread's spans while it runs), rebased to the job's
        enqueue so its queue wait keeps its offset; the response carries
        its events and the recorder's base. Any other job leaves the same
        two spans, `serve.queue_wait` and `serve.job`, in the flight
        ring, tagged with its trace id, for `trace_pull`."""
        t0 = time.perf_counter()
        tags = {"job": job.id, "trace_id": job.trace_id}
        with (obs_trace.scoped() if job.want_trace
              else contextlib.nullcontext()) as rec:
            sink = rec if job.want_trace else self._flight
            if job.want_trace:
                rec.rebase(job.enqueued_t)
            if sink is not None:
                sink.complete("serve.queue_wait", job.enqueued_t,
                              job.started_t or t0, tags)
            resp = self._run_passes(job, t0)
        if sink is not None:
            sink.complete("serve.job", t0, time.perf_counter(), tags)
        if job.want_trace:
            resp["trace"] = rec.events()
            # the recorder's time zero on this process's perf_counter:
            # with the ping handshake's offset the client maps every
            # server span onto its own clock (client.merge_trace)
            resp["trace_base_mono"] = rec._base
        return resp

    def _run_passes(self, job: Job, t0: float) -> dict:
        opts = job.options
        journal = self.journal
        launches0 = _job_launches()
        polisher = self._polisher(
            (job.sequences, job.overlaps, job.target), opts,
            fault_plan=job.fault_plan)
        # the flight dump of a job that dies mid-phase carries its stage
        # counters so far
        job.stats_ref = polisher.pipeline_stats
        polisher.serve_job_id = job.id
        polisher.serve_trace_id = job.trace_id
        polisher.serve_tenant = job.tenant
        polisher.serve_deadline = job.deadline
        if job.want_progress:
            polisher.progress_hook = job.notify_progress
        if job.cancelled:
            raise JobCancelledError("running")
        if job.range_lo is not None:
            # a range shard: only the windows whose grid start lies in
            # [range_lo, range_hi), streamed as bare-named segments
            polisher.window_range = (job.range_lo, job.range_hi)
        if job.frag_lo is not None:
            # a fragment shard: only the targets of index [lo, hi)
            polisher.target_range = (job.frag_lo, job.frag_hi)
        mark = _job_launches(polisher)
        polisher.initialize()
        # each finished contig is a part; with `stream` the client gets
        # it as a result_part frame before the job ends, and the parts
        # concatenate to the FASTA (ContigStreamer emits in contig order)
        parts: list[bytes] = []

        def on_part(seq) -> None:
            part = b">" + seq.name.encode() + b"\n" + seq.data + b"\n"
            parts.append(part)
            if journal is not None:
                journal.record("part-streamed", job=job.id,
                               trace=job.trace_id,
                               contig=seq.name.split(" ", 1)[0],
                               part=len(parts), bytes=len(part))
            frame = {"type": "result_part", "job_id": job.id,
                     "part": len(parts), "name": seq.name,
                     "fasta": part.decode("latin-1")}
            if job.range_lo is not None:
                # a range shard's frame carries the raw segment and the
                # accounting the whole contig's tags are re-derived from;
                # its parts do not concatenate to a FASTA
                frame["fasta"] = seq.data.decode("latin-1")
                frame["seg"] = polisher.segment_meta.get(seq.name)
            job.notify_part(frame)

        def on_group(seqs, lo, hi) -> None:
            # a fragment job's reads ship in groups of frag_group
            # targets; `frag` is the group's target range on the whole
            # read set (dropped reads advance it too)
            body = b"".join(b">" + s.name.encode() + b"\n" + s.data
                            + b"\n" for s in seqs)
            parts.append(body)
            if journal is not None:
                journal.record("part-streamed", job=job.id,
                               trace=job.trace_id, part=len(parts),
                               bytes=len(body), reads=len(seqs))
            base = job.frag_lo or 0
            job.notify_part({"type": "result_part", "job_id": job.id,
                             "part": len(parts), "reads": len(seqs),
                             "frag": [base + lo, base + hi],
                             "fasta": body.decode("latin-1")})

        drop = not opts.get("include_unpolished", False)

        def one_pass(final: bool):
            if job.fragment:
                return polisher.polish(drop, batcher=self.batcher,
                                       on_group=on_group if final else None,
                                       group_size=self.config.frag_group)
            return polisher.polish(drop, batcher=self.batcher,
                                   on_part=on_part if final else None)

        per_round: list[dict] = []
        #: each pass's K1 / K3 launches in the iterations it rode
        ridden: list[tuple[int, int]] = []

        def ride() -> None:
            batch = polisher.serve_batch or {}
            ridden.append((batch.get("k1_launches", 0),
                           batch.get("k3_launches", 0)))

        if job.rounds is None:
            polished = one_pass(True)
            ride()
        else:
            # round k's contigs are round k+1's draft, re-mapped in this
            # process (Polisher.redraft); only the last round streams
            with self._rounds_lock:
                self._rounds["jobs"] += 1
                self._rounds["inflight"] += 1
            try:
                with tempfile.TemporaryDirectory(
                        prefix=f"racon_torch_rounds_{job.id}_") as workdir:
                    for rnd in range(1, job.rounds + 1):
                        final = rnd == job.rounds
                        if job.cancelled:
                            raise JobCancelledError("running")
                        if journal is not None:
                            journal.record("round-started", job=job.id,
                                           trace=job.trace_id, round=rnd,
                                           of=job.rounds)
                        rt0 = time.perf_counter()
                        polished = one_pass(final)
                        wall = time.perf_counter() - rt0
                        ride()
                        batch = polisher.serve_batch or {}
                        info = {"round": rnd, "wall_s": round(wall, 4),
                                "windows": batch.get("windows"),
                                "iterations": batch.get("iterations"),
                                "sequences": len(polished)}
                        # the round's launches: K2 in the initialize()
                        # before it, K1 / K3 in its pass
                        now = _job_launches(polisher)
                        info.update(
                            k1_launches=now[0] - mark[0] + ridden[-1][0],
                            k2_launches=now[1] - mark[1],
                            k3_launches=now[2] - mark[2] + ridden[-1][1])
                        mark = now
                        if polisher.serve_cache is not None:
                            info["cache"] = dict(polisher.serve_cache)
                        per_round.append(info)
                        self.hists.observe(f"serve.round_{rnd}", wall)
                        if journal is not None:
                            journal.record(
                                "round-finished", job=job.id,
                                trace=job.trace_id, round=rnd,
                                of=job.rounds, wall_s=round(wall, 4),
                                sequences=len(polished),
                                cache_hits=(polisher.serve_cache
                                            or {}).get("hits"))
                        with self._rounds_lock:
                            self._rounds["completed"] += 1
                        if not final:
                            # the next round starts fresh counters: this
                            # round's histograms join the server's now
                            self.hists.merge(polisher.hists)
                            polisher.redraft(polished, workdir,
                                             tag=f"r{rnd}")
                            polisher.initialize()
                            job.stats_ref = polisher.pipeline_stats
            finally:
                with self._rounds_lock:
                    self._rounds["inflight"] -= 1
        if job.cancelled:
            # a cancel that reached a fault-plan job mid-pass (no pooled
            # ticket to kill): its bytes are unwanted
            raise JobCancelledError("running")
        # the body comes from `polished`, not the parts: the streamer
        # swallows on_part's exceptions, so a lost part must not
        # truncate the result
        fasta = b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                         for s in polished)
        k1, k2, k3 = (b - a for a, b in zip(launches0,
                                            _job_launches(polisher)))
        batch = dict(polisher.serve_batch or {})
        # launches on this worker thread (K2 in each initialize(), K1 / K3
        # of a fault-plan job's own pass) plus those of the iterations
        # the job rode, each billed in full to every rider; a rounds job
        # is billed every round's
        batch["k1_launches"] = k1 + sum(r[0] for r in ridden)
        batch["k2_launches"] = k2
        batch["k3_launches"] = k3 + sum(r[1] for r in ridden)
        resp = {"type": "result", "job_id": job.id,
                "sequences": len(polished),
                "metrics": polisher.metrics.snapshot(),
                "serve": {"queue_wait_s": round(job.queue_wait_s, 4),
                          "exec_s": round(time.perf_counter() - t0, 4),
                          "phase_s": {k: round(v, 4) for k, v in
                                      polisher.phase_s.items()},
                          "batch": batch}}
        if job.rounds is not None:
            # present only when the request asked for rounds; cache
            # totals only with the window cache armed
            block = {"requested": job.rounds, "completed": len(per_round),
                     "per_round": per_round}
            caches = [i["cache"] for i in per_round if i.get("cache")]
            if caches:
                block["cache"] = {"hits": sum(c["hits"] for c in caches),
                                  "misses": sum(c["misses"]
                                                for c in caches)}
            resp["rounds"] = block
        if job.want_stream:
            resp["streamed"] = True
            resp["parts"] = len(parts)
        else:
            resp["fasta"] = fasta.decode("latin-1")
        return resp

    # -------------------------------------------------- flight recorder
    def _dump_path(self, job: Job, reason: str) -> str:
        return os.path.join(self.config.flight_dir,
                            f"flight_{job.id}_{reason}.json")

    def _flight_dump(self, job: Job, reason: str,
                     resp: dict | None) -> None:
        """Write the flight ring, windowed to `job`, as a Chrome trace
        named for the job, with its identity, error and stage counters.
        Best-effort: a full disk or an unwritable directory loses the
        artifact, never the job's response or the server."""
        if not self.config.flight_dir or self._flight is None:
            return
        try:
            os.makedirs(self.config.flight_dir, exist_ok=True)
            path = self._dump_path(job, reason)
            info = {"job_id": job.id, "reason": reason,
                    "queue_wait_s": round(job.queue_wait_s, 4),
                    "error_type": (resp or {}).get("error_type"),
                    "message": (resp or {}).get("message"),
                    "stage_stats": (job.stats_ref.snapshot()
                                    if job.stats_ref is not None else None)}
            obs_flight.dump(self._flight, path, since=job.started_t,
                            flight=info)
            self._dumps.append(path)
            log_info(f"[racon_tpu_torch::serve] flight recorder dumped to "
                     f"{path} ({reason})")
        except Exception as exc:  # noqa: BLE001 — see docstring
            log_info(f"[racon_tpu_torch::serve] warning: could not write "
                     f"flight dump ({type(exc).__name__}: {exc})")

    def debug_snapshot(self, max_events: int = 5000) -> dict:
        """The `debug` body: the flight ring's most recent events (at most
        `max_events` spans, thread names kept; 0 or less: all) and the
        dumps written so far."""
        events: list = []
        if self._flight is not None:
            events = obs_flight.window_events(self._flight)
            if max_events > 0 and len(events) > max_events:
                meta = [e for e in events if e.get("ph") == "M"]
                rest = [e for e in events if e.get("ph") != "M"]
                events = meta + rest[-max_events:]
        return {"type": "debug", "events": events,
                "dumps": list(self._dumps),
                "flight_installed": self._flight_installed}

    def _trace_pull(self, req: dict) -> dict:
        """The `trace_pull` body: the flight ring windowed to one trace id
        (an exact or a dotted `<id>.<child>` match; obs/flight.
        trace_events) or, with `trace_ids`, to the union of those, with
        the recorder's base and a fresh clock sample so the caller can
        rebase the events onto its own timeline. It reads the ring that
        is already recording: a pull costs the server its reply."""
        trace_id = req.get("trace_id")
        if not _good_id(trace_id):
            return error_response("bad-request",
                                  "trace_pull needs a trace_id of "
                                  "[A-Za-z0-9._-], at most 64 chars")
        want = trace_id
        tids = req.get("trace_ids")
        if tids is not None:
            if (not isinstance(tids, list) or not tids
                    or not all(_good_id(t) for t in tids)):
                return error_response("bad-request",
                                      "trace_pull trace_ids must be a "
                                      "non-empty list of [A-Za-z0-9._-] "
                                      "ids")
            want = tids
        cap = req.get("max_events", self.config.trace_pull_events)
        if isinstance(cap, bool) or not isinstance(cap, int):
            return error_response("bad-request",
                                  "max_events must be an integer")
        events: list = []
        base = None
        if self._flight is not None:
            events = obs_flight.trace_events(self._flight, want,
                                             max_events=cap)
            base = self._flight._base
        return {"type": "trace", "trace_id": trace_id, "events": events,
                "base_mono": base, "mono_s": time.perf_counter()}

    # --------------------------------------------------------- exposition
    def prometheus_text(self) -> str:
        """One Prometheus scrape body (obs/prom.py): lifetime counters,
        live gauges and every latency histogram, read at call time. It
        takes only the queue's, the batcher's pool and the counters'
        short locks, never a lane's, so a scrape does not wait on a
        running iteration; safe at any point of the server's life."""
        from ..sched.autotune import get_autotuner

        t_render = time.perf_counter()
        cfg = self.config
        q = self.queue.snapshot()
        b = self.batcher.snapshot()
        counters: dict = {f"serve.jobs.{k}": q[k] for k in (
            "submitted", "admitted", "rejected_full", "rejected_draining",
            "rejected_quota", "expired", "completed", "failed",
            "deadline_hit", "deadline_miss")}
        counters["serve.batch.iterations"] = b["iterations"]
        counters["serve.batch.shared_iterations"] = b["shared_iterations"]
        counters["serve.batch.windows"] = b["windows"]
        counters["serve.batch.host_seconds"] = round(b.get("host_s", 0.0),
                                                     4)
        counters["serve.compiles"] = b["compiles"]
        for lane in b.get("lanes") or ():
            counters[f"serve.lane.{lane['lane']}.iterations"] = \
                lane["iterations"]
        # tenant ids that name a series unchanged by sanitization only:
        # 'team.a' and 'team-a' would collide into one series
        for tenant, tc in (q.get("tenants") or {}).items():
            if tenant and all(c.isalnum() or c == "_" for c in tenant):
                counters[f"serve.tenant.{tenant}.admitted"] = \
                    tc["admitted"]
                counters[f"serve.tenant.{tenant}.completed"] = \
                    tc["completed"]
        if self.journal is not None:
            counters["serve.journal.events"] = self.journal.events
            counters["serve.journal.dropped"] = self.journal.dropped
        consults = get_autotuner(cfg.autotune_table).consult_counts()
        if consults:
            counters["sched.autotune.consults"] = obs_prom.Labeled(
                consults, "winner-table consults by decision (decision "
                "'none' = cold bucket, the engine's default)")
        gauges: dict = {
            "serve.uptime_seconds": (
                round(time.perf_counter() - self._t_start, 3),
                "seconds since this server process started serving"),
            "serve.start_time_seconds": (
                round(self._t_wall_start, 3),
                "unix time the server started (a counter reset with an "
                "unchanged start time is a bug, with a changed one a "
                "restart)"),
            "serve.queue_depth": q["depth"],
            "serve.queue_capacity": q["maxsize"],
            "serve.queue_oldest_wait_seconds": q.get("oldest_wait_s", 0.0),
            "serve.inflight": self._inflight_count(),
            "serve.draining": self._draining.is_set(),
            "serve.service_time_ema_seconds": q["ema_service_s"],
            "serve.worker_lanes": b.get("worker_lanes", 1),
        }
        for lane in b.get("lanes") or ():
            gauges[f"serve.lane.{lane['lane']}.busy"] = (
                lane["busy"], "1 while this worker lane runs a device "
                "iteration")
        for engine, e in (b.get("occupancy") or {}).items():
            if "occupancy_pct" in e:
                gauges[f"sched.{engine}.occupancy_pct"] = e["occupancy_pct"]
        tenants = q.get("tenants") or {}
        if tenants:
            gauges["serve.tenant_queue_depth"] = obs_prom.Labeled(
                [({"tenant": t}, tc.get("queued", 0))
                 for t, tc in sorted(tenants.items())],
                "live queued jobs per tenant")
            gauges["serve.tenant_credit"] = obs_prom.Labeled(
                [({"tenant": t}, tc.get("credit", 0.0))
                 for t, tc in sorted(tenants.items())],
                "accrued fair-order credit per tenant (one spent a pop)")
        tdev = self.batcher.tenant_device_seconds()
        if tdev:
            counters["serve.tenant_device_seconds"] = obs_prom.Labeled(
                [({"tenant": t}, v) for t, v in sorted(tdev.items())],
                "device seconds charged per tenant (lane iteration wall "
                "prorated by window share; empty tenant label = "
                "untenanted traffic)")
        # the audit's families only with the auditor armed
        if self.auditor is not None:
            a = self.auditor.snapshot()
            counters["audit.windows"] = (
                a["windows"], "windows that passed through audited "
                "iterations (the sampling denominator)")
            counters["audit.sampled"] = (
                a["sampled"], "windows selected by the content-keyed "
                "sample at the armed rate")
            counters["audit.shadow_seconds"] = round(a["shadow_s"], 4)
            counters["audit.repaired"] = a["repaired"]
            counters["audit.demotions"] = (
                a["demotions"], "winner-table entries demoted to the "
                "oracle candidate after a mismatch")
            counters["audit.shadow_launches"] = a["shadow"]["launches"]
            counters["audit.shadow_compiles"] = a["shadow"]["compiles"]
            mism = self.auditor.mismatch_samples()
            if mism:
                counters["audit.mismatches"] = obs_prom.Labeled(
                    mism, "confirmed silent-data-corruption events by "
                    "(engine, kernel, dtype, bucket, lane)")
            gauges["audit.rate"] = (
                a["rate"], "content-keyed sample fraction the auditor "
                "audits at")
            gauges["audit.alert"] = (
                a["alert_firing"], "1 while unacknowledged identity "
                "mismatches exist (clear with the debug RPC's audit_ack)")
            lane_rows = b.get("lanes") or ()
            if lane_rows:
                gauges["lane_health"] = obs_prom.Labeled(
                    [({"lane": str(ln["lane"])}, ln["health"])
                     for ln in lane_rows],
                    "lane health: 1 healthy, 0 quarantined, 0.5 degraded "
                    "(failed re-probe, last serving lane)")
        # the window cache's families only with the cache armed
        wc = self.batcher.wincache
        if wc is not None:
            c = wc.snapshot()
            counters["serve.wincache.ops"] = obs_prom.Labeled(
                [({"op": "eviction"}, c["evictions"]),
                 ({"op": "hit"}, c["hits"]),
                 ({"op": "invalidation"}, c["invalidations"]),
                 ({"op": "miss"}, c["misses"]),
                 ({"op": "put"}, c["puts"]),
                 ({"op": "quarantined"}, c["quarantined"])],
                "window consensus cache operations by outcome (a hit "
                "skips the device)")
            counters["serve.wincache.hit_bytes"] = (
                c["hit_bytes"], "consensus bytes served from the cache "
                "instead of a device iteration")
            gauges["serve.wincache.bytes"] = (
                c["bytes"], "resident cache payload bytes (LRU-bounded by "
                "max_bytes)")
            gauges["serve.wincache.entries"] = c["entries"]
            gauges["serve.wincache.max_bytes"] = c["max_bytes"]
        # the rounds families once a rounds job has been seen
        with self._rounds_lock:
            r = dict(self._rounds)
        if r["jobs"]:
            counters["serve.rounds_jobs"] = (
                r["jobs"], "jobs that asked for polishing rounds (rounds=N "
                "on the submit frame)")
            counters["serve.rounds_completed"] = (
                r["completed"], "polishing rounds completed across all "
                "rounds jobs")
            gauges["serve.rounds_inflight"] = (
                r["inflight"], "rounds jobs running now")
        # the QoS families when armed or once one of them counted
        with self._run_lock:
            qos = dict(self.qos)
            cancelled = self.cancelled
            preempted_now = len(self._preempted)
        doomed = qos["doomed_at_admission"] + qos["doomed_mid_run"]
        if (cfg.preempt or cfg.abort_margin is not None
                or cfg.tenant_burst > 0 or any(qos.values())
                or cancelled):
            counters["serve.preemptions"] = (
                qos["preemptions"], "running jobs preempted by a higher "
                "priority (windows parked, resumed with the same bytes)")
            counters["serve.aborted_doomed"] = (
                doomed, "jobs failed with deadline-doomed (predicted "
                "finish past the deadline by more than the abort margin)")
            counters["serve.cancelled"] = (
                cancelled, "jobs cancelled through the cancel RPC (queued "
                "or running)")
            gauges["serve.preempted_inflight"] = (
                preempted_now, "jobs parked by preemption now (their "
                "finished windows are kept)")
            if cfg.tenant_burst > 0:
                counters["serve.burst_admits"] = (
                    q.get("burst_admits", 0), "admissions over the tenant "
                    "quota paid for by burst tokens")
        burn = self.burn.state()
        gauges["slo.burn_rate"] = (
            burn["fast"], "fast-window SLO burn rate: the deadline-miss "
            "rate over the window as a multiple of the error budget")
        gauges["slo.burn_rate_slow"] = burn["slow"]
        gauges["slo.burn_alert"] = (
            burn["firing"], "1 while both burn windows exceed the "
            "threshold")
        # the scrape's own cost: the renders before this one
        with self._scrape_lock:
            counters["serve.scrapes"] = self._scrape_count
            counters["serve.scrape_seconds"] = round(self._scrape_render_s,
                                                     6)
        body = obs_prom.render(counters, gauges, self.hists)
        with self._scrape_lock:
            self._scrape_count += 1
            self._scrape_render_s += time.perf_counter() - t_render
        return body

    # -------------------------------------------------------------- misc
    def _inflight_count(self) -> int:
        with self._idle:
            return self._inflight

    def stats_snapshot(self) -> dict:
        q = self.queue.snapshot()
        latency = self.hists.get("job.latency")
        deadlined = q["deadline_hit"] + q["deadline_miss"]
        with self._run_lock:
            cancelled = self.cancelled
            qos = dict(self.qos)
            qos["preempted_inflight"] = len(self._preempted)
        out = {"uptime_s": round(time.perf_counter() - self._t_start, 3),
               "warm": self._warm, "inflight": self._inflight_count(),
               "draining": self._draining.is_set(),
               "device": str(self.config.device), "cancelled": cancelled,
               "queue": q, "batcher": self.batcher.snapshot(),
               "audit": (self.auditor.snapshot()
                         if self.auditor is not None else None),
               "slo": {"deadline_hit": q["deadline_hit"],
                       "deadline_miss": q["deadline_miss"],
                       "expired": q["expired"],
                       "miss_rate": (round(q["deadline_miss"] / deadlined,
                                           4) if deadlined else 0.0),
                       "burn": self.burn.state(),
                       "recent": q.get("recent"),
                       "latency": (latency.snapshot()
                                   if latency is not None else None)}}
        # each block below appears only once its feature is armed or has
        # counted, so a server without them answers as before
        cfg = self.config
        if (cfg.preempt or cfg.abort_margin is not None
                or cfg.tenant_burst > 0 or any(qos.values())):
            qos["preempt"] = cfg.preempt
            out["qos"] = qos
        tenants = self.batcher.tenant_device_seconds()
        if tenants:
            out["tenant_device_seconds"] = tenants
        with self._rounds_lock:
            if self._rounds["jobs"]:
                out["rounds"] = dict(self._rounds)
        if self._dumps:
            out["flight"] = {"dumps": list(self._dumps),
                             "installed": self._flight_installed}
        if self.journal is not None:
            out["journal"] = {"path": cfg.journal_path,
                              "events": self.journal.events,
                              "dropped": self.journal.dropped}
        return out

    def _on_audit_alert(self, state: str, detail: dict) -> None:
        """The auditor's alert sink: a typed `alert` line in the journal
        and a log line (the alert clears with the debug RPC's
        `audit_ack`)."""
        if self.journal is not None:
            self.journal.record("alert", kind="audit-mismatch", state=state,
                                mismatches=detail.get("mismatches"),
                                acked=detail.get("acked"))
        log_info(f"[racon_tpu_torch::serve] audit alert "
                 f"{'FIRING' if state == 'firing' else 'clear'}: "
                 f"{detail.get('mismatches', 0)} identity mismatches, "
                 f"{detail.get('acked', 0)} acknowledged")

    @property
    def address(self) -> str:
        return self.config.address

    def wait_stopped(self, timeout: float | None = None) -> bool:
        """Block until a drain (a `shutdown` request, or drain()) ended."""
        return self._stopped.wait(timeout)


# ------------------------------------------------------------------ CLI
def _metrics_port(raw: str) -> int:
    """argparse type of --metrics-port: an integer >= 0, refused at parse
    time otherwise (a typo must not bind a port no scraper finds)."""
    import argparse

    try:
        port = int(raw)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"invalid metrics port {raw!r} (expected an integer)") from None
    if port < 0:
        raise argparse.ArgumentTypeError(
            f"invalid metrics port {port} (expected >= 0; 0 = ephemeral)")
    return port


def serve_main(argv: list[str]) -> int:
    """`python -m racon_tpu_torch serve`: run a PolishServer until
    SIGTERM / SIGINT or a `shutdown` request, then drain."""
    import argparse
    import signal

    ap = argparse.ArgumentParser(
        prog="racon_tpu_torch serve",
        description="warm polishing job server (unix socket or localhost "
                    "TCP); every knob is a flag")
    ap.add_argument("--socket", default=None,
                    help=f"unix socket path (default {default_socket()})")
    ap.add_argument("--port", type=int, default=None,
                    help="listen on localhost TCP instead of the unix "
                         "socket (0 = ephemeral)")
    ap.add_argument("--workers", type=int, default=2,
                    help="job worker threads (default 2)")
    ap.add_argument("--queue-depth", type=int, default=16,
                    help="admission-control queue bound (default 16)")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    help="graceful-drain budget in seconds (default 30)")
    ap.add_argument("--iteration-windows", type=int, default=256,
                    help="most windows a device iteration takes "
                         "(default 256)")
    ap.add_argument("--max-wait-ms", type=float, default=0.0,
                    help="let a sparse window pool coalesce up to this "
                         "long before a short device iteration (default "
                         "0: dispatch at once)")
    ap.add_argument("--tenant-weights", default=None,
                    help="per-tenant fair-scheduling weights, e.g. "
                         "'gold=4,free=1,default=1'")
    ap.add_argument("--tenant-quota", type=int, default=0,
                    help="most queued jobs per tenant (default 0: off)")
    ap.add_argument("--tenant-burst", type=int, default=0,
                    help="burst tokens a tenant may spend above its "
                         "quota, refilled at its weight per second "
                         "(default 0: off)")
    ap.add_argument("--max-frame", type=int, default=DEFAULT_MAX_FRAME,
                    help="largest request frame in bytes (default "
                         f"{DEFAULT_MAX_FRAME})")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the synthetic warm-up job")
    ap.add_argument("-w", "--window-length", type=int, default=500)
    ap.add_argument("-q", "--quality-threshold", type=float, default=10.0)
    ap.add_argument("-e", "--error-threshold", type=float, default=0.3)
    ap.add_argument("--no-trimming", action="store_true")
    ap.add_argument("-m", "--match", type=int, default=3)
    ap.add_argument("-x", "--mismatch", type=int, default=-5)
    ap.add_argument("-g", "--gap", type=int, default=-4)
    ap.add_argument("-t", "--threads", type=int, default=2,
                    help="host threads per job (default 2)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda raises without a card; cpu runs the "
                         "kernels' plain versions")
    ap.add_argument("-c", "--cudapoa-batches", type=int, default=0)
    ap.add_argument("-b", "--cuda-banded-alignment", action="store_true")
    ap.add_argument("--cudaaligner-batches", type=int, default=0)
    ap.add_argument("--cudaaligner-band-width", type=int, default=0)
    ap.add_argument("--cudaaligner-max-length", type=int, default=None,
                    help="the device aligner's length envelope: a pair "
                         "longer than the largest bucket edge within it "
                         "is aligned on the host (default: the largest "
                         "bucket edge)")
    ap.add_argument("--device-latency-s", type=float, default=0.0,
                    help="simulated device latency: sleep this many "
                         "seconds after each pipeline chunk's result wait "
                         "(default 0: off; the output does not change)")
    ap.add_argument("--device-latency-x", type=float, default=0.0,
                    help="simulated device latency: sleep this multiple "
                         "of each pipeline chunk's dispatch time after it "
                         "(default 0: off; the output does not change)")
    ap.add_argument("--host-poa-chunk", type=int, default=None,
                    help="windows per host POA chunk (default: the host "
                         "engine's own; the output does not change)")
    ap.add_argument("--cuda-engine", choices=("session", "fused"),
                    default="session")
    ap.add_argument("--cuda-fused", choices=("auto", "0", "1"),
                    default="auto")
    ap.add_argument("--cuda-dtype", choices=("auto", "int32", "int16"),
                    default="auto")
    ap.add_argument("--cuda-pipeline-depth", type=int, default=2)
    ap.add_argument("--cuda-adaptive-buckets", action="store_true")
    ap.add_argument("--cuda-autotune-table", default=None)
    ap.add_argument("--wincache", action="store_true",
                    help="arm the window cache: a window whose content, "
                         "engine parameters and kernel posture were "
                         "polished before skips the device (rounds jobs "
                         "gain most); the output does not change")
    ap.add_argument("--wincache-max-bytes", type=int,
                    default=DEFAULT_MAX_BYTES,
                    help="the window cache's LRU bound in bytes (default "
                         f"{DEFAULT_MAX_BYTES})")
    ap.add_argument("--frag-group", type=int, default=64,
                    help="corrected reads per result_part frame of a "
                         "fragment job (default 64)")
    ap.add_argument("--preempt", action="store_true",
                    help="a newly admitted job of a higher priority "
                         "parks a running lower one's pooled windows "
                         "between device iterations; the parked job "
                         "resumes, with the same bytes, once a worker "
                         "frees")
    ap.add_argument("--abort-margin", type=float, default=None,
                    help="fail a job typed deadline-doomed when its "
                         "predicted finish lies past its deadline by more "
                         "than this many seconds, at admission and at "
                         "iteration boundaries (default: off)")
    ap.add_argument("--worker-lanes", type=int, default=1,
                    help="cut the device list into this many lanes, each "
                         "with its own feeder (default 1; clamps to the "
                         "devices: one for --device cpu or one card)")
    ap.add_argument("--audit-rate", type=float, default=0.0,
                    help="the fraction of finished windows re-executed "
                         "through the oracle and compared byte for byte "
                         "(default 0: off)")
    ap.add_argument("--no-audit-demote", action="store_true",
                    help="an audit mismatch does not demote the winner "
                         "table")
    ap.add_argument("--no-lane-quarantine", action="store_true",
                    help="an audit mismatch does not quarantine its lane")
    ap.add_argument("--flight-dir", default=None,
                    help="where a failed or late job's flight dump and an "
                         "audit mismatch's dual-stream dump go (default "
                         f"{default_flight_dir()}, used best-effort; '' "
                         "writes none; a named directory that is not "
                         "writable fails the start)")
    ap.add_argument("--flight-events", type=int,
                    default=obs_flight.DEFAULT_CAPACITY,
                    help="the flight ring's capacity in spans (default "
                         f"{obs_flight.DEFAULT_CAPACITY})")
    ap.add_argument("--trace-pull-events", type=int,
                    default=obs_flight.DEFAULT_PULL_EVENTS,
                    help="the most spans one trace_pull returns (default "
                         f"{obs_flight.DEFAULT_PULL_EVENTS})")
    ap.add_argument("--metrics-port", type=_metrics_port, default=None,
                    help="serve Prometheus text on this 127.0.0.1 HTTP "
                         "port as /metrics, with /healthz (0: ephemeral; "
                         "default: none; the scrape RPC answers "
                         "regardless)")
    ap.add_argument("--journal", default=None,
                    help="JSONL journal of every job's lifecycle, keyed "
                         "by job and trace id (default: off; an "
                         "unwritable path fails the start)")
    ap.add_argument("--journal-max-bytes", type=int,
                    default=JOURNAL_MAX_BYTES,
                    help="rotate the journal past this many bytes (one "
                         f"older generation kept; default "
                         f"{JOURNAL_MAX_BYTES})")
    ap.add_argument("--no-exemplars", action="store_true",
                    help="no trace-id or flight-dump exemplars on the "
                         "job-latency histogram")
    ap.add_argument("--slo-budget", type=float,
                    default=obs_fleet.DEFAULT_BUDGET,
                    help="the allowed deadline-miss rate the burn rate is "
                         f"measured against (default "
                         f"{obs_fleet.DEFAULT_BUDGET})")
    ap.add_argument("--slo-burn-fast-s", type=float,
                    default=obs_fleet.DEFAULT_FAST_S,
                    help="the burn rate's fast window in seconds (default "
                         f"{obs_fleet.DEFAULT_FAST_S:g})")
    ap.add_argument("--slo-burn-slow-s", type=float,
                    default=obs_fleet.DEFAULT_SLOW_S,
                    help="the burn rate's slow window in seconds (default "
                         f"{obs_fleet.DEFAULT_SLOW_S:g})")
    ap.add_argument("--slo-burn-threshold", type=float,
                    default=obs_fleet.DEFAULT_THRESHOLD,
                    help="the burn multiple both windows must reach for "
                         f"the alert to fire (default "
                         f"{obs_fleet.DEFAULT_THRESHOLD:g})")
    ap.add_argument("--cuda-trace", default=None, metavar="PATH",
                    help="record every span (a full recorder in place of "
                         "the flight ring) and write the Chrome trace here "
                         "at drain")
    ap.add_argument("--cuda-metrics", default=None, metavar="PATH",
                    help="write the stats snapshot here as JSON at drain")
    args = ap.parse_args(argv)

    kw = dict(socket_path=args.socket, port=args.port, workers=args.workers,
              queue_depth=args.queue_depth,
              drain_timeout_s=args.drain_timeout,
              iteration_windows=args.iteration_windows,
              max_wait_s=args.max_wait_ms / 1000.0,
              tenant_weights=args.tenant_weights,
              tenant_quota=args.tenant_quota,
              tenant_burst=args.tenant_burst, max_frame=args.max_frame,
              warmup=not args.no_warmup, window_length=args.window_length,
              quality_threshold=args.quality_threshold,
              error_threshold=args.error_threshold,
              trim=not args.no_trimming, match=args.match,
              mismatch=args.mismatch, gap=args.gap, job_threads=args.threads,
              device=args.device, cuda_poa_batches=args.cudapoa_batches,
              cuda_banded_alignment=args.cuda_banded_alignment,
              cuda_aligner_batches=args.cudaaligner_batches,
              cuda_aligner_band_width=args.cudaaligner_band_width,
              aligner_max_length=args.cudaaligner_max_length,
              device_latency_s=args.device_latency_s,
              device_latency_x=args.device_latency_x,
              host_poa_chunk=args.host_poa_chunk,
              cuda_engine=args.cuda_engine, cuda_fused=args.cuda_fused,
              score_dtype=args.cuda_dtype,
              pipeline_depth=args.cuda_pipeline_depth,
              adaptive_buckets=args.cuda_adaptive_buckets,
              autotune_table=args.cuda_autotune_table,
              wincache=args.wincache,
              wincache_max_bytes=args.wincache_max_bytes,
              frag_group=args.frag_group, preempt=args.preempt,
              abort_margin=args.abort_margin,
              worker_lanes=args.worker_lanes, audit_rate=args.audit_rate,
              audit_demote=not args.no_audit_demote,
              lane_quarantine=not args.no_lane_quarantine,
              flight_events=args.flight_events,
              trace_pull_events=args.trace_pull_events,
              metrics_port=args.metrics_port, journal=args.journal,
              journal_max_bytes=args.journal_max_bytes,
              exemplars=not args.no_exemplars, slo_budget=args.slo_budget,
              slo_burn_fast_s=args.slo_burn_fast_s,
              slo_burn_slow_s=args.slo_burn_slow_s,
              slo_burn_threshold=args.slo_burn_threshold,
              trace_path=args.cuda_trace, metrics_path=args.cuda_metrics)
    if args.flight_dir is not None:
        kw["flight_dir"] = args.flight_dir
    try:
        server = PolishServer(**kw).start()
    except (RaconError, OSError) as exc:
        print(f"[racon_tpu_torch::serve] error: {exc}", file=sys.stderr)
        return 1

    stop = threading.Event()

    def _on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    while not stop.is_set() and not server.wait_stopped(0.2):
        pass
    server.drain()
    return 0
