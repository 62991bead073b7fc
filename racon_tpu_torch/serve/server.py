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

Not ported here: the metrics HTTP port and `scrape`, the journal (the
auditor's `journal` is given only from Python), the flight recorder,
`trace_pull` / `debug`, per-job trace scoping and the SLO burn-rate
tracker.
"""

from __future__ import annotations

import contextlib
import gzip
import os
import random
import socket
import sys
import tempfile
import threading
import time

from ..errors import RaconError
from ..obs.hist import HistogramSet
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
        self.flight_dir = kw.pop("flight_dir", None)
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
        self._warm: dict | None = None

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
        # a card that is not there fails the start, warm-up or not
        resolve(cfg.device)
        for d in cfg.devices or ():
            resolve(d)
        if cfg.warmup:
            self.warmup()
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
        log_info(f"[racon_tpu_torch::serve] listening on {cfg.address} "
                 f"({cfg.workers} workers, queue depth {cfg.queue_depth}, "
                 f"device {cfg.device}"
                 + (f", warm in {self._warm['warmup_s']:.2f}s"
                    if self._warm else "") + ")")
        return self

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
            autotune_table=cfg.autotune_table, fault_plan=fault_plan)

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
        self._drained_clean = clean
        self._stopped.set()
        return clean

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
            return {"type": "pong", "warm": self._warm is not None,
                    "uptime_s": round(
                        time.perf_counter() - self._t_start, 3)}
        if rtype == "stats":
            return dict(self.stats_snapshot(), type="stats")
        if rtype == "healthz":
            return dict(self.healthz_snapshot(), type="healthz")
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
            if val is not None and (not isinstance(val, str)
                                    or not 0 < len(val) <= 64
                                    or not set(val) <= _ID_OK):
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
                  want_progress=bool(req.get("progress")),
                  want_stream=bool(req.get("stream")),
                  tenant=req.get("tenant") or "", rounds=rounds,
                  range_lo=range_lo, range_hi=range_hi, fragment=fragment,
                  frag_lo=frag_lo, frag_hi=frag_hi)
        if ingest_spec is not None:
            # a file that does not parse fails this job at the door,
            # typed, before it takes queue or device time
            from .ingest import IngestError, prepare

            try:
                done = prepare(job.sequences, job.overlaps, job.target,
                               ingest_spec, self._ingest_workdir(), job.id,
                               trace_id=job.trace_id)
            except IngestError as exc:
                return error_response("bad-request", str(exc),
                                      job_id=job_id,
                                      terminal="rejected-ingest",
                                      stage=exc.stage)
            job.sequences, job.overlaps, job.target = done
        try:
            self.queue.submit(job)
        except TenantQuotaExceeded as exc:
            return error_response("tenant-quota", str(exc),
                                  retry_after=round(exc.retry_after, 3),
                                  tenant=job.tenant, job_id=job_id)
        except QueueFull as exc:
            return error_response("queue-full", str(exc),
                                  retry_after=round(exc.retry_after, 3),
                                  job_id=job_id)
        except DeadlineDoomed as exc:
            # the service-time estimate says the job cannot meet its
            # deadline: it fails before it costs queue or device time
            with self._run_lock:
                self.qos["doomed_at_admission"] += 1
            return error_response(
                "deadline-doomed", str(exc), job_id=job_id,
                predicted_s=round(exc.predicted_s, 3),
                remaining_s=round(exc.remaining_s, 3))
        except Draining as exc:
            return error_response("draining", str(exc), job_id=job_id)
        self._maybe_preempt(job)
        if job.relaying:
            self._stream_frames(job, conn)
        else:
            job.event.wait()
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
        try:
            resp = self._run_job(job)
            ok = True
        except JobCancelledError as exc:
            resp = error_response("cancelled", str(exc), job_id=job.id,
                                  error_type=type(exc).__name__,
                                  queue_wait_s=round(job.queue_wait_s, 4))
        except DeadlineDoomed as exc:
            # the iteration-boundary estimate gave the deadline up
            with self._run_lock:
                self.qos["doomed_mid_run"] += 1
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
            self.queue.task_done(job, ok, time.perf_counter() - t0)
        finally:
            job.finish()
            self._qos_job_done(job)
            with self._idle:
                self._inflight -= 1
                self._idle.notify_all()

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
        opts = job.options
        t0 = time.perf_counter()
        launches0 = _job_launches()
        polisher = self._polisher(
            (job.sequences, job.overlaps, job.target), opts,
            fault_plan=job.fault_plan)
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
                        with self._rounds_lock:
                            self._rounds["completed"] += 1
                        if not final:
                            polisher.redraft(polished, workdir,
                                             tag=f"r{rnd}")
                            polisher.initialize()
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
        return out

    def _on_audit_alert(self, state: str, detail: dict) -> None:
        """The auditor's alert sink: logged (the alert clears with
        `auditor.ack()`)."""
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
                    help="where an audit mismatch writes its dual-stream "
                         "dump (default: none written)")
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
              flight_dir=args.flight_dir)
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
