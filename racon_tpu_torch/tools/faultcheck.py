"""The fault grid: the port's resilience contract, cell by cell.

    python -m racon_tpu_torch.tools.faultcheck [--quick] [--device cuda|cpu]

A small seeded polishing job (mixed read lengths: with the aligner's
length envelope at 1,024, its two 1,300 bp reads are host-fallback
pairs) runs with a fault injected at each point of `MATRIX` (pack
raise, device raise, device hang, unpack corrupt, fallback raise, in
the alignment phase with the device aligner on and in the consensus
phase with it off, and a persistent device failure), under each column:

    depth0        the synchronous pipeline
    depth2        the dispatch pipeline at depth 2
    depth2+sched  depth 2 with the occupancy scheduler armed
    depth2+trace  depth 2 with the span tracer armed
    depth2+fused  depth 2, device consensus through the fused engine
    serve         the fault as a per-job plan on one warm server
    serve-lanes2  the same on a two-lane server, beside a clean job

The JAX package's `depth2+pallas` column folds into `--device`: on
`cuda` (the default; it raises without a card) every column launches
the kernels, and on `cpu` every column runs their plain versions.

The port has no watchdog and no retry or fallback ladder, so a cell
holds the run to the port's own contract (resilience/faults.py):

  - a `raise` or `corrupt` row: the fault fired (`faults` >= 1); the run
    raised the taxonomy's type and no other (`raise` -> DeviceError,
    `corrupt` -> ChunkCorrupt); no `racon-torch-*` thread outlives it
    (the grid's servers' `racon-torch-serve-*` threads excepted); its
    wall is under WALL_CAP; and a clean run right after, in the same
    process, writes the clean bytes. `depth2+trace` also validates the
    Chrome trace: its `resilience.faults` instants equal the failed
    polisher's counter;
  - a `hang` row: the stage stalls and the run goes on: the bytes equal
    the clean run's, and the wall is at least the stall and less than
    the stall plus WALL_CAP (`stalled <s>s (no deadline)`). No deadline
    turns a hang into a typed timeout: a deadline is the watchdog;
  - the `serve` column: the poisoned job fails with the row's typed
    error (a hang row's job stalls and answers the clean bytes), the
    server survives and its next clean job gives the clean bytes;
    `serve-lanes2` runs a clean job beside the poisoned one, which must
    answer the clean bytes.

Clean gates before the grid: the scheduler-on run equals the static run,
and `--cuda-fused 0` equals `1` on the fused engine. Sections after it,
each a cell or two:

    audit     a silent `sdc` flip caught, journaled, demoted and repaired
              at audit rate 1.0, and shipped unnoticed at rate 0
    router    two `serve` replica processes behind a router, one killed
              with `kill -9` mid-job: the requeued job and a concurrent
              one both give a solo run's bytes
    range     one contig range-sharded over two replica processes that
              run the device engines (`-c 1 --cudaaligner-batches 1`;
              on cuda each shard must launch K1 and K2), one killed
              mid-job: requeued, segments tiled, identical
    fragment  a poisoned fragment ingest refused typed beside a contig
              job; a fragment job read-range-sharded over two replica
              processes, one killed mid-job
    trace     a traced routed job through a kill: the requeue instant in
              the merged trace, tracereport's checks clean
    preempt   a gold job preempting a free one; a cancel during a
              device hang, typed `JobCancelled` once the stall returns

A `hang=8` plan keeps the routed shards busy while a replica is killed;
the stall is waited out. It stalls a shard's first device dispatch
(the aligner's, where the device aligner is on), so the replica is
killed before that dispatch launches: no kernel is in flight then. Replica stderr goes to a log in the section's
temporary directory and is printed with a failed cell. `--quick` drops
the hang rows. The grid goes to stderr; the exit code is 0 only when
every cell is green. Knobs are flags: no environment variable sets any.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import sys
import tempfile
import threading
import time

#: (name, aligner_batches, fault spec, slow)
MATRIX = [
    ("align pack raise", 1, "pack:chunk=0:raise", False),
    ("align device raise", 1, "device:chunk=0:raise", False),
    ("align device hang", 1, "device:chunk=0:hang=5", True),
    ("align unpack corrupt", 1, "unpack:chunk=0:corrupt", False),
    ("align fallback raise", 1, "fallback:chunk=0:raise", False),
    ("consensus pack raise", 0, "pack:chunk=0:raise", False),
    ("consensus device raise", 0, "device:chunk=0:raise", False),
    ("consensus device hang", 0, "device:chunk=0:hang=5", True),
    ("consensus unpack corrupt", 0, "unpack:chunk=0:corrupt", False),
    ("consensus device persistent", 0,
     "device:chunk=0:raise,device:chunk=0:raise", False),
]

#: the one-shot columns: name -> (pipeline depth, adaptive scheduler,
#: traced, fused engine)
ONE_SHOT = {"depth0": (0, False, False, False),
            "depth2": (2, False, False, False),
            "depth2+sched": (2, True, False, False),
            "depth2+trace": (2, False, True, False),
            "depth2+fused": (2, False, False, True)}
SERVE_COLUMNS = ("serve", "serve-lanes2")
COLUMNS = tuple(ONE_SHOT) + SERVE_COLUMNS

#: the aligner's length envelope: faultcheck's two 1,300 bp reads become
#: host-fallback pairs, the work the `fallback` row injects into
MAX_LENGTH = 1024

WALL_CAP = 120.0  # a cell's budget; a wedged run fails, it does not hang

#: the thread-name prefix of the port's workers; the serve threads of
#: the grid's live servers are not orphans
THREAD_PREFIX = "racon-torch"
SERVE_PREFIX = "racon-torch-serve"


def make_dataset(dirname: str, rng: random.Random):
    """The grid's seeded job (gzip reads / PAF / draft), written byte for
    byte as the JAX tool writes it for the same `rng`: a 2 kb truth, a 4%
    draft, 400 bp reads every 100 bases and two 1,300 bp reads."""
    import gzip

    from ..synth import ACGT, mutate

    truth = bytes(rng.choice(ACGT) for _ in range(2000))
    draft = mutate(rng, truth, 0.04)
    jobs = [(start, 400) for start in range(0, len(truth) - 400, 100)]
    jobs += [(0, 1300), (600, 1300)]  # overlength: host-fallback pairs
    reads, paf = [], []
    for k, (start, read_len) in enumerate(jobs):
        read = mutate(rng, truth[start:start + read_len], 0.05)
        reads.append((f"r{k}", read))
        t_end = min(start + read_len, len(draft))
        paf.append(f"r{k}\t{len(read)}\t0\t{len(read)}\t+\tdraft\t"
                   f"{len(draft)}\t{start}\t{t_end}\t{read_len}\t"
                   f"{read_len}\t60")
    paths = (os.path.join(dirname, "reads.fasta.gz"),
             os.path.join(dirname, "ovl.paf.gz"),
             os.path.join(dirname, "draft.fasta.gz"))
    with gzip.open(paths[0], "wb") as f:
        for name, read in reads:
            f.write(b">" + name.encode() + b"\n" + read + b"\n")
    with gzip.open(paths[1], "wb") as f:
        f.write(("\n".join(paf) + "\n").encode())
    with gzip.open(paths[2], "wb") as f:
        f.write(b">draft\n" + draft + b"\n")
    return paths


def fasta(polished) -> bytes:
    return b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                    for s in polished)


class Grid:
    """The grid's fixed posture: the dataset, the device and a winner
    table path that is never written (every engine dispatches cold)."""

    def __init__(self, paths, device: str, table: str):
        self.paths = paths
        self.device = device
        self.table = table
        #: the clean bytes per (depth, aligner) and ("fused", aligner)
        self.clean: dict = {}

    def polisher(self, depth: int, aligner: int, adaptive: bool = False,
                 fused: str | None = None, fault_plan: str | None = None):
        """A one-shot kC polisher of the grid's job (-q -1, 2 threads)."""
        from ..core.polisher import PolisherType, create_polisher

        return create_polisher(
            *self.paths, PolisherType.kC, 500, -1.0, 0.3, num_threads=2,
            cuda_aligner_batches=aligner,
            cuda_poa_batches=1 if fused else 0,
            cuda_engine="fused" if fused else "session",
            cuda_fused=fused or "auto", pipeline_depth=depth,
            adaptive_buckets=adaptive, device=self.device,
            autotune_table=self.table, fault_plan=fault_plan,
            aligner_max_length=MAX_LENGTH)

    def polish(self, depth: int, aligner: int, **kw) -> bytes:
        p = self.polisher(depth, aligner, **kw)
        p.initialize()
        return fasta(p.polish())

    def clean_gates(self, aligners=(0, 1), depths=(0, 2),
                    columns=COLUMNS) -> list[str]:
        """The clean bytes, and the clean gates the columns rest on: the
        scheduler-on run equals the static one, `cuda_fused` 0 equals 1.
        Returns the failed gates."""
        bad = []
        for depth in depths:
            for aligner in aligners:
                self.clean[depth, aligner] = self.polish(depth, aligner)
        for aligner in aligners:
            if "depth2+sched" in columns and self.polish(
                    2, aligner, adaptive=True) != self.clean[2, aligner]:
                bad.append(f"the scheduler-on clean run diverged from the "
                           f"static run (aligner {aligner})")
            if "depth2+fused" in columns:
                split = self.polish(2, aligner, fused="0")
                self.clean["fused", aligner] = self.polish(2, aligner,
                                                           fused="1")
                if self.clean["fused", aligner] != split:
                    bad.append(f"the fused engine's one-launch clean run "
                               f"diverged from the split path (aligner "
                               f"{aligner})")
        return bad


def orphans(grace: float = 3.0) -> list[str]:
    """The port's worker threads still alive after `grace` seconds."""
    deadline = time.perf_counter() + grace
    while True:
        alive = [t.name for t in threading.enumerate()
                 if t.name.startswith(THREAD_PREFIX)
                 and not t.name.startswith(SERVE_PREFIX)]
        if not alive or time.perf_counter() >= deadline:
            return alive
        time.sleep(0.05)


def validate_trace(trace_path: str, stats: dict) -> str | None:
    """A failed run's Chrome trace: valid trace-event JSON whose
    `resilience.faults` and `resilience.quarantined` instants equal the
    run's counters. None when it holds, else a failure."""
    try:
        with open(trace_path) as fh:
            events = json.load(fh)["traceEvents"]
    except (OSError, ValueError, KeyError, TypeError) as exc:
        return f"FAIL trace unparseable ({type(exc).__name__}: {exc})"
    for ev in events:
        for field in ("name", "ph", "pid", "tid"):
            if field not in ev:
                return f"FAIL trace event missing {field!r}"
        if ev["ph"] == "X" and (ev["dur"] < 0 or ev["ts"] < 0):
            return "FAIL trace span with negative ts/dur"
    for key in ("faults", "quarantined"):
        seen = sum(ev.get("args", {}).get("n", 1) for ev in events
                   if ev["name"] == f"resilience.{key}")
        if seen != stats[key]:
            return (f"FAIL trace {key} events {seen} != counter "
                    f"{stats[key]}")
    return None


def expected_error(spec: str):
    """The taxonomy type a one-shot `raise` / `corrupt` spec must raise,
    or None for a hang spec; and the hang's stall in seconds."""
    from ..errors import ChunkCorrupt, DeviceError

    actions = [e.split(":")[-1] for e in spec.split(",")]
    if actions[0].startswith("hang="):
        return None, float(actions[0].partition("=")[2])
    return (ChunkCorrupt if actions[0] == "corrupt" else DeviceError), 0.0


def run_cell(grid: Grid, column: str, aligner: int, spec: str) -> str:
    """One one-shot cell under the port's contract (module docstring)."""
    from ..obs import trace as obs_trace

    depth, adaptive, traced, fused = ONE_SHOT[column]
    kw = {"adaptive": adaptive, "fused": "1" if fused else None}
    expect = grid.clean["fused", aligner] if fused \
        else grid.clean[depth, aligner]
    want, stall = expected_error(spec)
    trace_path = None
    if traced:
        fd, trace_path = tempfile.mkstemp(suffix=".json",
                                          prefix="racon_torch_trace_")
        os.close(fd)
        obs_trace.configure(trace_path)
    out, caught, pol = None, None, None
    t0 = time.perf_counter()
    try:
        pol = grid.polisher(depth, aligner, fault_plan=spec, **kw)
        pol.initialize()
        out = fasta(pol.polish())
    except Exception as exc:  # noqa: BLE001 — the cell checks its type
        caught = exc
    finally:
        wall = time.perf_counter() - t0
        if traced:
            try:
                obs_trace.save(trace_path)
            finally:
                obs_trace.reset()
    try:
        if pol is None:
            return f"FAIL crashed ({type(caught).__name__}: {caught})"
        stats = pol.stage_stats
        if stats["faults"] < 1:
            return "FAIL fault never fired"
        if want is None:
            if caught is not None:
                return f"FAIL crashed ({type(caught).__name__}: {caught})"
            if wall < stall:
                return f"FAIL returned before the stall ({wall:.1f}s)"
            if wall >= stall + WALL_CAP:
                return f"FAIL over budget ({wall:.0f}s)"
        else:
            if caught is None:
                return "FAIL the fault did not fail the run"
            if type(caught) is not want:
                return (f"FAIL raised {type(caught).__name__}, not "
                        f"{want.__name__} ({caught})")
            if wall > WALL_CAP:
                return f"FAIL over budget ({wall:.0f}s)"
        left = orphans()
        if left:
            return f"FAIL orphaned threads {left}"
        if traced:
            bad = validate_trace(trace_path, stats)
            if bad is not None:
                return bad
        tag = " traced" if traced else ""
        if want is None:
            if out != expect:
                return "FAIL output diverged after the stall"
            return f"pass  stalled {stall:g}s (no deadline){tag}"
        if grid.polish(depth, aligner, **kw) != expect:
            return "FAIL the clean run after the fault diverged"
        return f"pass  {want.__name__}{tag}, next clean"
    finally:
        if trace_path is not None:
            try:
                os.unlink(trace_path)
            except OSError:
                pass


def _poisoned(client, paths, aligner: int, spec: str, t0: float):
    """Submit the poisoned job. Returns (outcome, failure): the outcome is
    the typed error's name for a raise or corrupt row, the stalled job's
    FASTA for a hang row; the failure a FAIL cell, or None."""
    from ..serve import JobFailed, ServeError

    want, stall = expected_error(spec)
    opts = {"cuda_aligner_batches": aligner}
    try:
        res = client.submit(*paths, fault_plan=spec, options=opts)
    except JobFailed as exc:
        if want is None or exc.error_type != want.__name__:
            return None, f"FAIL untyped failure ({exc.error_type})"
        return exc.error_type, None
    except ServeError as exc:
        return None, f"FAIL {exc.code}: {exc}"
    except Exception as exc:  # noqa: BLE001 — a failed cell
        return None, f"FAIL {type(exc).__name__}: {exc}"
    if want is not None:
        return None, "FAIL poisoned job succeeded"
    wall = time.perf_counter() - t0
    if wall < stall:
        return None, f"FAIL answered before the stall ({wall:.1f}s)"
    return res.fasta, None


def run_serve_cell(grid: Grid, client, aligner: int, spec: str) -> str:
    """One `serve` cell: the row's fault as a per-job plan against the
    grid's live server, then a clean job on it."""
    t0 = time.perf_counter()
    got, bad = _poisoned(client, grid.paths, aligner, spec, t0)
    if bad:
        return bad
    wall = time.perf_counter() - t0
    if wall > WALL_CAP + expected_error(spec)[1]:
        return f"FAIL over budget ({wall:.0f}s)"
    stalled = isinstance(got, bytes)
    if stalled and got != grid.clean[2, aligner]:
        return "FAIL the stalled job diverged"
    try:
        after = client.submit(*grid.paths,
                              options={"cuda_aligner_batches": aligner})
    except Exception as exc:  # noqa: BLE001 — a dead server fails
        return f"FAIL server did not survive ({type(exc).__name__}: {exc})"
    if after.fasta != grid.clean[2, aligner]:
        return "FAIL clean job after fault diverged"
    if stalled:
        return f"pass  stalled {expected_error(spec)[1]:g}s, next clean"
    return f"pass  {got}, next clean"


def run_serve_lanes_cell(grid: Grid, client, aligner: int,
                         spec: str) -> str:
    """One `serve-lanes2` cell: the poisoned job on the two-lane server
    beside a concurrent clean job, which must answer the clean bytes."""
    clean_result: dict = {}

    def clean_job():
        try:
            clean_result["resp"] = client.submit(
                *grid.paths, options={"cuda_aligner_batches": aligner},
                retries=3)
        except Exception as exc:  # noqa: BLE001 — checked below
            clean_result["exc"] = exc

    t = threading.Thread(target=clean_job, daemon=True)
    t.start()
    t0 = time.perf_counter()
    got, bad = _poisoned(client, grid.paths, aligner, spec, t0)
    wall = time.perf_counter() - t0
    t.join(WALL_CAP)
    if bad:
        return bad
    if wall > WALL_CAP + expected_error(spec)[1]:
        return f"FAIL over budget ({wall:.0f}s)"
    if isinstance(got, bytes) and got != grid.clean[2, aligner]:
        return "FAIL the stalled job diverged"
    if "exc" in clean_result:
        exc = clean_result["exc"]
        return (f"FAIL concurrent clean job died ({type(exc).__name__}: "
                f"{exc})")
    if "resp" not in clean_result:
        return "FAIL concurrent clean job never finished"
    if clean_result["resp"].fasta != grid.clean[2, aligner]:
        return "FAIL concurrent clean job diverged"
    how = (f"stalled {expected_error(spec)[1]:g}s"
           if isinstance(got, bytes) else got)
    return f"pass  {how}, clean lane identical"


def grid_servers(grid: Grid, tmp: str, columns=COLUMNS) -> dict:
    """The live servers of the serve columns: column -> (server,
    client). The lanes server runs two lanes on the grid's device."""
    import torch

    from ..serve import PolishClient, PolishServer

    out = {}
    common = dict(workers=2, quality_threshold=-1.0, warmup=False,
                  device=grid.device, autotune_table=grid.table,
                  aligner_max_length=MAX_LENGTH,
                  flight_dir=os.path.join(tmp, "flight"))
    try:
        if "serve" in columns:
            srv = PolishServer(socket_path=os.path.join(tmp, "grid.sock"),
                               **common).start()
            out["serve"] = (srv, PolishClient(
                socket_path=srv.config.socket_path, timeout=600))
        if "serve-lanes2" in columns:
            dev = torch.device(grid.device)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", 0)
            srv = PolishServer(
                socket_path=os.path.join(tmp, "grid_lanes.sock"),
                worker_lanes=2, devices=[dev] * 2, **common).start()
            out["serve-lanes2"] = (srv, PolishClient(
                socket_path=srv.config.socket_path, timeout=600))
    except BaseException:
        for srv, _ in out.values():
            srv.drain(timeout=30)
        raise
    return out


def run_grid(grid: Grid, rows, columns, tmp: str, emit=None) -> list:
    """Every (row, column) cell; returns [(row name, [cell, ...])] and
    hands each finished row to `emit(name, cells)`."""
    servers = grid_servers(grid, tmp, columns)
    out = []
    try:
        for name, aligner, spec, _slow in rows:
            cells = []
            for column in columns:
                if column in ONE_SHOT:
                    cells.append(run_cell(grid, column, aligner, spec))
                elif column == "serve":
                    cells.append(run_serve_cell(
                        grid, servers["serve"][1], aligner, spec))
                else:
                    cells.append(run_serve_lanes_cell(
                        grid, servers["serve-lanes2"][1], aligner, spec))
            out.append((name, cells))
            if emit is not None:
                emit(name, cells)
    finally:
        for srv, _ in servers.values():
            srv.drain(timeout=60)
    return out


# ------------------------------------------------------------ sections
def plant_table(path: str, backend: str) -> None:
    """A winner table with an aggressive session entry per K1 bucket of
    `backend`, so the audit's online demotion has entries to veto."""
    from ..ops.poa_graph import BUCKETS
    from ..sched.autotune import Autotuner, plane

    at = Autotuner(path)
    for nb, lb in BUCKETS:
        at.record("session", (nb, lb), (3, -5, -4, 8),
                  {"kernel": plane(backend), "dtype": "int16", "ms": {},
                   "identical": True}, backend=backend)
    at.save()


def run_audit_cells(tmp: str, paths, device: str) -> list:
    """The identity audit against a silent `sdc` flip: one server at
    audit rate 1.0 over a planted winner table, with a journal and a
    flight directory. Sampled, the flip is caught, journaled, demoted on
    disk and repaired; at rate 0 it ships and no audit event fires."""
    import torch

    from ..obs.journal import read_journal
    from ..sched.autotune import Autotuner, reset_autotuner_cache
    from ..serve import PolishClient, PolishServer

    names = ("audit sdc sampled", "audit sdc unsampled")
    cells: list = []
    at_path = os.path.join(tmp, "audit_autotune.json")
    reset_autotuner_cache()
    server = None
    try:
        plant_table(at_path, torch.device(device).type)
        reset_autotuner_cache()
        journal = os.path.join(tmp, "audit_journal.jsonl")
        server = PolishServer(
            socket_path=os.path.join(tmp, "audit.sock"), workers=1,
            warmup=False, quality_threshold=-1.0, audit_rate=1.0,
            journal=journal, flight_dir=os.path.join(tmp, "audit_fl"),
            device=device, autotune_table=at_path,
            aligner_max_length=MAX_LENGTH).start()
        client = PolishClient(socket_path=server.config.socket_path,
                              timeout=600)
        # small windows keep the oracle's shadow passes cheap
        opts = {"cuda_poa_batches": 1, "window_length": 100}
        clean = client.submit(*paths, options=opts).fasta
        bad = client.submit(*paths, options=opts,
                            fault_plan="device:chunk=1:sdc").fasta
        snap = server.auditor.snapshot()
        events = [e for e in read_journal(journal)
                  if e.get("event") == "audit-mismatch"]
        table = Autotuner(at_path).table
        demoted_on_disk = any(e.get("demoted") for e in table.values()
                              if isinstance(e, dict))
        checks = [("repaired", bad == clean),
                  ("journal", len(events) >= 1),
                  ("counter", snap["mismatches"] >= 1),
                  ("demoted", snap["demotions"] >= 1 and demoted_on_disk)]
        failed = [n for n, ok in checks if not ok]
        cells.append((names[0],
                      f"pass  caught ({snap['mismatches']} mismatches, "
                      f"{snap['demotions']} demotions, FASTA identical)"
                      if not failed else f"FAIL {' '.join(failed)}"))
        # the same flip at rate 0 ships: the sampling's documented miss
        pre = snap["mismatches"]
        server.auditor.set_rate(0.0)
        missed = client.submit(*paths, options=opts,
                               fault_plan="device:chunk=1:sdc").fasta
        snap2 = server.auditor.snapshot()
        checks = [("shipped-corrupt", missed != clean),
                  ("no-audit-event", snap2["mismatches"] == pre)]
        failed = [n for n, ok in checks if not ok]
        cells.append((names[1],
                      "pass  missed (corruption shipped, no audit event: "
                      "the sampling's documented miss)"
                      if not failed else f"FAIL {' '.join(failed)}"))
    except Exception as exc:  # noqa: BLE001 — a crashed section is red
        detail = f"FAIL crashed ({type(exc).__name__}: {exc})"
        while len(cells) < len(names):
            cells.append((names[len(cells)], detail))
    finally:
        if server is not None:
            server.drain(timeout=60)
        reset_autotuner_cache()
    return cells


def one_shot(paths, device: str, fragment: bool = False) -> bytes:
    """A solo run at the serve defaults (w 500, -q 10, -e 0.3, host
    engines): the bytes a routed job must reproduce. It runs the
    synchronous pipeline (the same bytes as depth 2), which starts no
    worker thread, so a section may run beside the grid's orphan checks."""
    from ..core.polisher import PolisherType, create_polisher

    p = create_polisher(*paths, PolisherType.kF if fragment
                        else PolisherType.kC, 500, 10.0, 0.3,
                        num_threads=2, device=device, pipeline_depth=0,
                        aligner_max_length=MAX_LENGTH)
    p.initialize()
    return fasta(p.polish(not fragment))


class Replicas:
    """Replica processes (`python -m racon_tpu_torch serve`) on unix
    sockets under `tmp`, started at once, each one's stderr in
    `<tmp>/<tag>_rep<i>.log`; every process is killed on exit."""

    def __init__(self, tmp: str, tag: str, device: str, n: int = 2,
                 engine_args: tuple = ()):
        from ..serve.autoscale import spawn_replica

        self.socks = [os.path.join(tmp, f"{tag}_rep{i}.sock")
                      for i in range(n)]
        self.procs = [spawn_replica(sock, [
            "--device", device, "--workers", "2", "--no-warmup",
            "--cudaaligner-max-length", str(MAX_LENGTH), *engine_args])
            for sock in self.socks]

    def __enter__(self) -> "Replicas":
        return self

    def wait_up(self, timeout: float = 120.0) -> None:
        from ..serve.autoscale import wait_replica_ready

        for sock, proc in zip(self.socks, self.procs):
            if not wait_replica_ready(sock, proc, timeout):
                raise RuntimeError(f"replica {sock} never came up (exit "
                                   f"{proc.poll()}): {self.tails()}")

    def kill(self, i: int = 0) -> None:
        """The real `kill -9`."""
        self.procs[i].send_signal(signal.SIGKILL)

    def tails(self) -> list[str]:
        from ..serve.autoscale import replica_log_tail

        return [replica_log_tail(sock, 2000) for sock in self.socks]

    def __exit__(self, *exc_info) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)


#: the plan that keeps every routed shard busy while a replica is
#: killed: the stall is waited out and the bytes do not change
SLOW = {"fault_plan": "device:chunk=0:hang=8"}


def _router(reps: Replicas, tmp: str, tag: str, journal: str):
    from ..serve import PolishRouter

    return PolishRouter(replicas=",".join(reps.socks),
                        socket_path=os.path.join(tmp, f"{tag}_rt.sock"),
                        journal=journal, health_interval_s=0.5).start()


def _exc_note(res: dict) -> list:
    exc = res.get("exc")
    return [f"({type(exc).__name__}: {exc})"] if exc is not None else []


def run_router_cells(tmp: str, device: str) -> list:
    """Two replica processes behind a router, one killed with `kill -9`
    mid-job: the requeued job and a concurrent one both give a solo
    run's bytes; `requeued` and `replica-down` are on the journal."""
    from ..obs.journal import read_journal
    from ..serve import PolishClient, make_synth_dataset

    names = ("router kill -9 mid-job", "router survivor concurrent job")
    cells: list = []
    data_dir = os.path.join(tmp, "router_data")
    os.makedirs(data_dir, exist_ok=True)
    rpaths = make_synth_dataset(data_dir, contigs=4)
    journal = os.path.join(tmp, "router_journal.jsonl")
    router = None
    reps = Replicas(tmp, "router", device)
    try:
        with reps:
            clean = one_shot(rpaths, device)
            reps.wait_up()
            router = _router(reps, tmp, "router", journal)
            main_res: dict = {}
            side_res: dict = {}

            def run_job(out: dict):
                mine = PolishClient(socket_path=router.config.socket_path,
                                    timeout=600)
                try:
                    out["fasta"] = mine.submit(*rpaths, stream=True,
                                               **SLOW).fasta
                except Exception as exc:  # noqa: BLE001 — checked below
                    out["exc"] = exc

            threads = [threading.Thread(target=run_job, args=(r,),
                                        daemon=True)
                       for r in (main_res, side_res)]
            for t in threads:
                t.start()
            time.sleep(1.0)  # shards dispatched and stalled on chunk 0
            reps.kill(0)
            for t in threads:
                t.join(WALL_CAP)
            events = [e["event"] for e in read_journal(journal)]
            for name, res, requeue in ((names[0], main_res, True),
                                       (names[1], side_res, False)):
                checks = [("completed", "fasta" in res),
                          ("identical", res.get("fasta") == clean)]
                if requeue:
                    checks.append(("requeued-journaled",
                                   "requeued" in events
                                   and "replica-down" in events))
                failed = [n for n, ok in checks if not ok] + _exc_note(res)
                cells.append((name, "pass  " + (
                    "requeued, identical" if requeue
                    else "undisturbed, identical")
                    if not failed else f"FAIL {' '.join(failed)} "
                                       f"{reps.tails()}"))
    except Exception as exc:  # noqa: BLE001 — a crashed section is red
        detail = (f"FAIL crashed ({type(exc).__name__}: {exc}) "
                  f"{reps.tails()}")
        while len(cells) < len(names):
            cells.append((names[len(cells)], detail))
    finally:
        if router is not None:
            router.drain()
    return cells


#: the range section's replicas run the device engines (K1 and K2 on a
#: card, their plain versions on the CPU); the other sections' replicas
#: run the serve defaults, the host engines, as the JAX tool's do
ENGINE_ARGS = ("-c", "1", "--cudaaligner-batches", "1")


def run_range_cells(tmp: str, device: str, detail: dict | None = None
                    ) -> list:
    """One contig range-sharded over two replica processes running the
    device engines (ENGINE_ARGS), one killed with `kill -9` mid-job: the
    requeued window range completes on the survivor with a solo run's
    bytes; the journal holds `range-plan`, `requeued` and
    `replica-down`, is consistent, and obsreport's segment receipts tile
    the window axis once. The job is traced, so the router returns each
    shard's serve batch; on cuda every shard must have launched K1 and
    K2 in its replica. `detail`, when given, receives those batches
    (`shards`) and the job's wall (`wall_s`)."""
    from ..obs.journal import check_consistency, read_journal
    from ..serve import PolishClient, make_synth_dataset
    from . import obsreport

    name = "range-shard kill -9 mid-job"
    data_dir = os.path.join(tmp, "range_data")
    os.makedirs(data_dir, exist_ok=True)
    rpaths = make_synth_dataset(data_dir)  # one contig
    journal = os.path.join(tmp, "range_journal.jsonl")
    router = None
    reps = Replicas(tmp, "range", device, engine_args=(
        *ENGINE_ARGS, "--cuda-autotune-table",
        os.path.join(tmp, "range_autotune.json")))
    try:
        with reps:
            clean = one_shot(rpaths, device)
            reps.wait_up()
            router = _router(reps, tmp, "range", journal)
            res: dict = {}

            def run_job():
                mine = PolishClient(socket_path=router.config.socket_path,
                                    timeout=600)
                try:
                    res["resp"] = mine.submit(*rpaths, stream=True,
                                              trace=True, **SLOW)
                except Exception as exc:  # noqa: BLE001 — checked below
                    res["exc"] = exc

            t = threading.Thread(target=run_job, daemon=True)
            t0 = time.perf_counter()
            t.start()
            time.sleep(1.0)  # both range shards dispatched and stalled
            reps.kill(0)
            t.join(WALL_CAP)
            wall = time.perf_counter() - t0
            entries = read_journal(journal)
            events = [e["event"] for e in entries]
            resp = res.get("resp")
            shards = [d.get("batch") or {} for d in
                      (resp.router.get("shards_detail") or ()
                       if resp is not None else ())]
            if detail is not None:
                detail.update(shards=shards, wall_s=wall)
            launched = bool(shards) and all(
                b.get("k1_launches", 0) > 0 and b.get("k2_launches", 0) > 0
                for b in shards)
            checks = [("completed", resp is not None),
                      ("identical", resp is not None
                       and resp.fasta == clean),
                      ("range-sharded", resp is not None
                       and resp.router.get("range") is True),
                      ("range-plan-journaled", "range-plan" in events),
                      ("requeued-journaled", "requeued" in events
                       and "replica-down" in events),
                      ("journal-consistent",
                       check_consistency(entries) == []),
                      ("segments-tile",
                       obsreport.check_parts_routed(entries) == [])]
            if device == "cuda":
                checks.append(("kernels-launched", launched))
            failed = [n for n, ok in checks if not ok] + _exc_note(res)
            cell = (f"pass  requeued, segments tiled, identical "
                    f"({wall:.1f}s)" if not failed
                    else f"FAIL {' '.join(failed)} {reps.tails()}")
    except Exception as exc:  # noqa: BLE001 — a crashed section is red
        cell = f"FAIL crashed ({type(exc).__name__}: {exc}) {reps.tails()}"
    finally:
        if router is not None:
            router.drain()
    return [(name, cell)]


def run_fragment_cells(tmp: str, device: str) -> list:
    """Fragment correction on the serve side. 1: a fragment submit of a
    reads file that is not FASTA, with ingest on, refused typed
    `bad-request` (`rejected-ingest` journaled) while a contig job on
    the same server gives its solo bytes, then a clean fragment job the
    solo kF bytes. 2: a fragment job read-range-sharded over two replica
    processes, one killed with `kill -9` mid-job: the solo kF bytes,
    `frag-plan` / `requeued` journaled, read groups tiling the axis."""
    from ..obs.journal import check_consistency, read_journal
    from ..serve import (PolishClient, PolishServer, ServeError,
                         make_fragment_dataset, make_synth_dataset)
    from . import obsreport

    names = ("fragment poisoned ingest, contig alongside",
             "fragment kill -9 mid-job")
    cells: list = []
    frag_dir = os.path.join(tmp, "frag_data")
    os.makedirs(frag_dir, exist_ok=True)
    fpaths = make_fragment_dataset(frag_dir)
    contig_dir = os.path.join(tmp, "frag_contig_data")
    os.makedirs(contig_dir, exist_ok=True)
    cpaths = make_synth_dataset(contig_dir)
    reps = Replicas(tmp, "frag", device)  # they start during cell 1
    router = None
    try:
        with reps:
            clean_frag = one_shot(fpaths, device, fragment=True)
            clean_contig = one_shot(cpaths, device)

            # ---- cell 1: poisoned fragment ingest, contig alongside
            journal1 = os.path.join(tmp, "frag_journal1.jsonl")
            try:
                bad = os.path.join(tmp, "frag_bad.fasta")
                with open(bad, "w") as fh:
                    fh.write("this is not fasta\n")
                srv = PolishServer(
                    socket_path=os.path.join(tmp, "frag.sock"), workers=2,
                    warmup=False, journal=journal1, device=device,
                    aligner_max_length=MAX_LENGTH).start()
                try:
                    res: dict = {}

                    def contig_job():
                        mine = PolishClient(
                            socket_path=srv.config.socket_path,
                            timeout=600)
                        try:
                            res["resp"] = mine.submit(*cpaths)
                        except Exception as exc:  # noqa: BLE001
                            res["exc"] = exc

                    t = threading.Thread(target=contig_job, daemon=True)
                    t.start()
                    client = PolishClient(
                        socket_path=srv.config.socket_path, timeout=600)
                    typed = None
                    try:
                        client.submit(bad, fpaths[1], fpaths[2],
                                      fragment=True, ingest=True)
                    except ServeError as exc:
                        typed = exc
                    after = client.submit(*fpaths, fragment=True)
                    t.join(WALL_CAP)
                finally:
                    srv.drain(timeout=60)
                entries = read_journal(journal1)
                events = [e["event"] for e in entries]
                checks = [("typed-reject", typed is not None
                           and typed.code == "bad-request"),
                          ("rejected-ingest-journaled",
                           "rejected-ingest" in events),
                          ("contig-survived", res.get("resp") is not None
                           and res["resp"].fasta == clean_contig),
                          ("fragment-after-reject-identical",
                           after.fasta == clean_frag),
                          ("journal-consistent",
                           check_consistency(entries) == [])]
                failed = [n for n, ok in checks if not ok] + _exc_note(res)
                cells.append((names[0],
                              "pass  typed bad-request, contig unharmed"
                              if not failed
                              else f"FAIL {' '.join(failed)}"))
            except Exception as exc:  # noqa: BLE001 — a red cell
                cells.append((names[0], f"FAIL crashed "
                                        f"({type(exc).__name__}: {exc})"))

            # ---- cell 2: kill -9 one replica mid-fragment-job
            reps.wait_up()
            journal2 = os.path.join(tmp, "frag_journal2.jsonl")
            router = _router(reps, tmp, "frag", journal2)
            res2: dict = {}

            def run_job():
                mine = PolishClient(socket_path=router.config.socket_path,
                                    timeout=600)
                try:
                    res2["resp"] = mine.submit(*fpaths, fragment=True,
                                               stream=True, **SLOW)
                except Exception as exc:  # noqa: BLE001 — checked below
                    res2["exc"] = exc

            t = threading.Thread(target=run_job, daemon=True)
            t.start()
            time.sleep(1.0)  # both fragment shards dispatched and stalled
            reps.kill(0)
            t.join(WALL_CAP)
            entries = read_journal(journal2)
            events = [e["event"] for e in entries]
            resp = res2.get("resp")
            checks = [("completed", resp is not None),
                      ("identical", resp is not None
                       and resp.fasta == clean_frag),
                      ("fragment-sharded", resp is not None
                       and resp.router.get("fragment") is True),
                      ("frag-plan-journaled", "frag-plan" in events),
                      ("requeued-journaled", "requeued" in events
                       and "replica-down" in events),
                      ("journal-consistent",
                       check_consistency(entries) == []),
                      ("read-groups-tile",
                       obsreport.check_parts_routed(entries) == [])]
            failed = [n for n, ok in checks if not ok] + _exc_note(res2)
            cells.append((names[1],
                          "pass  requeued, read groups tiled, identical"
                          if not failed
                          else f"FAIL {' '.join(failed)} {reps.tails()}"))
    except Exception as exc:  # noqa: BLE001 — a crashed section is red
        detail = (f"FAIL crashed ({type(exc).__name__}: {exc}) "
                  f"{reps.tails()}")
        while len(cells) < len(names):
            cells.append((names[len(cells)], detail))
    finally:
        if router is not None:
            router.drain()
    return cells


def run_trace_cells(tmp: str, device: str) -> list:
    """A traced routed job (`submit_traced`) over two replica processes,
    one killed with `kill -9` mid-job: a solo run's bytes, the journal's
    requeue consistent, the `router.requeue` instant in the merged
    trace and tracereport's checks clean."""
    from ..obs.journal import check_consistency, read_journal
    from ..serve import PolishClient, make_synth_dataset
    from . import tracereport

    name = "traced requeue kill -9 mid-job"
    data_dir = os.path.join(tmp, "trace_data")
    os.makedirs(data_dir, exist_ok=True)
    rpaths = make_synth_dataset(data_dir, contigs=4)
    journal = os.path.join(tmp, "trace_journal.jsonl")
    trace_out = os.path.join(tmp, "trace_merged.json")
    router = None
    reps = Replicas(tmp, "trace", device)
    try:
        with reps:
            clean = one_shot(rpaths, device)
            reps.wait_up()
            router = _router(reps, tmp, "trace", journal)
            res: dict = {}

            def run_job():
                mine = PolishClient(socket_path=router.config.socket_path,
                                    timeout=600)
                try:
                    r, doc = mine.submit_traced(*rpaths,
                                                trace_out=trace_out, **SLOW)
                    res["fasta"], res["doc"] = r.fasta, doc
                except Exception as exc:  # noqa: BLE001 — checked below
                    res["exc"] = exc

            t = threading.Thread(target=run_job, daemon=True)
            t.start()
            time.sleep(1.0)  # shards dispatched and stalled on chunk 0
            reps.kill(0)
            t.join(WALL_CAP)
            entries = read_journal(journal)
            events = [e["event"] for e in entries]
            doc = res.get("doc") or {}
            requeue_spans = sum(1 for ev in doc.get("traceEvents") or []
                                if ev.get("ph") == "i"
                                and ev.get("name") == "router.requeue")
            problems = (tracereport.check(doc, tracereport.analyze(doc))
                        if doc else ["no merged trace"])
            checks = [("completed", "fasta" in res),
                      ("identical", res.get("fasta") == clean),
                      ("requeued-journaled", "requeued" in events
                       and "replica-down" in events),
                      ("journal-consistent",
                       not check_consistency(entries)),
                      ("requeue-span", requeue_spans >= 1),
                      ("tracereport-check", not problems)]
            failed = [n for n, ok in checks if not ok] + _exc_note(res)
            if problems:
                failed.append(f"({problems[-1]})")
            cell = ("pass  requeue span present, report consistent"
                    if not failed
                    else f"FAIL {' '.join(failed)} {reps.tails()}")
    except Exception as exc:  # noqa: BLE001 — a crashed section is red
        cell = f"FAIL crashed ({type(exc).__name__}: {exc}) {reps.tails()}"
    finally:
        if router is not None:
            router.drain()
    return [(name, cell)]


def run_preempt_cells(tmp: str, device: str) -> list:
    """A gold job preempting a running free job on a one-worker server
    (both give the undisturbed bytes, `preempted` and `resumed`
    journaled); then a cancel landing during a `device:chunk=0:hang=8`
    job: acked, the job fails typed `JobCancelled` once the stall
    returns, and the server's next clean job gives the clean bytes."""
    from ..obs.journal import read_journal
    from ..serve import (JobCancelled, PolishClient, PolishServer,
                         make_synth_dataset)

    names = ("preempt gold over free", "cancel during device hang")
    cells: list = []
    data_dir = os.path.join(tmp, "preempt_data")
    os.makedirs(data_dir, exist_ok=True)
    ppaths = make_synth_dataset(data_dir, contigs=3)
    sock = os.path.join(tmp, "preempt.sock")
    journal = os.path.join(tmp, "preempt_journal.jsonl")
    server = None
    try:
        server = PolishServer(socket_path=sock, workers=1, warmup=False,
                              quality_threshold=-1.0, preempt=True,
                              journal=journal, device=device,
                              aligner_max_length=MAX_LENGTH).start()
        client = PolishClient(socket_path=sock, timeout=600)
        clean = client.submit(*ppaths).fasta

        def run_job(out: dict, **kw):
            mine = PolishClient(socket_path=sock, timeout=600)
            try:
                out["fasta"] = mine.submit(*ppaths, **kw).fasta
            except Exception as exc:  # noqa: BLE001 — checked below
                out["exc"] = exc

        free_res: dict = {}
        gold_res: dict = {}
        # the feeder held: the free job is pooled, not dispatched, when
        # gold arrives (the admission-time preemption, not a race)
        server.batcher.hold()
        try:
            t_free = threading.Thread(target=run_job, args=(free_res,),
                                      kwargs={"tenant": "free"},
                                      daemon=True)
            t_free.start()
            deadline = time.perf_counter() + 60
            while (time.perf_counter() < deadline
                   and not server.batcher._job_tickets):
                time.sleep(0.02)
            t_gold = threading.Thread(target=run_job, args=(gold_res,),
                                      kwargs={"tenant": "gold",
                                              "priority": 5}, daemon=True)
            t_gold.start()
            while (time.perf_counter() < deadline
                   and server.qos["preemptions"] < 1):
                time.sleep(0.02)
        finally:
            server.batcher.release()
        t_free.join(WALL_CAP)
        t_gold.join(WALL_CAP)
        events = [e["event"] for e in read_journal(journal)]
        checks = [("preempted", server.qos["preemptions"] >= 1),
                  ("preempted-journaled", "preempted" in events),
                  ("resumed-journaled", "resumed" in events),
                  ("free-identical", free_res.get("fasta") == clean),
                  ("gold-identical", gold_res.get("fasta") == clean)]
        failed = ([n for n, ok in checks if not ok] + _exc_note(free_res)
                  + _exc_note(gold_res))
        cells.append((names[0], "pass  preempted+resumed, both identical"
                      if not failed else f"FAIL {' '.join(failed)}"))

        # cell 2: a cancel landing inside the hang on the same server
        poison_res: dict = {}
        t_poison = threading.Thread(
            target=run_job, args=(poison_res,),
            kwargs={"trace_id": "faultcheck-cancel", **SLOW}, daemon=True)
        t_poison.start()
        time.sleep(1.0)  # admitted and stalled inside the hang
        try:
            cres = client.cancel(trace_id="faultcheck-cancel")
        except Exception as exc:  # noqa: BLE001 — checked below
            cres = {"error": f"{type(exc).__name__}: {exc}"}
        t_poison.join(WALL_CAP)
        try:
            after = client.submit(*ppaths).fasta
        except Exception:  # noqa: BLE001 — a dead server is the failure
            after = None
        checks = [("cancel-acked", cres.get("type") == "ok"),
                  ("typed-cancelled",
                   isinstance(poison_res.get("exc"), JobCancelled)),
                  ("server-survived-identical", after == clean)]
        failed = [n for n, ok in checks if not ok]
        cells.append((names[1], "pass  cancelled typed after the stall, "
                                "server clean"
                      if not failed else f"FAIL {' '.join(failed)}"))
    except Exception as exc:  # noqa: BLE001 — a crashed section is red
        detail = f"FAIL crashed ({type(exc).__name__}: {exc})"
        while len(cells) < len(names):
            cells.append((names[len(cells)], detail))
    finally:
        if server is not None:
            server.drain(timeout=60)
    return cells


#: the sections after the grid and the audit, in order
SECTIONS = (run_router_cells, run_range_cells, run_fragment_cells,
            run_trace_cells, run_preempt_cells)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m racon_tpu_torch.tools.faultcheck",
        description="the fault grid under the port's contract: each "
                    "injection point in every column, then the audit, "
                    "router, range, fragment, trace and preempt sections; "
                    "exit 0 only when every cell is green")
    ap.add_argument("--quick", action="store_true",
                    help="skip the hang rows (the slow ones)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda launches the kernels and raises without a "
                         "card; cpu runs their plain versions")
    args = ap.parse_args(argv)

    rows = [m for m in MATRIX if not (args.quick and m[3])]
    width = max(len(m[0]) for m in MATRIX)
    failures = n_cells = 0

    def emit(name, cells):
        nonlocal failures, n_cells
        n_cells += len(cells)
        failures += sum(c.startswith("FAIL") for c in cells)
        print(f"{name:<{width}}  " + "".join(f"{c:<42}" for c in cells),
              file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="racon_torch_faultcheck_") \
            as tmp:
        paths = make_dataset(tmp, random.Random(11))
        grid = Grid(paths, args.device,
                    os.path.join(tmp, "autotune_cold.json"))
        bad = grid.clean_gates()
        if bad:
            for msg in bad:
                print(f"[faultcheck] FAIL: {msg}", file=sys.stderr)
            return 1
        print(f"{'injection point':<{width}}  "
              + "".join(f"{c:<42}" for c in COLUMNS), file=sys.stderr)
        run_grid(grid, rows, COLUMNS, tmp, emit)
        for name, cell in run_audit_cells(tmp, paths, args.device):
            emit(name, [cell])
        for section in SECTIONS:
            for name, cell in section(tmp, args.device):
                emit(name, [cell])
    print(f"[faultcheck] {'FAIL' if failures else 'PASS'}: "
          f"{n_cells - failures}/{n_cells} cells green on {args.device} in "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
