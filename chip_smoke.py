"""Chip smoke test of racon_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

K1 and K2 come in four instantiations: int32 or int16 scores (int16
where the bucket's overflow proof holds, ops/dtypes.py) times int8 or
2-bit packed operands (ops/encode.py); K3 in two (int32 or int16 scores;
the fused engine has no 2-bit form). The main path runs the default
posture (`--cuda-dtype auto`, packing on). Phases, in order; any
mismatch or exception exits non-zero:

  1. build: the CUDA kernels (nvcc, sm_90a) and the C++ host library,
     from the sources in this checkout;
  2. K1 (csrc/poa_window_sweep.cu) against its plain PyTorch version on
     real session jobs of the full-size workload: the fullest batch of
     every bucket that occurs at each instantiation the bucket allows
     (the plain version once per score width, both operand forms held
     against it), a padding row (nnodes == 0), and two adversarial
     batches (synth.poa_jobs: predecessors farther back than the
     kernel's shared-memory ring, band-0 rows at 640 columns, in-degree
     8): at (2048, 640), int32 only, and at (1280, 640), where int16
     holds and the predecessors lie beyond the int16 ring too. Ranks
     must be identical. Every captured batch of an int16 bucket is also
     run at int32 and int16, whose ranks must agree (the cross-width
     check). Prints the largest predecessor distance of the main path's
     jobs, the ring rows at both widths, each instantiation's time on the
     fullest batches, ns per DP row, real jobs per launch, and the
     traceback's share of the kernel time (a scratch copy of the source
     without the traceback, built beside the kernels and timed on the
     same batches);
  3. K2 (csrc/align_wavefront.cu) against its plain version on the
     workload's real overlap pairs, batched as the main path batches
     them (the fullest batch of each (edge, band) and the last, partial
     one, at each instantiation the edge allows), and on adversarial
     batches (synth.align_pairs at the main path's (8192, 896), where
     some pair must be band-touched, int32 with N bases; and at edge 512
     with the widest band the wrapper takes, on the shared-memory path,
     at both widths, with N bases and ACGT-only in both forms): ops,
     count, distance and touched flag must be identical. Every captured
     batch of an int16 edge is also run at both widths, whose runs and
     reject decisions must agree. Prints each instantiation's time, ns
     per wavefront (kernel ms over the batch's largest m + n), the
     traceback's share (a no-traceback copy of the source, as for K1)
     and the plane's bytes;
  4. golden (phases 4 and 4b: their six CLI processes run at once):
     `python -m racon_tpu_torch -c 1` on the 50 kb, 20x, seed 42
     synthetic workload must reproduce tests/data/synth_50kb_golden.fasta
     byte for byte, at the default posture and dispatch pipeline depth
     (2), at `--cuda-pipeline-depth 0` and at `--cuda-dtype int32`;
     then one run with both device paths (`--cudaaligner-batches 1`),
     `--cuda-trace` and `--cuda-metrics`, whose trace must load and hold
     the pipeline's stage spans and whose dump the `pipeline` namespace;
  4b. fragment golden: `python -m racon_tpu_torch -f -c 1` on a 40 kb,
     10x, 8 kb-read all-vs-all read set (synth.simulate_truth +
     ava_overlaps, seed 42; 50 reads) must reproduce
     tests/data/synth_frag_golden.fasta byte for byte, at depth 2 and 0;
  5. the main path at full size: 200 kb genome, 30x, 8 kb reads (12%
     read error, 10% draft error, w 500, seed 42) polished with
     `-c 1 --cudaaligner-batches 1`, at pipeline depth 0 and then at the
     default depth 2, whose FASTA must be byte-identical; each prints its
     phase walls, the pipeline's stage seconds, chunks and launches, and
     its peak device memory. At depth 2 (the main path) both kernels
     must launch, K1 at both score widths and both kernels packed, and
     the polished contig must be closer to the simulated truth than the
     draft;
  5b. the main path on a small read set whose reads carry N bases (40 kb,
     15x, one base in 200 an N): both kernels must launch their int8
     instantiations, the fullest batch of each shape is held against
     the plain version, and the contig must beat the draft;
  6. one torch.profiler pass over a consensus phase of the same workload
     (after the timed main path): K1's summed device time, the device's
     busy share of the phase's wall, the five longest host-side ranges;
  7. the same over one BatchAligner.align pass over the workload's
     overlap pairs, for K2, at depth 0 and through a depth-2 pipeline:
     at depth 2 K2 must have run on at least 2 CUDA streams, and whether
     the ranges of the pack and unpack worker threads reached the
     capture is printed; then four untraced passes at depths 0, 2, 2, 0;
  8. the fragment path at full size: phase 5's reads with their
     all-vs-all overlaps (min_overlap 1,000), corrected by the port's
     wrapper in-process (`-f --split 800000 --num-shards 4 --shard-id 0
     -c 1 --cudaaligner-batches 1`); both kernels must launch, the
     corrected reads must lie closer to their truth than the raw reads,
     and every target not dropped as unpolished must be written; it
     runs at the default pipeline depth (2) and prints its stage
     seconds. The fullest batch of each K1 bucket and of each K2 (edge,
     band) this path launched is held identical to its plain version at
     the instantiation it ran and timed, and cross-checked at both widths
     where int16 holds; one BatchAligner.align pass over the shard's
     pairs is traced;
  9. the fused engine (K3, csrc/poa_fused.cu) on phase 5's contig cell
     at the full envelope (N 2048, L 640, P 8) and pipeline depth 2:
     `-c 1 --cudaaligner-batches 1 --cuda-engine fused` at `--cuda-fused
     0` and `1`, once at 5/-4/-8 (K3 at int32) and once at the CLI's
     default 3/-5/-4 (int16). The two postures' FASTA must be
     byte-identical and beat the draft (the session engine's distance is
     printed beside it); K3 must launch once a chunk at 1 and once per
     chained call at 0; the windows built by K3 and those left to the
     session engine (K1) or the host are printed. Per instantiation, the
     deepest chunk's second chained call (layer base > 0) at full width
     (128 rows), its first 8 layers, is held against the plain version
     on all 11 state arrays and timed against its bound, and the fused
     launch of the shallowest chunk that chains two calls or more, on a
     slice of its first 8 rows and one layer past its chain's first
     call, is held likewise; K3 is
     timed per chunk at both postures (CUDA events) and by stage (sort,
     range subgraph, DP, traceback, scans, writes; rows swept a layer, ns
     a DP row) on the deepest chunk's fused launch and the held chained
     call, from a diagnostic build of its source (K3_STAGE_CLOCKS); two
     fused consensus passes of one engine are traced (K3's device time,
     the device busy share; its first pass, and its second with the
     streams and K3 scratch it keeps), each with its cudaMalloc calls and
     the memory reserved after it;
  10. the occupancy scheduler (`--cuda-adaptive-buckets`) and the batch
     runner's lanes (adaptive_path): the contig cell with the scheduler
     on at pipeline depth 2 (FASTA equal to phase 5's; the derived
     ladders, each engine's occupancy on and off, K1's and K2's
     launches by shape, which must hold a derived shape); the fullest
     batch of each derived K1 shape and K2 (edge, band) held against the
     plain version; every batch of the cell replayed with the scheduler
     off and on, K1, K2 and K3 timed over all of them (replay_contig);
     the fused engine with the scheduler on at `--cuda-fused 0` at
     5/-4/-8 and `1` at 3/-5/-4 (FASTA equal to phase 9's; K3 launched at
     a derived depth, one chained call at the smallest derived depth held
     on 8 rows); the fragment shard of phase 8 with the scheduler on
     (FASTA equal to phase 8's); and the contig main path over 2 lanes on
     one card, and over every visible card when there are more, for both
     engines (FASTA equal to the 1-lane FASTA, calls counted per lane,
     each bucket's per-lane useful cells summing to its useful cells).
  11. the autotuner, the oracle and the auditor (autotune_path): every
     key the engines consult profiled on the card (K1 and K2 at both
     widths, K3 split against one launch), each entry identical to its
     oracle candidate, and a warm table profiling nothing; the contig
     cell with the table for both engines (FASTA equal to phases 5 and
     9's, decisions from the table); every window of the session and
     the fused runs audited against the oracle on the card (0
     mismatches); a planted mismatch caught, repaired and demoted, and
     the next fused run launching split only with the same FASTA.
  12. the polisher's hooks (hooks_path): phase 5's polisher rebound to
     the same triple (FASTA and per-run counters equal to phase 5's),
     then run as two window-range shards split off the w grid (segments
     concatenating to phase 5's contig, tags re-derived from
     `segment_meta`, fewer K2 pairs a shard); two polishing rounds on a
     fused-engine polisher (round 1 equal to phase 9's, `redraft`'s
     in-process re-map, round 2 warm equal to a fresh polisher's, K3
     launched); and the fragment cell's kF shard 0 of 16 through the
     fused engine at `--cuda-fused 0` and `1` (byte-identical, K3
     launched, distance below the raw reads').
  13. the warm server (serve_path): one PolishServer on the card (unix
     socket, 2 workers, `-c 1 --cudaaligner-batches 1`, depth 2,
     5/-4/-8, warm-up on) driven through its client: two contig-cell
     jobs (buffered and streamed) pooled in shared iterations (FASTA
     equal to phase 5's, a two-job iteration, K1 and K2 launched); a
     fused-engine job beside a session job (FASTA equal to phase 9's
     int32, K3 launched, no iteration shared across the keys); a
     `device:chunk=0:raise` job failing typed beside a clean job, then a
     clean job alone (its wall against phase 5's one-shot wall); a queued
     job cancelled with the feeder held and both workers busy, then
     `shutdown` draining cleanly; the fullest K1 batch of the shared
     iterations held against its plain version.
  14. what a served job can ask for (serve_kinds_path): one PolishServer
     on the card as in phase 13 with the window cache and preemption
     armed and fragment groups of 16: a fused rounds job (`rounds=2`,
     FASTA equal to phase 12's round 2, K2 launched in both rounds, K3
     launched) and the same job again (every round-1 window answered by
     the cache, fewer K1 and K3 launches); two range shards at once
     (segments concatenating to phase 5's contig, tags re-derived from
     their `seg` accounting); a fragment job on the first 1/16 of phase
     8's targets (groups of at most 16 reads tiling the slice, equal to
     a one-shot kF polisher on the same slice, closer to the truth than
     the raw reads); an ingest job (phase 5's bytes), a cut reads file
     refused typed `rejected-ingest`, a job after it; a contig job
     preempted by a higher-priority job and resumed (1 preemption, 1
     resume, the bytes of phase 5, device seconds for both tenants);
     `shutdown` draining cleanly; the fullest K3 call of the rounds job,
     its first 8 layers, held against its plain version and timed
     against its bound.
  15. worker lanes and the identity audit (serve_lanes_path): one
     PolishServer with two worker lanes over [cuda:0, cuda:0] (3
     workers, the window cache on, audit rate 1.0, a scratch winner
     table with one hand-recorded session entry): two contig jobs and a
     fused job at once (FASTA equal to phases 5 and 9's, both lanes ran,
     K1, K2 and K3 launched; the lanes' iterations and busy seconds, the
     most iterations at once); their audit clean; a
     `device:chunk=1:sdc` job beside a clean job (both equal to phase
     5's; 1 mismatch repaired, the entry demoted on disk, the lane
     quarantined, re-probed and back at health 1.0, one dual-stream
     dump, the window cache invalidated); every cached consensus flipped
     and the job resubmitted (phase 5's bytes, the entries blamed, no
     demotion, no lane quarantined); `shutdown` draining cleanly; the
     fullest K1 batch of lane 1's iterations held against its plain
     version and timed against its bound.
  16. the server's observability (serve_obs_path): one PolishServer as
     in phase 13 with the metrics port, a journal, flight dumps and the
     audit at rate 0.1 armed: a traced contig job through
     `submit_traced` (FASTA equal to phase 5's, K1 and K2 launched, its
     merged client and server trace holding the iteration spans tagged
     with its id inside the client's request); an untraced job with a
     trace id and its `trace_pull`; a `device:chunk=0:raise` job whose
     flight dump exists when its error arrives, listed by `debug` and
     named by a latency exemplar; a job released past its deadline
     (journaled miss, its dump, the SLO burn alert); scrapes over the
     socket and HTTP timed beside the iterations, parsed strictly, their
     counters equal to `stats`; `shutdown` with a consistent journal and
     no tracer left armed; the fullest K1 batch of the first two jobs held
     against its plain version and timed against its bound.
  17. the fleet's router (router_path): two PolishServers on the card
     (one worker each, warm-up on, COLD_TABLE) behind a PolishRouter with
     a journal and a metrics port: phase 5's one-contig triple as a
     traced routed job, which two routable replicas run as two window
     ranges (merged FASTA equal to phase 5's, every shard launching K1
     and K2 from its own `serve.batch`, the merged trace holding the
     router's and both replicas' tracks); its wall against phase 13's
     lone job; the router's scrape (the replicas' families federated
     beside its own) timed and parsed strictly; the journal consistent
     after the drain; the fullest K1 batch of the first replica held
     against its plain version and timed against its bound.
  18. the elastic fleet (autoscale_path): one PolishServer on the card
     (phase 17's posture) behind a PolishRouter with an Autoscaler whose
     default spawn starts a second `serve` process on the card with the
     same posture: phase 5's one-contig triple as three traced jobs at
     once, the held shards' pressure spawning the replica, which runs one
     of them (each FASTA equal to phase 5's, the spawned replica's job
     launching K1 and K2); a servetop screen while it is alive; the
     replica stopped after the idle and its process gone; the journal
     consistent with a balanced autoscale ledger (obsreport), each merged
     trace clean under tracereport; the server's fullest K1 batch held
     against its plain version and timed against its bound.
  19. the operator tools faultcheck and servebench on the card
     (tools_path): faultcheck's range section (a one-contig job range-
     sharded over two `serve --device cuda` processes, one killed with
     `kill -9` mid-job) beside its grid (every quick row of MATRIX in the
     depth2, depth2+fused and serve columns, after the clean gates) and
     its audit section, every cell green, K2 and K3 launched, the range
     replicas running `-c 1 --cudaaligner-batches 1` and launching K1
     and K2; then servebench's default mode at 20 kb x 20x over 4
     contigs (`-c 1 --cudaaligner-batches 1`), exit 0 with K1 and K2
     launched on the warm server, its artifact under build/. The
     fullest K2 batch of each shape that the grid and the warm server
     launched is held against its plain version (the grid's at every
     instantiation; a shape and instantiation the run held earlier on a
     batch at least as full, as phase 8 holds servebench's, is not held
     again).

K2 batches of HOST_PLAIN_CELLS (pairs x band) or fewer are held against
a plain version computed on the host CPU (the card runs the plain wavefront
loop slower there), in three worker processes started at the outset,
so those run beside each other and beside the card's work; every other
hold computes it on the card. The kernels' nvcc builds and the host
library's g++ run at once. K2's
`plain_ms` in the kernel line sums the card's plain times only; the
host's are `plain_ms_host`, and `plain_by_batch` says where each ran.

Prints per-phase numbers, then the kernel line (K1 and K2: launches on
the contig path of phase 5 at depth 2, the N-base path of phase 5b, the
fragment path of phase 8, the fused path of phase 9, the runs of phase
10, all of phase 11 (path `autotune`), of phase 12 (path `hooks`), of
phase 13 (path `serve`), of phase 14 (path `serve_kinds`), of phase 15
(path `serve_lanes`), of phase 16 (path `serve_obs`), of phase 17
(path `router`), of phase 18 (path `autoscale`: this process's and
the spawned replica's, the latter also as `launches_autoscale_child`
and in no instantiation row) and of phase 19 (paths `faultcheck`: the
grid and the audit, and the range section's replica processes, the
latter also as `launches_faultcheck_child` and in no instantiation row;
`servebench`: the warm server), in all, by path
and by instantiation; K3: launches on the four runs of phase 9, the
fused runs of phases 10, 12, 13, 14 and 15, phase 11, phase 19's
faultcheck grid, and phase 14's held call), the card's name and power
limit, and as the last line
{"ok": true, "device": {...}}. Exits non-zero without a result when no
CUDA device is present or when run outside the repository. Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import multiprocessing
import os
import random
import subprocess
import sys
import tempfile
import time
from concurrent.futures import Future, ProcessPoolExecutor, ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
#: the winner table of every phase before phase 11: a path that never
#: exists, so those phases dispatch cold whatever table the user's cache
#: holds
COLD_TABLE = os.path.join(HERE, "build", "autotune_cold.json")


#: peak rates of one H100 SXM: HBM bytes/s (NVIDIA data sheet), and the
#: 32-bit integer rate the kernels' DP runs at (adds, compares, mins and
#: selects; no FMAs): 132 SMs x 64 INT32 lanes x 1.98 GHz (NVIDIA Hopper
#: architecture white paper)
PEAK_BYTES = 3.35e12
PEAK_OPS = 132 * 64 * 1.98e9

MATCH, MISMATCH, GAP = 5, -4, -8

#: the kernels' instantiations: (score dtype, packed operands)
PLANS = (("int32", False), ("int32", True), ("int16", False),
         ("int16", True))


def log(msg: str) -> None:
    print(msg, flush=True)


def plan_name(dtype: str, packed: bool) -> str:
    return f"{dtype}/{'packed' if packed else 'int8'}"


def by_plan(launches_by_shape: dict) -> dict:
    """A wrapper's launches_by_shape ((shape..., dtype, packed) -> n)
    summed per instantiation name."""
    out: dict = {}
    for key, n in launches_by_shape.items():
        name = plan_name(*key[-2:])
        out[name] = out.get(name, 0) + n
    return dict(sorted(out.items()))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import racon_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: racon_tpu_torch not found next to this script "
              f"({exc})", file=sys.stderr)
        return 2
    if "jax" in sys.modules or "racon_tpu" in sys.modules:
        print("chip_smoke: JAX was loaded", file=sys.stderr)
        return 1

    from racon_tpu_torch import _build, native
    from racon_tpu_torch.device import card_info
    from racon_tpu_torch.synth import simulate_truth, write_dataset

    dev = torch.device("cuda", 0)
    card = card_info()
    report: dict = {"card": card}
    if os.path.exists(COLD_TABLE):
        os.remove(COLD_TABLE)
    log(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} "
        f"on {torch.cuda.get_device_name(0)}")

    # the host CPU's workers for K2's small plain holds (HOST_PLAIN_CELLS),
    # started now so they are warm by phase 3; stopped at exit
    global PLAIN_POOL
    PLAIN_POOL = ProcessPoolExecutor(
        3, mp_context=multiprocessing.get_context("spawn"),
        initializer=_warm_plain_worker)
    atexit.register(PLAIN_POOL.shutdown, cancel_futures=True)
    for _ in range(3):
        PLAIN_POOL.submit(int)

    # ---------------------------------------------------------- 1. build
    # every nvcc and the host library's g++ run at once
    t0 = time.perf_counter()
    notb = build_without_traceback("poa_window_sweep.cu",
                                   "rt_poa_window_sweep", 11, 9)
    notb2 = build_without_traceback("align_wavefront.cu",
                                    "rt_align_wavefront", 8, 6)
    k3stg = build_k3_stages()

    def host_lib() -> float:
        t1 = time.perf_counter()
        native.get_lib()
        return time.perf_counter() - t1

    with ThreadPoolExecutor(1) as ex:
        host = ex.submit(host_lib)
        _build.kernels()
        k_s = time.perf_counter() - t0
        n_s = host.result()
    log(f"[chip_smoke] build: kernels {k_s:.2f} s "
        f"({'cached' if _build.build_info.get('cached') else 'nvcc'}), "
        f"host library {n_s:.2f} s beside them; card {card}")
    for line in _build.build_info.get("ptxas", "").splitlines():
        if any(w in line for w in ("registers", "Compiling entry", "spill")):
            log(f"[chip_smoke]   ptxas: {line.strip()}")
    report["build_s"] = {"kernels": k_s, "host": n_s}

    workdir = tempfile.mkdtemp(prefix="racon_chip_smoke_")
    rng = random.Random(42)
    t0 = time.perf_counter()
    truth, draft, reads_t, paf = simulate_truth(rng, 200_000, 30, 8000, 0.12,
                                                0.10)
    reads = [(r[0], r[1]) for r in reads_t]
    big_dir = os.path.join(workdir, "w200")
    os.makedirs(big_dir)
    big = write_dataset(big_dir, draft, reads, paf)
    log(f"[chip_smoke] simulated 200 kb x 30x: {len(reads)} reads in "
        f"{time.perf_counter() - t0:.1f} s")

    walls = report["phase_walls_s"] = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        try:
            return fn(*args)
        finally:
            walls[name] = time.perf_counter() - t

    kernels = []
    k1, windows = phase("2 K1", check_window_sweep, dev, big, report, notb)
    kernels.append(k1)
    kernels.append(phase("3 K2", check_wavefront, dev, draft, reads, paf,
                         report, notb2))
    phase("4 goldens", check_goldens, workdir, report)
    contig = phase("5 main path", main_path, dev, big, truth, draft, report)
    nbases = phase("5 N-base path", n_base_path, dev, workdir, report)
    phase("6 consensus profile", profile_consensus, dev, windows, report)
    phase("7 align profile", profile_align, dev,
          overlap_pairs(draft, reads, paf), report)
    fragment = phase("8 fragment", fragment_path, dev, truth, reads_t,
                     workdir, report)
    k1f, k2f, k3 = phase("9 fused", fused_path, dev, big, truth, draft,
                         windows, report, k3stg)
    k1a, k2a, k3a = phase("10 adaptive", adaptive_path, dev, big, windows,
                          report)
    k1t, k2t, k3t = phase("11 autotune", autotune_path, dev, big, workdir,
                          report)
    k1h, k2h, k3h = phase("12 hooks", hooks_path, dev, big, truth, draft,
                          reads_t, workdir, report)
    k1s, k2s, k3s = phase("13 serve", serve_path, dev, big, workdir, report)
    k1k, k2k, k3k = phase("14 serve kinds", serve_kinds_path, dev, big,
                          truth, reads_t, workdir, report)
    k1l, k2l, k3l = phase("15 serve lanes", serve_lanes_path, dev, big,
                          workdir, report)
    k1o, k2o = phase("16 serve obs", serve_obs_path, dev, big, workdir,
                     report)
    k1r, k2r = phase("17 router", router_path, dev, big, workdir, report)
    k1x, k2x = phase("18 autoscale", autoscale_path, dev, big, workdir,
                     report)
    tools = phase("19 tools", tools_path, dev, workdir, report)
    log(f"[chip_smoke] phase walls (s): "
        f"{ {k: round(v, 2) for k, v in walls.items()} }; card {card}")
    for k, *paths in zip(kernels, contig, nbases, fragment, (k1f, k2f),
                         (k1a, k2a), (k1t, k2t), (k1h, k2h), (k1s, k2s),
                         (k1k, k2k), (k1l, k2l), (k1o, k2o),
                         (k1r, k2r), (k1x, k2x), tools["faultcheck"][:2],
                         tools["servebench"]):
        by_path = dict(zip(("contig", "nbases", "fragment", "fused",
                            "adaptive", "autotune", "hooks", "serve",
                            "serve_kinds", "serve_lanes", "serve_obs",
                            "router", "autoscale", "faultcheck",
                            "servebench"), paths))
        k["launches"] = sum(n for n, _ in paths)
        k["launches_by_path"] = {p: n for p, (n, _) in by_path.items()}
        k["launches_by_plan"] = {p: pl for p, (_, pl) in by_path.items()}
        for row in k["instantiations"]:
            row["launches"] = sum(pl.get(row["plan"], 0)
                                  for _, pl in paths)
    for runs in (k3a, k3t, k3h, k3s, k3k, k3l, tools["faultcheck"][2]):
        k3["launches"] += sum(runs.values())
        k3["launches_by_path"].update(runs)
        for row in k3["instantiations"]:
            row["launches"] += sum(n for name, n in runs.items()
                                   if name.startswith(row["plan"])
                                   or (row["plan"] == "int32"
                                       and name.startswith("fused ")))
    k3["held_serve_kinds"] = report["serve_kinds_path"]["k3_held"]
    kernels[0]["held_serve_lanes"] = report["serve_lanes_path"][
        "k1_fullest_lane1"]
    kernels[0]["held_serve_obs"] = report["serve_obs_path"]["k1_fullest"]
    kernels[0]["held_router"] = report["router_path"]["k1_fullest"]
    kernels[0]["held_autoscale"] = report["autoscale_path"]["k1_fullest"]
    # the spawned replica's launches are in `launches` and
    # `launches_by_path`; its jobs report no instantiation
    for k, key in zip(kernels, ("k1", "k2")):
        k["launches_autoscale_child"] = \
            report["autoscale_path"]["b"]["child_launches"][key]
        k["launches_faultcheck_child"] = \
            report["tools_path"]["a"]["range_replica_launches"][key]
    kernels[1]["held_faultcheck"] = report["tools_path"]["a"]["k2_held"]
    kernels[1]["held_servebench"] = report["tools_path"]["b"]["k2_held"]
    kernels.append(k3)

    out_dir = os.path.join(HERE, "build")
    os.makedirs(out_dir, exist_ok=True)
    report["kernels"] = kernels
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1, sort_keys=True)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


TRACEBACK = ("    // -- traceback --\n", "    // -- end traceback --\n")


def build_without_traceback(source: str, symbol: str, n_ptr: int,
                            n_int: int):
    """Start nvcc on a scratch copy of a kernel source (a file of csrc/)
    with its traceback cut out (between the source's traceback markers):
    the difference in time to the full kernel is the traceback's share.
    Returns what load_without_traceback needs: the running process, the
    library it writes, and the C entry point's name and signature
    (n_ptr pointers, n_int ints, the stream)."""
    from racon_tpu_torch import _build

    src = open(os.path.join(_build.CSRC, source)).read()
    head, rest = src.split(TRACEBACK[0])
    _, tail = rest.split(TRACEBACK[1])
    d = os.path.join(HERE, "build", "scratch")
    os.makedirs(d, exist_ok=True)
    stem = os.path.splitext(source)[0]
    cu = os.path.join(d, f"{stem}_no_traceback.cu")
    with open(cu, "w") as fh:
        fh.write(head + tail)
    lib = os.path.join(d, f"lib{stem}_no_traceback-{os.getpid()}.so")
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib, cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib, symbol, n_ptr, n_int


def load_without_traceback(notb):
    """The no-traceback copy's C entry point, once nvcc has finished."""
    import ctypes

    proc, path, symbol, n_ptr, n_int = notb
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"nvcc of the no-traceback copy of {symbol} "
                         f"failed:\n{text}")
    fn = getattr(ctypes.CDLL(path), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    return fn


def sweep(args, plan):
    """One K1 launch through the wrapper at instantiation `plan`."""
    from racon_tpu_torch.ops import poa_kernels

    return poa_kernels.window_sweep(*args, MATCH, MISMATCH, GAP, *plan)


def sweep_without_traceback(fn, args, plan):
    """One launch of the no-traceback copy at instantiation `plan`,
    scratch allocated as the wrapper allocates it (not counted as a
    launch of K1)."""
    import torch

    from racon_tpu_torch.ops.poa_kernels import scratch

    dtype, packed = plan
    B, N, P = args[1].shape
    L = args[4].shape[1] * (4 if packed else 1)
    dev = args[0].device
    spill, bps = scratch(B, N, L, dev, dtype)
    out = torch.empty((B, L), dtype=torch.int32, device=dev)
    rc = fn(
        *(t.data_ptr() for t in args), spill.data_ptr(), bps.data_ptr(),
        out.data_ptr(), B, N, L, P, MATCH, MISMATCH, GAP,
        2 if dtype == "int16" else 4, int(packed),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise SystemExit(f"no-traceback copy failed to launch: {rc}")
    return out


def adversarial_batch(dev, n_nodes, ring_band0):
    """128 jobs at the (n_nodes, 640) bucket from synth.poa_jobs: band 0
    and band 256 alternating, in-degree up to 8, a predecessor at least
    300 ranks back on every fifth node (beyond the ring of a band-0
    job, `ring_band0` rows), a length-0 layer and a padding job."""
    import torch

    from racon_tpu_torch.synth import max_pred_distance, poa_jobs

    jobs = poa_jobs(2, 128, n_nodes, 640, 8, (0, 256), far=300, pad_rows=1,
                    empty_layers=1)
    dist = max_pred_distance(jobs[1], jobs[7])
    if dist <= ring_band0:
        raise SystemExit(f"adversarial batch: largest predecessor distance "
                         f"{dist} is within the ring ({ring_band0} rows)")
    return dist, [torch.from_numpy(a).to(dev) for a in jobs]


def window_sweep_bound(args, L) -> tuple[float, str]:
    """Least time for one window_sweep batch: its inputs read once (in
    the form given: packed operands are a quarter of the int8 bytes) and
    its int32 ranks [B, L] written once, or the DP this data needs. A
    real node row needs only its in-band columns (all lens + 1 when the
    band is 0); each such cell takes, per in-edge, 2 adds (diagonal,
    vertical), 2 maxes and the 2 equality tests of the backpointer, and
    per cell the substitution compare and the running max (subtract,
    max, add): 6 x in-degree + 4 operations, at either score width."""
    import torch

    codes, preds, centers, sinks, seq, lens, band, nnodes = args
    nbytes = (sum(t.numel() * t.element_size() for t in args)
              + preds.shape[0] * L * 4)
    deg = (preds >= 0).sum(dim=2)                                 # [B, N]
    N = deg.shape[1]
    rows = torch.arange(N, device=deg.device)[None, :] < nnodes[:, None]
    c = centers.long()
    ln = lens.long()[:, None]
    half = (band.long() // 2)[:, None]
    cols = (torch.minimum(ln, c + half) - torch.clamp(c - half, min=1) + 1)
    cols = torch.where(band[:, None] > 0, cols.clamp(min=0), ln + 1)
    ops = float(((6 * deg + 4) * cols * rows).sum())
    return bound(nbytes, ops)


def wavefront_bound(q_lens, t_lens, offsets, band, count,
                    packed=False) -> tuple[float, str]:
    """Least time for one wavefront_align batch: each pair's bases (a
    quarter byte each when packed), lengths and band offsets up to
    wavefront m + n read once, its ops and meta written once; or the DP
    cells inside both the band and the matrix, at 8 operations each (the
    substitution compare, 3 adds, 2 mins and the 2 compares that pick
    the backpointer), at either score width."""
    import torch

    m = q_lens.long()[:, None]
    n = t_lens.long()[:, None]
    mn = (m + n)[:, 0]
    d = torch.arange(offsets.shape[1], device=offsets.device)[None, :]
    off = offsets.long()
    lo = torch.maximum(off, (d - n).clamp(min=0))
    hi = torch.minimum(off + band - 1, torch.minimum(d, m))
    cells = ((hi - lo + 1).clamp(min=0) * (d <= m + n)).sum()
    base_bytes = mn.sum() / 4 if packed else mn.sum()
    nbytes = float(base_bytes + 4 * (mn + 1).sum() + 4 * count.long().sum()
                   + 20 * len(mn))
    return bound(nbytes, 8.0 * float(cells))


def replay_ms(fn, batches) -> float:
    """CUDA-event time of one launch of `fn` on every batch, after one
    warm-up pass over them all."""
    return cuda_ms(lambda: [fn(b) for b in batches], reps=1)


def k1_forms(args, N, L):
    """The int8 and the 2-bit packed form of one K1 batch, on its device.
    The packed form is None when a layer base or a node code is not ACGT
    or L is not a multiple of 4 (such a batch runs int8)."""
    import torch

    from racon_tpu_torch.ops.encode import pack_2bit, packable, unpack_2bit

    codes, seq, lens, nnodes = args[0], args[4], args[5], args[7]
    if codes.dtype == torch.uint8:
        a8 = [unpack_2bit(codes, N, nnodes), *args[1:4],
              unpack_2bit(seq, L, lens), *args[5:]]
        return a8, list(args)
    c, s, ln, nn = (x.cpu().numpy() for x in (codes, seq, lens, nnodes))
    if L % 4 or not (packable(s, ln) and packable(c, nn)):
        return list(args), None
    return list(args), [torch.from_numpy(pack_2bit(c)).to(codes.device),
                        *args[1:4],
                        torch.from_numpy(pack_2bit(s)).to(codes.device),
                        *args[5:]]


def hold_k1(args, N, L, what: str, time_it: bool = True,
            widths=None) -> dict:
    """K1 against its plain version on one batch at every instantiation
    the bucket allows (int16 where the overflow proof holds, packed where
    every base is ACGT): the plain version once per score width, both
    operand forms held against it. Exits on a difference. Returns
    {plan: row} with the kernel's CUDA-event ms (mean of 3 after a
    warm-up), the plain version's host-clocked ms and the bound."""
    import torch

    from racon_tpu_torch.ops.dtypes import poa_int16_ok
    from racon_tpu_torch.ops.poa_graph import graph_aligner

    P = args[1].shape[2]
    a8, ap = k1_forms(args, N, L)
    if widths is None:
        widths = ("int32", "int16") if poa_int16_ok(
            N, L, MATCH, MISMATCH, GAP) else ("int32",)
    rows = {}
    for dtype in widths:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = graph_aligner(N, L, P, MATCH, MISMATCH, GAP, dtype)(*a8)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for packed, a in ((False, a8), (True, ap)):
            if a is None:
                continue
            plan = (dtype, packed)
            got = sweep(a, plan)
            err = int((got.long() - want.long()).abs().max())
            if err or not torch.equal(got, want):
                raise SystemExit(f"K1 window_sweep {plan_name(*plan)} "
                                 f"disagrees with its plain version on "
                                 f"{what}: max |diff| {err}")
            row = {"plain_ms": plain_ms, "err": err}
            if time_it:
                row["ms"] = cuda_ms(lambda: sweep(a, plan), reps=3)
                row["bound_ms"], row["bound_by"] = window_sweep_bound(a, L)
            rows[plan] = row
    return rows


def log_plans(kernel: str, what: str, rows: dict) -> None:
    """One line: the instantiations held identical, their kernel times
    and the plain version's time at each score width."""
    times = "; ".join(f"{plan_name(*p)} {r['ms']:.3f} ms"
                      for p, r in rows.items() if "ms" in r)
    plain = ", ".join(sorted({f"{p[0]} {r['plain_ms']:.1f} ms"
                              for p, r in rows.items()}))
    log(f"[chip_smoke] {kernel} {what}: identical at "
        f"{', '.join(plan_name(*p) for p in rows)}; kernel {times}; "
        f"plain {plain}")


def check_window_sweep(dev, paths, report, notb) -> tuple[dict, list]:
    """Phase 2: capture every padded batch a consensus pass over the
    whole workload launches at the default posture (the main path's own
    batches: same windows, same engine), hold K1 to its plain version at
    every instantiation on the fullest batch of each bucket, a padding
    row and two adversarial batches, check the two widths against each
    other on every batch of an int16 bucket, and time K1 over all of
    them. Returns the kernel line's entry and the packed windows (for
    phase 6)."""
    import torch

    from racon_tpu_torch.core.polisher import PolisherType, create_polisher
    from racon_tpu_torch.ops import poa_kernels
    from racon_tpu_torch.ops.dtypes import poa_int16_ok
    from racon_tpu_torch.ops.poa import _pack
    from racon_tpu_torch.ops.poa_graph import (MAX_LEN, MAX_NODES, MAX_PRED,
                                               DeviceGraphPOA)
    from racon_tpu_torch.synth import max_pred_distance

    t0 = time.perf_counter()
    pol = create_polisher(*paths, PolisherType.kC, 500, 10.0, 0.3, True,
                          MATCH, MISMATCH, GAP, num_threads=os.cpu_count(),
                          device="cuda", autotune_table=COLD_TABLE)
    pol.initialize()
    windows = [_pack(w) for w in pol.windows if len(w.sequences) >= 3]

    class Capture(DeviceGraphPOA):
        batches: list = []

        def run_bucket(self, nb, lb, *args):
            plan = (self.plan_for(nb, lb), args[0].dtype == torch.uint8)
            self.batches.append(((nb, lb), plan, [a.clone() for a in args]))
            return super().run_bucket(nb, lb, *args)

    eng = Capture(MATCH, MISMATCH, GAP, device=dev,
                  num_threads=os.cpu_count())
    eng.consensus(windows)
    torch.cuda.synchronize()
    batches = eng.batches
    fullest: dict = {}
    n_real = 0
    dist = 0
    for key, plan, args in batches:
        n = int((args[-1] > 0).sum())
        n_real += n
        dist = max(dist, max_pred_distance(args[1].cpu().numpy(),
                                           args[7].cpu().numpy()))
        if n > fullest.get(key, (0,))[0]:
            fullest[key] = (n, plan, args)
    n_by_plan: dict = {}
    for _, plan, _ in batches:
        n_by_plan[plan_name(*plan)] = n_by_plan.get(plan_name(*plan), 0) + 1
    log(f"[chip_smoke] K1 job capture: {len(batches)} batches in "
        f"{len(fullest)} buckets from {len(windows)} windows in "
        f"{time.perf_counter() - t0:.1f} s")
    rings = {f"{nb}x{lb}": {dt: {
        "band256": poa_kernels.ring_rows(nb, lb, MAX_PRED, min(257, lb), dt),
        "band0": poa_kernels.ring_rows(nb, lb, MAX_PRED, lb, dt)}
        for dt in ("int32", "int16")} for nb, lb in sorted(fullest)}
    log(f"[chip_smoke] K1 main-path jobs: largest predecessor distance "
        f"{dist}; ring rows per bucket and score width {rings}; real jobs "
        f"per launch {n_real / len(batches):.1f} ({n_real} jobs in "
        f"{len(batches)} launches: {n_by_plan})")
    report["window_sweep_jobs"] = {
        "max_pred_distance": dist, "ring_rows": rings,
        "jobs_per_launch": n_real / len(batches), "jobs": n_real,
        "launches": len(batches), "launches_by_plan": n_by_plan}

    # the fullest batch of each bucket, every instantiation
    no_tb = load_without_traceback(notb)
    buckets = []
    by = "operations"
    err = 0
    main_rows = []          # the instantiation the main path ran
    inst: dict = {}         # plan -> summed fullest-batch numbers
    for (nb, lb), (n, plan, args) in sorted(fullest.items()):
        rows = hold_k1(args, nb, lb, f"the fullest {(nb, lb)} batch")
        tb_free = cuda_ms(lambda: sweep_without_traceback(no_tb, args, plan),
                          reps=3)
        B = args[0].shape[0]
        rows_k = int(args[7].max())
        r = rows[plan]
        ms = r["ms"]
        for p, x in rows.items():
            err = max(err, x["err"])
            acc = inst.setdefault(p, {"batches": 0, "ms": 0.0,
                                      "plain_ms": 0.0, "bound_ms": 0.0,
                                      "bound_by": by})
            for k in ("ms", "plain_ms", "bound_ms"):
                acc[k] += x[k]
            acc["batches"] += 1
            acc["bound_by"] = x["bound_by"]
        by = r["bound_by"]
        main_rows.append(r)
        buckets.append({
            "bucket": [nb, lb], "jobs": n, "rows": B,
            "plan": plan_name(*plan),
            "instantiations": {plan_name(*p): x for p, x in rows.items()},
            "ms": ms, "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": by, "dp_rows": rows_k,
            "ns_per_dp_row": ms * 1e6 / rows_k, "no_traceback_ms": tb_free,
            "traceback_share": 1.0 - tb_free / ms})
        log_plans("K1", f"fullest batch at bucket {(nb, lb)} ({n} jobs / "
                  f"{B} rows, main path ran {plan_name(*plan)})", rows)
        log(f"[chip_smoke] K1 bucket {(nb, lb)} at {plan_name(*plan)}: "
            f"bound {r['bound_ms']:.4f} ms ({by}); {ms * 1e6 / rows_k:.0f} "
            f"ns per DP row over {rows_k} rows; without traceback "
            f"{tb_free:.3f} ms (traceback share "
            f"{100 * (1 - tb_free / ms):.1f}%)")

    # the padding-row case: the first job of the first fullest batch
    # replaced by an empty row (nnodes == 0), the shape the tail is
    # filled with
    (nb, lb), (n, plan, args) = sorted(fullest.items())[0]
    pad = [a.clone() for a in k1_forms(args, nb, lb)[0]]
    pad[0][0] = 5
    pad[1][0] = -1
    for i in (2, 3, 5, 6, 7):
        pad[i][0] = 0
    pad[4][0] = 5
    rows = hold_k1(pad, nb, lb, "a padding row", time_it=False)
    log(f"[chip_smoke] K1 padding row (nnodes 0) at bucket {(nb, lb)}: "
        f"identical at {', '.join(plan_name(*p) for p in rows)}")

    # adversarial batches: at (2048, 640) (int32 only at these scores),
    # and at (1280, 640), where int16 holds, beyond the int16 ring too
    adv = {}
    for n_nodes in (MAX_NODES, 1280):
        widths = ("int32", "int16") if poa_int16_ok(
            n_nodes, MAX_LEN, MATCH, MISMATCH, GAP) else ("int32",)
        ring0 = {dt: poa_kernels.ring_rows(n_nodes, MAX_LEN, MAX_PRED,
                                           MAX_LEN, dt) for dt in widths}
        adv_dist, batch = adversarial_batch(dev, n_nodes, max(ring0.values()))
        n_jobs = int((batch[-1] > 0).sum())
        rows = hold_k1(batch, n_nodes, MAX_LEN,
                       f"the adversarial ({n_nodes}, {MAX_LEN}) batch")
        log_plans("K1", f"adversarial batch at {(n_nodes, MAX_LEN)}: "
                  f"{n_jobs} jobs (band 0 and 256, in-degree up to 8, "
                  f"largest predecessor distance {adv_dist} > ring "
                  f"{ring0} rows of a band-0 job, a length-0 layer, a "
                  f"padding job)", rows)
        adv[f"{n_nodes}x{MAX_LEN}"] = {
            "jobs": n_jobs, "max_pred_distance": adv_dist,
            "ring_band0": ring0,
            "instantiations": {plan_name(*p): x for p, x in rows.items()}}
        err = max([err] + [x["err"] for x in rows.values()])
    report["window_sweep_adversarial"] = adv

    # every captured batch: one launch each at the instantiation the main
    # path ran, with and without the traceback
    all_ms = replay_ms(lambda b: sweep(b[2], b[1]), batches)
    all_tb_free = replay_ms(
        lambda b: sweep_without_traceback(no_tb, b[2], b[1]), batches)
    all_bound = sum(window_sweep_bound(a, k[1])[0] for k, _, a in batches)
    all_rows = sum(int(a[7].max()) for _, _, a in batches)
    log(f"[chip_smoke] K1 over all {len(batches)} captured batches: "
        f"kernel {all_ms:.2f} ms, bound {all_bound:.4f} ms; "
        f"{all_ms * 1e6 / all_rows:.0f} ns per DP row over {all_rows} rows; "
        f"without traceback {all_tb_free:.2f} ms (traceback share "
        f"{100 * (1 - all_tb_free / all_ms):.1f}%)")
    # the same batches of the int16 buckets at int32 (the main path ran
    # them at int16): identical ranks at both widths, and the two times
    narrow = [b for b in batches if b[1][0] == "int16"]
    for (nb, lb), plan, args in narrow:
        wide = sweep(args, ("int32", plan[1]))
        if not torch.equal(wide, sweep(args, plan)):
            raise SystemExit(f"K1 cross-width check: int16 and int32 ranks "
                             f"differ on a captured {(nb, lb)} batch")
    narrow_ms = replay_ms(lambda b: sweep(b[2], b[1]), narrow)
    wide_ms = replay_ms(lambda b: sweep(b[2], ("int32", b[1][1])), narrow)
    log(f"[chip_smoke] K1 cross-width check: {len(narrow)} batches of the "
        f"int16 buckets give identical ranks at int16 and int32; one pass "
        f"over them {narrow_ms:.2f} ms at int16, {wide_ms:.2f} ms at int32")
    report["window_sweep"] = buckets
    report["window_sweep_all"] = {
        "batches": len(batches), "ms": all_ms, "bound_ms": all_bound,
        "dp_rows": all_rows, "ns_per_dp_row": all_ms * 1e6 / all_rows,
        "no_traceback_ms": all_tb_free,
        "traceback_share": 1.0 - all_tb_free / all_ms,
        "cross_width_batches": len(narrow), "cross_width_int16_ms": narrow_ms,
        "cross_width_int32_ms": wide_ms}
    batches.clear()
    return ({"name": "window_sweep", "route": "cuda",
             "source": "racon_tpu_torch/csrc/poa_window_sweep.cu",
             "replaces": "racon_tpu/ops/poa_pallas.py:91",
             "launches": 0, "max_abs_err": err,
             "ms": sum(r["ms"] for r in main_rows),
             "plain_ms": sum(r["plain_ms"] for r in main_rows),
             "bound_ms": sum(r["bound_ms"] for r in main_rows),
             "bound_by": by, "library_ms": None,
             "instantiations": [{"plan": plan_name(*p), **inst[p]}
                                for p in PLANS if p in inst]}, windows)



def overlap_pairs(draft, reads, paf) -> list:
    """The workload's (query, target) overlap pairs, each read in its
    overlap's strand against its draft span, as the main path aligns
    them."""
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    pairs = []
    for (name, read), rec in zip(reads, paf):
        f = rec.split("\t")
        q = read.translate(comp)[::-1] if f[4] == "-" else read
        pairs.append((q, draft[int(f[7]):int(f[8])]))
    return pairs


def k2_forms(al, pairs, edge, band, idx):
    """The int8 and the 2-bit packed operands of one K2 batch, on the
    aligner's device; the packed ones None when a base is not ACGT."""
    from racon_tpu_torch.ops.encode import packable

    a8 = al.operands(pairs, edge, band, idx, pack=False)
    q, t, ql, tl = (x.cpu().numpy() for x in a8[:4])
    if not (packable(q, ql) and packable(t, tl)):
        return a8, None
    return a8, al.operands(pairs, edge, band, idx, pack=True)


def adversarial_pairs() -> list:
    """Phase 3's adversarial batches (synth.align_pairs): at the main
    path's (8192, 896) every kind, N bases included; at edge 512 with
    the widest band the wrapper takes every kind, and every kind but the
    N bases (so both operand forms run). (edge, band, pairs, label)."""
    from racon_tpu_torch.ops.align_kernels import MAX_BAND
    from racon_tpu_torch.synth import ALIGN_KINDS, align_pairs

    acgt = tuple(k for k in ALIGN_KINDS if k != "n_bases")
    return [(8192, 896, align_pairs(3, 8192, 896), "with N bases"),
            (512, MAX_BAND, align_pairs(3, 512, MAX_BAND), "with N bases"),
            (512, MAX_BAND, align_pairs(3, 512, MAX_BAND, acgt),
             "ACGT only")]


def mask_of(meta, ops):
    """1 on each lane's first `count` ops, 0 past them."""
    import torch

    pos = torch.arange(ops.shape[1], device=ops.device)[None, :]
    return (pos < meta[:, :1]).to(ops.dtype)


def plane_bytes(band, args) -> int:
    """Bytes of the backpointer plane the wrapper allocates for a batch."""
    from racon_tpu_torch.ops import align_kernels

    q, offs = args[0], args[4]
    x = align_kernels.scratch(0, offs.shape[1], band, q.device)
    return q.shape[0] * x.shape[1] * x.shape[2] * x.element_size()


def align_k2(args, band, plan):
    """One K2 launch through the wrapper at instantiation `plan`."""
    from racon_tpu_torch.ops import align_kernels

    return align_kernels.wavefront_align(*args, band, *plan)


def launch_k2(fn, edge, band, args, plan):
    """One launch of a K2 C entry point (its no-traceback copy's) at
    instantiation `plan`, the plane allocated as the wrapper allocates
    it; not counted as a launch of K2. Returns (ops, meta)."""
    import torch

    from racon_tpu_torch.ops import align_kernels

    q, offs = args[0], args[4]
    B, n_waves = q.shape[0], offs.shape[1]
    bps = align_kernels.scratch(B, n_waves, band, q.device)
    ops = torch.empty((B, n_waves), dtype=torch.int32, device=q.device)
    meta = torch.empty((B, 3), dtype=torch.int32, device=q.device)
    rc = fn(*(x.data_ptr() for x in args), bps.data_ptr(), ops.data_ptr(),
            meta.data_ptr(), B, edge, band, n_waves,
            2 if plan[0] == "int16" else 4, int(plan[1]),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise SystemExit(f"K2 no-traceback copy failed to launch: {rc}")
    return ops, meta


#: a held K2 batch of at most this many cells a wavefront step (pairs x
#: band) has its plain version computed on the host CPU: on the card the
#: plain version steps one wavefront at a time in small launches, whatever
#: the batch, and the host's step grows with its cells; at band 896 the
#: host was faster up to 8 pairs and level at 16 (PERF.md, section 6)
HOST_PLAIN_CELLS = 16 * 896


def host_plain(a8, band) -> bool:
    return a8[0].shape[0] * band <= HOST_PLAIN_CELLS

#: worker processes that compute those host plain versions (started by
#: main), so they run beside each other and beside the card's work
PLAIN_POOL = None

#: every (edge, band, plan) K2 was held at in this run -> (pairs, what)
HELD_K2: dict = {}


def _warm_plain_worker() -> None:
    import torch

    import racon_tpu_torch.ops.align  # noqa: F401

    torch.set_num_threads(2)


def _host_plain_k2(arrays, band: int, dtype: str):
    """K2's plain version on the host CPU, in a PLAIN_POOL worker: numpy
    operands in, (ops, meta, ms of the plain version) out."""
    import torch

    from racon_tpu_torch.ops.align import banded_nw, traceback

    q, t, ql, tl, offs = (torch.from_numpy(a) for a in arrays)
    t0 = time.perf_counter()
    bp, dist = banded_nw(q, t, ql, tl, offs, band, dtype)
    ops, meta = traceback(bp, dist, offs, ql, tl, band)
    return ops.numpy(), meta.numpy(), (time.perf_counter() - t0) * 1e3


def k2_widths(edge, widths=None) -> tuple:
    from racon_tpu_torch.ops.dtypes import aligner_int16_ok

    if widths is not None:
        return tuple(widths)
    return ("int32", "int16") if aligner_int16_ok(edge) else ("int32",)


def plain_k2_async(edge, band, a8, widths=None) -> dict:
    """Starts the plain version of a held K2 batch of HOST_PLAIN_CELLS
    or fewer (host_plain) on the host CPU, one PLAIN_POOL task per width:
    {dtype: future}; {} for a larger batch (hold_k2 computes that one on
    the card). Start it early and hand it to hold_k2 to overlap it."""
    if not host_plain(a8, band):
        return {}
    arrays = [x.cpu().numpy() for x in a8]
    out = {}
    for dt in k2_widths(edge, widths):
        if PLAIN_POOL is not None:
            out[dt] = PLAIN_POOL.submit(_host_plain_k2, arrays, band, dt)
        else:  # imported, not run: in this process, now
            out[dt] = Future()
            out[dt].set_result(_host_plain_k2(arrays, band, dt))
    return out


def hold_k2(edge, band, a8, ap, what: str, time_it: bool = True,
            widths=None, plain=None) -> dict:
    """K2 against its plain version on one batch at every instantiation
    the edge allows (int16 where the overflow proof holds, packed when
    `ap` is given): the plain version once per score width (on the host
    CPU for a batch of HOST_PLAIN_CELLS or fewer, in PLAIN_POOL,
    `plain` when plain_k2_async started it before; on the card
    otherwise), both operand forms held against it (ops[:count], count,
    distance, touched). Exits on a difference. Returns {plan: row}, each
    with the kernel's CUDA-event ms (mean of 2 after a warm-up), the
    plain version's ms (host-clocked; in the worker, its compute alone)
    and where it ran, the bound and the band-touched pairs."""
    import torch

    from racon_tpu_torch.ops.align import banded_nw, traceback

    widths = k2_widths(edge, widths)
    q, t, ql, tl, offs = a8
    if plain is None:
        plain = plain_k2_async(edge, band, a8, widths)
    rows = {}
    for dtype in widths:
        if dtype in plain:
            h_ops, h_meta, plain_ms = plain[dtype].result()
            w_ops = torch.from_numpy(h_ops).to(q.device)
            w_meta = torch.from_numpy(h_meta).to(q.device)
            plain_dev = "cpu"
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bp, dist = banded_nw(*a8, band, dtype)
            w_ops, w_meta = traceback(bp, dist, offs, ql, tl, band)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            plain_dev = q.device.type
            del bp
        for packed, a in ((False, a8), (True, ap)):
            if a is None:
                continue
            plan = (dtype, packed)
            ops, meta = align_k2(a, band, plan)
            mask = mask_of(meta, ops)
            err = int((meta - w_meta).abs().max())
            if err or not torch.equal(ops * mask, w_ops * mask):
                raise SystemExit(f"K2 wavefront_align {plan_name(*plan)} "
                                 f"disagrees with its plain version on "
                                 f"{what}: meta max |diff| {err}")
            row = {"plain_ms": plain_ms, "plain_on": plain_dev,
                   "err": err, "touched": int(meta[:, 2].sum())}
            if time_it:
                row["ms"] = cuda_ms(lambda: align_k2(a, band, plan), reps=2)
                row["bound_ms"], row["bound_by"] = wavefront_bound(
                    ql, tl, offs, band, meta[:, 0], packed)
            rows[plan] = row
            key = (edge, band, plan_name(*plan))
            if q.shape[0] > HELD_K2.get(key, (0,))[0]:
                HELD_K2[key] = (q.shape[0], what)
    return rows


def plain_key(row) -> str:
    """Where a hold row's plain time is summed: `plain_ms` when the plain
    version ran on the card, `plain_ms_host` when on the host CPU."""
    return "plain_ms_host" if row["plain_on"] == "cpu" else "plain_ms"


def decisions(ops, meta, q_lens, t_lens):
    """Per lane: the ops in traceback order and whether BatchAligner
    rejects the pair (touched, or an in-band cost above 0.4 x length):
    what two score widths must agree on (the raw distance of a clamped
    end cell is each width's sentinel)."""
    import torch

    mask = mask_of(meta, ops)
    lens = torch.maximum(q_lens, t_lens)
    reject = (meta[:, 2] > 0) | (meta[:, 1].double() > 0.4 * lens.double())
    return ops * mask, meta[:, 0], reject


def cross_width_k2(args, band, packed, what: str) -> None:
    """The int16 and the int32 kernel on one batch: identical runs,
    counts and reject decisions, or exit."""
    import torch

    wide = decisions(*align_k2(args, band, ("int32", packed)), args[2],
                     args[3])
    narrow = decisions(*align_k2(args, band, ("int16", packed)), args[2],
                       args[3])
    if not all(torch.equal(a, b) for a, b in zip(wide, narrow)):
        raise SystemExit(f"K2 cross-width check: int16 and int32 runs or "
                         f"reject decisions differ on {what}")


def check_wavefront(dev, draft, reads, paf, report, notb) -> dict:
    """Phase 3: K2 against its plain version on the workload's overlap
    pairs, batched as the main path batches them: the fullest (first)
    batch of each (edge, band) and the last, partial batch of each that
    has several, at every instantiation the edge allows; the fullest
    timed at each, and with and without the traceback (the no-traceback
    copy `notb`) at the main path's; every batch replayed at the main
    path's instantiation and, where int16 holds, checked at both widths;
    then the adversarial batches (adversarial_pairs) compared and
    timed."""
    import torch

    from racon_tpu_torch.ops.align import BatchAligner
    from racon_tpu_torch.ops.dtypes import aligner_int16_ok

    pairs = overlap_pairs(draft, reads, paf)
    al = BatchAligner(device=dev)
    # each batch in the form and at the dtype the main path runs it
    chunks = []
    for edge, band, idx in al.chunks(pairs):
        args = al.operands(pairs, edge, band, idx)
        plan = (al.plan_for(edge, band), args[0].dtype == torch.uint8)
        chunks.append((edge, band, idx, args, plan))
    no_tb = load_without_traceback(notb)
    main_rows = []
    inst: dict = {}
    rows_out = []
    err = 0
    by = "operations"
    cases = []
    for c in chunks:
        same = [x for x in chunks if x[:2] == c[:2]]
        if c is same[0]:
            cases.append(("fullest", c))
        elif c is same[-1]:
            cases.append(("last partial", c))
    # the host plains of the small batches start first, so they run
    # beside the card's plain versions of the others
    forms = [k2_forms(al, pairs, c[0], c[1], c[2]) for _, c in cases]
    started = [plain_k2_async(c[0], c[1], f[0])
               for (_, c), f in zip(cases, forms)]
    adv = []
    for edge, band, adv_pairs, label in adversarial_pairs():
        idx = list(range(len(adv_pairs)))
        a8, ap = k2_forms(al, adv_pairs, edge, band, idx)
        adv.append((edge, band, adv_pairs, label, idx, a8, ap,
                    plain_k2_async(edge, band, a8)))
    for (kind, (edge, band, idx, args, plan)), (a8, ap), pl in zip(
            cases, forms, started):
        rows = hold_k2(edge, band, a8, ap,
                       f"the {kind} ({edge}, {band}) batch",
                       time_it=kind == "fullest", plain=pl)
        err = max([err] + [x["err"] for x in rows.values()])
        n_touched = rows[plan]["touched"]
        if kind == "last partial":
            log(f"[chip_smoke] K2 last partial batch at bucket {edge} band "
                f"{band}: {len(idx)} pairs identical at "
                f"{', '.join(plan_name(*p) for p in rows)} ({n_touched} "
                f"band-touched)")
            continue
        r = rows[plan]
        ms = r["ms"]
        tb_free = cuda_ms(lambda: launch_k2(no_tb, edge, band, args, plan),
                          reps=2)
        waves = int((args[2].long() + args[3].long()).max()) + 1
        plane = plane_bytes(band, args)
        by = r["bound_by"]
        main_rows.append(r)
        for p, x in rows.items():
            acc = inst.setdefault(p, {"batches": 0, "ms": 0.0,
                                      "plain_ms": None, "plain_ms_host": None,
                                      "bound_ms": 0.0, "bound_by": by})
            for k in ("ms", "bound_ms"):
                acc[k] += x[k]
            # None where no batch's plain version ran there
            acc[plain_key(x)] = (acc[plain_key(x)] or 0.0) + x["plain_ms"]
            acc["batches"] += 1
            acc["bound_by"] = x["bound_by"]
        rows_out.append({
            "kind": kind, "edge": edge, "band": band, "pairs": len(idx),
            "plan": plan_name(*plan),
            "instantiations": {plan_name(*p): x for p, x in rows.items()},
            "ms": ms, "plain_ms": r["plain_ms"], "plain_on": r["plain_on"],
            "bound_ms": r["bound_ms"],
            "bound_by": by, "touched": n_touched, "wavefronts": waves,
            "ns_per_wavefront": ms * 1e6 / waves,
            "no_traceback_ms": tb_free,
            "traceback_share": 1.0 - tb_free / ms, "plane_bytes": plane})
        log_plans("K2", f"fullest batch at bucket {edge} band {band} "
                  f"({len(idx)} pairs, {n_touched} band-touched; main path "
                  f"ran {plan_name(*plan)})", rows)
        log(f"[chip_smoke] K2 bucket {edge} band {band} at "
            f"{plan_name(*plan)}: bound {r['bound_ms']:.4f} ms ({by}); "
            f"{ms * 1e6 / waves:.0f} ns per wavefront over {waves}; "
            f"without traceback {tb_free:.3f} ms (traceback share "
            f"{100 * (1 - tb_free / ms):.1f}%); plane {plane} bytes")
    adv_rows = []
    for edge, band, adv_pairs, label, idx, a8, ap, pl in adv:
        rows = hold_k2(edge, band, a8, ap,
                       f"the adversarial ({edge}, {band}) batch {label}",
                       plain=pl)
        err = max([err] + [x["err"] for x in rows.values()])
        n_touched = max(x["touched"] for x in rows.values())
        # a band narrower than the bucket can be touched, and the
        # band-edge pairs must touch it (a wider band covers every row of
        # every pair's matrix)
        if band < edge and not n_touched:
            raise SystemExit(f"K2 adversarial batch at bucket {edge} band "
                             f"{band}: no pair band-touched, so the "
                             f"traceback's band-edge cells went untested")
        log_plans("K2", f"adversarial batch at bucket {edge} band {band} "
                  f"{label} ({len(idx)} pairs, {n_touched} band-touched)",
                  rows)
        adv_rows.append({"edge": edge, "band": band, "label": label,
                         "pairs": len(idx), "touched": n_touched,
                         "instantiations": {plan_name(*p): x
                                            for p, x in rows.items()}})

    all_ms = replay_ms(lambda c: align_k2(c[3], c[1], c[4]), chunks)
    all_tb_free = replay_ms(
        lambda c: launch_k2(no_tb, c[0], c[1], c[3], c[4]), chunks)
    all_bound = 0.0
    all_waves = all_plane = 0
    for edge, band, idx, args, plan in chunks:
        cnt = align_k2(args, band, plan)[1][:, 0]
        all_bound += wavefront_bound(args[2], args[3], args[4], band, cnt,
                                     plan[1])[0]
        all_waves += int((args[2].long() + args[3].long()).max()) + 1
        all_plane += plane_bytes(band, args)
    narrow = [c for c in chunks if aligner_int16_ok(c[0])]
    for edge, band, idx, args, plan in narrow:
        cross_width_k2(args, band, plan[1],
                       f"a captured ({edge}, {band}) batch")
    log(f"[chip_smoke] K2 over all {len(chunks)} batches: kernel "
        f"{all_ms:.2f} ms, bound {all_bound:.4f} ms; "
        f"{all_ms * 1e6 / all_waves:.0f} ns per wavefront over "
        f"{all_waves}; without traceback {all_tb_free:.2f} ms (traceback "
        f"share {100 * (1 - all_tb_free / all_ms):.1f}%); planes "
        f"{all_plane} bytes; cross-width check: {len(narrow)} batches of "
        f"int16 edges give identical runs and reject decisions at int16 "
        f"and int32")
    report["wavefront_align"] = rows_out
    report["wavefront_align_adversarial"] = adv_rows
    report["wavefront_align_all"] = {
        "batches": len(chunks), "ms": all_ms, "bound_ms": all_bound,
        "wavefronts": all_waves,
        "ns_per_wavefront": all_ms * 1e6 / all_waves,
        "no_traceback_ms": all_tb_free,
        "traceback_share": 1.0 - all_tb_free / all_ms,
        "plane_bytes": all_plane, "cross_width_batches": len(narrow)}
    return {"name": "wavefront_align", "route": "cuda",
            "source": "racon_tpu_torch/csrc/align_wavefront.cu",
            "replaces": "racon_tpu/ops/align_pallas.py:91",
            "launches": 0, "max_abs_err": err,
            "ms": sum(r["ms"] for r in main_rows),
            # the plain version's time on the card, and apart from it
            # the rows whose plain version ran on the host CPU
            "plain_ms": sum(r["plain_ms"] for r in main_rows
                            if plain_key(r) == "plain_ms"),
            "plain_ms_host": sum(r["plain_ms"] for r in main_rows
                                 if plain_key(r) == "plain_ms_host"),
            "plain_by_batch": [{k: r[k] for k in ("edge", "band", "pairs",
                                                  "plain_ms", "plain_on")}
                               for r in rows_out],
            "bound_ms": sum(r["bound_ms"] for r in main_rows),
            "bound_by": by, "library_ms": None,
            "instantiations": [{"plan": plan_name(*p), **inst[p]}
                               for p in PLANS if p in inst]}


def start_cli(args, d: str, tag: str) -> dict:
    """Starts `python -m racon_tpu_torch *args` (-m 5 -x -4 -g -8, all the
    host's threads, COLD_TABLE) with its stdout and stderr in files of
    `d`; returns the run's handle."""
    out, err = (os.path.join(d, f"{tag}.{x}") for x in ("out", "err"))
    with open(out, "wb") as fo, open(err, "wb") as fe:
        proc = subprocess.Popen(
            [sys.executable, "-m", "racon_tpu_torch", *args, "-m", "5",
             "-x", "-4", "-g", "-8", "-t", str(os.cpu_count()),
             "--cuda-autotune-table", COLD_TABLE],
            cwd=HERE, stdout=fo, stderr=fe)
    return {"proc": proc, "out": out, "err": err, "tag": tag,
            "t0": time.perf_counter()}


def finish_clis(runs: list, timeout: float = 600.0) -> None:
    """Waits for every run (each given `timeout` seconds from its start),
    stamping its wall (`s`), its stdout (`stdout`) and its exit code;
    exits on a run that fails or overruns, after killing the others."""
    try:
        while any("s" not in r for r in runs):
            for r in runs:
                if "s" in r:
                    continue
                rc = r["proc"].poll()
                wall = time.perf_counter() - r["t0"]
                if rc is None and wall > timeout:
                    raise SystemExit(f"{r['tag']} ran over {timeout:g} s")
                if rc is None:
                    continue
                r["s"] = wall
                if rc != 0:
                    with open(r["err"], "rb") as fh:
                        sys.stderr.write(fh.read().decode(
                            errors="replace")[-4000:])
                    raise SystemExit(f"{r['tag']} failed (rc {rc})")
                with open(r["out"], "rb") as fh:
                    r["stdout"] = fh.read()
            time.sleep(0.05)
    finally:
        for r in runs:
            if r["proc"].poll() is None:
                r["proc"].kill()
                r["proc"].wait()


def check_goldens(workdir, report) -> None:
    """Phases 4 and 4b, their six CLI processes started at once (they are
    independent; one at a time they took 73 s on an H100 host, most of
    it each process's start): the CLI at -c 1 (device POA, host aligner, -b off) must
    reproduce the committed 50 kb golden byte for byte at the default
    posture and pipeline depth, at --cuda-pipeline-depth 0 and at
    --cuda-dtype int32, and the committed fragment golden at -f -c 1,
    depth 2 and 0; and the traced run (check_trace_metrics). The walls
    are each process's own, beside the five others."""
    from racon_tpu_torch.synth import (ava_overlaps, simulate,
                                       simulate_truth, write_dataset,
                                       write_fragment_dataset)

    _, draft, reads, paf = simulate(random.Random(42), 50_000, 20, 8000,
                                    0.12, 0.10)
    d = os.path.join(workdir, "w50")
    os.makedirs(d)
    paths = write_dataset(d, draft, reads, paf)
    _, _, freads, _ = simulate_truth(random.Random(42), 40_000, 10, 8000,
                                     0.12, 0.10)
    fd = os.path.join(workdir, "frag40")
    os.makedirs(fd)
    fpaths = write_fragment_dataset(fd, freads, ava_overlaps(freads))
    jobs = [(flags, paths, "synth_50kb_golden.fasta") for flags in (
        ["-c", "1"], ["-c", "1", "--cuda-pipeline-depth", "0"],
        ["-c", "1", "--cuda-dtype", "int32"])]
    jobs += [(flags, fpaths, "synth_frag_golden.fasta") for flags in (
        ["-f", "-c", "1"], ["-f", "-c", "1", "--cuda-pipeline-depth", "0"])]
    trace_path = os.path.join(d, "trace.json")
    metrics_path = os.path.join(d, "metrics.json")
    t0 = time.perf_counter()
    runs = [start_cli([*flags, *p], workdir, f"golden{i}")
            for i, (flags, p, _) in enumerate(jobs)]
    runs.append(start_cli(
        ["-c", "1", "--cudaaligner-batches", "1", "--cuda-trace",
         trace_path, "--cuda-metrics", metrics_path, *paths], workdir,
        "traced"))
    finish_clis(runs)
    report["goldens_wall_s"] = time.perf_counter() - t0
    report["golden_s"], report["fragment_golden_s"] = {}, {}
    for (flags, _, golden), r in zip(jobs, runs):
        with open(os.path.join(HERE, "tests", "data", golden), "rb") as fh:
            if r["stdout"] != fh.read():
                raise SystemExit(f"golden: {flags} output differs from "
                                 f"tests/data/{golden}")
        frag = golden == "synth_frag_golden.fasta"
        what = (f"{len(freads)} reads of 8 kb" if frag else "50 kb x 20x")
        log(f"[chip_smoke] {'fragment ' if frag else ''}golden: {what} "
            f"{' '.join(flags)} byte-identical to the committed golden "
            f"({r['s']:.1f} s)")
        report["fragment_golden_s" if frag else "golden_s"][
            " ".join(flags)] = r["s"]
    check_trace_metrics(runs[-1], trace_path, metrics_path, report)
    log(f"[chip_smoke] goldens: {len(runs)} CLI processes at once in "
        f"{report['goldens_wall_s']:.1f} s")


def check_trace_metrics(run: dict, trace_path: str, metrics_path: str,
                        report) -> None:
    """The run `python -m racon_tpu_torch -c 1 --cudaaligner-batches 1`
    with --cuda-trace and --cuda-metrics on the 50 kb set: the trace must
    load as Chrome trace JSON holding the pipeline's pack / device /
    unpack spans of the aligner loop and the session's spans, and the
    dump must hold the pipeline namespace with the aligner's chunks and
    launches."""
    if not run["stdout"].startswith(b">"):
        raise SystemExit("traced CLI run wrote no FASTA")
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    with open(metrics_path) as fh:
        metrics = json.load(fh)
    spans: dict = {}
    for e in events:
        if e.get("ph") == "X":
            spans[e["name"]] = spans.get(e["name"], 0) + 1
    want = ("pipeline.pack", "pipeline.device", "pipeline.unpack",
            "session.dispatch", "session.commit", "polisher.consensus")
    missing = [n for n in want if not spans.get(n)]
    pipe = metrics.get("pipeline", {})
    if missing or not pipe.get("chunks") or not pipe.get("launches"):
        raise SystemExit(f"traced CLI run: spans {missing} missing from "
                         f"the trace, or no chunks / launches in the "
                         f"metrics' pipeline namespace ({pipe})")
    log(f"[chip_smoke] traced CLI run (50 kb, -c 1 --cudaaligner-batches 1, "
        f"depth 2) in {run['s']:.1f} s: trace of {len(events)} events, "
        f"spans {dict(sorted(spans.items()))}; metrics namespaces "
        f"{sorted(metrics)}, pipeline {pipe}")
    report["traced_cli"] = {"wall_s": run["s"], "spans": spans,
                            "pipeline": pipe,
                            "namespaces": sorted(metrics)}


class Tally:
    """The launches of a phase's runs: K1's and K2's in all and by
    instantiation, K3's per run; each run's numbers under its name."""

    def __init__(self):
        self.runs: dict = {}
        self.k1 = self.k2 = 0
        self.k1p: dict = {}
        self.k2p: dict = {}
        self.k3: dict = {}

    def add(self, name: str, m: dict) -> None:
        self.runs[name] = m
        self.k1 += m["k1_launches"]
        self.k2 += m["k2_launches"]
        for src, dst in ((m["k1_launches_by_plan"], self.k1p),
                         (m["k2_launches_by_plan"], self.k2p)):
            for key, n in src.items():
                dst[key] = dst.get(key, 0) + n
        if "k3_launches" in m:
            self.k3[name] = m["k3_launches"]

    def result(self):
        return (self.k1, self.k1p), (self.k2, self.k2p), self.k3


def polish_once(paths, depth: int, scores=(MATCH, MISMATCH, GAP),
                keep_windows: bool = False, **kw):
    """One polish of `paths` with both device paths on at the default
    posture and pipeline depth `depth`, the launch counters zeroed just
    before and read just after. Returns (polisher, polished, numbers);
    with the fused engine the numbers hold its launches and windows, and
    the launches its chunks and chain plans call for. `keep_windows`
    keeps the run's windows, consensus filled, as the polisher's
    `kept_windows` (polish() drops its own list). The winner table is
    COLD_TABLE unless `autotune_table` names another."""
    from racon_tpu_torch.core.polisher import PolisherType, create_polisher

    pol = create_polisher(*paths, PolisherType.kC, 500, 10.0, 0.3, True,
                          *scores, num_threads=os.cpu_count(),
                          cuda_poa_batches=1, cuda_banded_alignment=False,
                          cuda_aligner_batches=1, device="cuda",
                          pipeline_depth=depth,
                          **{"autotune_table": COLD_TABLE, **kw})
    return run_measured(pol, keep_windows)


def run_measured(pol, keep_windows: bool = False):
    """One initialize() + polish() of an existing polisher (a fresh one,
    or one rebound or re-drafted), measured as polish_once measures it."""
    import torch

    from racon_tpu_torch.ops import align_kernels, poa_fused_kernels
    from racon_tpu_torch.ops import poa_kernels

    depth = pol.pipeline_depth
    dev = pol.device
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    poa_kernels.reset_launches()
    align_kernels.reset_launches()
    poa_fused_kernels.reset_launches()
    t0 = time.perf_counter()
    pol.initialize()
    t1 = time.perf_counter()
    n_windows = len(pol.windows)
    pol.kept_windows = list(pol.windows) if keep_windows else None
    # each window's backbone and layer lengths, for the K3 launches the
    # fused engine's chunks call for
    shapes = [(len(w.sequences[0]), [len(q) for q in w.sequences[1:]])
              for w in pol.windows]
    t2 = time.perf_counter()
    polished = pol.polish()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    k1_by_shape = dict(poa_kernels.launches_by_shape)
    k2_by_shape = dict(align_kernels.launches_by_shape)
    stages = pol.stage_stats
    fused = {}
    if pol.cuda_engine == "fused":
        eng = pol.poa.engine
        k3_by_shape = dict(poa_fused_kernels.launches_by_shape)
        # the windows K3 takes (two or more layers, within the node and
        # length envelope), deepest first, B a chunk: each chunk's
        # deepest window
        depths = sorted((len(lens) for bb, lens in shapes
                         if len(lens) >= 2 and bb + 1 <= eng.N
                         and all(0 < x <= eng.L for x in lens)),
                        reverse=True)
        fused = {
            "k3_depth_buckets": list(eng.depth_buckets),
            "k3_launches": poa_fused_kernels.launches,
            "k3_launches_by_shape": {
                f"{n}x{ln}x{d} {dt} {'fused' if sl else 'split'}": c
                for (n, ln, d, dt, sl), c in sorted(k3_by_shape.items())},
            "k3_depths_launched": {
                post: sorted((d for (_, _, d, _, sl), c in k3_by_shape.items()
                              if sl == (post == "fused") for _ in range(c)),
                             reverse=True)
                for post in ("split", "fused")},
            "k3_chunk_depths": depths[::eng.B],
            "k3_min_bucket": min(eng.depth_buckets),
            "k3_dtype": eng.score_dtype, "batch_rows": eng.B,
            "fused_stats": dict(eng.last_stats),
            "windows_k3": pol.poa.n_fused,
            "windows_k3_left": eng.n_fallback,
        }
    return pol, polished, {**fused,
        "pipeline_depth": depth,
        "initialize_s": t1 - t0, "align_s": pol.phase_s["align"],
        "consensus_s": pol.phase_s["consensus"],
        "stitch_s": pol.phase_s["stitch"], "polish_s": t3 - t2,
        "windows": n_windows,
        "windows_per_s": n_windows / pol.phase_s["consensus"],
        "pairs_per_s": pol.n_aligner_pairs / pol.phase_s["align"],
        "k1_launches": poa_kernels.launches,
        "k2_launches": align_kernels.launches,
        "k1_launches_by_bucket": {
            f"{a}x{b} {plan_name(dt, pk)}": n
            for (a, b, dt, pk), n in sorted(k1_by_shape.items())},
        "k2_launches_by_edge_band": {
            f"{a}/{b} {plan_name(dt, pk)}": n
            for (a, b, dt, pk), n in sorted(k2_by_shape.items())},
        "k1_launches_by_plan": by_plan(k1_by_shape),
        "k2_launches_by_plan": by_plan(k2_by_shape),
        "pipeline_stages": {k: stages[k] for k in (
            "pack_s", "device_s", "unpack_s", "fallback_s", "chunks",
            "launches", "errors")},
        "windows_device": pol.poa.n_device, "windows_host": pol.poa.n_host,
        "windows_backbone": pol.poa.n_backbone,
        "layer_jobs": pol.poa.engine.last_stats.get("committed", 0),
        "pairs": pol.n_aligner_pairs, "pairs_device": pol.n_aligner_device,
        "pairs_host": pol.n_aligner_host_fallback,
        "pairs_unbucketable": pol.aligner.n_unbucketed,
        "pairs_band_rejects": pol.aligner.n_band_rejects,
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
        "peak_reserved_bytes": torch.cuda.max_memory_reserved(dev),
        "adaptive": pol.scheduler.adaptive,
        "occupancy": pol.occupancy_stats,
        "session_grid": ([list(b) for b in pol.poa.engine.buckets]
                         if pol.cuda_engine == "session" else None),
        "lanes": pol.device_runner.n_devices,
        "lane_calls": list(pol.device_runner.lane_calls),
    }


def log_depth(label: str, m: dict) -> None:
    st = m["pipeline_stages"]
    log(f"[chip_smoke] {label} at pipeline depth {m['pipeline_depth']}: "
        f"align {m['align_s']:.3f} s, consensus {m['consensus_s']:.3f} s; "
        f"stages pack {st['pack_s']:.3f} s, device {st['device_s']:.3f} s, "
        f"unpack {st['unpack_s']:.3f} s, fallback {st['fallback_s']:.3f} s "
        f"over {st['chunks']} chunks / {st['launches']} launches; peak "
        f"device memory {m['peak_device_bytes']} bytes allocated, "
        f"{m.get('peak_reserved_bytes', 'not read')} reserved")


#: what phases 10 to 12 hold their runs against, kept by the earlier
#: phases: the polished FASTA of the contig cell at depth 2 (phase 5,
#: "contig"), its polisher and numbers ("contig_polisher",
#: "contig_numbers"), of the fused engine at each score width (phase 9,
#: "fused int32" / "fused int16") and of the fragment shard (phase 8,
#: "fragment"), and the fragment cell's input paths
KEPT: dict = {}


def fasta_of(polished) -> list:
    return [(p.name, p.data) for p in polished]


def merged_occupancy(pols) -> dict:
    """One occupancy snapshot over several polishers (the wrapper's
    chunks)."""
    from racon_tpu_torch.sched import OccupancyStats

    merged = OccupancyStats()
    for p in pols:
        merged.merge_from(p.scheduler.stats)
    return merged.snapshot()


def occupancy_view(occ: dict) -> dict:
    """Per engine: occupancy %, useful and padded cells."""
    return {e: {"occupancy_pct": v["occupancy_pct"],
                "useful_cells": v["useful_cells"],
                "padded_cells": v["total_cells"] - v["useful_cells"]}
            for e, v in sorted(occ.items()) if v.get("buckets")}


def main_path(dev, paths, truth, draft, report):
    """Phase 5: the full-size polish with both device paths on at the
    default posture, at pipeline depth 0 and then at the default depth 2
    (the main path: its counters make the kernel line); the FASTA must be
    byte-identical. K1 must launch at both score widths and both kernels
    packed. Returns ((K1 launches, by instantiation), (K2 ...))."""
    from racon_tpu_torch.native import edit_distance

    _, sync_out, sync = polish_once(paths, 0)
    pol, polished, main = polish_once(paths, 2)
    if [(p.name, p.data) for p in polished] != [(p.name, p.data)
                                                for p in sync_out]:
        raise SystemExit("main path: the FASTA at pipeline depth 2 differs "
                         "from depth 0's")
    KEPT["contig"] = fasta_of(polished)
    KEPT["contig_polisher"] = pol
    KEPT["contig_numbers"] = main
    d_draft = edit_distance(draft, truth)
    d_pol = edit_distance(polished[0].data, truth)
    main.update(draft_distance=d_draft, polished_distance=d_pol)
    report["main_path"] = main
    report["main_path_depth0"] = sync
    for k, v in main.items():
        log(f"[chip_smoke] main path {k}: {v}")
    log_depth("main path", sync)
    log_depth("main path", main)
    log("[chip_smoke] main path: FASTA byte-identical at pipeline depth 0 "
        "and 2")
    k1, k2 = main["k1_launches"], main["k2_launches"]
    k1_plans, k2_plans = main["k1_launches_by_plan"], main[
        "k2_launches_by_plan"]
    if k1 <= 0 or k2 <= 0:
        raise SystemExit(f"main path did not launch both kernels "
                         f"(window_sweep {k1}, wavefront_align {k2})")
    widths = {name.split("/")[0] for name in k1_plans}
    if widths != {"int16", "int32"}:
        raise SystemExit(f"main path launched K1 at {sorted(widths)}, not "
                         f"at both score widths")
    for name, plans in (("window_sweep", k1_plans),
                        ("wavefront_align", k2_plans)):
        if not any(p.endswith("/packed") for p in plans):
            raise SystemExit(f"main path never launched {name} packed "
                             f"({plans})")
    if not d_pol < d_draft:
        raise SystemExit(f"polished distance {d_pol} not below the "
                         f"draft's {d_draft}")
    return (k1, k1_plans), (k2, k2_plans)


def n_base_path(dev, workdir, report):
    """Phase 5b: the main path on a small read set (40 kb genome, 15x,
    8 kb reads, seed 7) in which one read base in 200 is an N, so that
    batches ship int8: both kernels must launch their int8
    instantiations, the fullest batch of each shape they launched is
    held against the plain version at the instantiation it ran, and the
    polished contig must beat the draft. Returns ((K1 launches, by
    instantiation), (K2 ...))."""
    from racon_tpu_torch.native import edit_distance
    from racon_tpu_torch.synth import simulate, write_dataset

    rng = random.Random(7)
    truth, draft, reads, paf = simulate(rng, 40_000, 15, 8000, 0.12, 0.10)
    with_n = []
    for name, read in reads:
        b = bytearray(read)
        for i in range(rng.randrange(200), len(b), 200):
            b[i] = ord("N")
        with_n.append((name, bytes(b)))
    d = os.path.join(workdir, "nbases")
    os.makedirs(d)
    paths = write_dataset(d, draft, with_n, paf)
    with PathCapture() as cap:
        pol, polished, m = polish_once(paths, 2)
    d_draft = edit_distance(draft, truth)
    d_pol = edit_distance(polished[0].data, truth)
    m.update(draft_distance=d_draft, polished_distance=d_pol)
    report["n_base_path"] = m
    log(f"[chip_smoke] N-base path (40 kb x 15x, 1 base in 200 an N): "
        f"K1 {m['k1_launches_by_plan']}, K2 {m['k2_launches_by_plan']}; "
        f"distance {d_draft} -> {d_pol}")
    log_depth("N-base path", m)
    for name, plans in (("window_sweep", m["k1_launches_by_plan"]),
                        ("wavefront_align", m["k2_launches_by_plan"])):
        if not any(p.endswith("/int8") for p in plans):
            raise SystemExit(f"N-base path never launched {name} int8 "
                             f"({plans})")
    if not d_pol < d_draft:
        raise SystemExit(f"N-base path: polished distance {d_pol} not "
                         f"below the draft's {d_draft}")
    rows, n_cross = hold_captured(dev, cap, "N-base path")
    report["n_base_batches"] = rows
    report["n_base_cross_width_batches"] = n_cross
    return ((m["k1_launches"], m["k1_launches_by_plan"]),
            (m["k2_launches"], m["k2_launches_by_plan"]))


def profile_phase(label: str, run, kernel: str, short: str,
                  prefix: str | None = None,
                  count: str | None = None) -> dict:
    """One torch.profiler pass over `run()`: the summed device time of the
    kernel whose name holds `kernel`, the streams it ran on (from the
    capture's Chrome trace), the device's busy share of the host-clocked
    wall (the union of its kernel and copy intervals), the five host-side
    ranges with the longest summed time, with `prefix` the summed time
    and calls of every host range whose name starts with it, and with
    `count` the calls and summed time of the host event of that name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    busy_us = 0.0
    end = float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    mine = [e for e in events
            if e.device_type == DeviceType.CUDA and kernel in e.name]
    k_us = sum(e.time_range.elapsed_us() for e in mine)
    host = sorted(((k.cpu_time_total, k.key, k.count)
                   for k in prof.key_averages()
                   if k.device_type == DeviceType.CPU),
                  reverse=True)[:5]
    named: dict = {}
    calls: dict = {}
    for k in prof.key_averages():
        # a range also has a device-side entry of the same name
        if (prefix and k.key.startswith(prefix)
                and k.device_type == DeviceType.CPU):
            named[k.key] = named.get(k.key, 0.0) + k.cpu_time_total / 1e3
            calls[k.key] = calls.get(k.key, 0) + k.count
    counted = [k for k in prof.key_averages()
               if count and k.key == count and k.device_type == DeviceType.CPU]
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace_events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    streams = sorted({str(e.get("args", {}).get("stream", e.get("tid")))
                      for e in trace_events
                      if e.get("cat") == "kernel"
                      and kernel in e.get("name", "")})
    share = busy_us / (wall_s * 1e6)
    log(f"[chip_smoke] profile: {label} wall {wall_s:.3f} s under the "
        f"profiler; {short} device time {k_us / 1e3:.1f} ms over "
        f"{len(mine)} launches on streams {streams}; device busy "
        f"{busy_us / 1e3:.1f} ms = {100 * share:.1f}% of the wall")
    for us, name, count in host:
        log(f"[chip_smoke] profile {label} host range {name}: "
            f"{us / 1e3:.1f} ms over {count} calls")
    return {"wall_s": wall_s, "kernel_device_ms": k_us / 1e3,
            "kernel_launches": len(mine), "kernel_streams": streams,
            "device_busy_ms": busy_us / 1e3, "device_busy_share": share,
            "host_ranges": [{"name": n, "ms": us / 1e3, "calls": c}
                            for us, n, c in host], "ranges_ms": named,
            "range_calls": calls,
            "count_calls": sum(k.count for k in counted),
            "count_ms": sum(k.cpu_time_total for k in counted) / 1e3}


def profile_consensus(dev, windows, report) -> None:
    """Phase 6: one profiled consensus phase of the 200 kb workload (the
    session engine on the phase-2 windows), after the timed main path;
    K1 is its kernel."""
    from racon_tpu_torch.ops.poa_graph import DeviceGraphPOA

    eng = DeviceGraphPOA(MATCH, MISMATCH, GAP, device=dev,
                         num_threads=os.cpu_count())
    report["profile_consensus"] = profile_phase(
        "consensus phase", lambda: eng.consensus(windows),
        "window_sweep_kernel", "K1")


def profile_align(dev, pairs, report) -> None:
    """Phase 7: one profiled BatchAligner.align pass over the 200 kb
    workload's overlap pairs (its ranges align.operands, align.kernel,
    align.decode; K2 is its kernel) at pipeline depth 0, then one through
    a depth-2 pipeline. At depth 2, K2 must have launched on at least 2
    CUDA streams (counted where the wrapper is called, and read from the
    capture); whether the ranges recorded on the pack and unpack worker
    threads reached the capture is printed, and the port's tracer records
    the pass's stage spans beside the profiler. Then four untraced passes
    at depths 0, 2, 2, 0, timed on the host clock."""
    import torch

    from racon_tpu_torch.obs import trace
    from racon_tpu_torch.ops import align_kernels
    from racon_tpu_torch.ops.align import BatchAligner
    from racon_tpu_torch.pipeline import DispatchPipeline

    out = {}
    for depth in (0, 2):
        al = BatchAligner(device=dev)
        n_chunks = len(BatchAligner(device=dev).chunks(pairs))
        launch_streams = set()
        wrapped = align_kernels.wavefront_align

        def counted(*args, **kw):
            launch_streams.add(torch.cuda.current_stream(dev).cuda_stream)
            return wrapped(*args, **kw)

        align_kernels.wavefront_align = counted
        rec = trace.configure(None)
        try:
            with DispatchPipeline(depth=depth) as pl:
                prof = profile_phase(
                    f"align phase at depth {depth}",
                    lambda: al.align(pairs, pipeline=pl),
                    "align_wavefront_kernel", "K2", prefix="align.")
        finally:
            align_kernels.wavefront_align = wrapped
            trace.reset()
        spans: dict = {}
        for e in rec.events():
            if e["ph"] == "X":
                key = e["name"] + (f".{e['args']['seg']}"
                                   if "seg" in e.get("args", {}) else "")
                spans[key] = spans.get(key, 0.0) + e["dur"] / 1e3
        prof["trace_span_ms"] = spans
        st = pl.stats.snapshot()
        calls = prof["range_calls"]
        workers = all(calls.get(r, 0) >= n_chunks
                      for r in ("align.operands", "align.decode"))
        prof.update(pipeline_depth=depth, launch_streams=len(launch_streams),
                    chunks=n_chunks, worker_ranges_captured=workers,
                    pipeline_stages=st)
        log(f"[chip_smoke] profile align phase at depth {depth}: K2 launched "
            f"on {len(launch_streams)} streams (wrapper side), "
            f"{len(prof['kernel_streams'])} in the capture; device busy "
            f"{100 * prof['device_busy_share']:.1f}%; range calls {calls} "
            f"over {n_chunks} chunks: worker-thread ranges "
            f"{'captured' if workers else 'NOT captured'}; stages "
            f"pack {st['pack_s']:.3f} s, device {st['device_s']:.3f} s, "
            f"unpack {st['unpack_s']:.3f} s; tracer span ms {spans}")
        out[depth] = prof
    report["profile_align"] = out[0]
    report["profile_align_depth2"] = out[2]
    # untraced passes at the two depths in turns, for the spread
    walls = []
    for depth in (0, 2, 2, 0):
        al = BatchAligner(device=dev)
        with DispatchPipeline(depth=depth) as pl:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            al.align(pairs, pipeline=pl)
            torch.cuda.synchronize()
            walls.append((depth, time.perf_counter() - t0))
    log(f"[chip_smoke] align passes in turns (depth, wall s): "
        f"{[(d, round(w, 4)) for d, w in walls]}")
    report["align_walls_in_turns"] = walls
    if out[2]["launch_streams"] < 2:
        raise SystemExit(f"align phase at depth 2: K2 launched on "
                         f"{out[2]['launch_streams']} stream(s), not >= 2")




class PathCapture:
    """For one run of a path, patches the session engine's dispatch and
    the aligner's entry point: keeps the fullest K1 batch of each bucket (a
    device-side copy of its inputs, taken without a sync, with the
    instantiation it ran), the pairs of every align call (references)
    and the calls' summed wall; with `keep_all`, every K1 batch as well
    (for replay_contig). With `runner` (one worker lane's BatchRunner),
    only the K1 batches of engines on that runner are kept: not the
    other lane's, nor the audit oracle's. Both call through, so every
    launch is the run's own and is counted where it launches."""

    def __init__(self, keep_all: bool = False, runner=None):
        self.keep_all = keep_all
        self.runner = runner
        #: ((nb, lb), plan, inputs) of every K1 batch, with keep_all
        self.k1_batches: list = []
        self.k1: dict = {}          # (nb, lb) -> (real jobs, plan, inputs)
        self.k1_jobs = 0
        self.align_calls: list = []
        #: the aligner's envelope and band of each align call, so a hold
        #: batches the pairs as that call did
        self.align_opts: list = []
        self.align_s = 0.0
        self._n = 0

    def __enter__(self):
        import torch

        from racon_tpu_torch.ops.align import BatchAligner
        from racon_tpu_torch.ops.poa_graph import DeviceGraphPOA

        self._saved = (DeviceGraphPOA._dispatch, DeviceGraphPOA.run_bucket,
                       BatchAligner.align)
        dispatch, run_bucket, align = self._saved
        cap = self

        def kept(eng) -> bool:
            return cap.runner is None or eng.runner is cap.runner

        def _dispatch(eng, jobs, sel, nb, lb, B):
            if kept(eng):
                cap._n = len(sel)
                cap.k1_jobs += len(sel)
            return dispatch(eng, jobs, sel, nb, lb, B)

        def _run_bucket(eng, nb, lb, *args):
            if not kept(eng):
                return run_bucket(eng, nb, lb, *args)
            plan = (eng.plan_for(nb, lb), args[0].dtype == torch.uint8)
            if cap.keep_all:
                cap.k1_batches.append(((nb, lb), plan,
                                       [a.clone() for a in args]))
            if cap._n > cap.k1.get((nb, lb), (0,))[0]:
                cap.k1[(nb, lb)] = (cap._n, plan, [a.clone() for a in args])
            return run_bucket(eng, nb, lb, *args)

        def _align(al, pairs, progress=None, **kw):
            cap.align_calls.append(pairs)
            cap.align_opts.append({"max_length": al.max_length,
                                   "band_width": al.band_width})
            t0 = time.perf_counter()
            try:
                return align(al, pairs, progress, **kw)
            finally:
                cap.align_s += time.perf_counter() - t0

        DeviceGraphPOA._dispatch = _dispatch
        DeviceGraphPOA.run_bucket = _run_bucket
        BatchAligner.align = _align
        return self

    def __exit__(self, *exc):
        from racon_tpu_torch.ops.align import BatchAligner
        from racon_tpu_torch.ops.poa_graph import DeviceGraphPOA

        (DeviceGraphPOA._dispatch, DeviceGraphPOA.run_bucket,
         BatchAligner.align) = self._saved
        return False


def hold_fullest_k2(dev, cap, label: str, every: bool = False,
                    once: bool = False):
    """The fullest batch of each K2 (edge, band) that a captured run
    (PathCapture) launched, batched as each align call batched its pairs
    (its envelope and band), held against its plain version at the
    instantiation it ran (`every`: at every instantiation the edge and
    its bases allow), timed, and checked at both widths where int16
    holds. With `once`, a shape whose instantiation this run already
    held on a batch at least as full (HELD_K2) is not held again: its row
    names that hold instead. Returns (rows, cross-width batches); the
    holds' launches come after the run's counts were read, and count for
    no path."""
    import torch

    from racon_tpu_torch.ops.align import BatchAligner
    from racon_tpu_torch.ops.dtypes import aligner_int16_ok

    fullest: dict = {}
    for pairs, opts in zip(cap.align_calls, cap.align_opts):
        al = BatchAligner(device=dev, **opts)
        for edge, band, idx in al.chunks(pairs):
            if len(idx) > fullest.get((edge, band), (0,))[0]:
                fullest[(edge, band)] = (len(idx), pairs, idx, opts)
    rows = []
    todo = []
    for (edge, band), (n, pairs, idx, opts) in sorted(fullest.items()):
        al = BatchAligner(device=dev, **opts)
        args = al.operands(pairs, edge, band, idx)
        plan = (al.plan_for(edge, band), args[0].dtype == torch.uint8)
        before = HELD_K2.get((edge, band, plan_name(*plan)))
        if once and before is not None and before[0] >= n:
            rows.append({"kernel": "K2", "shape": [edge, band], "pairs": n,
                         "plan": plan_name(*plan), "held_before": before[1],
                         "held_before_pairs": before[0]})
            continue
        a8 = args if not plan[1] else al.operands(pairs, edge, band, idx,
                                                  pack=False)
        widths = None if every else (plan[0],)
        # the host plains start first, beside the card's of the others
        todo.append((edge, band, n, args, a8, plan, widths,
                     plain_k2_async(edge, band, a8, widths)))
    n_cross = 0
    for edge, band, n, args, a8, plan, widths, started in todo:
        held = hold_k2(edge, band, a8, args if plan[1] else None,
                       f"the {label}'s fullest ({edge}, {band}) batch",
                       widths=widths, plain=started)
        r = held[plan]
        if aligner_int16_ok(edge):
            cross_width_k2(args, band, plan[1], f"the {label}'s "
                           f"fullest ({edge}, {band}) batch")
            n_cross += 1
        rows.append({"kernel": "K2", "shape": [edge, band], "pairs": n,
                     "plan": plan_name(*plan), "touched": r["touched"],
                     "held_at": sorted(plan_name(*p) for p in held),
                     "max_abs_err": max(x["err"] for x in held.values()),
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "plain_on": r["plain_on"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]})
    del todo
    return rows, n_cross


def hold_captured(dev, cap, label: str):
    """The fullest batch of each K1 bucket and of each K2 (edge, band)
    that a captured run (PathCapture) launched, held against its
    plain version at the instantiation it ran, timed, and checked at both
    widths where int16 holds. Returns (rows, cross-width batches)."""
    import torch

    # the fullest batch of each K1 bucket at the instantiation it ran,
    # against the plain version, and at both widths where int16 holds
    rows = []
    n_cross = 0
    for (nb, lb), (n, plan, args) in sorted(cap.k1.items()):
        held = hold_k1(args, nb, lb,
                       f"the {label}'s fullest {(nb, lb)} batch",
                       widths=(plan[0],))
        r = held[plan]
        if plan[0] == "int16":
            if not torch.equal(sweep(args, plan),
                               sweep(args, ("int32", plan[1]))):
                raise SystemExit(f"K1 cross-width check: int16 and int32 "
                                 f"ranks differ on the {label}'s "
                                 f"fullest {(nb, lb)} batch")
            n_cross += 1
        rows.append({"kernel": "K1", "shape": [nb, lb], "jobs": n,
                     "rows": args[0].shape[0], "plan": plan_name(*plan),
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]})
    k2_rows, k2_cross = hold_fullest_k2(dev, cap, label)
    rows += k2_rows
    n_cross += k2_cross
    log_held(label, rows)
    log(f"[chip_smoke] {label} cross-width check: {n_cross} fullest "
        f"batches of int16 shapes identical at int16 and int32")
    return rows, n_cross


def log_held(label: str, rows: list) -> None:
    """One line for each held fullest batch (hold_captured's rows)."""
    for r in rows:
        if "held_before" in r:
            log(f"[chip_smoke] {label} {r['kernel']} fullest batch at "
                f"{tuple(r['shape'])}, {r['plan']}: {r['pairs']} pairs; "
                f"this shape and instantiation were held earlier in this "
                f"run on {r['held_before']} ({r['held_before_pairs']} "
                f"pairs), so not again")
            continue
        log(f"[chip_smoke] {label} {r['kernel']} fullest batch at "
            f"{tuple(r['shape'])}, {r['plan']}: "
            + (f"{r['jobs']} jobs / {r['rows']} rows"
               if r["kernel"] == "K1" else
               f"{r['pairs']} pairs ({r['touched']} band-touched)")
            + f" identical; kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.1f} ms"
            + (f" on {r['plain_on']}" if "plain_on" in r else "")
            + (f" (held at {', '.join(r['held_at'])})" if "held_at" in r
               else "")
            + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def fragment_path(dev, truth, reads, workdir, report):
    """Phase 8: fragment correction at full size through the wrapper
    (shard 0 of 4 of the reads split at 800,000 bytes) at the default
    posture, launch counters zeroed just before and read just after;
    then the fullest batch of each shape it launched held against the
    plain version at the instantiation it ran, timed, and checked at
    both widths where int16 holds; and one traced align pass over the
    shard's pairs. Returns ((K1 launches, by instantiation), (K2 ...))."""
    import io

    import torch

    from racon_tpu_torch import wrapper
    from racon_tpu_torch.native import edit_distance
    from racon_tpu_torch.ops import align_kernels, poa_kernels
    from racon_tpu_torch.ops.align import BatchAligner
    from racon_tpu_torch.synth import (ava_overlaps, truth_segment,
                                       write_fragment_dataset)

    t0 = time.perf_counter()
    paf = ava_overlaps(reads, min_overlap=1000)
    d = os.path.join(workdir, "frag200")
    os.makedirs(d)
    paths = write_fragment_dataset(d, reads, paf)
    log(f"[chip_smoke] fragment path: {len(reads)} reads, {len(paf)} "
        f"all-vs-all overlap rows ({time.perf_counter() - t0:.1f} s)")

    out = io.BytesIO()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with PathCapture() as cap:
        poa_kernels.reset_launches()
        align_kernels.reset_launches()
        t0 = time.perf_counter()
        pols = wrapper.run(*paths, split=800_000, fragment_correction=True,
                           threads=os.cpu_count(), cuda_poa_batches=1,
                           cuda_aligner_batches=1, device="cuda",
                           num_shards=4, shard_id=0, out=out,
                           autotune_table=COLD_TABLE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1 = poa_kernels.launches
        k1_by_shape = dict(poa_kernels.launches_by_shape)
        k2 = align_kernels.launches
        k2_by_shape = dict(align_kernels.launches_by_shape)
    peak = torch.cuda.max_memory_allocated(dev)
    k1_plans, k2_plans = by_plan(k1_by_shape), by_plan(k2_by_shape)
    KEPT["fragment"] = out.getvalue()
    KEPT["fragment_paths"] = paths

    def total(f):
        return sum(f(p) for p in pols)

    align_s = total(lambda p: p.phase_s["align"])
    consensus_s = total(lambda p: p.phase_s["consensus"])
    n_pairs = total(lambda p: p.n_aligner_pairs)
    n_windows = total(lambda p: p.poa.n_device + p.poa.n_host
                      + p.poa.n_backbone)
    n_targets = total(lambda p: p.n_targets)
    n_dropped = total(lambda p: p.n_dropped)
    lines = out.getvalue().split(b"\n")
    written = list(zip(lines[0::2], lines[1::2]))
    # shard 0 holds the first chunks, and chunks are consecutive reads
    by_name = {r[0]: r for r in reads[:n_targets]}
    raw = fixed = raw_all = 0
    for head, seq in written:
        read = by_name[head[1:].split(b" ")[0].decode()[:-1]]
        seg = truth_segment(truth, read)
        raw += edit_distance(read[1], seg)
        fixed += edit_distance(seq, seg)
    for read in by_name.values():
        raw_all += edit_distance(read[1], truth_segment(truth, read))
    by_bucket: dict = {}
    sizer = BatchAligner(device=dev)
    for pairs in cap.align_calls:
        for q, t in pairs:
            edge = sizer._bucket_of(max(len(q), len(t)))
            by_bucket[edge] = by_bucket.get(edge, 0) + 1
    frag = {
        "chunks": len(pols), "targets": n_targets, "dropped": n_dropped,
        "written": len(written), "overlap_rows": len(paf),
        "wall_s": wall, "align_s": align_s,
        # BatchAligner.align's share of the align phase (the rest: the
        # pairs' spans, CIGARs from the runs, breaking points)
        "batch_aligner_s": cap.align_s, "consensus_s": consensus_s,
        "pairs": n_pairs, "pairs_per_s": n_pairs / align_s,
        "pairs_by_bucket": {str(k): v for k, v in sorted(
            by_bucket.items(), key=lambda kv: kv[0] or 1 << 30)},
        "windows": n_windows, "windows_per_s": n_windows / consensus_s,
        "pairs_device": total(lambda p: p.n_aligner_device),
        "pairs_host": total(lambda p: p.n_aligner_host_fallback),
        "pairs_unbucketable": total(lambda p: p.aligner.n_unbucketed),
        "pairs_band_rejects": total(lambda p: p.aligner.n_band_rejects),
        "windows_device": total(lambda p: p.poa.n_device),
        "windows_host": total(lambda p: p.poa.n_host),
        "windows_backbone": total(lambda p: p.poa.n_backbone),
        "layer_jobs": total(
            lambda p: p.poa.engine.last_stats.get("committed", 0)),
        "k1_launches": k1, "k2_launches": k2,
        "k1_launches_by_bucket": {
            f"{a}x{b} {plan_name(dt, pk)}": n
            for (a, b, dt, pk), n in sorted(k1_by_shape.items())},
        "k2_launches_by_edge_band": {
            f"{a}/{b} {plan_name(dt, pk)}": n
            for (a, b, dt, pk), n in sorted(k2_by_shape.items())},
        "k1_launches_by_plan": k1_plans, "k2_launches_by_plan": k2_plans,
        "k1_jobs_per_launch": cap.k1_jobs / max(k1, 1),
        "pipeline_depth": pols[0].pipeline_depth,
        "pipeline_stages": {k: total(lambda p: p.stage_stats[k]) for k in (
            "pack_s", "device_s", "unpack_s", "fallback_s", "chunks",
            "launches", "errors")},
        "peak_device_bytes": peak,
        "raw_distance_written": raw, "corrected_distance": fixed,
        "raw_distance_all_targets": raw_all,
        "occupancy": merged_occupancy(pols),
    }
    report["fragment_path"] = frag
    for k, v in frag.items():
        log(f"[chip_smoke] fragment path {k}: {v}")
    log_depth("fragment path", dict(frag, align_s=align_s,
                                    consensus_s=consensus_s))
    if k1 <= 0 or k2 <= 0:
        raise SystemExit(f"fragment path did not launch both kernels "
                         f"(window_sweep {k1}, wavefront_align {k2})")
    if not fixed < raw:
        raise SystemExit(f"corrected distance {fixed} not below the raw "
                         f"reads' {raw}")
    if len(written) != n_targets - n_dropped:
        raise SystemExit(f"fragment path wrote {len(written)} reads, not "
                         f"{n_targets} targets less {n_dropped} dropped")

    rows, n_cross = hold_captured(dev, cap, "fragment path")
    report["fragment_batches"] = rows
    report["fragment_cross_width_batches"] = n_cross

    all_pairs = [p for pairs in cap.align_calls for p in pairs]
    prof = profile_phase("fragment align phase",
                         lambda: BatchAligner(device=dev).align(all_pairs),
                         "align_wavefront_kernel", "K2", prefix="align.")
    per_pair = {k: v / len(all_pairs) for k, v in prof["ranges_ms"].items()}
    prof["ms_per_pair"] = per_pair
    log(f"[chip_smoke] profile fragment align phase over {len(all_pairs)} "
        f"pairs: ms per pair {per_pair}")
    report["profile_fragment_align"] = prof
    return (k1, k1_plans), (k2, k2_plans)




#: K3's stages as its diagnostic build counts them (the first six slots of
#: each block's [16] i64 record; then rows swept, DP passes, layers run and
#: the block's total cycles at 6..9)
K3_STAGES = ("sort", "range", "dp", "traceback", "scans", "writes")


def build_k3_stages():
    """Start nvcc on csrc/poa_fused.cu with K3_STAGE_CLOCKS defined: the
    diagnostic build, whose entry rt_poa_fused_stages takes a [B, 16] i64
    tensor first and writes each block's clock64() cycles per stage into
    it. The production build never defines the macro. Returns what
    load_without_traceback needs."""
    from racon_tpu_torch import _build

    d = os.path.join(HERE, "build", "scratch")
    os.makedirs(d, exist_ok=True)
    lib = os.path.join(d, f"libpoa_fused_stages-{os.getpid()}.so")
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DK3_STAGE_CLOCKS", "-shared",
         "-o", lib, os.path.join(_build.CSRC, "poa_fused.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib, "rt_poa_fused_stages", 22, 11


def k3_stage_split(fn, state, ops, done, scores, dtype) -> dict:
    """One launch of K3's diagnostic build (`fn`) on a copy of `state`
    with one call's operands (either posture), timed with CUDA events
    (not counted as a K3 launch). Returns the deepest block's (the most
    cycles) cycles and share per stage, its rows swept per layer and ns
    per DP row (its DP cycles over its rows at its clock: its total
    cycles over the launch's time), and the shares summed over all
    blocks."""
    import numpy as np
    import torch

    from racon_tpu_torch.ops import poa_fused_kernels as fk

    seqs, lens, wts, *slicing = ops
    B, N, P = state[1].shape
    D, L = seqs.shape[1], seqs.shape[2]
    dev = seqs.device
    st = [t.clone() for t in state]
    stg = torch.zeros((B, 16), dtype=torch.int64, device=dev)
    lb = torch.full((B,), done, dtype=torch.int32, device=dev)
    scratch = fk.scratch(B, N, L, dev, dtype)
    sliced = len(slicing) == 4
    ptrs = [t.data_ptr() for t in (*st, seqs, lens, wts, *slicing)]
    if not sliced:
        ptrs.append(None)
    ptrs += [lb.data_ptr()] + [t.data_ptr() for t in scratch]
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    rc = fn(stg.data_ptr(), *ptrs, B, N, L, D, P, *scores, 0,
            2 if dtype == "int16" else 4, int(sliced),
            torch.cuda.current_stream(dev).cuda_stream)
    b.record()
    torch.cuda.synchronize()
    if rc != 0:
        raise SystemExit(f"K3 stage build {dtype}: launch returned {rc}")
    ms = a.elapsed_time(b)
    c = stg.cpu().numpy().astype(np.float64)
    deep = int(c[:, 9].argmax())
    row = c[deep]
    ghz = row[9] / (ms * 1e6)
    tot = row[:len(K3_STAGES)].sum()
    tot_all = c[:, :len(K3_STAGES)].sum()
    return {
        "ms": ms, "block": deep, "ghz": ghz,
        "cycles": {s: int(row[i]) for i, s in enumerate(K3_STAGES)},
        "share": {s: row[i] / tot for i, s in enumerate(K3_STAGES)},
        "share_all_blocks": {s: c[:, i].sum() / tot_all
                             for i, s in enumerate(K3_STAGES)},
        "rows": int(row[6]), "dp_passes": int(row[7]),
        "layers": int(row[8]),
        "rows_per_layer": row[6] / max(row[8], 1),
        "ns_per_row": row[2] / max(row[6], 1) / ghz,
        "ms_per_layer": ms / max(row[8], 1)}


def log_stage_split(label: str, sp: dict) -> None:
    log(f"[chip_smoke] K3 stage split, {label}: {sp['ms']:.2f} ms; deepest "
        f"block {sp['block']}: " + ", ".join(
            f"{s} {100 * sp['share'][s]:.1f}%" for s in K3_STAGES)
        + f"; {sp['layers']} layers, {sp['dp_passes']} DP passes, "
        f"{sp['rows_per_layer']:.0f} rows swept a layer, "
        f"{sp['ns_per_row']:.0f} ns a DP row at {sp['ghz']:.2f} GHz, "
        f"{sp['ms_per_layer']:.2f} ms a layer; all blocks: " + ", ".join(
            f"{s} {100 * sp['share_all_blocks'][s]:.1f}%"
            for s in K3_STAGES))


def fused_bound(state, ops, done, scores, dtype) -> tuple[float, str]:
    """Least time the card needs for one K3 call on the split posture
    (the chunk's state, the call's operands (seqs, lens, wts, rlo, rhi,
    band) and its layer base `done`): the state read and written once and
    the layers read once, over the bytes rate; or the operations this
    call's data needs, over the integer rate. Those are counted layer by
    layer from the state each layer meets, which a replay of the call
    one layer at a time (D = 1 K3 launches on a copy) gives. A window
    counts from its first layer until it fails: a layer it enters failed
    needs nothing, one that fails the ring rule (decided on the rank
    order, before the DP) only its sort. A counted layer needs:
    - for each node in the layer's bpos range, the row's in-band cells
      (its centre's band clipped to columns 1..slen; all slen columns
      when the band is 0) times 6 x the row's in-degree within the range
      (1 for a row fed by the source) + 4, as window_sweep_bound counts a
      cell;
    - the same over all slen columns once more where the banded pass
      clipped and the full DP ran: where a banded-only replay ends in
      another state, or where its ingest shows fewer than half of its
      aligned positions (those that made no new column) landing on an
      old node (of their base: the matches, and the alt nodes, so an
      upper bound on the matches) — a retry that neither shows is not
      counted;
    - a sort of the live nodes' keys, n log2 n compare-exchanges of 2
      operations, and the ingest at 30 operations a layer base."""
    import torch

    from racon_tpu_torch.ops import poa_fused_kernels as fk
    from racon_tpu_torch.ops.poa_graph import RING

    seqs, lens, wts, rlo, rhi, band = ops
    B, N, P = state[1].shape
    nbytes = 2 * sum(t.numel() * t.element_size() for t in state)
    nbytes += sum(t.numel() * t.element_size() for t in ops)
    state = tuple(t.clone() for t in state)
    idx = torch.arange(N, device=lens.device)
    n_ops = 0.0
    for d in range(lens.shape[1]):
        codes, preds, col_of, colkey, bpos = (state[i] for i in (0, 1, 4, 5,
                                                                 7))
        slen = lens[:, d].long()
        live = (slen > 0) & ~state[10]
        n_old, nseq_old, cols_old = (state[i].clone() for i in (8, 3, 9))
        n = n_old.double().clamp(min=2)
        irr = ((codes >= 0) & (bpos >= rlo[:, d, None])
               & (bpos <= rhi[:, d, None]))
        pc = preds.long().clamp(min=0).view(B, -1)
        pin = (preds >= 0) & torch.gather(irr, 1, pc).view(B, N, P)
        deg = pin.sum(2).clamp(min=1)
        key = torch.where(
            codes >= 0,
            (torch.gather(colkey, 1, col_of.long().clamp(0, N - 1)) << 11)
            | idx, (1 << 62) | idx)
        rank = key.argsort(dim=1).argsort(dim=1)
        back = rank[:, :, None] - torch.gather(rank, 1, pc).view(B, N, P)
        ring_fail = (pin & (back > RING)).flatten(1).any(1)
        origin = rlo[:, d].long().clamp(min=0)[:, None]
        c = bpos.long() - origin + 1
        half = (band[:, d].long() // 2)[:, None]
        ln = slen[:, None]
        cols = (torch.minimum(ln, c + half) - torch.clamp(c - half, min=1)
                + 1).clamp(min=0)
        cols = torch.where(band[:, d, None] > 0, cols, ln)
        cell = (6 * deg + 4) * irr
        one = [t[:, d:d + 1].contiguous() for t in ops]
        lb = torch.full((B,), done + d, dtype=torch.int32,
                        device=lens.device)
        banded = fk.fused_layers(tuple(t.clone() for t in state), *one[:3],
                                 tuple(one[3:]), lb, *scores,
                                 banded_only=True, score_dtype=dtype)
        state = fk.fused_layers(state, *one[:3], tuple(one[3:]), lb,
                                *scores, score_dtype=dtype)
        moved = torch.stack([(x != y).reshape(B, -1).any(1)
                             for x, y in zip(banded, state)]).any(0)
        n_al = slen - (banded[9] - cols_old)
        hits = ((banded[3] - nseq_old) * (idx < n_old[:, None])).sum(1)
        clipped = ~banded[10] & ((n_al == 0) | (2 * hits < n_al))
        retried = (band[:, d] > 0) & (moved | clipped)
        work = ((cell * cols).sum(1) + retried * (cell * ln).sum(1)
                + 30 * slen)
        work = torch.where(ring_fail, 0, work) + 2 * n * torch.log2(n)
        n_ops += float((live * work).sum())
    return bound(nbytes, n_ops)


def fused_path(dev, paths, truth, draft, windows, report, k3stg):
    """Phase 9: the fused engine (K3, csrc/poa_fused.cu) on the contig
    cell, at the full envelope (N 2048, L 640, P 8), pipeline depth 2:
    `-c 1 --cudaaligner-batches 1 --cuda-engine fused` in-process at
    `--cuda-fused 0` and `1`, at 5/-4/-8 (int32) and at the CLI's default
    3/-5/-4 (int16). The two postures' FASTA must be byte-identical and
    closer to the truth than the draft; K3 must launch once a chunk at 1
    and at least once at 0, and its launched depths must cover each
    chunk's deepest window. Then, per instantiation,
    the deepest chunk's second chained call at full width, its first
    DEPTH_BUCKETS[0] layers, is held against the plain version on all 11
    state arrays (and timed, with its bound), the fused launch of the
    shallowest chunk that chains two calls or more on a slice of its
    first 8 rows, one layer past its chain's first call, likewise, K3
    is timed over every chunk at both postures
    (CUDA events) and by stage (`k3stg`: the diagnostic build started by
    build_k3_stages), and two fused consensus passes of one engine are
    traced. Returns (K1, K2 launches of the four runs, by instantiation)
    and K3's kernel line entry."""
    import numpy as np
    import torch

    from racon_tpu_torch.device import card_info
    from racon_tpu_torch.native import edit_distance
    from racon_tpu_torch.ops import poa_fused_kernels as fk
    from racon_tpu_torch.ops.poa_fused import (DEPTH_BUCKETS, STATE,
                                               FusedPOA, fused_raw)
    from racon_tpu_torch.pipeline import DispatchPipeline

    tal = Tally()
    d_draft = edit_distance(draft, truth)
    d_session = report["main_path"]["polished_distance"]
    out: dict = {"runs": tal.runs}
    for scores, dtype in (((5, -4, -8), "int32"), ((3, -5, -4), "int16")):
        fasta = {}
        for fused in ("0", "1"):
            _, polished, m = polish_once(paths, 2, scores=scores,
                                           cuda_engine="fused",
                                           cuda_fused=fused)
            fasta[fused] = [(p.name, p.data) for p in polished]
            d_pol = edit_distance(polished[0].data, truth)
            name = f"{dtype} fused={fused}"
            # K3's launched depths against each chunk's deepest window: at
            # 1 one launch a chunk, at 0 one per chained call, and either
            # way each chunk's depths cover its deepest window by less
            # than the smallest depth bucket
            want = m["k3_chunk_depths"]
            post = "fused" if fused == "1" else "split"
            got = m["k3_depths_launched"][post]
            lo = m["k3_min_bucket"]
            if fused == "1":
                ok = len(got) == len(want) and all(
                    0 <= g - w < lo for g, w in zip(got, want))
            else:
                ok = (len(got) >= len(want)
                      and 0 <= sum(got) - sum(want) < lo * len(want))
            if (m["k3_dtype"] != dtype or not ok
                    or m["k3_launches"] != len(got)):
                raise SystemExit(
                    f"fused path {name}: K3 launched {m['k3_launches']} "
                    f"times at {m['k3_dtype']} with {post} depths {got}; "
                    f"the chunks' deepest windows are {want} at {dtype}")
            if not d_pol < d_draft:
                raise SystemExit(f"fused path {name}: distance {d_pol} not "
                                 f"below the draft's {d_draft}")
            m.update(polished_distance=d_pol, draft_distance=d_draft)
            tal.add(name, m)
            log(f"[chip_smoke] fused path {name}: consensus "
                f"{m['consensus_s']:.3f} s ({m['windows_per_s']:.1f} "
                f"windows/s), K3 {m['k3_launches']} launches over "
                f"{len(want)} chunks of {m['batch_rows']} rows (deepest "
                f"windows {want} layers, depths launched {got}); windows "
                f"built by K3 "
                f"{m['windows_k3']}, left to the session engine "
                f"{m['windows_k3_left']} (K1 {m['k1_launches']} launches), "
                f"on the host {m['windows_host']}; distance {d_draft} -> "
                f"{d_pol} (session engine {d_session}); card {card_info()}")
            log_depth(f"fused path {name}", m)
        if fasta["0"] != fasta["1"]:
            raise SystemExit(f"fused path {dtype}: the FASTA at "
                             f"--cuda-fused 0 and 1 differ")
        KEPT[f"fused {dtype}"] = fasta["0"]
        log(f"[chip_smoke] fused path {dtype}: FASTA byte-identical at "
            f"--cuda-fused 0 and 1")

    # ---- K3 against its plain version, and timed, per instantiation
    stage_fn = load_without_traceback(k3stg)
    rows = []
    t_phase = time.perf_counter()
    for scores, dtype in (((5, -4, -8), "int32"), ((3, -5, -4), "int16")):
        eng = FusedPOA(*scores, device=dev, fused="1")
        order = eng._fused_order(windows)
        chunks = [order[s:s + eng.B] for s in range(0, len(order), eng.B)]

        def to_dev(arrays):
            return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in arrays]

        def launch(state, ops, done, B):
            seqs, lens, wts, *slicing = ops
            lb = torch.full((B,), done, dtype=torch.int32, device=dev)
            return fk.fused_layers(tuple(state), seqs, lens, wts,
                                   tuple(slicing), lb, *scores,
                                   score_dtype=dtype)

        # every chunk at both postures, K3 alone between CUDA events, and
        # each chunk's bound (summed over its chained calls)
        per_chunk = {"split": [], "fused": [], "bound": []}
        for chunk in chunks:
            plan = eng._chain_plan(max(len(windows[i]) - 1 for i in chunk))
            st, calls = eng._pack_chunk(windows, chunk)
            stf, opsf = eng._pack_chunk_fused(windows, chunk, sum(plan))
            state = to_dev(st)
            chunk_bound = 0.0
            for d, o, done in calls:
                o = to_dev(o)
                chunk_bound += fused_bound(state, o, done, scores, dtype)[0]
                state = launch(state, o, done, eng.B)
            per_chunk["bound"].append(chunk_bound)
            for post, st0, cl in (("split", st, calls),
                                  ("fused", stf, [(sum(plan), opsf, 0)])):
                state = to_dev(st0)
                cl = [(d, to_dev(o), done) for d, o, done in cl]
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for d, o, done in cl:
                    state = launch(state, o, done, eng.B)
                b.record()
                torch.cuda.synchronize()
                per_chunk[post].append(a.elapsed_time(b))
        # the deepest chunk's second chained call at full width (a layer
        # base above 0: the insertion keys' salt path), from the state
        # K3 leaves after the first
        st, calls = eng._pack_chunk(windows, chunks[0])
        if len(calls) < 2:
            raise SystemExit(f"K3 {dtype}: the deepest chunk has "
                             f"{len(calls)} chained call, want 2 or more")
        _, ops0, _ = calls[0]
        d1, ops1, done1 = calls[1]
        state0 = launch(to_dev(st), to_dev(ops0), 0, eng.B)
        ops = to_dev(ops1)
        # held and timed: its first DEPTH_BUCKETS[0] layers (the whole
        # call's 16 took the plain version 28-36 s a width on an H100)
        dh = DEPTH_BUCKETS[0]
        held_ops = cut_layers(ops, dh)
        k_state = [t.clone() for t in state0]
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        k_state = launch(k_state, held_ops, done1, eng.B)
        b.record()
        torch.cuda.synchronize()
        k_ms = a.elapsed_time(b)
        t0 = time.perf_counter()
        lb = torch.full((eng.B,), done1, dtype=torch.int32, device=dev)
        p_state = fused_raw(eng.N, eng.L, dh, eng.P, *scores,
                            score_dtype=dtype)(*state0, *held_ops, lb)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        for nm, x, y in zip(STATE, k_state, p_state):
            if not torch.equal(x, y):
                raise SystemExit(f"K3 {dtype}: {nm} differs from the plain "
                                 f"version on the deepest chunk's second "
                                 f"chained call")
        bms, by = fused_bound(state0, held_ops, done1, scores, dtype)
        held = [f"the deepest chunk's second chained call, its first {dh} "
                f"of {d1} layers from layer {done1} x {eng.B} rows"]
        # the fused launch of the shallowest chunk whose chain takes two
        # calls or more, on a slice of its first 8 rows (all its rows
        # would take the plain version many minutes), cut one layer past
        # its chain's first call (the whole launch's 24 layers took the
        # plain version 30-35 s a width on an H100)
        plans = [eng._chain_plan(max(len(windows[i]) - 1 for i in c))
                 for c in chunks]
        ci = min((k for k, pl in enumerate(plans) if len(pl) >= 2),
                 key=lambda k: sum(plans[k]))
        first = chunks[ci][:8]
        rs = len(first)
        eng8 = FusedPOA(*scores, device=dev, batch_rows=rs, fused="1")
        Ds = sum(plans[ci])
        Dc = plans[ci][0] + 1
        st8, ops8 = eng8._pack_chunk_fused(windows, first, Ds)
        s8, o8 = to_dev(st8), cut_layers(to_dev(ops8), Dc)
        k8 = launch([t.clone() for t in s8], o8, 0, rs)
        t0 = time.perf_counter()
        p8 = fused_raw(eng.N, eng.L, Dc, eng.P, *scores, score_dtype=dtype,
                       device_slice=True)(
            *s8, *o8, torch.zeros(rs, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        slice_ms = (time.perf_counter() - t0) * 1e3
        for nm, x, y in zip(STATE, k8, p8):
            if not torch.equal(x, y):
                raise SystemExit(f"K3 {dtype}: {nm} differs from the "
                                 f"plain version on the fused launch of "
                                 f"chunk {ci}'s first {rs} rows")
        # K3's time by stage (its diagnostic build) on the deepest chunk's
        # whole fused launch at full width and on the held chained call
        stages = {}
        stf0, opsf0 = eng._pack_chunk_fused(windows, chunks[0],
                                            sum(plans[0]))
        for what, st0, o, done in (
                ("fused", to_dev(stf0), to_dev(opsf0), 0),
                ("chained", state0, ops, done1)):
            stages[what] = k3_stage_split(stage_fn, st0, o, done, scores,
                                          dtype)
            log_stage_split(f"{dtype}, the deepest chunk's "
                            + ("fused launch" if what == "fused" else
                               "second chained call"), stages[what])
        held.append(f"chunk {ci}'s fused launch, its first {Dc} of {Ds} "
                    f"layers x {rs} rows")
        row = {"plan": dtype, "max_abs_err": 0, "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": bms, "bound_by": by, "library_ms": None,
               "held": held, "plain_slice_ms": slice_ms, "stages": stages,
               "chunk_ms_split": per_chunk["split"],
               "chunk_ms_fused": per_chunk["fused"],
               "chunk_bound_ms": per_chunk["bound"],
               "rows": eng.B, "chunks": len(chunks)}
        rows.append(row)
        log(f"[chip_smoke] K3 {dtype} ({eng.B} rows a chunk, "
            f"{len(chunks)} chunks): identical to the plain version on "
            f"every state array of {' and '.join(held)}; the chained "
            f"call {k_ms:.2f} ms (plain {p_ms:.0f} ms, bound {bms:.4f} ms by "
            f"{by}); per chunk split {[round(x, 2) for x in per_chunk['split']]}"
            f" ms, fused {[round(x, 2) for x in per_chunk['fused']]} ms "
            f"(sums {sum(per_chunk['split']):.2f} / "
            f"{sum(per_chunk['fused']):.2f} ms; bound "
            f"{sum(per_chunk['bound']):.4f} ms); plain on the fused "
            f"launch's slice {slice_ms:.0f} ms; card {card_info()}")
    out["holds_s"] = time.perf_counter() - t_phase

    # ---- traced fused consensus passes (int32, posture 1, depth 2): a
    # fresh engine's first pass, then its second (the engine keeps its
    # streams and K3's scratch for the run), each with its cudaMalloc
    # calls and the memory the caching allocator holds after it
    eng = FusedPOA(MATCH, MISMATCH, GAP, device=dev, fused="1",
                   num_threads=os.cpu_count())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with DispatchPipeline(depth=2) as pl:
        for what in ("profile", "profile_warm"):
            torch.cuda.reset_peak_memory_stats(dev)
            out[what] = prof = profile_phase(
                f"fused consensus phase ({what})",
                lambda: eng.consensus(windows, fallback=False, pipeline=pl),
                "fused_kernel", "K3", count="cudaMalloc")
            prof["reserved_bytes"] = torch.cuda.memory_reserved(dev)
            prof["peak_reserved_bytes"] = torch.cuda.max_memory_reserved(
                dev)
            log(f"[chip_smoke] fused consensus phase ({what}): "
                f"{prof['count_calls']} cudaMalloc calls "
                f"({prof['count_ms']:.2f} ms), {prof['reserved_bytes']} "
                f"bytes reserved after it, peak "
                f"{prof['peak_reserved_bytes']}")
    out["instantiations"] = rows
    report["fused_path"] = out
    k3_runs = tal.k3
    k3 = sum(k3_runs.values())
    for row in rows:
        row["launches"] = sum(n for name, n in k3_runs.items()
                              if name.startswith(row["plan"]))
    main_row = rows[0]
    entry = {"name": "poa_fused", "route": "cuda",
             "source": "racon_tpu_torch/csrc/poa_fused.cu",
             "replaces": "racon_tpu/ops/poa_fused.py:133",
             "launches": k3, "max_abs_err": 0, "ms": main_row["ms"],
             "plain_ms": main_row["plain_ms"],
             "bound_ms": main_row["bound_ms"],
             "bound_by": main_row["bound_by"], "library_ms": None,
             "launches_by_path": k3_runs,
             "instantiations": [{k: r[k] for k in (
                 "plan", "launches", "max_abs_err", "ms", "plain_ms",
                 "bound_ms", "bound_by", "library_ms")} for r in rows]}
    return (tal.k1, tal.k1p), (tal.k2, tal.k2p), entry

def replay_contig(dev, windows, pairs, adaptive_k1) -> dict:
    """Every batch of the contig cell with the scheduler off and on, each
    kernel timed over all of them in this call (CUDA events; one launch a
    batch after a warm-up pass): K1 on the batches a session engine
    launches over the cell's windows (scheduler on: `adaptive_k1`, the
    batches, grid and occupancy the phase's depth-2 run captured, which
    are what such an engine launches), K2 on the batches an aligner makes
    of its overlap pairs, K3 (int32, split posture) on every chunk's
    chained calls. Launches here are not counted as a path's."""
    import numpy as np
    import torch

    from racon_tpu_torch.device import card_info
    from racon_tpu_torch.ops import poa_fused_kernels as fk
    from racon_tpu_torch.ops.align import BatchAligner
    from racon_tpu_torch.ops.poa_fused import FusedPOA
    from racon_tpu_torch.ops.poa_graph import DeviceGraphPOA
    from racon_tpu_torch.sched import BatchScheduler

    class Capture(DeviceGraphPOA):
        def run_bucket(self, nb, lb, *args):
            plan = (self.plan_for(nb, lb), args[0].dtype == torch.uint8)
            self.batches.append(((nb, lb), plan, [a.clone() for a in args]))
            return super().run_bucket(nb, lb, *args)

    def to_dev(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    out: dict = {}
    for label, adaptive in (("static", False), ("adaptive", True)):
        if adaptive:
            k1_batches, grid, occ = adaptive_k1
        else:
            eng = Capture(MATCH, MISMATCH, GAP, device=dev,
                          num_threads=os.cpu_count(),
                          scheduler=BatchScheduler(adaptive=adaptive))
            eng.batches = []
            eng.consensus(windows)
            torch.cuda.synchronize()
            k1_batches, grid = eng.batches, [list(b) for b in eng.buckets]
            occ = eng.sched.stats.snapshot()
            del eng
        k1 = {"launches": len(k1_batches),
              "ms": replay_ms(lambda b: sweep(b[2], b[1]), k1_batches),
              "grid": grid, "occupancy": occupancy_view(occ)}
        del k1_batches
        al = BatchAligner(device=dev,
                          scheduler=BatchScheduler(adaptive=adaptive))
        batches = []
        for edge, band, idx in al.chunks(pairs):
            args = al.operands(pairs, edge, band, idx)
            batches.append((band, (al.plan_for(edge, band),
                                   args[0].dtype == torch.uint8), args))
        k2 = {"launches": len(batches),
              "shapes": sorted({(int(b[2][0].shape[1]
                                     * (4 if b[1][1] else 1)), b[0])
                                for b in batches}),
              "ms": replay_ms(lambda b: align_k2(b[2], b[0], b[1]),
                              batches)}
        del batches
        fe = FusedPOA(MATCH, MISMATCH, GAP, device=dev, fused="0",
                      scheduler=BatchScheduler(adaptive=adaptive))
        fe.adapt(windows)
        order = fe._fused_order(windows)
        k3_ms, k3_calls = [], 0
        for s0 in range(0, len(order), fe.B):
            st, calls = fe._pack_chunk(windows, order[s0:s0 + fe.B])
            state = tuple(to_dev(st))
            ops = [(to_dev(o), done) for _, o, done in calls]
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for (seqs, lens, wts, *slicing), done in ops:
                lbase = torch.full((fe.B,), done, dtype=torch.int32,
                                   device=dev)
                state = fk.fused_layers(state, seqs, lens, wts,
                                        tuple(slicing), lbase, MATCH,
                                        MISMATCH, GAP)
            b.record()
            torch.cuda.synchronize()
            k3_ms.append(a.elapsed_time(b))
            k3_calls += len(calls)
        k3 = {"launches": k3_calls, "ms": sum(k3_ms), "chunk_ms": k3_ms,
              "depth_buckets": list(fe.depth_buckets)}
        out[label] = {"k1": k1, "k2": k2, "k3": k3}
        log(f"[chip_smoke] contig replay, scheduler {label}: K1 "
            f"{k1['ms']:.2f} ms over {k1['launches']} batches (grid "
            f"{k1['grid']}, occupancy {k1['occupancy']}); K2 "
            f"{k2['ms']:.2f} ms over {k2['launches']} batches at "
            f"{k2['shapes']}; K3 {k3['ms']:.2f} ms over "
            f"{k3['launches']} chained calls (depths "
            f"{k3['depth_buckets']}); card {card_info()}")
    return out


def adaptive_path(dev, paths, windows, report):
    """Phase 10: the occupancy scheduler (`--cuda-adaptive-buckets`) and
    the batch runner's lanes, every check against the earlier phases'
    bytes:

      1. the contig cell (session engine) with the scheduler on at
         pipeline depths 2 (this phase's main path, its launches counted)
         and 0, each FASTA equal to phase 5's; the derived ladders (the
         aligner's edges per static bucket, the session grid, the fused
         depth ladder), each engine's occupancy with the scheduler on and
         off, and K1's and K2's launches by shape, which must hold a
         derived shape;
      2. the fullest batch of each derived K1 shape and of each derived
         K2 (edge, band) held against the plain version (K2 on its first
         16 rows above edge 2048: the plain version's loop runs one step
         a wavefront); the static shapes are held in phases 2 and 3;
         then every batch of the cell replayed with the scheduler off
         and on, K1, K2 and K3 timed over all of them (replay_contig);
      3. the fused engine with the scheduler on at `--cuda-fused 0` and
         `1`, at 5/-4/-8 and 3/-5/-4, each FASTA equal to phase 9's; K3
         launched at a derived depth; one chained call at the smallest
         derived depth outside DEPTH_BUCKETS held against fused_raw on
         its chunk's first 8 rows;
      4. the fragment shard of phase 8 through the wrapper with the
         scheduler on, its FASTA equal to phase 8's;
      5. the contig main path over 2 lanes on one card (and over every
         visible card when there are more), for both engines: the FASTA
         equal to the 1-lane FASTA, the calls counted per lane, and each
         bucket's per-lane useful cells summing to its useful cells.

    Returns (K1 launches, by instantiation), (K2 ...) over the phase's
    runs, and K3's launches per run."""
    import io

    import numpy as np
    import torch

    from racon_tpu_torch import wrapper
    from racon_tpu_torch.device import card_info
    from racon_tpu_torch.ops import align_kernels, poa_fused_kernels as fk
    from racon_tpu_torch.ops import poa_kernels
    from racon_tpu_torch.ops.align import BatchAligner
    from racon_tpu_torch.ops.poa_fused import (DEPTH_BUCKETS, STATE,
                                               FusedPOA, fused_raw)
    from racon_tpu_torch.ops.poa_graph import BUCKETS
    from racon_tpu_torch.sched import BatchScheduler

    tal = Tally()
    out: dict = {"runs": tal.runs}
    tally = tal.add

    def same(got, key, what):
        if got != KEPT[key]:
            raise SystemExit(f"adaptive path: {what}: the FASTA differs "
                             f"from the {key} FASTA of the earlier phase")

    # ---- 1. the contig cell with the scheduler on (depth 0 against 2
    # is phase 5's check)
    with PathCapture(keep_all=True) as cap:
        _, polished, m2 = polish_once(paths, 2, adaptive_buckets=True)
    tally("contig depth 2", m2)
    same(fasta_of(polished), "contig", "contig cell, depth 2")
    log_depth("adaptive path (contig)", m2)
    derived = {}
    for key in m2["occupancy"]["aligner"]["buckets"]:
        edge, band = (int(x) for x in key.strip("()").split(","))
        static = min(e for e in BatchAligner.BUCKETS if e >= edge)
        derived.setdefault(f"{static}/{band}", []).append(edge)
    ladders = {"aligner_edges_by_static_bucket":
               {k: sorted(v) for k, v in sorted(derived.items())},
               "session_grid": m2["session_grid"]}
    off = report["main_path"]["occupancy"]
    log(f"[chip_smoke] adaptive path: contig FASTA byte-identical to phase "
        f"5's at depth 2; aligner edges per static bucket "
        f"{ladders['aligner_edges_by_static_bucket']}, session grid "
        f"{ladders['session_grid']} (static {[list(b) for b in BUCKETS]})")
    log(f"[chip_smoke] adaptive path: contig occupancy on "
        f"{occupancy_view(m2['occupancy'])}; off (phase 5) "
        f"{occupancy_view(off)}; card {card_info()}")
    log(f"[chip_smoke] adaptive path: K1 launches by shape "
        f"{m2['k1_launches_by_bucket']}; K2 {m2['k2_launches_by_edge_band']}")
    k1_shapes = sorted(cap.k1)
    if not any(tuple(s) not in BUCKETS for s in k1_shapes):
        raise SystemExit(f"adaptive path: K1 launched only at static "
                         f"shapes {k1_shapes}")
    al = BatchAligner(device=dev, scheduler=BatchScheduler(adaptive=True))
    fullest: dict = {}
    for pairs in cap.align_calls:
        for edge, band, idx in al.chunks(pairs):
            if len(idx) > fullest.get((edge, band), (0,))[0]:
                fullest[(edge, band)] = (len(idx), pairs, idx)
    if not any(e not in BatchAligner.BUCKETS for e, _ in fullest):
        raise SystemExit(f"adaptive path: K2 launched only at static "
                         f"edges {sorted(fullest)}")

    # ---- 2. the fullest batch of each derived shape, held (the static
    # shapes are phases 2 and 3's); the K2 batches' host plain versions
    # start first, beside each other and the K1 holds
    k2_todo = []
    for (edge, band), (n, pairs, idx) in sorted(fullest.items()):
        if edge in BatchAligner.BUCKETS:
            continue
        part = idx[:16] if edge > 2048 else idx
        a8, ap = k2_forms(al, pairs, edge, band, part)
        dtype = al.plan_for(edge, band)
        k2_todo.append((edge, band, n, part, a8, ap, dtype,
                        plain_k2_async(edge, band, a8, (dtype,))))
    rows = []
    for (nb, lb), (n, plan, args) in sorted(cap.k1.items()):
        if (nb, lb) in BUCKETS:
            continue
        held = hold_k1(args, nb, lb, f"the adaptive path's fullest "
                       f"{(nb, lb)} batch", widths=(plan[0],))
        r = held[plan]
        rows.append({"kernel": "K1", "shape": [nb, lb], "jobs": n,
                     "rows": args[0].shape[0], "plan": plan_name(*plan),
                     "max_abs_err": 0,
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]})
    for edge, band, n, part, a8, ap, dtype, started in k2_todo:
        held = hold_k2(edge, band, a8, ap, f"the adaptive path's fullest "
                       f"({edge}, {band}) batch", widths=(dtype,),
                       plain=started)
        for p, r in held.items():
            rows.append({"kernel": "K2", "shape": [edge, band], "pairs": n,
                         "held_rows": len(part), "plan": plan_name(*p),
                         "max_abs_err": r["err"], "touched": r["touched"],
                         "ms": r["ms"], "plain_ms": r["plain_ms"],
                         "plain_on": r["plain_on"],
                         "bound_ms": r["bound_ms"],
                         "bound_by": r["bound_by"]})
        del a8, ap
    for r in rows:
        log(f"[chip_smoke] adaptive path {r['kernel']} fullest batch at "
            f"derived {tuple(r['shape'])}, {r['plan']}: "
            + (f"{r['jobs']} jobs / {r['rows']} rows"
               if r["kernel"] == "K1" else
               f"{r['held_rows']} of {r['pairs']} pairs "
               f"({r['touched']} band-touched)")
            + f" identical (max |diff| 0); kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.1f} ms"
            + (f" on {r['plain_on']}" if "plain_on" in r else "")
            + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    out["held"] = rows
    out["ladders"] = ladders
    if len(cap.k1_batches) != m2["k1_launches"]:
        raise SystemExit(f"adaptive path: {len(cap.k1_batches)} K1 batches "
                         f"captured of {m2['k1_launches']} launched")
    out["replay"] = replay_contig(
        dev, windows, cap.align_calls[0],
        (cap.k1_batches, m2["session_grid"],
         {"session": m2["occupancy"]["session"]}))
    cap.k1_batches = []
    out["occupancy"] = {"contig_session": {
        "on": occupancy_view(m2["occupancy"]), "off": occupancy_view(off)}}

    # ---- 3. the fused engine with the scheduler on, split at int32 and
    # one launch a chunk at int16 (phase 9 holds the postures equal)
    fused_ladders = {}
    for scores, dtype, fused in (((5, -4, -8), "int32", "0"),
                                 ((3, -5, -4), "int16", "1")):
        _, polished, m = polish_once(paths, 2, scores=scores,
                                     cuda_engine="fused",
                                     cuda_fused=fused,
                                     adaptive_buckets=True)
        name = f"{dtype} fused={fused} adaptive"
        tally(name, m)
        same(fasta_of(polished), f"fused {dtype}", name)
        fused_ladders[dtype] = m["k3_depth_buckets"]
        post = "fused" if fused == "1" else "split"
        launched = m["k3_depths_launched"][post]
        if fused == "0" and not any(d not in DEPTH_BUCKETS
                                    for d in launched):
            raise SystemExit(f"adaptive path {name}: K3 launched only "
                             f"at static depths {launched}")
        static = report["fused_path"]["runs"][
            f"{dtype} fused={fused}"]["occupancy"]
        out["occupancy"][f"contig_fused_{dtype}_{fused}"] = {
            "on": occupancy_view(m["occupancy"]),
            "off": occupancy_view(static)}
        log(f"[chip_smoke] adaptive path {name}: FASTA byte-identical "
            f"to phase 9's; depth ladder {m['k3_depth_buckets']}, K3 "
            f"{m['k3_launches']} launches at {post} depths {launched}; "
            f"consensus {m['consensus_s']:.3f} s; occupancy on "
            f"{occupancy_view(m['occupancy'])}, off "
            f"{occupancy_view(static)}")
    ladders["fused_depths"] = fused_ladders

    # K3 at the smallest derived depth outside DEPTH_BUCKETS, one chained
    # call on its chunk's first 8 rows
    scores = (5, -4, -8)
    eng = FusedPOA(*scores, device=dev, fused="0",
                   scheduler=BatchScheduler(adaptive=True))
    eng.adapt(windows)
    order = eng._fused_order(windows)
    chunks = [order[s:s + eng.B] for s in range(0, len(order), eng.B)]
    best = None
    for ci, chunk in enumerate(chunks):
        done = 0
        for d in eng._chain_plan(max(len(windows[i]) - 1 for i in chunk)):
            if d not in DEPTH_BUCKETS and (best is None or d < best[2]):
                best = (ci, done, d)
            done += d
    if best is None:
        raise SystemExit(f"adaptive path: no derived depth outside "
                         f"{DEPTH_BUCKETS} in {eng.depth_buckets}")
    ci, at, d = best
    first = chunks[ci][:8]
    eng8 = FusedPOA(*scores, device=dev, batch_rows=len(first), fused="0")
    eng8.depth_buckets = eng.depth_buckets
    st, calls = eng8._pack_chunk(windows, first)
    plan = eng._chain_plan(max(len(windows[i]) - 1 for i in chunks[ci]))
    if [dd for dd, _, _ in calls] != plan:
        raise SystemExit(f"adaptive path: chunk {ci}'s first {len(first)} "
                         f"rows chain {[dd for dd, _, _ in calls]}, the "
                         f"chunk {plan}")

    def to_dev(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    state = tuple(to_dev(st))
    for dd, ops, done in calls:
        seqs, lens, wts, *slicing = to_dev(ops)
        lbase = torch.full((len(first),), done, dtype=torch.int32,
                           device=dev)
        if done < at:
            state = fk.fused_layers(state, seqs, lens, wts, tuple(slicing),
                                    lbase, *scores)
            continue
        k_state = tuple(t.clone() for t in state)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        k_state = fk.fused_layers(k_state, seqs, lens, wts, tuple(slicing),
                                  lbase, *scores)
        b.record()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_state = fused_raw(eng.N, eng.L, dd, eng.P, *scores)(
            *state, seqs, lens, wts, *slicing, lbase)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for nm, x, y in zip(STATE, k_state, p_state):
            if not torch.equal(x, y):
                raise SystemExit(f"adaptive path: K3 {nm} differs from the "
                                 f"plain version at derived depth {dd}")
        out["k3_held"] = {"depth": dd, "layer_base": done,
                          "rows": len(first), "chunk": ci,
                          "ladder": list(eng.depth_buckets),
                          "max_abs_err": 0, "ms": a.elapsed_time(b),
                          "plain_ms": plain_ms}
        log(f"[chip_smoke] adaptive path: K3 at derived depth {dd} (ladder "
            f"{list(eng.depth_buckets)}, chunk {ci}, layer base {done}) on "
            f"{len(first)} rows identical to the plain version on every "
            f"state array (max |diff| 0); kernel {a.elapsed_time(b):.2f} "
            f"ms, plain {plain_ms:.0f} ms")
        break
    else:
        raise SystemExit(f"adaptive path: no chained call of chunk {ci} at "
                         f"layer base {at}")

    # ---- 4. the fragment shard with the scheduler on
    buf = io.BytesIO()
    poa_kernels.reset_launches()
    align_kernels.reset_launches()
    t0 = time.perf_counter()
    pols = wrapper.run(*KEPT["fragment_paths"], split=800_000,
                       fragment_correction=True, threads=os.cpu_count(),
                       cuda_poa_batches=1, cuda_aligner_batches=1,
                       device="cuda", num_shards=4, shard_id=0, out=buf,
                       adaptive_buckets=True, autotune_table=COLD_TABLE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fm = {"k1_launches": poa_kernels.launches,
          "k2_launches": align_kernels.launches,
          "k1_launches_by_plan": by_plan(poa_kernels.launches_by_shape),
          "k2_launches_by_plan": by_plan(align_kernels.launches_by_shape),
          "wall_s": wall,
          "align_s": sum(p.phase_s["align"] for p in pols),
          "consensus_s": sum(p.phase_s["consensus"] for p in pols),
          "occupancy": merged_occupancy(pols)}
    tally("fragment", fm)
    if buf.getvalue() != KEPT["fragment"]:
        raise SystemExit("adaptive path: the fragment shard's FASTA "
                         "differs from phase 8's")
    frag_off = report["fragment_path"]["occupancy"]
    out["occupancy"]["fragment"] = {"on": occupancy_view(fm["occupancy"]),
                                    "off": occupancy_view(frag_off)}
    log(f"[chip_smoke] adaptive path: fragment shard FASTA byte-identical "
        f"to phase 8's; align {fm['align_s']:.3f} s, consensus "
        f"{fm['consensus_s']:.3f} s; occupancy on "
        f"{occupancy_view(fm['occupancy'])}, off {occupancy_view(frag_off)}")

    # ---- 5. lanes: 2 on one card, and every visible card
    lane_sets = [("2 lanes on cuda:0", [dev, dev])]
    if torch.cuda.device_count() > 1:
        lane_sets.append((f"{torch.cuda.device_count()} cards", None))
    out["lanes"] = {}
    for label, devices in lane_sets:
        for engine, scores, key, kw in (
                ("session", (MATCH, MISMATCH, GAP), "contig", {}),
                ("fused", (5, -4, -8), "fused int32",
                 {"cuda_engine": "fused", "cuda_fused": "1"})):
            _, polished, m = polish_once(paths, 2, scores=scores,
                                         devices=devices, **kw)
            name = f"{engine} {label}"
            tally(name, m)
            same(fasta_of(polished), key, name)
            if m["lanes"] < 2 or min(m["lane_calls"]) <= 0:
                raise SystemExit(f"adaptive path {name}: calls per lane "
                                 f"{m['lane_calls']}")
            for e, v in m["occupancy"].items():
                for bk, bv in v["buckets"].items():
                    if sum(bv["shard_useful"]) != bv["useful_cells"]:
                        raise SystemExit(
                            f"adaptive path {name}: {e} bucket {bk}: lanes' "
                            f"useful cells {bv['shard_useful']} do not sum "
                            f"to {bv['useful_cells']}")
            out["lanes"][name] = {
                "lane_calls": m["lane_calls"],
                "shard_useful": {e: v.get("shard_useful")
                                 for e, v in m["occupancy"].items()},
                "align_s": m["align_s"], "consensus_s": m["consensus_s"]}
            log(f"[chip_smoke] adaptive path {name}: FASTA byte-identical "
                f"to the 1-lane FASTA; calls per lane {m['lane_calls']}; "
                f"K1 {m['k1_launches']}, K2 {m['k2_launches']}"
                + (f", K3 {m['k3_launches']}" if "k3_launches" in m else "")
                + f" launches; useful cells per lane "
                f"{ {e: v.get('shard_useful') for e, v in m['occupancy'].items()} }"
                f"; align {m['align_s']:.3f} s, consensus "
                f"{m['consensus_s']:.3f} s")
    report["adaptive_path"] = out
    return tal.result()


def autotune_path(dev, paths, workdir, report):
    """Phase 11: the autotuner, the oracle and the auditor on the card
    (sched/autotune.py, ops/oracle.py, obs/audit.py) with phase 5's
    contig cell, every FASTA held to the earlier phases':

      1. `autotune.profile_all` at the contig cell's 5/-4/-8 and the CLI's
         default 3/-5/-4: K1 at both widths on each static session bucket,
         K2 at both widths on every (edge, band) the auto band rule can
         dispatch for edges 512 to 8192 (no pair of the chip cells lies
         beyond 8192), K3 split against one launch on each depth bucket
         at (2048, 640), each at the width the engine launches it; each
         entry printed (winner, identical, both candidates' mean and
         fastest / slowest ms, whether the gap was noise), and every
         entry must be identical; the table saved under build/;
      2. a second Autotuner on the same file profiles nothing;
      3. the contig cell with the table: the fused engine at `--cuda-fused
         auto` at both score sets (FASTA equal to phase 9's) and the
         session engine at `--cuda-dtype auto` (FASTA equal to phase 5's);
         the fused and split chunks per leading depth bucket, K3's
         launches and each run's table decisions printed; at least one
         decision must come from the table;
      4. WindowAuditor(rate=1.0) on the card over every window of the
         session run and of both fused runs: 0 mismatches; the
         shadow seconds against the run's consensus wall, and the windows
         sampled at rate 0.1;
      5. one base of one window's consensus flipped and the fused run's
         windows audited again: exactly 1 mismatch, the window repaired to
         the oracle bytes, a flight artifact with both streams, the table
         on disk demoted for the fused engine's implicated engines (read
         back by a fresh Autotuner); then one more fused run at `auto`
         launches K3 split only and writes the same FASTA.

    No plain version runs: the instantiations launched here are held
    against theirs in phases 2, 3, 9 and 10. Returns K1's and K2's
    launches over the phase (in all, by instantiation) and K3's by score
    dtype."""
    import shutil

    import torch

    from racon_tpu_torch.device import card_info
    from racon_tpu_torch.obs.audit import (WindowAuditor,
                                           window_sample_fraction)
    from racon_tpu_torch.ops import align_kernels, poa_fused_kernels as fk
    from racon_tpu_torch.ops import poa_kernels
    from racon_tpu_torch.sched import autotune

    card = card_info()
    out: dict = {"runs": {}, "audits": {}}
    tot: dict = {"k1": 0, "k2": 0, "k1p": {}, "k2p": {}, "k3": {}}

    def take():
        """Fold the launch counters into the phase's totals, then zero
        them (polish_once zeroes them at its start)."""
        tot["k1"] += poa_kernels.launches
        tot["k2"] += align_kernels.launches
        for src, dst in ((poa_kernels.launches_by_shape, tot["k1p"]),
                         (align_kernels.launches_by_shape, tot["k2p"])):
            for name, n in by_plan(src).items():
                dst[name] = dst.get(name, 0) + n
        for (_, _, _, dt, _), n in fk.launches_by_shape.items():
            tot["k3"][f"{dt} autotune"] = tot["k3"].get(
                f"{dt} autotune", 0) + n
        for mod in (poa_kernels, align_kernels, fk):
            mod.reset_launches()

    def decisions(pol) -> dict:
        return {f"{e} {k}{':' + d if d else ''}": n
                for (e, k, d), n in pol.autotune_decisions.items()}

    for mod in (poa_kernels, align_kernels, fk):
        mod.reset_launches()
    table = os.path.join(HERE, "build", "autotune_phase11.json")
    if os.path.exists(table):
        os.remove(table)
    autotune.reset_autotuner_cache()

    # ---- 1. profile every key the engines consult
    scores = ((MATCH, MISMATCH, GAP), (3, -5, -4))
    at = autotune.Autotuner(table)

    def show(engine, key, ent, fresh):
        log(f"[chip_smoke] autotune {engine} {key}: winner "
            f"{ent['kernel']}:{ent['dtype']} identical={ent['identical']} "
            f"noise={ent.get('noise', False)} fresh={fresh} "
            f"ms={ent['ms']} spread={ent['spread']}")

    t0 = time.perf_counter()
    done = autotune.profile_all(at, scores=scores, device=dev,
                                report=show)
    torch.cuda.synchronize()
    out["profile_s"] = time.perf_counter() - t0
    at.save()
    take()
    out["entries"] = {f"{e} {'x'.join(str(v) for v in k)}": ent
                      for e, k, ent, _ in done}
    bad = [k for k, ent in out["entries"].items() if not ent["identical"]]
    if bad or not all(f for *_, f in done):
        raise SystemExit(f"autotune path: entries not identical {bad}, or "
                         f"not profiled fresh")
    log(f"[chip_smoke] autotune: {len(done)} entries profiled in "
        f"{out['profile_s']:.2f} s (K1 {tot['k1']}, K2 {tot['k2']}, K3 "
        f"{sum(tot['k3'].values())} launches), every candidate identical to "
        f"the oracle; aligner edges above 8192 not profiled (no pair of "
        f"the chip cells lies beyond 8192); card {card}")

    # ---- 2. the warm table profiles nothing
    again = autotune.profile_all(autotune.Autotuner(table), scores=scores,
                                 device=dev)
    launched = (poa_kernels.launches, align_kernels.launches, fk.launches)
    if any(f for *_, f in again) or any(launched):
        raise SystemExit(f"autotune path: the warm table profiled again "
                         f"(launches {launched})")
    log(f"[chip_smoke] autotune: a second Autotuner on {table} profiled "
        f"nothing ({len(again)} entries, fresh=False, no launch)")

    # ---- 3. the contig cell with the table
    runs = {}
    from_table = 0
    for label, sc, kw, key in (
            ("fused int32", (5, -4, -8), {"cuda_engine": "fused"},
             "fused int32"),
            ("fused int16", (3, -5, -4), {"cuda_engine": "fused"},
             "fused int16"),
            ("session", (MATCH, MISMATCH, GAP), {}, "contig")):
        pol, polished, m = polish_once(paths, 2, scores=sc,
                                       keep_windows=True,
                                       autotune_table=table, **kw)
        take()
        if fasta_of(polished) != KEPT[key]:
            raise SystemExit(f"autotune path {label}: the FASTA with the "
                             f"table differs from the {key} FASTA")
        dec = decisions(pol)
        from_table += sum(n for d, n in dec.items()
                          if d.split()[1] != "none")
        row = {"decisions": dec, "consensus_s": m["consensus_s"],
               "k1_launches_by_plan": m["k1_launches_by_plan"],
               "k2_launches_by_plan": m["k2_launches_by_plan"]}
        if "k3_chunk_depths" in m:
            eng = pol.poa.engine
            per: dict = {}
            for d in m["k3_chunk_depths"]:
                plan = eng._chain_plan(d)
                post = "fused" if eng._fused_plan(plan) else "split"
                per.setdefault(plan[0], {"fused": 0, "split": 0})[post] += 1
            launched = m["k3_depths_launched"]
            if len(launched["fused"]) != sum(v["fused"]
                                             for v in per.values()):
                raise SystemExit(f"autotune path {label}: K3 launched "
                                 f"fused {launched['fused']}, the table "
                                 f"fuses {per}")
            row.update(chunks_by_leading_bucket=per,
                       k3_launches=m["k3_launches"],
                       k3_depths_launched=launched, k3_dtype=m["k3_dtype"])
            log(f"[chip_smoke] autotune path {label}: FASTA equal to the "
                f"{key} FASTA; chunks per leading depth bucket {per}; K3 "
                f"{m['k3_launches']} launches at {m['k3_dtype']} (fused "
                f"depths {launched['fused']}, split {launched['split']}); "
                f"consensus {m['consensus_s']:.3f} s; table decisions "
                f"{dec}")
        else:
            log(f"[chip_smoke] autotune path {label}: FASTA equal to the "
                f"{key} FASTA; K1 by instantiation "
                f"{m['k1_launches_by_plan']}, K2 {m['k2_launches_by_plan']};"
                f" consensus {m['consensus_s']:.3f} s; table decisions "
                f"{dec}")
        runs[label] = (pol, m)
        out["runs"][label] = row
    if not from_table:
        raise SystemExit("autotune path: no decision came from the table")

    # ---- 4. the audit of the session and both fused runs
    flight = os.path.join(HERE, "build", "audit_flight")
    shutil.rmtree(flight, ignore_errors=True)
    auditor = WindowAuditor(1.0, device=dev, flight_dir=flight)
    for label in ("session", "fused int32", "fused int16"):
        pol, m = runs[label]
        wins = pol.kept_windows
        t0 = time.perf_counter()
        n = auditor.audit_windows([(w, pol) for w in wins])
        torch.cuda.synchronize()
        shadow = time.perf_counter() - t0
        take()
        at10 = sum(window_sample_fraction(w) < 0.1 for w in wins)
        out["audits"][label] = {"windows": len(wins), "mismatches": n,
                                "shadow_s": shadow,
                                "consensus_s": m["consensus_s"],
                                "sampled_at_0.1": at10}
        if n:
            raise SystemExit(f"autotune path: the audit of the {label} run "
                             f"found {n} mismatches")
        log(f"[chip_smoke] audit {label}: 0 mismatches over {len(wins)} "
            f"windows at rate 1.0; shadow {shadow:.3f} s against the "
            f"production consensus wall {m['consensus_s']:.3f} s; "
            f"{at10} windows sampled at rate 0.1; card {card}")

    # ---- 5. a planted mismatch
    pol, _ = runs["fused int16"]
    wins = pol.kept_windows
    target = next(w for w in wins if w.polished and len(w.consensus) > 16)
    truth = target.consensus
    planted = bytearray(truth)
    planted[8] = ord("A") if planted[8] != ord("A") else ord("C")
    target.consensus = bytes(planted)
    n = auditor.audit_windows([(w, pol) for w in wins])
    take()
    snap = auditor.snapshot()
    demoted = snap["recent"][-1]["demoted"] if snap["recent"] else []
    dumps = sorted(os.listdir(flight)) if os.path.isdir(flight) else []
    doc = (json.load(open(os.path.join(flight, dumps[0])))["flight"]
           if len(dumps) == 1 else {})
    if (n != 1 or target.consensus != truth or snap["mismatches"] != 1
            or doc.get("oracle", "").encode("latin-1") != truth
            or doc.get("produced", "").encode("latin-1") != planted
            or not demoted):
        raise SystemExit(f"autotune path: the planted window: {n} "
                         f"mismatches, repaired "
                         f"{target.consensus == truth}, flight {dumps}, "
                         f"demoted {demoted}")
    fresh = autotune.Autotuner(table).table
    left = [k for k, ent in fresh.items()
            if k.split("|")[1] in ("fused_loop", "fused", "session")
            and (ent["dtype"] != "int32"
                 or ent["kernel"] not in ("split",
                                          autotune.plane(dev.type)))]
    if left or not all(fresh[k].get("demoted") for k in demoted):
        raise SystemExit(f"autotune path: entries not demoted on disk "
                         f"{left}")
    log(f"[chip_smoke] audit planted: 1 mismatch (window "
        f"{target.id}:{target.rank}), repaired to the oracle bytes; flight "
        f"artifact {dumps[0]} with both streams; {len(demoted)} entries "
        f"demoted on disk ({sorted(demoted)[:3]}...), read back by a fresh "
        f"Autotuner; audit counters {({k: snap[k] for k in ('windows', 'sampled', 'audited', 'clean', 'mismatches', 'repaired', 'demotions')})}"
        f", shadow {snap['shadow']}")
    auditor.close()
    pol, polished, m = polish_once(paths, 2, scores=(3, -5, -4),
                                   cuda_engine="fused", autotune_table=table)
    take()
    if (m["k3_depths_launched"]["fused"]
            or fasta_of(polished) != KEPT["fused int16"]):
        raise SystemExit(f"autotune path: after the demotion K3 launched "
                         f"fused {m['k3_depths_launched']['fused']}, or the "
                         f"FASTA moved")
    log(f"[chip_smoke] autotune path after the demotion: fused engine at "
        f"auto launched K3 split only ({m['k3_launches']} launches), FASTA "
        f"unchanged; table decisions {decisions(pol)}")
    out["after_demotion"] = {"k3_launches": m["k3_launches"],
                             "demoted": demoted}
    out["launches"] = {"k1": tot["k1"], "k2": tot["k2"], "k3": tot["k3"],
                       "k1_by_plan": tot["k1p"], "k2_by_plan": tot["k2p"]}
    report["autotune_path"] = out
    return (tot["k1"], tot["k1p"]), (tot["k2"], tot["k2p"]), tot["k3"]


def k3_by_dtype() -> dict:
    """K3's launches since the last reset, by score dtype."""
    from racon_tpu_torch.ops import poa_fused_kernels

    out: dict = {}
    for (_, _, _, dtype, _), n in poa_fused_kernels.launches_by_shape.items():
        out[dtype] = out.get(dtype, 0) + n
    return out


#: phase 12's window-range split (target coordinates, off the w grid)
#: and its fragment shard: the split size in bytes and the shard count
#: (shard 0 is run)
RANGE_SPLIT = 100_250
FRAGMENT_SHARD = (300_000, 16)


def hooks_path(dev, paths, truth, draft, reads, workdir, report):
    """Phase 12: the polisher's warm-reuse, range-shard and rounds hooks
    on the card, every check against the earlier phases' bytes:

      a. phase 5's depth-2 session polisher rebound to the same triple:
         the FASTA equal to phase 5's, and the run's aligner pairs,
         pipeline chunks and K1 / K2 launches equal to phase 5's run (the
         counters are per run);
      b. the same polisher rebound with `window_range` (0, 100250), then
         (100250, 10**9) (a split off the w grid): the segments
         concatenate to phase 5's contig, the LN / RC / XC tags re-derived
         from `segment_meta` give phase 5's name, and each shard aligns
         fewer pairs than the whole run (a read across the split is
         aligned in both);
      c. a fresh fused-engine polisher (`--cuda-fused 1`, 5/-4/-8): round
         1 equal to phase 9's int32 FASTA, `redraft` (the in-process
         re-map: its wall and rows printed), round 2 on the warm polisher
         with K3 launched, equal to a fresh fused polisher's round 2 on
         the draft and PAF redraft wrote; the distance to the truth after
         each round;
      d. phase 8's reads through the wrapper's kF shard 0 of 16 (split at
         300,000 bytes) with the fused engine at `--cuda-fused 0` and
         `1`: the FASTA byte-identical, K3 launched, the corrected reads'
         summed distance to their truth below the raw reads'.

    Returns (K1 launches, by instantiation), (K2 ...) over the phase's
    runs, and K3's launches per run."""
    import io

    import torch

    from racon_tpu_torch import wrapper
    from racon_tpu_torch.device import card_info
    from racon_tpu_torch.native import edit_distance
    from racon_tpu_torch.ops import align_kernels, poa_fused_kernels
    from racon_tpu_torch.ops import poa_kernels
    from racon_tpu_torch.synth import truth_segment

    tal = Tally()
    out: dict = {"runs": tal.runs}
    card = card_info()

    # ---- a. rebind: the same bytes, per-run counters
    pol = KEPT["contig_polisher"]
    base = KEPT["contig_numbers"]
    pol.rebind(*paths)
    _, polished, m = run_measured(pol)
    tal.add("rebind", m)
    if fasta_of(polished) != KEPT["contig"]:
        raise SystemExit("hooks path: the rebound polisher's FASTA differs "
                         "from phase 5's")
    keys = ("pairs", "k1_launches", "k2_launches")
    got = {k: m[k] for k in keys}
    got["chunks"] = m["pipeline_stages"]["chunks"]
    want = {k: base[k] for k in keys}
    want["chunks"] = base["pipeline_stages"]["chunks"]
    if got != want:
        raise SystemExit(f"hooks path: the rebound run's counters {got} "
                         f"are not phase 5's {want}")
    log(f"[chip_smoke] hooks path rebind: FASTA byte-identical to phase "
        f"5's; counters per run {got}; align {m['align_s']:.3f} s, "
        f"consensus {m['consensus_s']:.3f} s (phase 5: "
        f"{base['align_s']:.3f} / {base['consensus_s']:.3f} s); card {card}")

    # ---- b. window-range shards of the same polisher
    name, data = KEPT["contig"][0]
    segs, metas, shards = [], [], {}
    for lo, hi in ((0, RANGE_SPLIT), (RANGE_SPLIT, 10**9)):
        pol.rebind(*paths)
        pol.window_range = (lo, hi)
        _, polished, m = run_measured(pol)
        label = f"range [{lo}, {hi})"
        tal.add(label, m)
        segs.append(polished[0].data)
        metas.append(pol.segment_meta[polished[0].name])
        shards[label] = {"pairs": m["pairs"], "windows": m["windows"],
                         "align_s": m["align_s"],
                         "consensus_s": m["consensus_s"],
                         "k2_launches": m["k2_launches"]}
        if m["pairs"] >= base["pairs"]:
            raise SystemExit(f"hooks path {label}: {m['pairs']} pairs "
                             f"aligned, the whole run {base['pairs']}")
    pol.window_range = None
    joined = b"".join(segs)
    ratio = sum(x["polished"] for x in metas) / float(
        metas[0]["total_windows"])
    derived = (f"{name.split()[0]} LN:i:{len(joined)} "
               f"RC:i:{metas[0]['coverage']} XC:f:{ratio:.6f}")
    if joined != data or derived != name:
        raise SystemExit(f"hooks path: the range segments give {derived} "
                         f"({len(joined)} bases), phase 5 {name}")
    out["range"] = {"shards": shards, "segment_meta": metas}
    log(f"[chip_smoke] hooks path range shards: segments concatenate to "
        f"phase 5's contig, tags re-derived equal ({derived}); K2 pairs per "
        f"shard {[v['pairs'] for v in shards.values()]} against "
        f"{base['pairs']} whole; {shards}")

    # ---- c. rounds on the fused engine
    d_draft = edit_distance(draft, truth)
    fpol, polished, m = polish_once(paths, 2, scores=(5, -4, -8),
                                    cuda_engine="fused", cuda_fused="1")
    dt = m["k3_dtype"]
    tal.add(f"{dt} hooks round 1", m)
    if fasta_of(polished) != KEPT["fused int32"]:
        raise SystemExit("hooks path: round 1 of the fused engine differs "
                         "from phase 9's int32 FASTA")
    d1 = edit_distance(polished[0].data, truth)
    t0 = time.perf_counter()
    draft_path, paf_path = fpol.redraft(polished, workdir, "r1")
    remap_s = time.perf_counter() - t0
    with open(paf_path) as fh:
        rows = sum(1 for _ in fh)
    _, polished2, m2 = run_measured(fpol)
    tal.add(f"{dt} hooks round 2 warm", m2)
    _, fresh2, mf = polish_once((paths[0], paf_path, draft_path), 2,
                                scores=(5, -4, -8), cuda_engine="fused",
                                cuda_fused="1")
    tal.add(f"{dt} hooks round 2 fresh", mf)
    if fasta_of(polished2) != fasta_of(fresh2):
        raise SystemExit("hooks path: round 2 on the warm fused polisher "
                         "differs from a fresh polisher's")
    if m2["k3_launches"] <= 0:
        raise SystemExit("hooks path: K3 did not launch in round 2")
    KEPT["fused round 2"] = fasta_of(polished2)
    d2 = edit_distance(polished2[0].data, truth)
    out["rounds"] = {"remap_s": remap_s, "paf_rows": rows,
                     "distance": [d_draft, d1, d2],
                     "round2_k3_launches": m2["k3_launches"],
                     "consensus_s": [m["consensus_s"], m2["consensus_s"],
                                     mf["consensus_s"]],
                     "align_s": [m["align_s"], m2["align_s"],
                                 mf["align_s"]]}
    log(f"[chip_smoke] hooks path rounds (fused engine, {dt}): round 1 "
        f"equal to phase 9's; redraft {remap_s:.2f} s ({rows} PAF rows of "
        f"{len(reads)} reads); round 2 warm equal to a fresh polisher's, K3 "
        f"{m2['k3_launches']} launches; distance draft {d_draft} -> round "
        f"1 {d1} -> round 2 {d2}; consensus {m['consensus_s']:.3f} / "
        f"{m2['consensus_s']:.3f} / {mf['consensus_s']:.3f} s; card {card}")

    # ---- d. the fragment cell through the fused engine
    fasta = {}
    for fused in ("0", "1"):
        buf = io.BytesIO()
        poa_kernels.reset_launches()
        align_kernels.reset_launches()
        poa_fused_kernels.reset_launches()
        t0 = time.perf_counter()
        pols = wrapper.run(*KEPT["fragment_paths"], split=FRAGMENT_SHARD[0],
                           fragment_correction=True, threads=os.cpu_count(),
                           cuda_poa_batches=1, cuda_aligner_batches=1,
                           device="cuda", num_shards=FRAGMENT_SHARD[1],
                           shard_id=0,
                           out=buf, cuda_engine="fused", cuda_fused=fused,
                           autotune_table=COLD_TABLE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k3 = k3_by_dtype()
        fm = {"k1_launches": poa_kernels.launches,
              "k2_launches": align_kernels.launches,
              "k1_launches_by_plan": by_plan(poa_kernels.launches_by_shape),
              "k2_launches_by_plan": by_plan(align_kernels.launches_by_shape),
              "wall_s": wall, "targets": sum(p.n_targets for p in pols),
              "align_s": sum(p.phase_s["align"] for p in pols),
              "consensus_s": sum(p.phase_s["consensus"] for p in pols),
              "k3_by_dtype": k3}
        tal.add(f"fragment fused={fused}", fm)
        for dtype, n in k3.items():
            tal.k3[f"{dtype} hooks fragment fused={fused}"] = n
        if not k3:
            raise SystemExit(f"hooks path: K3 did not launch on the "
                             f"fragment shard at --cuda-fused {fused}")
        fasta[fused] = buf.getvalue()
    if fasta["0"] != fasta["1"]:
        raise SystemExit("hooks path: the fused fragment shard's FASTA "
                         "differs between --cuda-fused 0 and 1")
    lines = fasta["1"].split(b"\n")
    by_name = {r[0]: r for r in reads}
    raw = fixed = 0
    for head, seq in zip(lines[0::2], lines[1::2]):
        read = by_name[head[1:].split(b" ")[0].decode()[:-1]]
        seg = truth_segment(truth, read)
        raw += edit_distance(read[1], seg)
        fixed += edit_distance(seq, seg)
    if not fixed < raw:
        raise SystemExit(f"hooks path: fused fragment distance {fixed} not "
                         f"below the raw reads' {raw}")
    out["fragment"] = {"written": len(lines) // 2, "raw_distance": raw,
                       "corrected_distance": fixed}
    log(f"[chip_smoke] hooks path fragment (fused engine, shard 0 of "
        f"{FRAGMENT_SHARD[1]}): FASTA byte-identical at --cuda-fused 0 and 1; {len(lines) // 2} "
        f"reads written, distance {raw} -> {fixed}; K3 "
        f"{[tal.runs[f'fragment fused={f}']['k3_by_dtype'] for f in '01']} "
        f"launches; walls {[round(tal.runs[f'fragment fused={f}']['wall_s'], 3) for f in '01']} s")
    report["hooks_path"] = out
    return tal.result()


def served_numbers(r, wall: float) -> dict:
    """One served job's numbers from its response and client wall."""
    serve = r.serve
    batch = serve["batch"]
    return {"queue_wait_s": serve["queue_wait_s"], "exec_s": serve["exec_s"],
            "wall_s": wall, "align_s": serve["phase_s"].get("align"),
            "consensus_s": serve["phase_s"].get("consensus"),
            "iterations": batch["iterations"],
            "shared_iterations": batch["shared_iterations"],
            "host_s": batch["host_s"], "device_s": batch["device_s"],
            "k1_launches": batch["k1_launches"],
            "k2_launches": batch["k2_launches"],
            "k3_launches": batch["k3_launches"]}


def serve_path(dev, paths, workdir, report):
    """Phase 13: one warm PolishServer on the card (unix socket, 2
    workers, `cuda_poa_batches=1`, `cuda_aligner_batches=1`, pipeline
    depth 2, scores 5/-4/-8, COLD_TABLE, warm-up on), driven through its
    client, every check against earlier phases' bytes:

      a. two contig-cell jobs (one buffered, one streamed) pooled behind
         the held feeder: both FASTA equal to phase 5's, the streamed
         parts concatenating to it, shared iterations, a two-job
         iteration, K1 and K2 launched;
      b. a fused-engine job (`--cuda-fused 1`) pooled beside a session
         job: its FASTA equal to phase 9's int32 FASTA, K3 launched, and
         no iteration of the two keys shared (the batcher's counters);
      c. a job on the warm-up dataset with the fault plan
         `device:chunk=0:raise` fails with JobFailed (DeviceError) while
         a concurrent contig-cell job gives phase 5's bytes; then one more
         clean contig-cell job, alone, whose wall is set against phase
         5's one-shot wall;
      d. with the feeder held and both workers busy (two warm-up-dataset
         jobs), a queued job is cancelled (JobCancelled); then
         `shutdown` drains: drain returns True and every admitted job is
         answered;
      e. the fullest K1 batch of part a's shared iterations held against
         its plain version (hold_k1) and timed.

    The launch counters are zeroed before the server starts and read
    after the drain (part e's launches excluded). Returns (K1 launches,
    by instantiation), (K2 ...) and K3's launches by dtype."""
    import threading

    from racon_tpu_torch.device import card_info
    from racon_tpu_torch.ops import align_kernels, poa_fused_kernels
    from racon_tpu_torch.ops import poa_kernels
    from racon_tpu_torch.serve import (JobCancelled, JobFailed,
                                       PolishClient, PolishServer,
                                       make_synth_dataset)

    card = card_info()
    out: dict = {"jobs": {}}
    contig = b"".join(b">" + n.encode() + b"\n" + d + b"\n"
                      for n, d in KEPT["contig"])
    fused = b"".join(b">" + n.encode() + b"\n" + d + b"\n"
                     for n, d in KEPT["fused int32"])
    small_dir = os.path.join(workdir, "serve_small")
    os.makedirs(small_dir)
    small = make_synth_dataset(small_dir)
    poa_kernels.reset_launches()
    align_kernels.reset_launches()
    poa_fused_kernels.reset_launches()
    t0 = time.perf_counter()
    srv = PolishServer(socket_path=os.path.join(workdir, "serve.sock"),
                       workers=2, device="cuda", match=MATCH,
                       mismatch=MISMATCH, gap=GAP,
                       job_threads=os.cpu_count(), cuda_poa_batches=1,
                       cuda_aligner_batches=1, pipeline_depth=2,
                       autotune_table=COLD_TABLE).start()
    out["start_s"] = time.perf_counter() - t0
    out["warm"] = srv._warm
    log(f"[chip_smoke] serve path: server up in {out['start_s']:.3f} s, "
        f"warm-up {srv._warm['warmup_s']:.3f} s ({srv._warm['compiles']} "
        f"first dispatches); card {card}")
    cl = PolishClient(socket_path=srv.config.socket_path, timeout=900)

    def wait_for(cond, what):
        deadline = time.monotonic() + 600
        while not cond():
            if time.monotonic() > deadline:
                raise SystemExit(f"serve path: {what}")
            time.sleep(0.01)

    def submit(name, results, paths_=paths, **kw):
        t = time.perf_counter()
        try:
            results[name] = (cl.submit(*paths_, **kw),
                             time.perf_counter() - t)
        except Exception as exc:  # noqa: BLE001 — checked by the caller
            results[name] = (exc, time.perf_counter() - t)

    def pooled(jobs: dict, n_tickets: int) -> dict:
        """Submit `jobs` (name -> submit kwargs) behind the held feeder,
        release it once `n_tickets` jobs pooled, return the results."""
        results: dict = {}
        srv.batcher.hold()
        threads = [threading.Thread(target=submit, args=(k, results),
                                    kwargs=kw) for k, kw in jobs.items()]
        for t in threads:
            t.start()
        wait_for(lambda: sum(map(len, srv.batcher._job_tickets.values()))
                 >= n_tickets, "the jobs never pooled")
        srv.batcher.release()
        for t in threads:
            t.join(900)
        return results

    def check(results, name, want, ref):
        """Job `name`'s FASTA must equal `want`, phase `ref`'s."""
        r, wall = results[name]
        if isinstance(r, Exception):
            raise SystemExit(f"serve path: job {name} failed: {r}")
        if r.fasta != want:
            raise SystemExit(f"serve path: job {name}'s FASTA differs "
                             f"from phase {ref}'s")
        nums = served_numbers(r, wall)
        out["jobs"][name] = nums
        log(f"[chip_smoke] serve path {name} job: queue wait "
            f"{nums['queue_wait_s']:.3f} s, align {nums['align_s']:.3f} s, "
            f"consensus {nums['consensus_s']:.3f} s, end to end "
            f"{nums['wall_s']:.3f} s; {nums['iterations']} iterations "
            f"({nums['shared_iterations']} shared), host_s "
            f"{nums['host_s']:.3f}; launches K1 {nums['k1_launches']} / K2 "
            f"{nums['k2_launches']} / K3 {nums['k3_launches']}")
        return r, nums

    # ---- a. two contig-cell jobs in shared iterations
    parts: list = []
    with PathCapture() as cap:
        res = pooled({"buffered": {}, "streamed": {"on_part":
                                                   parts.append}}, 2)
    for name in ("buffered", "streamed"):
        r, nums = check(res, name, contig, 5)
        if nums["shared_iterations"] < 1:
            raise SystemExit(f"serve path a: job {name} shared no "
                             "iteration")
    if b"".join(p["fasta"].encode("latin-1") for p in parts) != contig:
        raise SystemExit("serve path a: the streamed parts do not "
                         "concatenate to phase 5's FASTA")
    counters = dict(srv.batcher.counters)
    if counters["max_jobs_in_iteration"] != 2:
        raise SystemExit(f"serve path a: no two-job iteration "
                         f"({counters})")
    if poa_kernels.launches <= 0 or align_kernels.launches <= 0:
        raise SystemExit(f"serve path a: K1 {poa_kernels.launches} / K2 "
                         f"{align_kernels.launches} launches")
    out["a_counters"] = counters
    log(f"[chip_smoke] serve path a: both jobs equal to phase 5's, the "
        f"streamed {len(parts)} part(s) too; batcher {counters}")

    # ---- b. a fused-engine job beside a session job
    before = dict(srv.batcher.counters)
    res = pooled({"fused": {"options": {"cuda_engine": "fused",
                                        "cuda_fused": "1"}},
                  "session": {}}, 2)
    rf, nf = check(res, "fused", fused, 9)
    check(res, "session", contig, 5)
    after = dict(srv.batcher.counters)
    shared = after["shared_iterations"] - before["shared_iterations"]
    if nf["k3_launches"] <= 0 or shared or nf["shared_iterations"]:
        raise SystemExit(f"serve path b: K3 {nf['k3_launches']} launches, "
                         f"{shared} shared iterations")
    log(f"[chip_smoke] serve path b: the fused job equals phase 9's int32 "
        f"FASTA with K3 launched; {after['iterations'] - before['iterations']}"
        f" iterations, none shared by the two keys")

    # ---- c. a poisoned job beside a clean one, then a clean one alone
    res: dict = {}
    threads = [threading.Thread(target=submit, args=("clean", res)),
               threading.Thread(target=submit, args=("poisoned", res),
                                kwargs={"paths_": small,
                                        "fault_plan":
                                            "device:chunk=0:raise"})]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    bad = res["poisoned"][0]
    if not isinstance(bad, JobFailed) or bad.error_type != "DeviceError":
        raise SystemExit(f"serve path c: the poisoned job gave {bad!r}")
    check(res, "clean", contig, 5)
    res = {}
    submit("alone", res)
    _, alone = check(res, "alone", contig, 5)
    base = KEPT["contig_numbers"]
    one_shot = base["initialize_s"] + base["polish_s"]
    out["served_vs_one_shot_s"] = [alone["wall_s"], one_shot]
    log(f"[chip_smoke] serve path c: the poisoned job failed typed "
        f"({bad.error_type}), the concurrent and the next clean job equal "
        f"phase 5's; served contig job {alone['wall_s']:.3f} s end to end "
        f"against phase 5's one-shot {one_shot:.3f} s (initialize + "
        f"polish); card {card}")

    # ---- d. cancel a queued job, then shut down
    res = {}
    srv.batcher.hold()
    busy = [threading.Thread(target=submit, args=(f"busy{i}", res),
                             kwargs={"paths_": small}) for i in range(2)]
    for t in busy:
        t.start()
    wait_for(lambda: sum(map(len, srv.batcher._job_tickets.values())) == 2,
             "the two busy jobs never pooled")
    queued = threading.Thread(target=submit, args=("queued", res),
                              kwargs={"trace_id": "queued"})
    queued.start()
    wait_for(lambda: len(srv.queue) == 1, "the third job never queued")
    body = cl.cancel(trace_id="queued")
    queued.join(900)
    if body.get("cancelled") != "queued" or not isinstance(
            res["queued"][0], JobCancelled):
        raise SystemExit(f"serve path d: cancel gave {body}, the job "
                         f"{res['queued'][0]!r}")
    srv.batcher.release()
    cl.shutdown()
    clean = srv.drain(timeout=600)
    for t in busy:
        t.join(900)
    q = srv.queue.counters
    answered = q["completed"] + q["failed"] + q["expired"]
    if (not clean or answered != q["admitted"]
            or any(isinstance(res[f"busy{i}"][0], Exception)
                   for i in range(2))):
        raise SystemExit(f"serve path d: drain {clean}, queue {q}")
    out["queue"] = dict(q)
    out["batcher"] = srv.batcher.snapshot()
    launches = {"k1": poa_kernels.launches, "k2": align_kernels.launches,
                "k3": poa_fused_kernels.launches}
    k1p = by_plan(poa_kernels.launches_by_shape)
    k2p = by_plan(align_kernels.launches_by_shape)
    k3 = {f"{dt} serve": n for dt, n in k3_by_dtype().items()}
    out["launches"] = launches
    log(f"[chip_smoke] serve path d: queued job cancelled; drained "
        f"cleanly, {q['admitted']} admitted = {q['completed']} completed "
        f"+ {q['failed']} failed + {q['expired']} cancelled in queue; "
        f"launches over the phase {launches}")

    # ---- e. the fullest K1 batch of part a's shared iterations
    (nb, lb), (n, plan, args) = max(cap.k1.items(),
                                    key=lambda kv: kv[1][0])
    held = hold_k1(args, nb, lb, f"the serve path's fullest {(nb, lb)} "
                   "batch", widths=(plan[0],))[plan]
    out["k1_fullest"] = {"shape": [nb, lb], "jobs": n,
                         "plan": plan_name(*plan), **held}
    log(f"[chip_smoke] serve path e: the fullest K1 batch of the shared "
        f"iterations, {(nb, lb)} {plan_name(*plan)} with {n} jobs, "
        f"identical to the plain version; kernel {held['ms']:.3f} ms, "
        f"plain {held['plain_ms']:.1f} ms, bound {held['bound_ms']:.4f} ms "
        f"({held['bound_by']}); card {card}")
    report["serve_path"] = out
    return (launches["k1"], k1p), (launches["k2"], k2p), k3



class K3Capture:
    """For one job, patches K3's wrapper (ops/poa_fused_kernels.
    fused_layers, which the fused engine looks up at each pass): every
    call's inputs are copied on the device, on the launching stream and
    before the launch (the kernel updates its state in place), with the
    call's scores and posture, then the call goes through, so every
    launch is the job's own and is counted where it launches."""

    def __init__(self):
        #: (state, seqs, lens, wts, slicing, lbase, scores, kwargs)
        self.calls: list = []

    def __enter__(self):
        from racon_tpu_torch.ops import poa_fused_kernels as fk

        self._saved = fk.fused_layers
        launch = self._saved
        cap = self

        def fused_layers(state, seqs, lens, wts, slicing, lbase, match,
                         mismatch, gap, banded_only=False,
                         score_dtype="int32", scratch=None):
            cap.calls.append((
                tuple(t.clone() for t in state), seqs.clone(),
                lens.clone(), wts.clone(),
                tuple(t.clone() for t in slicing), lbase.clone(),
                (match, mismatch, gap),
                {"banded_only": banded_only, "score_dtype": score_dtype}))
            return launch(state, seqs, lens, wts, slicing, lbase, match,
                          mismatch, gap, banded_only=banded_only,
                          score_dtype=score_dtype, scratch=scratch)

        fk.fused_layers = fused_layers
        return self

    def __exit__(self, *exc):
        from racon_tpu_torch.ops import poa_fused_kernels as fk

        fk.fused_layers = self._saved
        return False

    def fullest(self):
        """The call with the most real rows (a row with a layer), and
        among those the one with the fewest layers, the cheapest to hold
        on the plain version; with its real rows."""
        import torch

        torch.cuda.synchronize()
        rows = [int((c[2] > 0).any(1).sum()) for c in self.calls]
        k = min(range(len(rows)),
                key=lambda i: (-rows[i], self.calls[i][1].shape[1]))
        return self.calls[k], rows[k]


def cut_layers(ops, d: int) -> tuple:
    """K3 layer inputs cut to their first `d` layers: every [B, D, ...]
    tensor sliced on its layer axis, the [B] ones (a fused launch's
    backbone lengths and offsets) kept. With the same state they make a
    K3 call at depth `d`, which the plain version runs in about d / D of
    the whole call's time (it loops over the layers)."""
    return tuple(t[:, :d].contiguous() if t.dim() >= 2 else t for t in ops)


def first_layers(call, d: int):
    """A captured K3 call cut to its first `d` layers (cut_layers)."""
    state, seqs, lens, wts, slicing, lbase, scores, kw = call
    seqs, lens, wts = cut_layers((seqs, lens, wts), d)
    return (state, seqs, lens, wts, cut_layers(slicing, d), lbase, scores,
            kw)


def hold_k3_call(call, what: str) -> dict:
    """One captured K3 call against its plain version (fused_raw at the
    call's shape, on the same tensors): all 11 state arrays must be
    identical. Returns the kernel's ms (CUDA events around each of 2
    launches on fresh copies of the state, the mean), the plain version's
    host-clocked ms, the max |diff| and the bound (fused_bound, layer by
    layer; a fused launch's slices derived per layer as the kernel and
    the plain version derive them)."""
    import torch

    from racon_tpu_torch.ops import poa_fused_kernels as fk
    from racon_tpu_torch.ops.poa_fused import STATE, fused_raw, slice_layer

    state, seqs, lens, wts, slicing, lbase, scores, kw = call
    B, N, P = state[1].shape
    _, D, L = seqs.shape
    sliced = len(slicing) == 4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fused_raw(N, L, D, P, *scores, device_slice=sliced, **kw)(
        *state, seqs, lens, wts, *slicing, lbase)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = fk.fused_layers(tuple(t.clone() for t in state), seqs, lens, wts,
                          slicing, lbase, *scores, **kw)
    err = 0
    for nm, x, y in zip(STATE, got, want):
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
        if not torch.equal(x, y):
            raise SystemExit(f"K3 {kw['score_dtype']}: {nm} differs from "
                             f"the plain version on {what}")
    ms = []
    for _ in range(2):
        st = tuple(t.clone() for t in state)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fk.fused_layers(st, seqs, lens, wts, slicing, lbase, *scores, **kw)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    if sliced:
        per = [slice_layer(slicing[0][:, d], slicing[1][:, d],
                           lens[:, d].to(torch.int32), slicing[2],
                           slicing[3]) for d in range(D)]
        ranges = tuple(torch.stack([p[i] for p in per], 1).contiguous()
                       for i in range(3))
    else:
        ranges = slicing
    bms, by = fused_bound(state, (seqs, lens, wts) + tuple(ranges),
                          int(lbase[0]), scores, kw["score_dtype"])
    return {"dtype": kw["score_dtype"], "layers": D, "rows": B,
            "fused_launch": sliced, "max_abs_err": err,
            "ms": sum(ms) / len(ms), "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by}


def serve_kinds_path(dev, paths, truth, reads, workdir, report):
    """Phase 14: what a served job can ask for, on one PolishServer on the
    card (unix socket, 2 workers, `cuda_poa_batches=1`,
    `cuda_aligner_batches=1`, pipeline depth 2, scores 5/-4/-8,
    COLD_TABLE, warm-up on, the window cache armed, preemption armed,
    `frag_group=16`), driven through its client, every check against
    bytes an earlier phase kept:

      a. a rounds job on the contig cell (`rounds=2`, the fused engine at
         `--cuda-fused 1`): its FASTA equal to phase 12's round 2, two
         entries in its `rounds` block, K2 launched in both rounds and K3
         launched; every K3 call it made copied (K3Capture);
      b. the same job again: the same FASTA, round 1's cache answering
         every one of its windows, fewer K1 and K3 launches than a; the
         cache's entries and bytes;
      c. two range shards of the contig cell at phase 12's split, at once:
         the streamed raw segments concatenate to phase 5's contig, the
         name re-derived from their `seg` accounting equals phase 5's,
         and each shard aligns fewer pairs than the whole job;
      d. a fragment job (`mode: "fragment"`) on phase 8's reads and
         all-vs-all overlaps, `frag_lo` / `frag_hi` the first 1/16 of the
         targets: groups of at most 16 reads whose `frag` ranges tile the
         slice, equal to a one-shot kF polisher with the same
         `target_range` at the same posture (run in this phase, before
         the server starts), K1 and K2 launched, the corrected reads
         closer to their truth than the raw reads;
      e. admit-time ingest: a contig-cell job with `ingest` gives phase
         5's bytes; a job whose reads file (phase 5's, cut inside a
         record's header) does not parse fails typed `rejected-ingest`;
         the server then serves the warm-up dataset;
      f. preemption: with the feeder held, a priority-0 contig-cell job
         (tenant `bulk`) and a priority-1 warm-up-dataset job (`side`)
         pooled on both workers, a priority-5 warm-up-dataset job
         (`gold`) parks the contig job's windows; after the release the
         `qos` counters show 1 preemption and 1 resume, the contig job
         gives phase 5's bytes, the other two part e's, and both
         `bulk` and `gold` have device seconds. These three run at
         pipeline depth 0, an engine key no earlier part used, so no
         cached window answers them and their windows pool behind the
         held feeder (the depth changes no byte, phase 5);
      then `shutdown` drains cleanly; after it, the fullest K3 call of
      part a (the most real rows, then the fewest layers), cut to its
      first DEPTH_BUCKETS[0] layers, is held against its plain version
      and timed against its bound.

    The launch counters are zeroed once the one-shot of part d is done,
    before the server starts, and read after the drain. Returns (K1
    launches, by instantiation), (K2 ...) and K3's launches by dtype."""
    import gzip
    import threading

    import torch

    from racon_tpu_torch.core.polisher import PolisherType, create_polisher
    from racon_tpu_torch.device import card_info
    from racon_tpu_torch.native import edit_distance
    from racon_tpu_torch.ops import align_kernels, poa_fused_kernels
    from racon_tpu_torch.ops import poa_kernels
    from racon_tpu_torch.ops.poa_fused import DEPTH_BUCKETS
    from racon_tpu_torch.serve import (PolishClient, PolishServer,
                                       ServeError, make_synth_dataset)
    from racon_tpu_torch.synth import truth_segment

    card = card_info()
    out: dict = {"jobs": {}}

    def as_fasta(pairs) -> bytes:
        return b"".join(b">" + n.encode() + b"\n" + d + b"\n"
                        for n, d in pairs)

    contig = as_fasta(KEPT["contig"])
    round2 = as_fasta(KEPT["fused round 2"])
    base = KEPT["contig_numbers"]
    small_dir = os.path.join(workdir, "serve_kinds_small")
    os.makedirs(small_dir)
    small = make_synth_dataset(small_dir)
    with gzip.open(paths[0], "rb") as fh:
        body = fh.read()
    cut_reads = os.path.join(workdir, "serve_kinds_cut_reads.fasta")
    with open(cut_reads, "wb") as fh:
        fh.write(body[:body.index(b"\n>", len(body) // 2) + 4])
    del body

    # ---- d's one-shot: a kF polisher on the same target slice
    fpaths = KEPT["fragment_paths"]
    frag_hi = -(-len(reads) // 16)
    t0 = time.perf_counter()
    fpol = create_polisher(*fpaths, PolisherType.kF, 500, 10.0, 0.3, True,
                           MATCH, MISMATCH, GAP, num_threads=os.cpu_count(),
                           cuda_poa_batches=1, cuda_banded_alignment=False,
                           cuda_aligner_batches=1, device="cuda",
                           pipeline_depth=2, autotune_table=COLD_TABLE)
    fpol.target_range = (0, frag_hi)
    fpol.initialize()
    frag_want = as_fasta(fasta_of(fpol.polish()))
    out["fragment_one_shot_s"] = time.perf_counter() - t0
    del fpol

    poa_kernels.reset_launches()
    align_kernels.reset_launches()
    poa_fused_kernels.reset_launches()
    t0 = time.perf_counter()
    srv = PolishServer(socket_path=os.path.join(workdir, "kinds.sock"),
                       workers=2, device="cuda", match=MATCH,
                       mismatch=MISMATCH, gap=GAP,
                       job_threads=os.cpu_count(), cuda_poa_batches=1,
                       cuda_aligner_batches=1, pipeline_depth=2,
                       autotune_table=COLD_TABLE, wincache=True,
                       preempt=True, frag_group=16).start()
    out["start_s"] = time.perf_counter() - t0
    log(f"[chip_smoke] serve kinds path: server up in {out['start_s']:.3f} "
        f"s (window cache and preemption armed, fragment groups of 16); "
        f"the one-shot kF slice [0, {frag_hi}) took "
        f"{out['fragment_one_shot_s']:.3f} s; card {card}")
    cl = PolishClient(socket_path=srv.config.socket_path, timeout=900)

    def wait_for(cond, what):
        deadline = time.monotonic() + 600
        while not cond():
            if time.monotonic() > deadline:
                raise SystemExit(f"serve kinds path: {what}")
            time.sleep(0.01)

    def submit(name, results, paths_=paths, **kw):
        t = time.perf_counter()
        try:
            results[name] = (cl.submit(*paths_, **kw),
                             time.perf_counter() - t)
        except Exception as exc:  # noqa: BLE001 — checked by the caller
            results[name] = (exc, time.perf_counter() - t)

    def check(results, name, want, ref):
        r, wall = results[name]
        if isinstance(r, Exception):
            raise SystemExit(f"serve kinds path: job {name} failed: {r!r}")
        if r.fasta != want:
            raise SystemExit(f"serve kinds path: job {name}'s FASTA "
                             f"differs from {ref}'s")
        nums = served_numbers(r, wall)
        if r.rounds:
            nums["rounds"] = r.rounds
        out["jobs"][name] = nums
        log(f"[chip_smoke] serve kinds path {name} job: queue wait "
            f"{nums['queue_wait_s']:.3f} s, end to end {nums['wall_s']:.3f} "
            f"s; {nums['iterations']} iterations (last pass), launches K1 "
            f"{nums['k1_launches']} / K2 {nums['k2_launches']} / K3 "
            f"{nums['k3_launches']}")
        return r, nums

    # ---- a. a fused rounds job
    fused = {"cuda_engine": "fused", "cuda_fused": "1"}
    res: dict = {}
    with K3Capture() as k3cap:
        submit("rounds", res, options=fused, rounds=2)
    ra, na = check(res, "rounds", round2, "phase 12's round 2")
    per = ra.rounds["per_round"]
    if (len(per) != 2 or any(p["k2_launches"] <= 0 for p in per)
            or na["k3_launches"] <= 0):
        raise SystemExit(f"serve kinds path a: rounds block {ra.rounds}, "
                         f"K3 {na['k3_launches']} launches")
    log(f"[chip_smoke] serve kinds path a: the fused rounds job equals "
        f"phase 12's round 2; per round "
        + "; ".join(f"r{p['round']} {p['wall_s']:.3f} s, {p['windows']} "
                    f"windows, cache {p['cache']}, K1 {p['k1_launches']} / "
                    f"K2 {p['k2_launches']} / K3 {p['k3_launches']}"
                    for p in per) + f"; {len(k3cap.calls)} K3 calls copied")

    # ---- b. the same job again, from the window cache
    res = {}
    submit("rounds again", res, options=fused, rounds=2)
    rb, nb = check(res, "rounds again", round2, "phase 12's round 2")
    first = rb.rounds["per_round"][0]
    wc = srv.batcher.snapshot()["wincache"]
    if (first["cache"] != {"hits": first["windows"], "misses": 0}
            or first["windows"] != base["windows"]
            or any(0 < na[k] <= nb[k] for k in ("k1_launches",
                                                  "k3_launches"))
            or nb["k1_launches"] + nb["k3_launches"]
            >= na["k1_launches"] + na["k3_launches"]
            or wc["entries"] <= 0 or wc["bytes"] <= 0):
        raise SystemExit(f"serve kinds path b: round 1 {first}, launches "
                         f"K1 {nb['k1_launches']} / K3 {nb['k3_launches']}"
                         f" against a's {na['k1_launches']} / "
                         f"{na['k3_launches']}, cache {wc}")
    out["wincache"] = wc
    log(f"[chip_smoke] serve kinds path b: the same bytes, round 1's cache "
        f"{first['cache']['hits']} hits of {first['windows']} windows, "
        f"launches K1 {nb['k1_launches']} / K3 {nb['k3_launches']} against "
        f"{na['k1_launches']} / {na['k3_launches']}; cache {wc['entries']} "
        f"entries, {wc['bytes']} bytes, hit rate {wc['hit_rate']:.3f}")

    # ---- c. two range shards at once
    name, data = KEPT["contig"][0]
    shard_res: dict = {}

    def shard(lo, hi):
        frames: list = []
        t = time.perf_counter()
        try:
            resp = cl.request({"type": "submit", "sequences": paths[0],
                               "overlaps": paths[1], "target": paths[2],
                               "range_lo": lo, "range_hi": hi,
                               "stream": True}, on_part=frames.append)
        except Exception as exc:  # noqa: BLE001 — checked below
            resp = exc
        shard_res[(lo, hi)] = (resp, frames, time.perf_counter() - t)

    splits = ((0, RANGE_SPLIT), (RANGE_SPLIT, 10**9))
    threads = [threading.Thread(target=shard, args=sp) for sp in splits]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    segs, metas, shards = [], [], {}
    for sp in splits:
        resp, frames, wall = shard_res[sp]
        if isinstance(resp, Exception) or len(frames) != 1:
            raise SystemExit(f"serve kinds path c {sp}: {resp!r}, "
                             f"{len(frames)} frames")
        pairs = resp["metrics"]["aligner"]["pairs"]
        if pairs >= base["pairs"]:
            raise SystemExit(f"serve kinds path c {sp}: {pairs} pairs "
                             f"aligned, the whole job {base['pairs']}")
        segs.append(frames[0]["fasta"].encode("latin-1"))
        metas.append(frames[0]["seg"])
        shards[f"[{sp[0]}, {sp[1]})"] = {
            "pairs": pairs, "wall_s": wall,
            "k1_launches": resp["serve"]["batch"]["k1_launches"],
            "k2_launches": resp["serve"]["batch"]["k2_launches"]}
    joined = b"".join(segs)
    ratio = sum(m["polished"] for m in metas) / float(
        metas[0]["total_windows"])
    derived = (f"{name.split()[0]} LN:i:{len(joined)} "
               f"RC:i:{metas[0]['coverage']} XC:f:{ratio:.6f}")
    if joined != data or derived != name:
        raise SystemExit(f"serve kinds path c: the served segments give "
                         f"{derived} ({len(joined)} bases), phase 5 {name}")
    out["range"] = {"shards": shards, "segment_meta": metas}
    log(f"[chip_smoke] serve kinds path c: the two served range shards "
        f"concatenate to phase 5's contig, tags re-derived equal; {shards} "
        f"(whole job {base['pairs']} pairs)")

    # ---- d. a fragment job on a slice of the targets
    frames = []
    t = time.perf_counter()
    rd = cl.submit(*fpaths, fragment=True, frag_lo=0, frag_hi=frag_hi,
                   on_part=frames.append)
    nd = served_numbers(rd, time.perf_counter() - t)
    tiles = [f["frag"] for f in frames]
    if (rd.fasta != frag_want or any(f["reads"] > 16 for f in frames)
            or [lo for lo, _ in tiles] != [0] + [hi for _, hi in tiles[:-1]]
            or tiles[-1][1] != frag_hi or nd["k1_launches"] <= 0
            or nd["k2_launches"] <= 0):
        raise SystemExit(f"serve kinds path d: equal to the one-shot "
                         f"{rd.fasta == frag_want}, groups "
                         f"{[(f['reads'], f['frag']) for f in frames]}, "
                         f"K1 {nd['k1_launches']} / K2 {nd['k2_launches']}")
    lines = rd.fasta.split(b"\n")
    by_name = {r[0]: r for r in reads}
    raw = fixed = 0
    for head, seq in zip(lines[0::2], lines[1::2]):
        read = by_name[head[1:].split(b" ")[0].decode()[:-1]]
        seg = truth_segment(truth, read)
        raw += edit_distance(read[1], seg)
        fixed += edit_distance(seq, seg)
    if not fixed < raw:
        raise SystemExit(f"serve kinds path d: distance {fixed} not below "
                         f"the raw reads' {raw}")
    nd.update(groups=len(frames), written=len(lines) // 2,
              raw_distance=raw, corrected_distance=fixed)
    out["jobs"]["fragment"] = nd
    log(f"[chip_smoke] serve kinds path d: the fragment slice [0, "
        f"{frag_hi}) equals the one-shot kF polisher's; {len(frames)} "
        f"groups of at most 16 reads tiling it, {len(lines) // 2} reads "
        f"written, distance {raw} -> {fixed}; end to end "
        f"{nd['wall_s']:.3f} s, launches K1 {nd['k1_launches']} / K2 "
        f"{nd['k2_launches']}")

    # ---- e. admit-time ingest
    res = {}
    submit("ingest", res, ingest=True)
    check(res, "ingest", contig, "phase 5")
    try:
        cl.submit(cut_reads, paths[1], paths[2], ingest=True)
        raise SystemExit("serve kinds path e: the cut reads file was "
                         "admitted")
    except ServeError as exc:
        if (exc.code != "bad-request"
                or exc.response.get("terminal") != "rejected-ingest"):
            raise SystemExit(f"serve kinds path e: the cut reads file gave "
                             f"{exc.response}") from None
        rejected = exc.response
    res = {}
    submit("small", res, paths_=small)
    if isinstance(res["small"][0], Exception):
        raise SystemExit(f"serve kinds path e: the job after the refusal "
                         f"failed: {res['small'][0]!r}")
    small_fasta = res["small"][0].fasta
    check(res, "small", small_fasta, "itself")
    log(f"[chip_smoke] serve kinds path e: the ingest job equals phase 5's; "
        f"the cut reads file refused ({rejected['terminal']}, stage "
        f"{rejected['stage']}: {rejected['message'][:80]}); the server then "
        f"served the warm-up dataset")

    # ---- f. preemption
    depth0 = {"pipeline_depth": 0}
    res = {}
    srv.batcher.hold()
    busy = [threading.Thread(target=submit, args=("bulk", res),
                             kwargs={"tenant": "bulk", "options": depth0}),
            threading.Thread(target=submit, args=("side", res),
                             kwargs={"paths_": small, "priority": 1,
                                     "tenant": "side", "options": depth0})]
    for t in busy:
        t.start()
    wait_for(lambda: len(srv.batcher._job_tickets) == 2,
             "the bulk and side jobs never pooled")
    gold = threading.Thread(target=submit, args=("gold", res),
                            kwargs={"paths_": small, "priority": 5,
                                    "tenant": "gold", "options": depth0})
    gold.start()
    wait_for(lambda: srv.qos["preemptions"] == 1,
             "the gold job never preempted the bulk job")
    # the gold job's windows pool before the release: released earlier,
    # the side job's iteration would cache them and gold would run none
    wait_for(lambda: len(srv.batcher._job_tickets) == 3,
             "the gold job never pooled")
    parked = srv.batcher.snapshot().get("parked_windows", 0)
    srv.batcher.release()
    for t in busy + [gold]:
        t.join(900)
    check(res, "bulk", contig, "phase 5")
    check(res, "side", small_fasta, "part e's")
    check(res, "gold", small_fasta, "part e's")
    stats = srv.stats_snapshot()
    qos = stats["qos"]
    tds = stats.get("tenant_device_seconds", {})
    if (parked <= 0 or qos["preemptions"] != 1 or qos["resumes"] != 1
            or not tds.get("bulk", 0) > 0 or not tds.get("gold", 0) > 0):
        raise SystemExit(f"serve kinds path f: {parked} windows parked, "
                         f"qos {qos}, tenant device seconds {tds}")
    out["qos"] = qos
    out["tenant_device_seconds"] = tds
    log(f"[chip_smoke] serve kinds path f: the gold job parked {parked} "
        f"windows of the bulk job; qos {qos}; all three FASTA correct; "
        f"tenant device seconds {tds}; card {card}")

    # ---- close
    cl.shutdown()
    if not srv.drain(timeout=600):
        raise SystemExit("serve kinds path: the drain ran over budget")
    q = srv.queue.counters
    out["queue"] = dict(q)
    out["batcher"] = srv.batcher.snapshot()
    launches = {"k1": poa_kernels.launches, "k2": align_kernels.launches,
                "k3": poa_fused_kernels.launches}
    k1p = by_plan(poa_kernels.launches_by_shape)
    k2p = by_plan(align_kernels.launches_by_shape)
    k3 = {f"{dt} serve_kinds": n for dt, n in k3_by_dtype().items()}
    out["launches"] = launches
    log(f"[chip_smoke] serve kinds path: drained cleanly, {q['admitted']} "
        f"admitted = {q['completed']} completed + {q['failed']} failed + "
        f"{q['expired']} cancelled in queue; launches over the phase "
        f"{launches}")

    # ---- the fullest K3 call of part a, its first layers, against its
    # plain version (the whole 32-layer call took the plain version
    # 33-44 s on an H100)
    call, rows = k3cap.fullest()
    call = first_layers(call, DEPTH_BUCKETS[0])
    what = (f"the served rounds job's fullest K3 call ({rows} rows), its "
            f"first {DEPTH_BUCKETS[0]} layers")
    held = hold_k3_call(call, what)
    held["real_rows"] = rows
    held["calls"] = len(k3cap.calls)
    del k3cap
    out["k3_held"] = held
    log(f"[chip_smoke] serve kinds path: {what}, {held['layers']} layers "
        f"x {held['rows']} rows ({'fused launch' if held['fused_launch'] else 'chained call'}, "
        f"{held['dtype']}), identical to the plain version on every state "
        f"array; kernel {held['ms']:.2f} ms, plain {held['plain_ms']:.0f} "
        f"ms, bound {held['bound_ms']:.4f} ms ({held['bound_by']}); card "
        f"{card}")
    report["serve_kinds_path"] = out
    return (launches["k1"], k1p), (launches["k2"], k2p), k3


def serve_lanes_path(dev, paths, workdir, report):
    """Phase 15: one PolishServer on the card with two worker lanes over
    `devices=[cuda:0, cuda:0]` (3 workers, `cuda_poa_batches=1`,
    `cuda_aligner_batches=1`, pipeline depth 2, scores 5/-4/-8, warm-up
    on, the window cache armed, `audit_rate=1.0` with its dumps under the
    workdir, and a scratch winner table holding one hand-recorded
    session-engine entry: the dtype phase 5's polisher ran at its
    smallest int16 bucket), every check against earlier phases' bytes:

      a. two contig-cell jobs and a fused-engine job (`--cuda-fused 1`)
         submitted at once behind the held feeders: the session jobs'
         FASTA equal to phase 5's, the fused job's to phase 9's int32;
         both lanes ran an iteration; K1, K2 and K3 launched; each lane's
         iterations and busy seconds, the most iterations at once, the
         iterations' summed seconds against their union (the part's
         `serve.iteration` spans, traced) and each job's wall are
         printed;
      b. the audit of part a: 0 mismatches, every sampled window audited,
         the shadow seconds against the consensus walls;
      c. a `device:chunk=1:sdc` contig job beside a clean one: both
         FASTA equal to phase 5's (the corrupted window repaired), 1
         mismatch, 1 repair, a demotion; the hand-recorded entry demoted
         on disk (a fresh Autotuner on the file); 1 lane quarantine and
         1 rejoin, both lanes back at health 1.0 within a deadline; one
         dual-stream dump whose produced bytes differ from the oracle's;
         the window cache invalidated;
      d. the cache: a clean contig job fills it, one base of every cached
         consensus is flipped, and the resubmitted job gives phase 5's
         FASTA with more mismatches, no more demotions, no lane
         quarantined, and at least as many entries quarantined as new
         mismatches;
      e. `shutdown` drains cleanly;
      f. the fullest K1 batch of lane 1's iterations (PathCapture on
         lane 1's runner) held against its plain version and timed
         against its bound.

    The launch counters are zeroed before the server starts and read
    after the drain (part f's launches excluded). Returns (K1 launches,
    by instantiation), (K2 ...) and K3's launches by dtype."""
    import threading

    import torch

    from racon_tpu_torch.device import card_info
    from racon_tpu_torch.obs import trace
    from racon_tpu_torch.ops import align_kernels, poa_fused_kernels
    from racon_tpu_torch.ops import poa_kernels
    from racon_tpu_torch.ops.poa_graph import MAX_PRED
    from racon_tpu_torch.sched.autotune import Autotuner, plane
    from racon_tpu_torch.serve import PolishClient, PolishServer
    from racon_tpu_torch.utils.logger import log_level, set_log_level

    card = card_info()
    out: dict = {"jobs": {}}
    contig = b"".join(b">" + n.encode() + b"\n" + d + b"\n"
                      for n, d in KEPT["contig"])
    fused = b"".join(b">" + n.encode() + b"\n" + d + b"\n"
                     for n, d in KEPT["fused int32"])
    # the hand-recorded entry: the bucket of the contig cell's fullest K1
    # batch (phase 5), at the dtype a cold table gives it
    plans = KEPT["contig_polisher"].poa.engine._plans
    bucket = max(plans, key=lambda b: (plans[b] == "int16", -b[0]))
    params = (MATCH, MISMATCH, GAP, MAX_PRED)
    table = os.path.join(workdir, "lanes_autotune.json")
    at = Autotuner(table)
    at.record("session", bucket, params,
              {"kernel": plane(dev.type), "dtype": plans[bucket], "ms": {},
               "identical": True}, backend=dev.type)
    at.save()
    entry_key = Autotuner.key("session", bucket, params, backend=dev.type)
    flight = os.path.join(workdir, "lanes_flight")
    poa_kernels.reset_launches()
    align_kernels.reset_launches()
    poa_fused_kernels.reset_launches()
    t0 = time.perf_counter()
    srv = PolishServer(socket_path=os.path.join(workdir, "lanes.sock"),
                       workers=3, device="cuda", devices=[dev, dev],
                       worker_lanes=2, match=MATCH, mismatch=MISMATCH,
                       gap=GAP, job_threads=os.cpu_count(),
                       cuda_poa_batches=1, cuda_aligner_batches=1,
                       pipeline_depth=2, autotune_table=table,
                       wincache=True, audit_rate=1.0,
                       flight_dir=flight).start()
    out["start_s"] = time.perf_counter() - t0
    lanes = srv.batcher._lanes
    if len(lanes) != 2:
        raise SystemExit(f"serve lanes path: {len(lanes)} lanes, not 2")
    log(f"[chip_smoke] serve lanes path: server up in {out['start_s']:.3f} "
        f"s with 2 lanes on {dev} (warm-up {srv._warm['warmup_s']:.3f} s), "
        f"audit rate 1.0, window cache on; hand-recorded entry {entry_key} "
        f"= {plans[bucket]}; card {card}")
    cl = PolishClient(socket_path=srv.config.socket_path, timeout=900)

    def wait_for(cond, what, timeout=600):
        deadline = time.monotonic() + timeout
        while not cond():
            if time.monotonic() > deadline:
                raise SystemExit(f"serve lanes path: {what}")
            time.sleep(0.01)

    def submit(name, results, **kw):
        t = time.perf_counter()
        try:
            results[name] = (cl.submit(*paths, **kw),
                             time.perf_counter() - t)
        except Exception as exc:  # noqa: BLE001 — checked by the caller
            results[name] = (exc, time.perf_counter() - t)

    def at_once(jobs: dict, pool: bool = True) -> dict:
        """Submit `jobs` (name -> submit kwargs) together; with `pool`,
        behind the held feeders until every ticket pooled."""
        results: dict = {}
        if pool:
            srv.batcher.hold()
        threads = [threading.Thread(target=submit, args=(k, results),
                                    kwargs=kw) for k, kw in jobs.items()]
        for t in threads:
            t.start()
        if pool:
            wait_for(lambda: sum(map(len, srv.batcher._job_tickets.values()))
                     >= len(jobs), "the jobs never pooled")
            srv.batcher.release()
        for t in threads:
            t.join(900)
        return results

    def check(results, name, want, ref):
        r, wall = results[name]
        if isinstance(r, Exception):
            raise SystemExit(f"serve lanes path: job {name} failed: {r}")
        if r.fasta != want:
            raise SystemExit(f"serve lanes path: job {name}'s FASTA "
                             f"differs from phase {ref}'s")
        nums = served_numbers(r, wall)
        out["jobs"][name] = nums
        log(f"[chip_smoke] serve lanes path {name} job: align "
            f"{nums['align_s']:.3f} s, consensus {nums['consensus_s']:.3f} "
            f"s, end to end {nums['wall_s']:.3f} s; {nums['iterations']} "
            f"iterations; launches K1 {nums['k1_launches']} / K2 "
            f"{nums['k2_launches']} / K3 {nums['k3_launches']}")
        return nums

    def lane_view():
        snap = srv.batcher.snapshot()
        return snap, [(ln["iterations"], ln["busy_s"], ln["health"])
                      for ln in snap["lanes"]]

    # ---- a. two contig jobs and a fused job at once, on two lanes
    _, before = lane_view()
    t0 = time.perf_counter()
    # lane 1's engines run serially under its lock: one writer at a time
    with PathCapture(runner=lanes[1].runner) as cap:
        # the part's spans: each shared iteration's (lane, start, end)
        rec = trace.configure()
        try:
            res = at_once({"contig1": {}, "contig2": {},
                           "fused": {"options": {"cuda_engine": "fused",
                                                 "cuda_fused": "1"}}})
        finally:
            trace.reset()
        wall_a = time.perf_counter() - t0
        spans = sorted((e["ts"] / 1e6, (e["ts"] + e["dur"]) / 1e6)
                       for e in rec.events()
                       if e.get("name") == "serve.iteration"
                       and not e["args"].get("solo"))
        union, end = 0.0, None
        for a0, a1 in spans:
            if end is None or a0 >= end:
                union += a1 - a0
                end = a1
            elif a1 > end:
                union += a1 - end
                end = a1
        summed = sum(a1 - a0 for a0, a1 in spans)
        nums = [check(res, "contig1", contig, 5),
                check(res, "contig2", contig, 5),
                check(res, "fused", fused, 9)]
        snap, after = lane_view()
        ran = [a[0] - b[0] for a, b in zip(after, before)]
        busy = [a[1] - b[1] for a, b in zip(after, before)]
        if min(ran) < 1:
            raise SystemExit(f"serve lanes path a: lane iterations {ran}")
        if (poa_kernels.launches <= 0 or align_kernels.launches <= 0
                or poa_fused_kernels.launches <= 0):
            raise SystemExit(f"serve lanes path a: K1 "
                             f"{poa_kernels.launches} / K2 "
                             f"{align_kernels.launches} / K3 "
                             f"{poa_fused_kernels.launches} launches")
        out["a"] = {"wall_s": wall_a, "lane_iterations": ran,
                    "lane_busy_s": busy,
                    "max_concurrent_iterations":
                        snap["max_concurrent_iterations"],
                    "iterations_summed_s": summed,
                    "iterations_union_s": union}
        log(f"[chip_smoke] serve lanes path a: 3 jobs in {wall_a:.3f} s; "
            f"lane iterations {ran}, busy {[round(b, 3) for b in busy]} s; "
            f"the {len(spans)} iterations summed {summed:.3f} s over a "
            f"union of {union:.3f} s (overlap {summed - union:.3f} s), at "
            f"most {snap['max_concurrent_iterations']} at once; job walls "
            f"{[round(n['wall_s'], 3) for n in nums]} s; card {card}")

        # ---- b. the audit of part a
        a = srv.auditor.snapshot()
        if a["mismatches"] or a["audited"] != a["sampled"]:
            raise SystemExit(f"serve lanes path b: audit {a}")
        consensus = sum(n["consensus_s"] or 0.0 for n in nums)
        out["b"] = {"audited": a["audited"], "shadow_s": a["shadow_s"],
                    "consensus_s": consensus,
                    "audit_s": snap["audit_s"]}
        log(f"[chip_smoke] serve lanes path b: {a['audited']} windows "
            f"audited (warm-up included), 0 mismatches; shadow "
            f"{a['shadow_s']:.3f} s against the three jobs' consensus "
            f"{consensus:.3f} s; the feeders' audit_s "
            f"{snap['audit_s']:.3f} s; card {card}")

        # ---- c. a silent corruption beside a clean job
        inval0 = srv.batcher.wincache.snapshot()["invalidations"]
        res = at_once({"sdc": {"fault_plan": "device:chunk=1:sdc",
                               "trace_id": "sdc"},
                       "clean": {}}, pool=False)
        check(res, "sdc", contig, 5)
        check(res, "clean", contig, 5)
        a = srv.auditor.snapshot()
        if (a["mismatches"], a["repaired"]) != (1, 1) or a["demotions"] < 1:
            raise SystemExit(f"serve lanes path c: audit {a}")
        ent = Autotuner(table).table.get(entry_key, {})
        if not ent.get("demoted") or ent.get("dtype") != "int32":
            raise SystemExit(f"serve lanes path c: the entry on disk reads "
                             f"{ent}")
        wait_for(lambda: lane_view()[0]["lane_rejoins"] >= 1,
                 "the quarantined lane never rejoined", 300)
        snap, view = lane_view()
        dumps = sorted(os.listdir(flight))
        doc = json.load(open(os.path.join(flight, dumps[0])))["flight"] \
            if len(dumps) == 1 else {}
        inval = snap["wincache"]["invalidations"] - inval0
        if (snap["lane_quarantines"] != 1 or snap["lane_rejoins"] != 1
                or any(h != 1.0 for _, _, h in view) or len(dumps) != 1
                or doc.get("produced") == doc.get("oracle") or inval < 1):
            raise SystemExit(f"serve lanes path c: quarantines "
                             f"{snap['lane_quarantines']}, rejoins "
                             f"{snap['lane_rejoins']}, lanes {view}, dumps "
                             f"{dumps}, cache invalidations {inval}")
        out["c"] = {"audit": {k: a[k] for k in ("mismatches", "repaired",
                                                 "demotions")},
                    "lane_reprobes": snap["lane_reprobes"],
                    "invalidations": inval, "recent": a["recent"][-1]}
        log(f"[chip_smoke] serve lanes path c: the sdc job's corrupted "
            f"window caught on lane {a['recent'][-1]['lane']} and repaired "
            f"(both FASTA equal to phase 5's); {a['demotions']} entry "
            f"demoted on disk; lane quarantined once, {snap['lane_reprobes']}"
            f" re-probe(s), rejoined; dump {dumps[0]}; the window cache "
            f"invalidated {inval} time(s); card {card}")

        # ---- d. a poisoned cache entry takes the blame
        res = {}
        submit("fill", res)
        check(res, "fill", contig, 5)
        before_d = srv.auditor.snapshot()
        q0 = srv.batcher.wincache.snapshot()["quarantined"]
        wc = srv.batcher.wincache
        with wc._lock:
            for key, (cons, pol) in list(wc._entries.items()):
                mid = len(cons) // 2
                flip = b"T" if cons[mid:mid + 1] != b"T" else b"A"
                wc._entries[key] = (cons[:mid] + flip + cons[mid + 1:], pol)
            flipped = len(wc._entries)
        level = log_level()
        set_log_level("quiet")  # one line a caught entry otherwise
        try:
            res = {}
            submit("poisoned", res)
        finally:
            set_log_level({0: "quiet", 1: "info", 2: "debug"}[level])
        check(res, "poisoned", contig, 5)
        a = srv.auditor.snapshot()
        snap, view = lane_view()
        new = a["mismatches"] - before_d["mismatches"]
        quarantined = snap["wincache"]["quarantined"] - q0
        if (new < 1 or a["demotions"] != before_d["demotions"]
                or snap["lane_quarantines"] != 1
                or any(h != 1.0 for _, _, h in view)
                or quarantined < new):
            raise SystemExit(f"serve lanes path d: {new} new mismatches, "
                             f"demotions {before_d['demotions']} -> "
                             f"{a['demotions']}, lane quarantines "
                             f"{snap['lane_quarantines']}, lanes {view}, "
                             f"{quarantined} entries quarantined")
        out["d"] = {"flipped": flipped, "new_mismatches": new,
                    "entries_quarantined": quarantined,
                    "wall_s": res["poisoned"][1]}
        log(f"[chip_smoke] serve lanes path d: {flipped} cached entries "
            f"flipped; the resubmitted job equals phase 5's with {new} "
            f"cache-hit mismatches caught, {quarantined} entries "
            f"quarantined, no demotion, no lane quarantined; card {card}")

        # ---- e. shut down
        cl.shutdown()
        if not srv.drain(timeout=600):
            raise SystemExit("serve lanes path e: the drain ran over "
                             "budget")
    q = srv.queue.counters
    out["queue"] = dict(q)
    out["batcher"] = srv.batcher.snapshot()
    out["audit"] = {k: v for k, v in srv.auditor.snapshot().items()
                    if k != "recent"}
    launches = {"k1": poa_kernels.launches, "k2": align_kernels.launches,
                "k3": poa_fused_kernels.launches}
    k1p = by_plan(poa_kernels.launches_by_shape)
    k2p = by_plan(align_kernels.launches_by_shape)
    k3 = {f"{dt} serve_lanes": n for dt, n in k3_by_dtype().items()}
    out["launches"] = launches
    log(f"[chip_smoke] serve lanes path e: drained cleanly, "
        f"{q['admitted']} admitted = {q['completed']} completed + "
        f"{q['failed']} failed; lanes "
        f"{[(ln['iterations'], ln['busy_s']) for ln in out['batcher']['lanes']]}"
        f" (iterations, busy s); launches over the phase {launches}")

    # ---- f. the fullest K1 batch of lane 1's iterations
    if not cap.k1:
        raise SystemExit("serve lanes path f: lane 1 launched no K1 batch")
    (nb, lb), (n, plan, args) = max(cap.k1.items(),
                                    key=lambda kv: kv[1][0])
    torch.cuda.synchronize()
    held = hold_k1(args, nb, lb, f"lane 1's fullest {(nb, lb)} batch",
                   widths=(plan[0],))[plan]
    out["k1_fullest_lane1"] = {"shape": [nb, lb], "jobs": n,
                               "plan": plan_name(*plan), **held}
    log(f"[chip_smoke] serve lanes path f: lane 1's fullest K1 batch, "
        f"{(nb, lb)} {plan_name(*plan)} with {n} jobs, identical to the "
        f"plain version; kernel {held['ms']:.3f} ms, plain "
        f"{held['plain_ms']:.1f} ms, bound {held['bound_ms']:.4f} ms "
        f"({held['bound_by']}); card {card}")
    report["serve_lanes_path"] = out
    return (launches["k1"], k1p), (launches["k2"], k2p), k3


#: the flight ring's capacity in phase 16: one 200 kb job's spans, with
#: room (printed after the phase)
OBS_FLIGHT_EVENTS = 16384


def serve_obs_path(dev, paths, workdir, report):
    """Phase 16: one PolishServer on the card with its observability
    armed (unix socket, 2 workers, `cuda_poa_batches=1`,
    `cuda_aligner_batches=1`, pipeline depth 2, scores 5/-4/-8,
    COLD_TABLE, warm-up on, `metrics_port=0`, a journal and a flight
    directory in the workdir, a flight ring of OBS_FLIGHT_EVENTS spans,
    `audit_rate=0.1`), driven through its client:

      a. one traced contig-cell job through `submit_traced(trace_out=)`:
         FASTA equal to phase 5's, K1 and K2 launched; the merged
         document loads and holds the client's request spans, the
         server's `serve.queue_wait` and `serve.job`, a `serve.iteration`
         whose `trace_ids` holds the job's id and the pipeline's stage
         spans, every server span inside the client's request on the
         client's clock, give or take the handshake's round trip;
      b. one untraced contig-cell job with a trace id, then `trace_pull`
         of that id: its `serve.queue_wait`, `serve.job` and iteration
         spans, nothing tagged with part a's id; FASTA equal to phase
         5's; its wall beside part a's and phase 13's lone job;
      c. a `device:chunk=0:raise` job on the warm-up dataset fails typed;
         its `flight_<id>_job-failed.json` exists when the error arrives,
         `debug` lists it and the scrape's `job.latency` exemplar names
         it;
      d. a job on the warm-up dataset (K1 launched) popped at once behind
         the held feeder and released past its deadline: a miss, not an
         expiry, journaled with its `deadline-miss` dump, and the SLO
         burn alert at 1 with a journaled `alert` of kind `slo-burn`;
      e. while parts a and b run, scrapes over the socket and over HTTP
         `/metrics` in turns, each timed and marked by the lane's busy
         gauge it rendered; every body parses strictly, at least one of
         each kind ran beside an iteration, the audit's families and
         `lane_health` render; after part d the scrape's counters equal
         `stats`; one `/healthz`;
      f. `shutdown` drains cleanly; the journal passes
         `check_consistency`, every job has its `received` and one
         terminal line; the ring's event count against its capacity; no
         tracer armed after the drain;
      g. the fullest K1 batch of parts a and b's iterations (PathCapture
         on the lane's runner: not the audit oracle's) held against its
         plain version and timed against its bound.

    The launch counters are zeroed before the server starts and read
    after the drain (part g's launches excluded). Returns (K1 launches,
    by instantiation) and (K2 ...)."""
    import threading
    import urllib.request

    import torch

    from racon_tpu_torch.device import card_info
    from racon_tpu_torch.obs import prom, trace
    from racon_tpu_torch.obs.journal import (RAN_EVENTS, TERMINAL_EVENTS,
                                             check_consistency,
                                             read_journal)
    from racon_tpu_torch.ops import align_kernels, poa_fused_kernels
    from racon_tpu_torch.ops import poa_kernels
    from racon_tpu_torch.serve import (JobFailed, PolishClient,
                                       PolishServer, make_synth_dataset)

    card = card_info()
    out: dict = {"jobs": {}}
    contig = b"".join(b">" + n.encode() + b"\n" + d + b"\n"
                      for n, d in KEPT["contig"])
    small_dir = os.path.join(workdir, "obs_small")
    os.makedirs(small_dir)
    small = make_synth_dataset(small_dir)
    journal = os.path.join(workdir, "obs_journal.jsonl")
    flight = os.path.join(workdir, "obs_flight")
    trace_out = os.path.join(workdir, "obs_trace.json")
    poa_kernels.reset_launches()
    align_kernels.reset_launches()
    poa_fused_kernels.reset_launches()
    t0 = time.perf_counter()
    srv = PolishServer(socket_path=os.path.join(workdir, "obs.sock"),
                       workers=2, device="cuda", match=MATCH,
                       mismatch=MISMATCH, gap=GAP,
                       job_threads=os.cpu_count(), cuda_poa_batches=1,
                       cuda_aligner_batches=1, pipeline_depth=2,
                       autotune_table=COLD_TABLE, metrics_port=0,
                       journal=journal, flight_dir=flight,
                       flight_events=OBS_FLIGHT_EVENTS,
                       audit_rate=0.1).start()
    out["start_s"] = time.perf_counter() - t0
    url = f"http://127.0.0.1:{srv.config.metrics_port}"
    log(f"[chip_smoke] serve obs path: server up in {out['start_s']:.3f} s "
        f"(warm-up {srv._warm['warmup_s']:.3f} s), metrics on {url}, "
        f"journal and flight dumps in the workdir, ring of "
        f"{OBS_FLIGHT_EVENTS} spans, audit rate 0.1; card {card}")
    cl = PolishClient(socket_path=srv.config.socket_path, timeout=900)
    lane = srv.batcher._lanes[0]

    def fail(part, msg):
        raise SystemExit(f"serve obs path {part}: {msg}")

    # ---- e. the scraper: both transports in turns while a and b run
    scrapes: list = []
    scraping = threading.Event()

    def scraper():
        kinds = ("rpc", "http")
        n = 0
        while scraping.is_set():
            kind = kinds[n % 2]
            n += 1
            t = time.perf_counter()
            if kind == "rpc":
                text = cl.scrape()
            else:
                text = urllib.request.urlopen(f"{url}/metrics",
                                              timeout=60).read().decode()
            dt = time.perf_counter() - t
            parsed = prom.parse(text)  # strict: raises on any bad line
            busy = parsed.gauges.get("racon_tpu_serve_lane_0_busy", 0.0)
            scrapes.append((kind, dt, bool(busy)))
            time.sleep(0.1)

    def served(name, r, wall):
        nums = served_numbers(r, wall)
        out["jobs"][name] = nums
        log(f"[chip_smoke] serve obs path {name} job: queue wait "
            f"{nums['queue_wait_s']:.3f} s, align {nums['align_s']:.3f} s, "
            f"consensus {nums['consensus_s']:.3f} s, end to end "
            f"{wall:.3f} s; {nums['iterations']} iterations; launches K1 "
            f"{nums['k1_launches']} / K2 {nums['k2_launches']}")
        return nums

    scraping.set()
    sc = threading.Thread(target=scraper, name="chip-smoke-scraper")
    sc.start()
    try:
        with PathCapture(runner=lane.runner) as cap:
            # ---- a. one traced contig job
            t = time.perf_counter()
            ra, doc = cl.submit_traced(*paths, trace_id="obs-a",
                                       trace_out=trace_out)
            wall_a = time.perf_counter() - t
            # ---- b. one untraced contig job with a trace id
            t = time.perf_counter()
            rb = cl.submit(*paths, trace_id="obs-b")
            wall_b = time.perf_counter() - t
    finally:
        scraping.clear()
        sc.join(120)
    na = served("a (traced)", ra, wall_a)
    nb = served("b (untraced)", rb, wall_b)
    if ra.fasta != contig or rb.fasta != contig:
        fail("a/b", "a FASTA differs from phase 5's")
    if min(na["k1_launches"], na["k2_launches"]) <= 0:
        fail("a", f"K1 {na['k1_launches']} / K2 {na['k2_launches']}")
    doc = json.load(open(trace_out))
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    client = [e for e in spans if e["pid"] == 1]
    server = [e for e in spans if e["pid"] == 2]
    names = {e["name"] for e in server}
    iters = [e for e in server if e["name"] == "serve.iteration"
             and "obs-a" in e["args"].get("trace_ids", ())]
    want = {"serve.queue_wait", "serve.job", "pipeline.pack",
            "pipeline.device", "pipeline.unpack"}
    if not (want <= names and iters and {"client.submit", "client.receive"}
            <= {e["name"] for e in client}):
        fail("a", f"the merged document holds {sorted(names)}, "
                  f"{len(iters)} iterations of obs-a")
    rtt_us = doc["trace_context"]["clock_rtt_s"] * 1e6
    lo = min(e["ts"] for e in client if e["name"] == "client.submit")
    hi = max(e["ts"] + e["dur"] for e in client
             if e["name"] == "client.receive")
    outside = [e["name"] for e in server
               if e["ts"] < lo - rtt_us or e["ts"] + e["dur"] > hi + rtt_us]
    if outside:
        fail("a", f"{len(outside)} server spans outside the request "
                  f"({sorted(set(outside))})")
    out["a"] = {"events": len(doc["traceEvents"]),
                "server_spans": len(server), "iterations": len(iters),
                "clock_offset_s": doc["trace_context"]["clock_offset_s"],
                "clock_rtt_s": doc["trace_context"]["clock_rtt_s"]}
    log(f"[chip_smoke] serve obs path a: the merged trace holds "
        f"{len(client)} client and {len(server)} server spans, "
        f"{len(iters)} iterations tagged obs-a, all inside the request "
        f"(clock offset {out['a']['clock_offset_s']:.6f} s, rtt "
        f"{out['a']['clock_rtt_s'] * 1e3:.3f} ms)")
    pull = cl.trace_pull("obs-b")
    pulled = [e for e in pull["events"] if e.get("ph") != "M"]
    pnames = [e["name"] for e in pulled]
    tagged_a = [e for e in pulled
                if e["args"].get("trace_id") == "obs-a"
                or "obs-a" in e["args"].get("trace_ids", ())]
    if (pnames.count("serve.queue_wait") != 1
            or pnames.count("serve.job") != 1
            or "serve.iteration" not in pnames or tagged_a):
        fail("b", f"trace_pull gave {sorted(set(pnames))}, "
                  f"{len(tagged_a)} spans of obs-a")
    lone = report["serve_path"]["jobs"]["alone"]["wall_s"]
    out["b"] = {"pulled": len(pulled), "walls_s": {
        "traced": wall_a, "untraced": wall_b, "phase13_alone": lone}}
    log(f"[chip_smoke] serve obs path b: trace_pull(obs-b) gave "
        f"{len(pulled)} spans ({pnames.count('serve.iteration')} "
        f"iterations), none of obs-a; walls: traced {wall_a:.3f} s, "
        f"untraced {wall_b:.3f} s, phase 13's lone job {lone:.3f} s; card "
        f"{card}")

    # ---- e. the scrapes of parts a and b
    for kind in ("rpc", "http"):
        busy = [dt for k, dt, b in scrapes if k == kind and b]
        idle = [dt for k, dt, b in scrapes if k == kind and not b]
        if not busy:
            fail("e", f"no {kind} scrape ran beside an iteration "
                      f"({len(idle)} idle)")
        out.setdefault("e", {})[kind] = {
            "busy_ms": sorted(round(x * 1e3, 3) for x in busy),
            "idle_ms": sorted(round(x * 1e3, 3) for x in idle)}
        mid = sorted(busy)[len(busy) // 2]
        log(f"[chip_smoke] serve obs path e: {kind} scrapes beside an "
            f"iteration {len(busy)}, median {mid * 1e3:.3f} ms, max "
            f"{max(busy) * 1e3:.3f} ms; idle {len(idle)}"
            + (f", median {sorted(idle)[len(idle) // 2] * 1e3:.3f} ms"
               if idle else ""))
        for label in ("busy", "idle"):
            log(f"[chip_smoke] serve obs path e: {kind} {label} ms "
                f"{out['e'][kind][label + '_ms']}")

    # ---- c. a poisoned job: its dump before its error
    dump_c = None
    try:
        cl.submit(*small, fault_plan="device:chunk=0:raise")
        fail("c", "the poisoned job did not fail")
    except JobFailed as exc:
        job_c = exc.response["job_id"]
        dump_c = os.path.join(flight, f"flight_{job_c}_job-failed.json")
        there = os.path.isfile(dump_c)
        if exc.error_type != "DeviceError" or not there:
            fail("c", f"{exc.error_type}, dump there: {there}")
    dumps = cl.debug(max_events=10)["dumps"]
    hist = prom.parse(cl.scrape()).histogram(
        "racon_tpu_job_latency_seconds")
    ex = [e for e in hist.bucket_exemplars().values()
          if e.get("flight") == dump_c]
    if dump_c not in dumps or not ex:
        fail("c", f"debug lists {dumps}, {len(ex)} exemplars name the dump")
    log(f"[chip_smoke] serve obs path c: the poisoned job failed typed "
        f"(DeviceError), {os.path.basename(dump_c)} written before its "
        f"error, listed by debug and named by a job.latency exemplar")

    # ---- d. a job popped at once and released past its deadline
    res: dict = {}

    def late():
        try:
            res["d"] = cl.submit(*small, deadline_s=1.0, trace_id="obs-d")
        except Exception as exc:  # noqa: BLE001 — checked below
            res["d"] = exc

    srv.batcher.hold()
    try:
        td = threading.Thread(target=late)
        td.start()
        deadline = time.monotonic() + 300
        while not srv.batcher._job_tickets:
            if time.monotonic() > deadline:
                fail("d", "the job never pooled")
            time.sleep(0.01)
        time.sleep(1.2)
    finally:
        srv.batcher.release()
    td.join(900)
    rd = res["d"]
    if isinstance(rd, Exception) or rd.serve["batch"]["k1_launches"] <= 0:
        fail("d", f"the late job gave {rd!r}")
    stats = cl.stats()
    s = prom.parse(cl.scrape())
    dump_d = os.path.join(flight, f"flight_{rd.job_id}_deadline-miss.json")
    if (stats["slo"]["deadline_miss"] != 1 or stats["queue"]["expired"]
            or s.gauges["racon_tpu_slo_burn_alert"] != 1
            or not os.path.isfile(dump_d)):
        fail("d", f"slo {stats['slo']}, dump there: "
                  f"{os.path.isfile(dump_d)}")
    log(f"[chip_smoke] serve obs path d: the late job (K1 "
        f"{rd.serve['batch']['k1_launches']} launches) missed its "
        f"deadline, {os.path.basename(dump_d)} written, burn rate "
        f"{stats['slo']['burn']['fast']:g}x, alert firing")

    # ---- e. the scrape's counters against stats, /healthz
    q, b = stats["queue"], stats["batcher"]
    pairs = [(f"racon_tpu_serve_jobs_{k}_total", q[k]) for k in (
        "submitted", "admitted", "rejected_full", "expired", "completed",
        "failed", "deadline_hit", "deadline_miss")]
    pairs += [("racon_tpu_serve_batch_iterations_total", b["iterations"]),
              ("racon_tpu_serve_batch_shared_iterations_total",
               b["shared_iterations"]),
              ("racon_tpu_serve_batch_windows_total", b["windows"]),
              ("racon_tpu_audit_windows_total", stats["audit"]["windows"]),
              ("racon_tpu_audit_sampled_total", stats["audit"]["sampled"])]
    wrong = [(n, s.counters.get(n), v) for n, v in pairs
             if s.counters.get(n) != v]
    if wrong or "racon_tpu_lane_health" not in s.gauge_series:
        fail("e", f"scrape against stats: {wrong}")
    health = json.loads(urllib.request.urlopen(f"{url}/healthz",
                                               timeout=60).read())
    if health.get("ok") is not True:
        fail("e", f"/healthz {health}")
    n_scrapes = s.counters["racon_tpu_serve_scrapes_total"]
    per = s.counters["racon_tpu_serve_scrape_seconds_total"] / n_scrapes
    out["e"]["render_s_per_scrape"] = per
    out["e"]["scrapes"] = n_scrapes
    log(f"[chip_smoke] serve obs path e: {len(pairs)} counters equal "
        f"stats; {int(n_scrapes)} scrapes rendered at {per * 1e3:.3f} ms "
        f"each (serve.scrape_seconds / serve.scrapes); /healthz ok; "
        f"audit {stats['audit']['sampled']} of "
        f"{stats['audit']['windows']} windows sampled, "
        f"{stats['audit']['mismatches']} mismatches; card {card}")

    # ---- f. shut down, read the journal
    ring = srv._flight
    cl.shutdown()
    if not srv.wait_stopped(600) or not srv._drained_clean:
        fail("f", "the drain did not end cleanly")
    held = len(ring.events())
    entries = read_journal(journal)
    faults = check_consistency(entries)
    by_job: dict = {}
    for e in entries:
        if e.get("job"):
            by_job.setdefault(e["job"], []).append(e["event"])
    bad = {j: evs for j, evs in by_job.items()
           if evs[0] != "received"
           or sum(ev in TERMINAL_EVENTS for ev in evs) != 1}
    if faults or bad or trace.get_tracer() is not None:
        fail("f", f"journal faults {faults}, jobs {bad}, tracer "
                  f"{trace.get_tracer()}")
    misses = [e for e in entries if e["event"] == "deadline-miss"]
    alerts = [(e["kind"], e["state"]) for e in entries
              if e["event"] == "alert"]
    if len(misses) != 1 or ("slo-burn", "firing") not in alerts:
        fail("f", f"{len(misses)} deadline-miss lines, alerts {alerts}")
    ran = sum(any(ev in RAN_EVENTS for ev in evs)
              for evs in by_job.values())
    out["f"] = {"journal_lines": len(entries), "jobs": len(by_job),
                "ran": ran, "ring_events": held,
                "ring_capacity": ring.capacity, "alerts": alerts}
    log(f"[chip_smoke] serve obs path f: drained cleanly; journal "
        f"{len(entries)} lines over {len(by_job)} jobs, consistent; the "
        f"ring holds {held} events of {ring.capacity}; no tracer armed")
    q = srv.queue.counters
    out["queue"] = dict(q)
    launches = {"k1": poa_kernels.launches, "k2": align_kernels.launches,
                "k3": poa_fused_kernels.launches}
    k1p = by_plan(poa_kernels.launches_by_shape)
    k2p = by_plan(align_kernels.launches_by_shape)
    out["launches"] = launches
    log(f"[chip_smoke] serve obs path f: {q['admitted']} admitted = "
        f"{q['completed']} completed + {q['failed']} failed; launches over "
        f"the phase {launches}")

    # ---- g. the fullest K1 batch of parts a and b's iterations
    if not cap.k1:
        fail("g", "the lane launched no K1 batch")
    (nbk, lbk), (n, plan, args) = max(cap.k1.items(),
                                      key=lambda kv: kv[1][0])
    torch.cuda.synchronize()
    held_k1 = hold_k1(args, nbk, lbk, f"the serve obs path's fullest "
                      f"{(nbk, lbk)} batch", widths=(plan[0],))[plan]
    out["k1_fullest"] = {"shape": [nbk, lbk], "jobs": n,
                         "plan": plan_name(*plan), **held_k1}
    log(f"[chip_smoke] serve obs path g: the fullest K1 batch of parts a "
        f"and b, {(nbk, lbk)} {plan_name(*plan)} with {n} jobs, identical "
        f"to the plain version; kernel {held_k1['ms']:.3f} ms, plain "
        f"{held_k1['plain_ms']:.1f} ms, bound {held_k1['bound_ms']:.4f} ms "
        f"({held_k1['bound_by']}); card {card}")
    report["serve_obs_path"] = out
    return (launches["k1"], k1p), (launches["k2"], k2p)


ROUTER_SCRAPES = 5


def router_path(dev, paths, workdir, report):
    """Phase 17: two PolishServers on the card (unix sockets, one worker
    each, `cuda_poa_batches=1`, `cuda_aligner_batches=1`, pipeline depth
    2, scores 5/-4/-8, COLD_TABLE, warm-up on, half the host's cores as
    job threads each) behind a PolishRouter (a journal and a metrics port
    in the workdir), driven through the router with the client:

      a. phase 5's one-contig triple as one traced routed job
         (`submit_traced`): two routable replicas and one contig make two
         window-range shards; the merged FASTA equals phase 5's, the
         `router` block shows 2 range shards, 2 segments, 1 part and no
         requeue, each shard's `serve.batch` launched K1 and K2, and the
         merged trace holds the client's, the router's and both
         replicas' tracks; its wall beside phase 13's lone job;
      b. ROUTER_SCRAPES times: a fleet poll (both replicas scraped,
         parsed and merged: the federation's cost), then a scrape through
         the router (the merged body beside the router's own families),
         each timed and parsed strictly; /healthz over HTTP;
      c. the router drained, then the replicas; the router's journal
         passes `check_consistency` and holds the range plan, two
         dispatched and two finished shards and two routed segments;
      d. the fullest K1 batch of the first replica's lane held against
         its plain version and timed against its bound.

    The launch counters are zeroed before the servers start and read
    after the drains (part d's launches excluded). Returns (K1 launches,
    by instantiation) and (K2 ...)."""
    import urllib.request

    import torch

    from racon_tpu_torch.device import card_info
    from racon_tpu_torch.obs import prom
    from racon_tpu_torch.obs.journal import check_consistency, read_journal
    from racon_tpu_torch.ops import align_kernels, poa_fused_kernels
    from racon_tpu_torch.ops import poa_kernels
    from racon_tpu_torch.serve import (PolishClient, PolishRouter,
                                       PolishServer)

    card = card_info()
    out: dict = {}
    contig = b"".join(b">" + n.encode() + b"\n" + d + b"\n"
                      for n, d in KEPT["contig"])
    journal = os.path.join(workdir, "router_journal.jsonl")

    def fail(part, msg):
        raise SystemExit(f"router path {part}: {msg}")

    poa_kernels.reset_launches()
    align_kernels.reset_launches()
    poa_fused_kernels.reset_launches()
    t0 = time.perf_counter()
    servers = [PolishServer(
        socket_path=os.path.join(workdir, f"router_rep{i}.sock"),
        workers=1, device="cuda", match=MATCH, mismatch=MISMATCH, gap=GAP,
        job_threads=max(1, (os.cpu_count() or 2) // 2), cuda_poa_batches=1,
        cuda_aligner_batches=1, pipeline_depth=2,
        autotune_table=COLD_TABLE).start() for i in range(2)]
    router = PolishRouter(
        replicas=[s.config.socket_path for s in servers],
        socket_path=os.path.join(workdir, "router.sock"), journal=journal,
        metrics_port=0).start()
    out["start_s"] = time.perf_counter() - t0
    log(f"[chip_smoke] router path: 2 replicas (warm-up "
        f"{[round(s._warm['warmup_s'], 3) for s in servers]} s) and the "
        f"router up in {out['start_s']:.3f} s; card {card}")
    cl = PolishClient(socket_path=router.config.socket_path, timeout=900)
    try:
        # ---- a. one traced routed job
        with PathCapture(runner=servers[0].batcher._lanes[0].runner) as cap:
            t = time.perf_counter()
            res, doc = cl.submit_traced(*paths, trace_id="routed")
            wall = time.perf_counter() - t
        rb = res.router
        if res.fasta != contig:
            fail("a", "the routed FASTA differs from phase 5's")
        if (not rb.get("range") or rb["range_shards"] != 2
                or rb["segments"] != 2 or rb["parts"] != 1
                or rb["requeues"]):
            fail("a", f"router block {rb}")
        shards = [d["batch"] for d in rb["shards_detail"]]
        if any(b["k1_launches"] <= 0 or b["k2_launches"] <= 0
               for b in shards):
            fail("a", f"a shard launched no K1 or K2: {shards}")
        pids = {e["args"]["name"] for e in doc["traceEvents"]
                if e.get("ph") == "M" and e["name"] == "process_name"}
        if len(pids) != 4 or len(res.trace_replicas or ()) != 2:
            fail("a", f"the merged trace holds {sorted(pids)}")
        lone = report["serve_path"]["jobs"]["alone"]["wall_s"]
        out["a"] = {"wall_s": wall, "router": {
            k: v for k, v in rb.items() if k != "shards_detail"},
            "phase13_alone_s": lone,
            "shards": [{"queue_wait_s": d["queue_wait_s"],
                        "exec_s": d["exec_s"],
                        "k1_launches": d["batch"]["k1_launches"],
                        "k2_launches": d["batch"]["k2_launches"],
                        "iterations": d["batch"]["iterations"]}
                       for d in rb["shards_detail"]],
            "trace_events": len(doc["traceEvents"])}
        log(f"[chip_smoke] router path a: the routed job ran as "
            f"{rb['range_shards']} range shards, FASTA equal to phase 5's; "
            f"end to end {wall:.3f} s (router wall {rb['wall_s']:.3f} s, "
            f"slowest shard exec {rb['shard_exec_max_s']:.3f} s) against "
            f"phase 13's lone job {lone:.3f} s ({wall / lone:.2f}x); "
            f"shards' K1 {[b['k1_launches'] for b in shards]} / K2 "
            f"{[b['k2_launches'] for b in shards]} launches; router block "
            f"{out['a']['router']}; card {card}")

        # ---- b. fleet polls and scrapes through the router
        polls, times = [], []
        for _ in range(ROUTER_SCRAPES):
            polls.append(router.fleet.poll().poll_s)
            t = time.perf_counter()
            text = cl.request({"type": "scrape"})["text"]
            times.append(time.perf_counter() - t)
            s = prom.parse(text)  # strict: raises on any bad line
        if (s.counters.get("racon_tpu_router_jobs_completed_total") != 1
                or s.gauges.get("racon_tpu_fleet_replicas") != 2
                or s.counters.get("racon_tpu_serve_jobs_completed_total")
                < 2):
            fail("b", "the federated scrape lacks the router's or the "
                      "replicas' counters")
        url = f"http://127.0.0.1:{router.config.metrics_port}/healthz"
        health = json.loads(urllib.request.urlopen(url, timeout=60).read())
        if not health.get("ok") or health.get("routable") != 2:
            fail("b", f"/healthz {health}")
        out["b"] = {"poll_ms": [round(x * 1e3, 3) for x in polls],
                    "scrape_ms": [round(x * 1e3, 3) for x in times],
                    "families": len(s.counters) + len(s.gauges)
                    + len(s.counter_series) + len(s.gauge_series)
                    + len(s.hists)}
        log(f"[chip_smoke] router path b: {ROUTER_SCRAPES} fleet polls "
            f"(both replicas scraped, parsed and merged), ms "
            f"{out['b']['poll_ms']}; router scrapes, ms "
            f"{out['b']['scrape_ms']}; {out['b']['families']} families; "
            f"/healthz ok, 2 routable")
    finally:
        clean = router.drain(timeout=120)
        drained = [srv.drain(timeout=600) for srv in servers]
    if not clean or not all(drained):
        fail("c", "a drain did not end cleanly")

    # ---- c. the journal
    entries = read_journal(journal)
    events = [e["event"] for e in entries]
    faults = check_consistency(entries)
    want = {"range-plan": 1, "shard-dispatched": 2, "shard-finished": 2,
            "part-routed": 2, "finished": 1}
    got = {ev: events.count(ev) for ev in want}
    if faults or got != want:
        fail("c", f"journal faults {faults}, events {got}")
    launches = {"k1": poa_kernels.launches, "k2": align_kernels.launches,
                "k3": poa_fused_kernels.launches}
    k1p = by_plan(poa_kernels.launches_by_shape)
    k2p = by_plan(align_kernels.launches_by_shape)
    out["launches"] = launches
    log(f"[chip_smoke] router path c: drained cleanly; journal "
        f"{len(entries)} lines, consistent; launches over the phase "
        f"{launches}")

    # ---- d. the fullest K1 batch of the first replica
    if not cap.k1:
        fail("d", "the first replica launched no K1 batch")
    (nbk, lbk), (n, plan, args) = max(cap.k1.items(),
                                      key=lambda kv: kv[1][0])
    torch.cuda.synchronize()
    held = hold_k1(args, nbk, lbk, f"the router path's fullest {(nbk, lbk)} "
                   f"batch", widths=(plan[0],))[plan]
    out["k1_fullest"] = {"shape": [nbk, lbk], "jobs": n,
                         "plan": plan_name(*plan), **held}
    log(f"[chip_smoke] router path d: the first replica's fullest K1 "
        f"batch, {(nbk, lbk)} {plan_name(*plan)} with {n} jobs, identical "
        f"to the plain version; kernel {held['ms']:.3f} ms, plain "
        f"{held['plain_ms']:.1f} ms, bound {held['bound_ms']:.4f} ms "
        f"({held['bound_by']}); card {card}")
    report["router_path"] = out
    return (launches["k1"], k1p), (launches["k2"], k2p)


#: phase 18's autoscaler: one replica to start, room for one more; fast
#: decisions, a short idle before the scale-down, and a hold long enough
#: to outlast a spawned replica's start (the interpreter, torch, the CUDA
#: context, the libraries and its warm-up), so a held shard can reach it
AUTOSCALE = {"min_replicas": 1, "max_replicas": 2, "interval_s": 0.2,
             "up_pressure": 1.0, "up_sustain_s": 0.5, "down_idle_s": 2.0,
             "cooldown_s": 0.5, "hold_s": 30.0, "ready_timeout_s": 60.0}
AUTOSCALE_JOBS = 3


def autoscale_replica_args(table: str, threads: int) -> list:
    """The `serve` flags of phase 18's spawned replica: the in-process
    server's posture, on the card."""
    return ["--device", "cuda", "--workers", "1", "-t", str(threads),
            "-m", str(MATCH), "-x", str(MISMATCH), "-g", str(GAP),
            "-c", "1", "--cudaaligner-batches", "1",
            "--cuda-pipeline-depth", "2", "--cuda-autotune-table", table]


def autoscale_path(dev, paths, workdir, report):
    """Phase 18: the elastic fleet. One PolishServer in this process
    (phase 17's posture: unix socket, one worker, session engine,
    `cuda_poa_batches=1`, `cuda_aligner_batches=1`, depth 2, 5/-4/-8,
    COLD_TABLE, warm-up on) behind a PolishRouter (a journal, health
    every 0.3 s) with an Autoscaler (AUTOSCALE) whose default spawn
    starts `python -m racon_tpu_torch serve` on the card with the same
    posture (`autoscale_replica_args`; a winner-table path of its own,
    which, like COLD_TABLE, must still not exist after the phase):

      a. phase 5's one-contig triple as AUTOSCALE_JOBS traced jobs at
         once (`submit_traced`): the first takes the server, the others
         hold for an idle replica, and the held shards' pressure spawns
         one replica process. Each merged FASTA equals phase 5's; the
         journal holds one `autoscale-up` and a shard dispatched to the
         spawned replica, whose job launched K1 and K2 (its `serve.batch`
         in the shard's result); a servetop screen taken while it is
         alive shows the autoscale suffix. Printed: the replica's time
         to its first clean healthz, the wave's wall, each job's wall
         beside phase 13's lone job;
      b. after the idle the journal holds `autoscale-down` and the
         process has exited; the journal passes `check_consistency` and
         obsreport's `check_autoscale`; tracereport's `check` of each
         merged trace is empty (the stages of the one that held most are
         printed);
      c. the server's fullest K1 batch held against its plain version and
         timed against its bound.

    No process outlives the phase, whatever fails. The in-process launch
    counters are zeroed before the server starts and read after the
    drains (part c excluded); the spawned replica's come from its jobs'
    results. Returns (K1 launches, by instantiation) and (K2 ...), the
    launches including the spawned replica's, the instantiations only
    this process's."""
    import threading

    import torch

    from racon_tpu_torch.device import card_info
    from racon_tpu_torch.obs.fleet import FleetAggregator
    from racon_tpu_torch.obs.journal import check_consistency, read_journal
    from racon_tpu_torch.ops import align_kernels, poa_fused_kernels
    from racon_tpu_torch.ops import poa_kernels
    from racon_tpu_torch.serve import (PolishClient, PolishRouter,
                                       PolishServer)
    from racon_tpu_torch.serve.autoscale import Autoscaler
    from racon_tpu_torch.tools import obsreport, servetop, tracereport

    card = card_info()
    out: dict = {}
    contig = b"".join(b">" + n.encode() + b"\n" + d + b"\n"
                      for n, d in KEPT["contig"])
    journal = os.path.join(workdir, "autoscale_journal.jsonl")
    child_table = os.path.join(workdir, "autoscale_child_table.json")
    sock_dir = os.path.join(workdir, "as")
    os.makedirs(sock_dir, exist_ok=True)
    threads = max(1, (os.cpu_count() or 2) // 2)

    def fail(part, msg):
        raise SystemExit(f"autoscale path {part}: {msg}")

    def log_tails() -> list:
        """The end of each spawned replica's standard error."""
        tails = []
        for name in sorted(os.listdir(sock_dir)):
            if name.endswith(".log"):
                with contextlib.suppress(OSError), \
                        open(os.path.join(sock_dir, name), "rb") as fh:
                    tails.append(fh.read()[-3000:].decode(errors="replace"))
        return tails

    poa_kernels.reset_launches()
    align_kernels.reset_launches()
    poa_fused_kernels.reset_launches()
    t0 = time.perf_counter()
    srv = PolishServer(
        socket_path=os.path.join(workdir, "autoscale_rep.sock"), workers=1,
        device="cuda", match=MATCH, mismatch=MISMATCH, gap=GAP,
        job_threads=threads, cuda_poa_batches=1, cuda_aligner_batches=1,
        pipeline_depth=2, autotune_table=COLD_TABLE).start()
    router = PolishRouter(
        replicas=[srv.config.socket_path],
        socket_path=os.path.join(workdir, "autoscale_router.sock"),
        journal=journal, health_interval_s=0.3).start()
    scaler = Autoscaler(router, socket_dir=sock_dir,
                        replica_args=autoscale_replica_args(child_table,
                                                            threads),
                        **AUTOSCALE).start()
    out["start_s"] = time.perf_counter() - t0
    log(f"[chip_smoke] autoscale path: server (warm-up "
        f"{srv._warm['warmup_s']:.3f} s), router and autoscaler up in "
        f"{out['start_s']:.3f} s; {AUTOSCALE}; card {card}")
    results: dict = {}
    walls: dict = {}
    screen = ""

    def job(i):
        cl = PolishClient(socket_path=router.config.socket_path, timeout=600)
        t = time.perf_counter()
        try:
            results[i] = cl.submit_traced(*paths, trace_id=f"wave{i}")
        except Exception as exc:  # noqa: BLE001 — reported below
            results[i] = exc
        walls[i] = time.perf_counter() - t

    wave = [threading.Thread(target=job, args=(i,), daemon=True)
            for i in range(AUTOSCALE_JOBS)]
    try:
        # ---- a. the wave
        with PathCapture(runner=srv.batcher._lanes[0].runner) as cap:
            tw = time.perf_counter()
            for t in wave:
                t.start()
            deadline = time.monotonic() + AUTOSCALE["ready_timeout_s"] + 30
            while (not scaler.counters["scale_ups"]
                   and not scaler.counters["spawn_failures"]
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            if not scaler.counters["scale_ups"]:
                fail("a", f"no scale-up: {scaler.snapshot()}, ready "
                          f"timeout {AUTOSCALE['ready_timeout_s']} s, the "
                          f"replica's stderr: {log_tails()}")
            child = scaler.spawned[0]
            # the servetop screen while the spawned replica is alive
            agg = FleetAggregator([router.config.socket_path,
                                   srv.config.socket_path, child["spec"]])
            snap = agg.poll()
            rows = [servetop.replica_row(r, {}, 0.0) for r in snap.replicas]
            screen = servetop.render_screen(snap, agg.burn.state(), rows,
                                            {}, 0.0)
            agg.close()
            for t in wave:
                t.join(600)
            wave_s = time.perf_counter() - tw
        bad = {i: r for i, r in results.items() if isinstance(r, Exception)}
        if bad or len(results) != AUTOSCALE_JOBS:
            fail("a", f"jobs failed or lost: {bad}, {len(results)} results")
        if any(res.fasta != contig for res, _ in results.values()):
            fail("a", "a job's FASTA differs from phase 5's")
        if "autoscale 1u/0d" not in screen or "[SCALED +1]" not in screen:
            fail("a", f"servetop shows no autoscale suffix:\n{screen}")
        on_child = {}
        for i, (res, doc) in sorted(results.items()):
            reps = [r["replica"] for r in res.trace_replicas or ()]
            batch = res.router["shards_detail"][0]["batch"]
            if reps == [child["spec"]]:
                on_child[i] = batch
        if not on_child:
            fail("a", "no job ran on the spawned replica")
        if any(b["k1_launches"] <= 0 or b["k2_launches"] <= 0
               for b in on_child.values()):
            fail("a", f"the spawned replica launched no K1 or K2: "
                      f"{on_child}")
        lone = report["serve_path"]["jobs"]["alone"]["wall_s"]
        out["a"] = {
            "ready_s": child["ready_s"], "wave_s": wave_s,
            "job_walls_s": [walls[i] for i in sorted(walls)],
            "phase13_alone_s": lone, "on_child": sorted(on_child),
            "child_batches": {i: {k: b.get(k) for k in (
                "k1_launches", "k2_launches", "iterations", "windows")}
                for i, b in on_child.items()},
            "screen": screen.splitlines()[1]}
        log(f"[chip_smoke] autoscale path a: {AUTOSCALE_JOBS} jobs at once, "
            f"each FASTA equal to phase 5's; the spawned replica ready in "
            f"{child['ready_s']:.3f} s, ran job(s) {sorted(on_child)} "
            f"(K1 {[b['k1_launches'] for b in on_child.values()]} / K2 "
            f"{[b['k2_launches'] for b in on_child.values()]} launches); "
            f"wave {wave_s:.3f} s, jobs "
            f"{[round(walls[i], 3) for i in sorted(walls)]} s against phase "
            f"13's lone job {lone:.3f} s; servetop: "
            f"{out['a']['screen'].strip()}; card {card}")

        # ---- b. scale-down after the idle
        deadline = time.monotonic() + AUTOSCALE["down_idle_s"] + 60
        while (not scaler.counters["scale_downs"]
               and time.monotonic() < deadline):
            time.sleep(0.05)
        if child["handle"].poll() is None:
            fail("b", f"the spawned replica is still running: "
                      f"{scaler.snapshot()}, its stderr: {log_tails()}")
        out["b"] = {"snapshot": scaler.snapshot(),
                    "exit_code": child["handle"].poll(),
                    "idle_to_exit_s": time.perf_counter() - tw - wave_s}
    finally:
        # stops what the autoscaler still owns (SIGTERM, then SIGKILL
        # after 15 s); a replica that never got ready was stopped already
        scaler.close()
        clean = router.drain(timeout=120)
        drained = srv.drain(timeout=600)
    if not clean or not drained:
        fail("b", "a drain did not end cleanly")
    if os.path.exists(COLD_TABLE) or os.path.exists(child_table):
        fail("b", "a winner table was written during the phase")
    entries = read_journal(journal)
    events = [e["event"] for e in entries]
    faults = check_consistency(entries) + obsreport.check_autoscale(entries)
    to_child = [e for e in entries if e["event"] == "shard-dispatched"
                and e.get("replica") == child["spec"]]
    if (faults or events.count("autoscale-up") != 1
            or events.count("autoscale-down") != 1 or not to_child
            or events.count("finished") != AUTOSCALE_JOBS):
        fail("b", f"journal faults {faults}, events "
                  f"{ {ev: events.count(ev) for ev in set(events)} }")
    stages = {}
    for i, (res, doc) in sorted(results.items()):
        rep = tracereport.analyze(doc)
        problems = tracereport.check(doc, rep)
        if problems:
            fail("b", f"tracereport on job {i}: {problems}")
        stages[i] = {k: round(v, 4) for k, v in rep["stages"].items()}
    held = max(stages, key=lambda i: stages[i]["hold"])
    # read with the launches, before part c's hold adds its own
    launches = {"k1": poa_kernels.launches, "k2": align_kernels.launches,
                "k3": poa_fused_kernels.launches}
    k1p = by_plan(poa_kernels.launches_by_shape)
    k2p = by_plan(align_kernels.launches_by_shape)
    child_launches = {k: sum(b[f"{k}_launches"] for b in on_child.values())
                      for k in ("k1", "k2", "k3")}
    out["b"].update(journal_lines=len(entries), stages=stages,
                    launches=launches, child_launches=child_launches)
    log(f"[chip_smoke] autoscale path b: scaled down, the replica exited "
        f"({out['b']['exit_code']}); journal {len(entries)} lines, "
        f"consistent, autoscale ledger balanced; tracereport checks clean, "
        f"job {held}'s stages {stages[held]}; launches here {launches}, "
        f"in the spawned replica {child_launches}")

    # ---- c. the fullest K1 batch of the server
    if not cap.k1:
        fail("c", "the server launched no K1 batch")
    (nbk, lbk), (n, plan, args) = max(cap.k1.items(),
                                      key=lambda kv: kv[1][0])
    torch.cuda.synchronize()
    held_k1 = hold_k1(args, nbk, lbk, f"the autoscale path's fullest "
                      f"{(nbk, lbk)} batch", widths=(plan[0],))[plan]
    out["k1_fullest"] = {"shape": [nbk, lbk], "jobs": n,
                         "plan": plan_name(*plan), **held_k1}
    log(f"[chip_smoke] autoscale path c: the server's fullest K1 batch, "
        f"{(nbk, lbk)} {plan_name(*plan)} with {n} jobs, identical to the "
        f"plain version; kernel {held_k1['ms']:.3f} ms, plain "
        f"{held_k1['plain_ms']:.1f} ms, bound {held_k1['bound_ms']:.4f} ms "
        f"({held_k1['bound_by']}); card {card}")
    report["autoscale_path"] = out
    return ((launches["k1"] + child_launches["k1"], k1p),
            (launches["k2"] + child_launches["k2"], k2p))


#: phase 19's faultcheck columns (every quick row in each) and its
#: servebench run: the default mode at a small size, the artifact under
#: build/
TOOLS_COLUMNS = ("depth2", "depth2+fused", "serve")
SERVEBENCH_ARGS = ["--device", "cuda", "--jobs", "2", "--cold-runs", "1",
                   "--genome-kb", "20", "--contigs", "4", "-c", "1",
                   "--cudaaligner-batches", "1"]


def tools_path(dev, workdir, report):
    """Phase 19: the operator tools faultcheck and servebench on the card,
    through their own functions (racon_tpu_torch/tools/):

      a. faultcheck: its range section (a one-contig job range-sharded
         over two `serve --device cuda -c 1 --cudaaligner-batches 1`
         replica processes, started at once, one killed with `kill -9`
         mid-job; each finished shard must have launched K1 and K2 in
         its replica) runs in a thread beside the rest, which starts no
         worker thread of its own, so the grid's orphan checks see none
         of it; meanwhile the grid's clean gates at depth 2 (the fused
         engine's `cuda_fused` 0 against 1), every quick row of MATRIX
         in TOOLS_COLUMNS (each cell through `run_cell` /
         `run_serve_cell`), then the audit section. Every cell must be
         green. The in-process launches are counted over the grid and
         the audit: K2 (the aligner rows) and K3 (the fused column) must
         be launched; K1 is counted where the audit's oracle and the
         session engine run it. Then, while the range section still
         runs, the fullest K2 batch of each shape the grid launched is
         held against its plain version at every instantiation
         (hold_fullest_k2);
      b. servebench's default mode (SERVEBENCH_ARGS: a cold CLI run as a
         `python -m racon_tpu_torch --device cuda` process, the warm
         server in this process), beside the range section's tail (its
         replicas stalled on `hang=8`), must exit 0 with K1 and K2 launched on
         the warm server; its artifact goes to build/. Printed: the cold
         wall, the warm p50, the wave's p50 and the gates. Then the
         fullest K2 batch of each shape the warm server launched is held
         at the instantiation it ran, unless this run held that shape
         and instantiation before on a batch at least as full.

    Returns {"faultcheck": ((K1 launches, by instantiation), (K2 ...),
    {"<dtype> faultcheck": K3 launches}), "servebench": ((K1 ...),
    (K2 ...))}."""
    import threading

    from racon_tpu_torch.device import card_info
    from racon_tpu_torch.ops import align_kernels, poa_fused_kernels
    from racon_tpu_torch.ops import poa_kernels
    from racon_tpu_torch.tools import faultcheck as fc
    from racon_tpu_torch.tools import servebench

    card = card_info()
    out: dict = {}
    tmp = os.path.join(workdir, "tools")
    rtmp = os.path.join(tmp, "range")
    os.makedirs(rtmp)

    def fail(part, msg):
        raise SystemExit(f"tools path {part}: {msg}")

    def reset():
        poa_kernels.reset_launches()
        align_kernels.reset_launches()
        poa_fused_kernels.reset_launches()

    def counts():
        return ((poa_kernels.launches, by_plan(poa_kernels.launches_by_shape)),
                (align_kernels.launches,
                 by_plan(align_kernels.launches_by_shape)),
                {f"{dt} faultcheck": n for dt, n in k3_by_dtype().items()})

    # ---- a. faultcheck
    ranged: dict = {"detail": {}}

    def range_section():
        t = time.perf_counter()
        try:
            ranged["cells"] = fc.run_range_cells(rtmp, "cuda",
                                                 ranged["detail"])
        except BaseException as exc:  # noqa: BLE001 — reported below
            ranged["cells"] = [("range", f"FAIL crashed ({exc})")]
        ranged["wall_s"] = time.perf_counter() - t

    reset()
    ta = time.perf_counter()
    t_range = threading.Thread(target=range_section, daemon=True)
    t_range.start()
    try:
        paths = fc.make_dataset(tmp, random.Random(11))
        grid = fc.Grid(paths, "cuda", os.path.join(tmp,
                                                   "autotune_cold.json"))
        with PathCapture() as cap_a:
            bad = grid.clean_gates(depths=(2,), columns=TOOLS_COLUMNS)
            if bad:
                fail("a", f"clean gates: {bad}")
            rows = [m for m in fc.MATRIX if not m[3]]
            t0 = time.perf_counter()
            cells = fc.run_grid(grid, rows, TOOLS_COLUMNS, tmp)
            grid_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            audit = fc.run_audit_cells(tmp, paths, "cuda")
            audit_s = time.perf_counter() - t0
        (k1, k1p), (k2, k2p), k3 = counts()
        # the grid's K2 batches, held after the counts were read, while
        # the range section (which launches nothing in this process)
        # still runs
        th = time.perf_counter()
        held_a, _ = hold_fullest_k2(dev, cap_a, "faultcheck grid",
                                    every=True)
        hold_a_s = time.perf_counter() - th
        del cap_a
        grid_done_s = time.perf_counter() - ta

        # ---- b. servebench, beside the range section's tail (its job
        # stalls on `hang=8`, then its replicas are killed)
        art = os.path.join(HERE, "build", "servebench_phase19.json")
        os.makedirs(os.path.dirname(art), exist_ok=True)
        reset()
        tb = time.perf_counter()
        with PathCapture() as cap_b:
            rc = servebench.main(SERVEBENCH_ARGS + ["--json", art])
        sb_s = time.perf_counter() - tb
        (s1, s1p), (s2, s2p), _ = counts()
        range_left = t_range.is_alive()
    finally:
        # the section kills its replica processes when it ends: wait for
        # it whatever failed here, so no process outlives the phase
        t_range.join(600)
    if t_range.is_alive():
        fail("a", "the range section did not end")
    fc_s = max(grid_done_s, ranged["wall_s"])
    red = [(name, col, cell) for name, row in cells
           for col, cell in zip(TOOLS_COLUMNS, row)
           if not cell.startswith("pass")]
    red += [(name, "section", cell) for name, cell in
            audit + ranged["cells"] if not cell.startswith("pass")]
    for name, row in cells:
        log(f"[chip_smoke] tools path a: {name:<28} "
            + " | ".join(f"{c}: {cell}" for c, cell in
                         zip(TOOLS_COLUMNS, row)))
    for name, cell in audit + ranged["cells"]:
        log(f"[chip_smoke] tools path a: {name:<28} {cell}")
    if red:
        fail("a", f"red cells: {red}")
    if k2 <= 0 or sum(k3.values()) <= 0:
        fail("a", f"the grid launched no K2 or no K3: K2 {k2}, K3 {k3}")
    # the range cell held each shard to K1 and K2 launches in its
    # replica process (the shards' serve batches, from the survivor)
    child = {k: sum(b.get(f"{k}_launches", 0)
                    for b in ranged["detail"].get("shards", ()))
             for k in ("k1", "k2", "k3")}
    n_cells = len(rows) * len(TOOLS_COLUMNS) + len(audit) + len(ranged[
        "cells"])
    if not held_a:
        fail("a", "the grid's K2 batches were not captured for a hold")
    log_held("faultcheck grid", held_a)
    out["a"] = {"cells": n_cells, "grid_s": grid_s, "audit_s": audit_s,
                "range_s": ranged["wall_s"], "wall_s": fc_s,
                "range_cell_s": ranged["detail"].get("wall_s"),
                "grid": {name: row for name, row in cells},
                "sections": dict(audit + ranged["cells"]),
                "launches": {"k1": k1, "k2": k2, "k3": k3},
                "range_replica_launches": child,
                "k2_held": held_a, "hold_s": hold_a_s}
    log(f"[chip_smoke] tools path a: faultcheck on cuda, {n_cells} cells "
        f"green ({len(rows)} quick rows x {TOOLS_COLUMNS}, the audit and "
        f"the range section); grid {grid_s:.3f} s, audit {audit_s:.3f} s, "
        f"range section {ranged['wall_s']:.3f} s (beside them and the "
        f"hold), in all "
        f"{fc_s:.3f} s; launches K1 {k1} {k1p}, K2 {k2} {k2p}, K3 {k3}; "
        f"the range section's replica processes K1 {child['k1']}, K2 "
        f"{child['k2']} (the shards that finished); {len(held_a)} K2 "
        f"batch shape(s) held in {out['a']['hold_s']:.3f} s; card {card}")

    # ---- b. servebench's verdict
    with open(art) as fh:
        doc = json.load(fh)
    if rc != 0 or not doc["pass"]:
        fail("b", f"servebench exited {rc}: {doc}")
    if s1 <= 0 or s2 <= 0:
        fail("b", f"the warm server launched no K1 or no K2: {s1}, {s2}")
    # the warm server's K2 batches, held after the counts were read
    th = time.perf_counter()
    held_b, _ = hold_fullest_k2(dev, cap_b, "servebench warm server",
                                once=True)
    del cap_b
    if not held_b:
        fail("b", "the warm server's K2 batches were not captured for a "
                  "hold")
    log_held("servebench warm server", held_b)
    w = doc["warm"]
    out["b"] = {"wall_s": sb_s, "cold_p50_s": doc["cold"]["p50_s"],
                "warm_seq_p50_s": w["seq_p50_s"], "wave_p50_s": w["p50_s"],
                "wave_s": w["wave_s"], "warmup_s": w["warmup_s"],
                "ttfb_p50_s": w["ttfb_p50_s"],
                "compiles_per_job": w["compiles_per_job"],
                "journal": doc["journal"], "speedup_p50": doc["speedup_p50"],
                "device": doc.get("device"),
                "beside_range_section": range_left,
                "launches": {"k1": s1, "k2": s2},
                "k2_held": held_b, "hold_s": time.perf_counter() - th}
    log(f"[chip_smoke] tools path b: servebench {' '.join(SERVEBENCH_ARGS)}"
        f" passed in {sb_s:.3f} s ("
        f"{'beside' if range_left else 'after'} the range section's "
        f"tail): cold CLI {doc['cold']['p50_s']:.3f} s, "
        f"warm p50 {w['seq_p50_s']:.3f} s (x{doc['speedup_p50']}), the "
        f"wave's p50 {w['p50_s']:.3f} s (time to first byte "
        f"{w['ttfb_p50_s']} s); gates: warm beats cold, first dispatches "
        f"a job {w['compiles_per_job']}, FASTA equal to the cold bytes, "
        f"progress and result_part frames, journal consistent "
        f"{doc['journal']['consistent']}; warm server launches K1 {s1} "
        f"{s1p}, K2 {s2} {s2p}; of its {len(held_b)} K2 batch shapes "
        f"{sum('held_before' not in r for r in held_b)} held here (in "
        f"{out['b']['hold_s']:.3f} s), the rest earlier in the run; card "
        f"{card}")
    report["tools_path"] = out
    # the range replicas' launches count for the path, unsplit by
    # instantiation (their jobs report none), as phase 18's child's do
    return {"faultcheck": ((k1 + child["k1"], k1p),
                           (k2 + child["k2"], k2p), k3),
            "servebench": ((s1, s1p), (s2, s2p))}


if __name__ == "__main__":
    sys.exit(main())
