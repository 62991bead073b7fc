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
  4. golden: `python -m racon_tpu_torch -c 1` on the 50 kb, 20x, seed 42
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
     (128 rows) is held against the plain version on all 11 state
     arrays and timed against its bound, and the whole fused launch of
     the shallowest chunk that chains two calls or more, on a slice of
     its first 8 rows, is held likewise; K3 is
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

Prints per-phase numbers, then the kernel line (K1 and K2: launches on
the contig path of phase 5 at depth 2, the N-base path of phase 5b, the
fragment path of phase 8, the fused path of phase 9, the runs of phase
10, all of phase 11 (path `autotune`) and of phase 12 (path `hooks`),
in all, by path and by instantiation; K3: launches on the four runs of
phase 9, the fused runs of phases 10 and 12 and phase 11), the
card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Exits non-zero without a result when no
CUDA device is present or when run outside the repository. Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import tempfile
import time

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

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    notb = build_without_traceback("poa_window_sweep.cu",
                                   "rt_poa_window_sweep", 11, 9)
    notb2 = build_without_traceback("align_wavefront.cu",
                                    "rt_align_wavefront", 8, 6)
    k3stg = build_k3_stages()
    _build.kernels()
    k_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    native.get_lib()
    n_s = time.perf_counter() - t1
    log(f"[chip_smoke] build: kernels {k_s:.2f} s "
        f"({'cached' if _build.build_info.get('cached') else 'nvcc'}), "
        f"host library {n_s:.2f} s; card {card}")
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
    phase("4 golden", check_golden, workdir, report)
    phase("4 fragment golden", check_fragment_golden, workdir, report)
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
    log(f"[chip_smoke] phase walls (s): "
        f"{ {k: round(v, 2) for k, v in walls.items()} }; card {card}")
    for k, *paths in zip(kernels, contig, nbases, fragment, (k1f, k2f),
                         (k1a, k2a), (k1t, k2t), (k1h, k2h)):
        by_path = dict(zip(("contig", "nbases", "fragment", "fused",
                            "adaptive", "autotune", "hooks"), paths))
        k["launches"] = sum(n for n, _ in paths)
        k["launches_by_path"] = {p: n for p, (n, _) in by_path.items()}
        k["launches_by_plan"] = {p: pl for p, (_, pl) in by_path.items()}
        for row in k["instantiations"]:
            row["launches"] = sum(pl.get(row["plan"], 0)
                                  for _, pl in paths)
    for runs in (k3a, k3t, k3h):
        k3["launches"] += sum(runs.values())
        k3["launches_by_path"].update(runs)
        for row in k3["instantiations"]:
            row["launches"] += sum(n for name, n in runs.items()
                                   if name.startswith(row["plan"])
                                   or (row["plan"] == "int32"
                                       and name.startswith("fused ")))
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


def hold_k2(edge, band, a8, ap, what: str, time_it: bool = True,
            widths=None) -> dict:
    """K2 against its plain version on one batch at every instantiation
    the edge allows (int16 where the overflow proof holds, packed when
    `ap` is given): the plain version once per score width, both operand
    forms held against it (ops[:count], count, distance, touched). Exits
    on a difference. Returns {plan: row}, each with the kernel's
    CUDA-event ms (mean of 2 after a warm-up), the plain version's
    host-clocked ms, the bound and the band-touched pairs."""
    import torch

    from racon_tpu_torch.ops.align import banded_nw, traceback
    from racon_tpu_torch.ops.dtypes import aligner_int16_ok

    if widths is None:
        widths = ("int32", "int16") if aligner_int16_ok(edge) else \
            ("int32",)
    q, t, ql, tl, offs = a8
    rows = {}
    for dtype in widths:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bp, dist = banded_nw(q, t, ql, tl, offs, band, dtype)
        w_ops, w_meta = traceback(bp, dist, offs, ql, tl, band)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
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
            row = {"plain_ms": plain_ms, "err": err,
                   "touched": int(meta[:, 2].sum())}
            if time_it:
                row["ms"] = cuda_ms(lambda: align_k2(a, band, plan), reps=2)
                row["bound_ms"], row["bound_by"] = wavefront_bound(
                    ql, tl, offs, band, meta[:, 0], packed)
            rows[plan] = row
    return rows


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
    for kind, (edge, band, idx, args, plan) in cases:
        a8, ap = k2_forms(al, pairs, edge, band, idx)
        rows = hold_k2(edge, band, a8, ap,
                       f"the {kind} ({edge}, {band}) batch",
                       time_it=kind == "fullest")
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
                                      "plain_ms": 0.0, "bound_ms": 0.0,
                                      "bound_by": by})
            for k in ("ms", "plain_ms", "bound_ms"):
                acc[k] += x[k]
            acc["batches"] += 1
            acc["bound_by"] = x["bound_by"]
        rows_out.append({
            "kind": kind, "edge": edge, "band": band, "pairs": len(idx),
            "plan": plan_name(*plan),
            "instantiations": {plan_name(*p): x for p, x in rows.items()},
            "ms": ms, "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
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
    for edge, band, adv_pairs, label in adversarial_pairs():
        idx = list(range(len(adv_pairs)))
        a8, ap = k2_forms(al, adv_pairs, edge, band, idx)
        rows = hold_k2(edge, band, a8, ap,
                       f"the adversarial ({edge}, {band}) batch {label}")
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
            "plain_ms": sum(r["plain_ms"] for r in main_rows),
            "bound_ms": sum(r["bound_ms"] for r in main_rows),
            "bound_by": by, "library_ms": None,
            "instantiations": [{"plan": plan_name(*p), **inst[p]}
                               for p in PLANS if p in inst]}


def run_golden(flags, paths, golden: str) -> float:
    """`python -m racon_tpu_torch` with `flags` on `paths` must write the
    committed tests/data/`golden` byte for byte. Returns its seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "racon_tpu_torch", *flags, "-m", "5", "-x",
         "-4", "-g", "-8", "-t", str(os.cpu_count()),
         "--cuda-autotune-table", COLD_TABLE, *paths],
        cwd=HERE, capture_output=True, timeout=600)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr.decode(errors="replace")[-4000:])
        raise SystemExit(f"golden run {flags} failed (rc {proc.returncode})")
    with open(os.path.join(HERE, "tests", "data", golden), "rb") as fh:
        if proc.stdout != fh.read():
            raise SystemExit(f"golden: {flags} output differs from "
                             f"tests/data/{golden}")
    return time.perf_counter() - t0




def check_golden(workdir, report) -> None:
    """Phase 4: the CLI at -c 1 (device POA, host aligner, -b off) must
    reproduce the committed 50 kb golden byte for byte, at the default
    posture and pipeline depth, at --cuda-pipeline-depth 0 and at
    --cuda-dtype int32; then the traced run (check_trace_metrics)."""
    from racon_tpu_torch.synth import simulate, write_dataset

    rng = random.Random(42)
    _, draft, reads, paf = simulate(rng, 50_000, 20, 8000, 0.12, 0.10)
    d = os.path.join(workdir, "w50")
    os.makedirs(d)
    paths = write_dataset(d, draft, reads, paf)
    report["golden_s"] = {}
    for flags in (["-c", "1"], ["-c", "1", "--cuda-pipeline-depth", "0"],
                  ["-c", "1", "--cuda-dtype", "int32"]):
        s = run_golden(flags, paths, "synth_50kb_golden.fasta")
        log(f"[chip_smoke] golden: 50 kb x 20x {' '.join(flags)} "
            f"byte-identical to the committed golden ({s:.1f} s)")
        report["golden_s"][" ".join(flags)] = s
    check_trace_metrics(d, paths, report)


def check_trace_metrics(d, paths, report) -> None:
    """`python -m racon_tpu_torch -c 1 --cudaaligner-batches 1` with
    --cuda-trace and --cuda-metrics on `paths`: the trace must load as
    Chrome trace JSON holding the pipeline's pack / device / unpack spans
    of the aligner loop and the session's spans, and the dump must hold
    the pipeline namespace with the aligner's chunks and launches."""
    trace_path = os.path.join(d, "trace.json")
    metrics_path = os.path.join(d, "metrics.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "racon_tpu_torch", "-c", "1",
         "--cudaaligner-batches", "1", "-m", "5", "-x", "-4", "-g", "-8",
         "-t", str(os.cpu_count()), "--cuda-trace", trace_path,
         "--cuda-metrics", metrics_path, "--cuda-autotune-table",
         COLD_TABLE, *paths],
        cwd=HERE, capture_output=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or not proc.stdout.startswith(b">"):
        sys.stderr.write(proc.stderr.decode(errors="replace")[-4000:])
        raise SystemExit(f"traced CLI run failed (rc {proc.returncode})")
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
        f"depth 2) in {wall:.1f} s: trace of {len(events)} events, spans "
        f"{dict(sorted(spans.items()))}; metrics namespaces "
        f"{sorted(metrics)}, pipeline {pipe}")
    report["traced_cli"] = {"wall_s": wall, "spans": spans,
                            "pipeline": pipe,
                            "namespaces": sorted(metrics)}


def check_fragment_golden(workdir, report) -> None:
    """Phase 4b: the CLI at -f -c 1 (device POA, host aligner, -b off)
    must reproduce the committed fragment golden byte for byte: 50 reads
    of 8 kb off a 40 kb genome at 10x, with their all-vs-all overlaps."""
    from racon_tpu_torch.synth import (ava_overlaps, simulate_truth,
                                       write_fragment_dataset)

    _, _, reads, _ = simulate_truth(random.Random(42), 40_000, 10, 8000,
                                    0.12, 0.10)
    d = os.path.join(workdir, "frag40")
    os.makedirs(d)
    paths = write_fragment_dataset(d, reads, ava_overlaps(reads))
    report["fragment_golden_s"] = {}
    for flags in (["-f", "-c", "1"],
                  ["-f", "-c", "1", "--cuda-pipeline-depth", "0"]):
        s = run_golden(flags, paths, "synth_frag_golden.fasta")
        log(f"[chip_smoke] fragment golden: {len(reads)} reads of 8 kb "
            f"{' '.join(flags)} byte-identical to the committed golden "
            f"({s:.1f} s)")
        report["fragment_golden_s"][" ".join(flags)] = s




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
    (for replay_contig). Both call through, so every launch is the run's
    own and is counted where it launches."""

    def __init__(self, keep_all: bool = False):
        self.keep_all = keep_all
        #: ((nb, lb), plan, inputs) of every K1 batch, with keep_all
        self.k1_batches: list = []
        self.k1: dict = {}          # (nb, lb) -> (real jobs, plan, inputs)
        self.k1_jobs = 0
        self.align_calls: list = []
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

        def _dispatch(eng, jobs, sel, nb, lb, B):
            cap._n = len(sel)
            cap.k1_jobs += len(sel)
            return dispatch(eng, jobs, sel, nb, lb, B)

        def _run_bucket(eng, nb, lb, *args):
            plan = (eng.plan_for(nb, lb), args[0].dtype == torch.uint8)
            if cap.keep_all:
                cap.k1_batches.append(((nb, lb), plan,
                                       [a.clone() for a in args]))
            if cap._n > cap.k1.get((nb, lb), (0,))[0]:
                cap.k1[(nb, lb)] = (cap._n, plan, [a.clone() for a in args])
            return run_bucket(eng, nb, lb, *args)

        def _align(al, pairs, progress=None, **kw):
            cap.align_calls.append(pairs)
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


def hold_captured(dev, cap, label: str):
    """The fullest batch of each K1 bucket and of each K2 (edge, band)
    that a captured run (PathCapture) launched, held against its
    plain version at the instantiation it ran, timed, and checked at both
    widths where int16 holds. Returns (rows, cross-width batches)."""
    import torch

    from racon_tpu_torch.ops.align import BatchAligner
    from racon_tpu_torch.ops.dtypes import aligner_int16_ok

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
    # the fullest batch of each K2 (edge, band), as the polishers batched
    # their pairs
    fullest: dict = {}
    for pairs in cap.align_calls:
        for edge, band, idx in BatchAligner(device=dev).chunks(pairs):
            if len(idx) > fullest.get((edge, band), (0,))[0]:
                fullest[(edge, band)] = (len(idx), pairs, idx)
    al = BatchAligner(device=dev)
    for (edge, band), (n, pairs, idx) in sorted(fullest.items()):
        args = al.operands(pairs, edge, band, idx)
        plan = (al.plan_for(edge, band), args[0].dtype == torch.uint8)
        a8 = args if not plan[1] else al.operands(pairs, edge, band, idx,
                                                  pack=False)
        held = hold_k2(edge, band, a8, args if plan[1] else None,
                       f"the {label}'s fullest ({edge}, {band}) batch",
                       widths=(plan[0],))
        r = held[plan]
        if aligner_int16_ok(edge):
            cross_width_k2(args, band, plan[1], f"the {label}'s "
                           f"fullest ({edge}, {band}) batch")
            n_cross += 1
        rows.append({"kernel": "K2", "shape": [edge, band], "pairs": n,
                     "plan": plan_name(*plan), "touched": r["touched"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]})
        del args, a8
    for r in rows:
        log(f"[chip_smoke] {label} {r['kernel']} fullest batch at "
            f"{tuple(r['shape'])}, {r['plan']}: "
            + (f"{r['jobs']} jobs / {r['rows']} rows"
               if r["kernel"] == "K1" else
               f"{r['pairs']} pairs ({r['touched']} band-touched)")
            + f" identical; kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    log(f"[chip_smoke] {label} cross-width check: {n_cross} fullest "
        f"batches of int16 shapes identical at int16 and int32")
    return rows, n_cross


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
    the deepest chunk's second chained call at full width is held
    against the plain version on all 11 state arrays (and timed, with
    its bound), the whole fused launch of the shallowest chunk that
    chains two calls or more on a slice of its first 8 rows likewise, K3
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
    from racon_tpu_torch.ops.poa_fused import STATE, FusedPOA, fused_raw
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
        k_state = [t.clone() for t in state0]
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        k_state = launch(k_state, ops, done1, eng.B)
        b.record()
        torch.cuda.synchronize()
        k_ms = a.elapsed_time(b)
        t0 = time.perf_counter()
        lb = torch.full((eng.B,), done1, dtype=torch.int32, device=dev)
        p_state = fused_raw(eng.N, eng.L, d1, eng.P, *scores,
                            score_dtype=dtype)(*state0, *ops, lb)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        for nm, x, y in zip(STATE, k_state, p_state):
            if not torch.equal(x, y):
                raise SystemExit(f"K3 {dtype}: {nm} differs from the plain "
                                 f"version on the deepest chunk's second "
                                 f"chained call")
        bms, by = fused_bound(state0, ops, done1, scores, dtype)
        held = [f"the deepest chunk's second chained call ({d1} layers "
                f"from layer {done1} x {eng.B} rows)"]
        # the whole fused launch of the shallowest chunk whose chain
        # takes two calls or more, on a slice of its first 8 rows (all
        # its rows would take the plain version many minutes; the deepest
        # chunk's 48 layers took it a minute a width)
        plans = [eng._chain_plan(max(len(windows[i]) - 1 for i in c))
                 for c in chunks]
        ci = min((k for k, pl in enumerate(plans) if len(pl) >= 2),
                 key=lambda k: sum(plans[k]))
        first = chunks[ci][:8]
        rs = len(first)
        eng8 = FusedPOA(*scores, device=dev, batch_rows=rs, fused="1")
        Ds = sum(plans[ci])
        st8, ops8 = eng8._pack_chunk_fused(windows, first, Ds)
        s8, o8 = to_dev(st8), to_dev(ops8)
        k8 = launch([t.clone() for t in s8], o8, 0, rs)
        t0 = time.perf_counter()
        p8 = fused_raw(eng.N, eng.L, Ds, eng.P, *scores, score_dtype=dtype,
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
        held.append(f"chunk {ci}'s fused launch ({Ds} layers x {rs} "
                    f"rows)")
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
    # shapes are phases 2 and 3's)
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
    for (edge, band), (n, pairs, idx) in sorted(fullest.items()):
        if edge in BatchAligner.BUCKETS:
            continue
        part = idx[:16] if edge > 2048 else idx
        a8, ap = k2_forms(al, pairs, edge, band, part)
        dtype = al.plan_for(edge, band)
        held = hold_k2(edge, band, a8, ap, f"the adaptive path's fullest "
                       f"({edge}, {band}) batch", widths=(dtype,))
        for p, r in held.items():
            rows.append({"kernel": "K2", "shape": [edge, band], "pairs": n,
                         "held_rows": len(part), "plan": plan_name(*p),
                         "max_abs_err": r["err"], "touched": r["touched"],
                         "ms": r["ms"], "plain_ms": r["plain_ms"],
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
            f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
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


if __name__ == "__main__":
    sys.exit(main())
