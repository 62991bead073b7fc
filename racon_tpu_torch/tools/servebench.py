"""The serve benchmark: a warm server's jobs against cold one-shot CLI
runs, and the fleet modes.

    python -m racon_tpu_torch.tools.servebench [--device cuda|cpu]
        [--jobs N] [--cold-runs N] [--genome-kb KB] [--contigs N]
        [-c N] [--cudaaligner-batches N] [--json PATH] [mode flags]

The default run starts one `PolishServer` (warmed on the benchmark's own
inputs), submits the jobs through `PolishClient`, and compares them with
sequential cold runs of `python -m racon_tpu_torch --device <dev>`, each
a fresh process paying the interpreter, `import torch`, the CUDA context,
the libraries' load and the engines' construction: the tax a warm server
saves. The kernels and the host library are built in this process before
any cold run, so no cold wall includes a build. Two warm phases:

  - sequential warm submits, the like-for-like twin of the cold runs:
    their p50 must beat the cold p50;
  - a concurrent wave of N submits, streamed: shared iterations, queue
    wait against execution, time to first progress frame and to first
    `result_part` frame (reported, not gated on speed).

The exit status is 0 only when the sequential warm p50 beats the cold
p50, no warm job first-dispatched a launch shape (`compiles`, the
scheduler's telemetry, sched/telemetry.py), every warm FASTA equals the
cold CLI's bytes, every wave job saw a progress frame and a
`result_part` frame before its result, and the servers' journals pass
`check_consistency` and obsreport's `check_parts_streamed`. `--json
PATH` writes the artifact with the JAX tool's field names; on `cuda` it
also carries `device.card_info` (the card's name and power limit).

Modes (each with its own artifact block and gates, as in the JAX tool):

  --check-slo     one wave with per-job deadlines: p99, the deadline-miss
                  rate from the server's own accounting, a live scrape
  --fleet N       N in-process servers, the wave round-robined over them,
                  the fleet aggregator polling them mid-wave (`fleet`)
  --router N      N replica processes behind the router at 1, 2, 4 ... N
                  replicas: jobs/s, requeues, merge overhead, identity,
                  `range_scaling_x` and a traced A/B (`router`, `trace`)
  --ramp N        Poisson load ramping 1x -> 10x through a router whose
                  autoscaler may grow to N replicas, then a trickle while
                  it drains back (`autoscale`)
  --audit-rate R  the identity audit armed, with an interleaved on / off
                  A/B of the sequential jobs (`audit`)
  --rounds N      a rounds=N job on a cache-off and a cache-on server,
                  and a resubmit (`rounds`, `cache`)
  --fragment N    N fragment jobs against a contig wave (`fragment`)
  --flood N       N free-tenant submitters flooding two routed replicas
                  while gold waves measure p99, then doomed aborts (`qos`)
  --qps R, --qps-curve R1,R2,...
                  open-loop Poisson arrivals at each rate, and the
                  saturation knee (`openloop`)
  --baseline PATH a prior artifact embedded and compared (`baseline`)

The fleet modes spawn replicas as processes (`python -m racon_tpu_torch
serve --device <dev>`), each one's stderr in a log in the mode's
temporary directory, printed when the replica fails to start. There
`--device-latency-ms`, `--device-latency-x` and `--host-poa-chunk` reach
every replica as its `--device-latency-s`, `--device-latency-x` and
`--host-poa-chunk` flags: a simulated per-chunk device round trip, slept
off the CPU, so scaling is measured where the device sets the pace.
Every knob is a flag; no environment variable sets any.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_dataset(tmpdir: str, genome_kb: int, coverage: int,
                  read_len: int, seed: int, contigs: int = 1):
    """The synthetic ONT-style workload (synth.simulate: 12% read error,
    10% draft error), written byte for byte as the JAX tool writes it
    for the same arguments. `contigs` > 1 splits the genome budget over
    that many independent contigs, so the first contig's bytes stream
    while later ones polish."""
    from ..synth import simulate

    all_reads, all_paf, drafts = [], [], []
    per_contig = max(1, genome_kb // max(1, contigs))
    for c in range(max(1, contigs)):
        rng = random.Random(seed + 1000 * c)
        _, draft, reads, paf = simulate(rng, per_contig * 1000, coverage,
                                        read_len, 0.12, 0.10)
        tag = f"c{c}_" if contigs > 1 else ""
        cname = f"draft{c}" if contigs > 1 else "draft"
        drafts.append((cname, draft))
        for name, read in reads:
            all_reads.append((tag + name, read))
        for line in paf:
            fields = line.split("\t")
            fields[0] = tag + fields[0]
            fields[5] = cname
            all_paf.append("\t".join(fields))
    paths = (os.path.join(tmpdir, "reads.fasta.gz"),
             os.path.join(tmpdir, "ovl.paf.gz"),
             os.path.join(tmpdir, "draft.fasta.gz"))
    with gzip.open(paths[0], "wb", compresslevel=1) as f:
        for name, read in all_reads:
            f.write(b">" + name.encode() + b"\n" + read + b"\n")
    with gzip.open(paths[1], "wb", compresslevel=1) as f:
        f.write(("\n".join(all_paf) + "\n").encode())
    with gzip.open(paths[2], "wb", compresslevel=1) as f:
        for cname, draft in drafts:
            f.write(b">" + cname.encode() + b"\n" + draft + b"\n")
    return paths


def merge_fleet_snaps(snaps: list[dict]) -> dict:
    """N replicas' stats snapshots as one: the queue and SLO counters
    sum (the gated miss rate sees every replica's deadlines), the
    batcher's activity counters sum, its high-water marks take the
    maximum, and lane rows concatenate tagged with their replica. What
    does not add (occupancy, latency percentiles, tenants) stays replica
    0's."""
    if len(snaps) == 1:
        return snaps[0]
    out = json.loads(json.dumps(snaps[0]))  # a deep, JSON-shaped copy
    q, b, slo = out["queue"], out["batcher"], out["slo"]
    q_sum = ("submitted", "admitted", "rejected_full",
             "rejected_draining", "rejected_quota", "expired",
             "completed", "failed", "deadline_hit", "deadline_miss",
             "depth")
    b_sum = ("iterations", "shared_iterations", "solo_iterations",
             "jobs", "windows", "host_s", "compiles", "compile_s")
    for lane in b.get("lanes") or []:
        lane["replica"] = 0
    for r, s in enumerate(snaps[1:], start=1):
        for k in q_sum:
            if k in s["queue"]:
                q[k] = q.get(k, 0) + s["queue"][k]
        for k in ("deadline_hit", "deadline_miss", "expired"):
            slo[k] += s["slo"][k]
        sb = s["batcher"]
        for k in b_sum:
            if k in sb:
                b[k] = b.get(k, 0) + sb[k]
        for k, v in sb.items():
            if k.startswith("max_"):
                b[k] = max(b.get(k, 0), v)
        b["lanes"] = (b.get("lanes") or []) + [
            dict(lane, replica=r) for lane in (sb.get("lanes") or [])]
        out["inflight"] += s.get("inflight", 0)
    deadlined = slo["deadline_hit"] + slo["deadline_miss"]
    slo["miss_rate"] = (round(slo["deadline_miss"] / deadlined, 4)
                        if deadlined else 0.0)
    return out


def lane_devices(device: str, lanes: int):
    """The device list of a server with `lanes` worker lanes: the CPU
    repeated, or the visible cards round-robin (two lanes share one card
    when it is the only one)."""
    import torch

    if device == "cpu":
        return [torch.device("cpu")] * lanes
    n = max(1, torch.cuda.device_count())
    return [torch.device("cuda", i % n) for i in range(lanes)]


def _mesh_block(batcher_snap: dict, devices) -> dict:
    """The artifact's `mesh` block (parallel/mesh.mesh_info) over the
    server's device list (None: every visible card), with the batcher's
    lane count."""
    from ..parallel.mesh import mesh_info

    return mesh_info(worker_lanes=batcher_snap.get("worker_lanes", 1),
                     devices=devices)


def server_kw(args) -> dict:
    """The PolishServer keywords every mode shares."""
    return dict(workers=args.workers, warmup=False,
                job_threads=args.threads, device=args.device,
                cuda_poa_batches=args.cudapoa_batches,
                cuda_aligner_batches=args.cudaaligner_batches)


def replica_flags(args) -> list[str]:
    """The `serve` flags of a bench replica process (the fleet modes run
    replicas as processes: N servers in one interpreter share one GIL and
    can only measure overhead, never scaling); the latency knobs reach it
    as flags. serve/autoscale.spawn_replica starts it, its stderr in a
    log beside its socket."""
    flags = ["--device", args.device, "--workers", str(args.workers),
             "--no-warmup", "-t", str(args.threads),
             "-c", str(args.cudapoa_batches),
             "--cudaaligner-batches", str(args.cudaaligner_batches)]
    if args.device_latency_ms:
        flags += ["--device-latency-s", str(args.device_latency_ms / 1000.0)]
    if args.device_latency_x:
        flags += ["--device-latency-x", str(args.device_latency_x)]
    if args.host_poa_chunk:
        flags += ["--host-poa-chunk", str(args.host_poa_chunk)]
    return flags


def wait_replica(sock: str, proc) -> None:
    """Raise with the replica's stderr unless it answers a clean healthz
    (serve/autoscale.wait_replica_ready) within 120 s."""
    from ..serve.autoscale import replica_log_tail, wait_replica_ready

    if not wait_replica_ready(sock, proc, 120.0):
        raise RuntimeError(f"replica {sock} never came up; its stderr:\n"
                           f"{replica_log_tail(sock)}")


def build_libraries(device: str) -> None:
    """Build (or find built) the host library and, on a card, the
    kernels, so that no timed cold run pays a build."""
    from .. import native

    native.get_lib()
    if device != "cpu":
        from .. import _build

        _build.kernels()


def cold_cli_run(paths, args) -> tuple[float, bytes]:
    """One fresh-process one-shot run: the whole cold tax, wall-clocked."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    cmd = [sys.executable, "-m", "racon_tpu_torch", "--device",
           args.device, "-t", str(args.threads)]
    if args.cudapoa_batches:
        cmd += ["-c", str(args.cudapoa_batches)]
    if args.cudaaligner_batches:
        cmd += ["--cudaaligner-batches", str(args.cudaaligner_batches)]
    cmd += list(paths)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stderr.decode(errors="replace"), file=sys.stderr)
        raise SystemExit(f"[servebench] cold CLI run failed "
                         f"(rc {proc.returncode})")
    return dt, proc.stdout


def _write(args, artifact: dict) -> None:
    if args.device != "cpu":
        from ..device import card_info

        artifact["device"] = {"card_info": card_info()}
    with open(args.json, "w") as fh:
        json.dump(artifact, fh, indent=2, sort_keys=True)
    print(f"[servebench] wrote {args.json}", file=sys.stderr)


def _verdict(fail: list) -> int:
    if fail:
        for f in fail:
            print(f"[servebench] FAIL: {f}", file=sys.stderr)
        return 1
    print("[servebench] PASS", file=sys.stderr)
    return 0


def check_slo(args) -> int:
    """`--check-slo`: one warm server, one concurrent wave with per-job
    deadlines, three gated cells in a faultcheck-style row: p99 latency,
    the deadline-miss rate from the server's own SLO accounting, and a
    scrape taken mid-wave that must hold populated latency histograms."""
    from ..serve import PolishClient, PolishServer
    from ..serve.queue import nearest_rank

    with tempfile.TemporaryDirectory(prefix="racon_torch_slo_") as tmp:
        print(f"[servebench] SLO gate: {args.jobs} jobs, deadline "
              f"{args.deadline:.0f}s, p99<= {args.slo_p99:.1f}s, "
              f"miss-rate<= {args.slo_miss_rate:.2f}", file=sys.stderr)
        paths = build_dataset(tmp, args.genome_kb, args.coverage,
                              args.read_len, args.seed,
                              contigs=args.contigs)
        server = PolishServer(socket_path=os.path.join(tmp, "serve.sock"),
                              flight_dir=os.path.join(tmp, "flight"),
                              **server_kw(args))
        server.warmup(paths=paths)
        server.start()
        client = PolishClient(socket_path=server.config.socket_path)
        latencies = [None] * args.jobs

        def submit(i):
            t0 = time.perf_counter()
            try:
                client.submit(*paths, deadline_s=args.deadline, retries=5)
            except Exception as exc:  # noqa: BLE001 — counted below
                print(f"[servebench] job {i} failed: {exc}",
                      file=sys.stderr)
                return
            latencies[i] = time.perf_counter() - t0

        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(args.jobs)]
        for t in threads:
            t.start()
        # the scrape answers while jobs execute: part of the gate
        live = client.scrape()
        for t in threads:
            t.join()
        snap = client.stats()
        server.drain(timeout=60)

    cells = []
    done = sorted(v for v in latencies if v is not None)
    if len(done) < args.jobs:
        cells.append(("completed", False, f"{len(done)}/{args.jobs} jobs"))
    p99 = nearest_rank(done, 0.99) if done else float("inf")
    cells.append(("p99", p99 <= args.slo_p99,
                  f"{p99:.2f}s <= {args.slo_p99:.1f}s"))
    slo = snap.get("slo") or {}
    miss_rate = float(slo.get("miss_rate", 1.0))
    cells.append(("miss-rate", miss_rate <= args.slo_miss_rate,
                  f"{miss_rate:.2f} <= {args.slo_miss_rate:.2f} "
                  f"({slo.get('deadline_miss', '?')} missed, "
                  f"{slo.get('expired', '?')} expired)"))
    hist_lines = [ln for ln in live.splitlines() if "_bucket{" in ln]
    populated = any(not ln.rstrip().endswith(" 0") for ln in hist_lines)
    cells.append(("scrape", bool(hist_lines) and populated,
                  f"{len(live.splitlines())} lines, "
                  f"{len(hist_lines)} buckets, "
                  f"{'populated' if populated else 'EMPTY'}"))
    row = "  ".join(f"{name} {'pass' if ok else 'FAIL'} ({detail})"
                    for name, ok, detail in cells)
    failures = sum(not ok for _, ok, _ in cells)
    print(f"[servebench] slo  {row}", file=sys.stderr)
    print(f"[servebench] SLO gate {'PASS' if not failures else 'FAIL'}: "
          f"{len(cells) - failures}/{len(cells)} cells green",
          file=sys.stderr)
    return 1 if failures else 0


def run_router_bench(args) -> int:
    """`--router N`: job throughput through the router against the
    replica count. N warm replica processes start once; for each swept
    count c (1, 2, 4 ... capped at N, N included) a router fronts the
    first c and the same concurrent wave runs through it: jobs/s, the
    requeue count (any requeue on a healthy fleet fails the bench), the
    router's merge overhead (job wall minus the slowest shard's exec),
    byte identity with a direct single-replica submit. Each count also
    times three sequential single jobs (streamed: the routed time to
    first part), whose wall falls when the router range-shards a
    one-contig job (`range_scaling_x`); the top count A/Bs the same job
    traced (`submit_traced`) and untraced (`trace.overhead_pct`)."""
    from ..serve import PolishClient, PolishRouter
    from ..serve.autoscale import spawn_replica, stop_replica
    from ..serve.queue import nearest_rank

    n_max = max(1, args.router)
    counts = sorted({c for c in (1, 2, 4) if c < n_max} | {n_max})
    fail: list[str] = []
    curve: list[dict] = []
    trace_pt = None
    with tempfile.TemporaryDirectory(prefix="racon_torch_routerbench_") \
            as tmp:
        print(f"[servebench] router bench: {n_max} replica(s), sweep "
              f"{counts}, {args.jobs} jobs per wave", file=sys.stderr)
        paths = build_dataset(tmp, args.genome_kb, args.coverage,
                              args.read_len, args.seed,
                              contigs=args.contigs)
        procs, socks = [], []
        try:
            t0 = time.perf_counter()
            for k in range(n_max):
                sock = os.path.join(tmp, f"rep{k}.sock")
                procs.append(spawn_replica(sock, replica_flags(args)))
                socks.append(sock)
            for sock, proc in zip(socks, procs):
                wait_replica(sock, proc)
                # a direct job warms the replica on the bench's shapes
                PolishClient(socket_path=sock).submit(*paths)
            print(f"[servebench] {n_max} replica process(es) warm in "
                  f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)
            solo = PolishClient(socket_path=socks[0]).submit(*paths)

            for c in counts:
                router = PolishRouter(
                    replicas=socks[:c],
                    socket_path=os.path.join(tmp, f"router{c}.sock"),
                    journal=os.path.join(tmp, f"router{c}.jsonl"))
                router.start()
                results: list = [None] * args.jobs

                def submit(i, _router=router, _c=c):
                    try:
                        cl = PolishClient(
                            socket_path=_router.config.socket_path)
                        results[i] = cl.submit(*paths, retries=5)
                    except Exception as exc:  # noqa: BLE001 — counted
                        print(f"[servebench] router job {i} ({_c} "
                              f"replicas) failed: {exc}", file=sys.stderr)

                threads = [threading.Thread(target=submit, args=(i,))
                           for i in range(args.jobs)]
                t_wave = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                wall = time.perf_counter() - t_wave
                seq_cl = PolishClient(socket_path=router.config.socket_path)
                seq_walls: list[float] = []
                ttfbs: list[float] = []
                r_seq = None
                for _ in range(3):
                    t_seq = time.perf_counter()
                    marks: list[float] = []
                    r_seq = seq_cl.submit(
                        *paths, retries=5,
                        on_part=lambda f, _m=marks: _m.append(
                            time.perf_counter()))
                    seq_walls.append(time.perf_counter() - t_seq)
                    if marks:
                        ttfbs.append(marks[0] - t_seq)
                    if r_seq.fasta != solo.fasta:
                        fail.append(f"router x{c}: sequential job FASTA "
                                    "diverged from the direct "
                                    "single-replica bytes")
                if c == n_max:
                    tr_walls: list[float] = []
                    for _ in range(3):
                        t_tr = time.perf_counter()
                        r_tr, _doc = seq_cl.submit_traced(*paths, retries=5)
                        tr_walls.append(time.perf_counter() - t_tr)
                        if r_tr.fasta != solo.fasta:
                            fail.append(f"router x{c}: traced job FASTA "
                                        "diverged from the direct "
                                        "single-replica bytes")
                    base_w = min(seq_walls) if seq_walls else 0.0
                    traced_w = min(tr_walls)
                    trace_pt = {
                        "untraced_wall_s": round(base_w, 3),
                        "traced_wall_s": round(traced_w, 3),
                        "overhead_pct": round(
                            (traced_w - base_w) / max(base_w, 1e-9) * 100.0,
                            2)}
                requeues = router.counters["requeues"]
                router.drain(timeout=60)
                done = [r for r in results if r is not None]
                identical = bool(done) and all(r.fasta == solo.fasta
                                               for r in done)
                ov = [(r.router["wall_s"] - r.router["shard_exec_max_s"])
                      / max(r.router["wall_s"], 1e-9) * 100.0
                      for r in done if r.router.get("wall_s")]
                shards = [r.router.get("shards", 1) for r in done]
                rb = r_seq.router if r_seq is not None else {}
                pt = {"replicas": c, "jobs": args.jobs,
                      "completed": len(done),
                      "wall_s": round(wall, 3),
                      "jobs_per_s": round(len(done) / max(wall, 1e-9), 3),
                      "shards_mean": round(statistics.mean(shards), 2)
                      if shards else 0,
                      "job_wall_s": round(min(seq_walls), 3)
                      if seq_walls else None,
                      "ttfb_s": round(min(ttfbs), 3) if ttfbs else None,
                      "range": bool(rb.get("range")),
                      "range_shards": rb.get("range_shards"),
                      "requeues": requeues,
                      "merge_overhead_pct": round(
                          nearest_rank(sorted(ov), 0.50), 2)
                      if ov else None,
                      "identical": identical}
                curve.append(pt)
                print(f"[servebench] router x{c}: "
                      f"{pt['completed']}/{args.jobs} jobs in {wall:.2f}s "
                      f"({pt['jobs_per_s']:.3f} jobs/s, "
                      f"{pt['shards_mean']:.1f} shards/job, merge overhead "
                      f"{pt['merge_overhead_pct'] or 0:.2f}%, {requeues} "
                      f"requeues), single job {pt['job_wall_s']:.2f}s"
                      + (f" range-sharded x{pt['range_shards']}"
                         if pt["range"] else "")
                      + f" [{'OK' if identical else 'FAIL'} identity]",
                      file=sys.stderr)
                if len(done) < args.jobs:
                    fail.append(f"router x{c}: only {len(done)}/"
                                f"{args.jobs} jobs completed")
                if not identical:
                    fail.append(f"router x{c}: routed FASTA diverged from "
                                "the direct single-replica bytes")
                if requeues:
                    fail.append(f"router x{c}: {requeues} requeues on a "
                                "healthy fleet (a replica dropped "
                                "mid-shard)")
        finally:
            for proc in procs:
                stop_replica(proc)

    scaling_x = (curve[-1]["jobs_per_s"]
                 / max(curve[0]["jobs_per_s"], 1e-9)) if curve else 0.0
    router_block = {
        "replicas_max": n_max,
        "jobs": args.jobs,
        "curve": curve,
        "jobs_per_s": curve[-1]["jobs_per_s"] if curve else 0.0,
        "job_wall_s": curve[-1]["job_wall_s"] if curve else None,
        "ttfb_s": curve[-1]["ttfb_s"] if curve else None,
        "range": bool(curve) and bool(curve[-1].get("range")),
        "requeues": sum(pt["requeues"] for pt in curve),
        "merge_overhead_pct": max(
            (pt["merge_overhead_pct"] for pt in curve
             if pt["merge_overhead_pct"] is not None), default=None),
        "identical": bool(curve) and all(pt["identical"] for pt in curve),
        "scaling_x": round(scaling_x, 3),
        "device_latency_ms": args.device_latency_ms,
        "device_latency_x": args.device_latency_x,
        "host_poa_chunk": args.host_poa_chunk,
    }
    print(f"[servebench] router scaling: x{scaling_x:.2f} jobs/s at "
          f"{n_max} replica(s) vs 1 ({router_block['requeues']} requeues "
          "total)", file=sys.stderr)
    # one job's scaling, only when the top point range-sharded
    if router_block["range"] and curve[0].get("job_wall_s"):
        router_block["range_shards"] = curve[-1].get("range_shards")
        router_block["range_scaling_x"] = round(
            curve[0]["job_wall_s"] / max(curve[-1]["job_wall_s"], 1e-9), 3)
        print(f"[servebench] range scaling: one job "
              f"x{router_block['range_scaling_x']:.2f} faster at {n_max} "
              f"replica(s) vs 1 ({curve[0]['job_wall_s']:.2f}s -> "
              f"{curve[-1]['job_wall_s']:.2f}s, "
              f"{router_block['range_shards']} window-range shards)",
              file=sys.stderr)
    if args.json:
        artifact = {"mode": "router", "jobs": args.jobs,
                    "router": router_block, "pass": not fail}
        if trace_pt is not None:
            artifact["trace"] = trace_pt
            print(f"[servebench] trace overhead: "
                  f"{trace_pt['overhead_pct']:+.2f}% "
                  f"({trace_pt['untraced_wall_s']:.2f}s untraced -> "
                  f"{trace_pt['traced_wall_s']:.2f}s traced)",
                  file=sys.stderr)
        _write(args, artifact)
    return _verdict(fail)


def run_rounds_bench(args) -> int:
    """`--rounds N`: serve-side rounds with and without the window cache.
    A cache-off server runs a `rounds=N` job (the reference bytes and the
    uncached per-round walls); a cache-on server runs the same job twice
    (hits from converged windows, then the identical-resubmit ceiling).
    Gates: all three FASTAs identical, every submit completed N rounds,
    a nonzero hit rate on the resubmit and, with `--audit-rate`, no audit
    mismatch."""
    from ..serve import PolishClient, PolishServer

    n = max(1, args.rounds)
    fail: list[str] = []
    with tempfile.TemporaryDirectory(prefix="racon_torch_roundsbench_") \
            as tmp:
        print(f"[servebench] rounds bench: {n} rounds, cache off vs on "
              "(+ resubmit)", file=sys.stderr)
        paths = build_dataset(tmp, args.genome_kb, args.coverage,
                              args.read_len, args.seed,
                              contigs=args.contigs)
        off = PolishServer(socket_path=os.path.join(tmp, "off.sock"),
                           **server_kw(args))
        off.warmup(paths=paths)
        off.start()
        try:
            r_off = PolishClient(socket_path=off.config.socket_path).submit(
                *paths, rounds=n)
        finally:
            off.drain(timeout=60)

        on_kw = dict(server_kw(args), wincache=True)
        if args.audit_rate is not None:
            on_kw["audit_rate"] = args.audit_rate
        on = PolishServer(socket_path=os.path.join(tmp, "on.sock"), **on_kw)
        on.warmup(paths=paths)
        on.start()
        try:
            client = PolishClient(socket_path=on.config.socket_path)
            r_on = client.submit(*paths, rounds=n)
            r_on2 = client.submit(*paths, rounds=n)
            cache_snap = on.batcher.wincache.snapshot()
            audit_snap = (on.auditor.snapshot()
                          if on.auditor is not None else None)
        finally:
            on.drain(timeout=60)

    identical = r_on.fasta == r_off.fasta and r_on2.fasta == r_off.fasta
    if not identical:
        fail.append("cached rounds FASTA diverged from the cache-off bytes")
    for tag, r in (("off", r_off), ("on", r_on), ("resubmit", r_on2)):
        if r.rounds.get("completed") != n:
            fail.append(f"{tag} submit completed "
                        f"{r.rounds.get('completed')}/{n} rounds")

    def _walls(res):
        return [p["wall_s"] for p in res.rounds.get("per_round", [])]

    def _rate(res):
        c = res.rounds.get("cache") or {}
        total = c.get("hits", 0) + c.get("misses", 0)
        return round(c.get("hits", 0) / total, 4) if total else 0.0

    off_w, on_w, on2_w = _walls(r_off), _walls(r_on), _walls(r_on2)
    # round 1 pays full dispatch; the cache's claim is about later rounds
    off_r2 = statistics.mean(off_w[1:]) if len(off_w) > 1 else None
    on_r2 = statistics.mean(on_w[1:]) if len(on_w) > 1 else None
    speedup = (round(off_r2 / max(on_r2, 1e-9), 3)
               if off_r2 is not None and on_r2 is not None else None)
    resub_x = (round(statistics.mean(off_w)
                     / max(statistics.mean(on2_w), 1e-9), 3)
               if off_w and on2_w else None)
    hit_rate, hit_rate2 = _rate(r_on), _rate(r_on2)
    if hit_rate2 <= 0.0:
        fail.append("cached resubmit saw a zero hit rate: the cache never "
                    "engaged")
    if audit_snap is not None and audit_snap["mismatches"]:
        fail.append(f"audit caught {audit_snap['mismatches']} mismatches "
                    "with the window cache armed")
    print(f"[servebench] rounds x{n} cache-off walls: "
          + " ".join(f"{w:.2f}" for w in off_w), file=sys.stderr)
    print(f"[servebench] rounds x{n} cache-on  walls: "
          + " ".join(f"{w:.2f}" for w in on_w)
          + f"  (hit rate {hit_rate * 100:.1f}%)", file=sys.stderr)
    print(f"[servebench] rounds x{n} resubmit  walls: "
          + " ".join(f"{w:.2f}" for w in on2_w)
          + f"  (hit rate {hit_rate2 * 100:.1f}%)", file=sys.stderr)
    if speedup is not None:
        print(f"[servebench] round-2+ mean: {off_r2:.3f}s no-cache vs "
              f"{on_r2:.3f}s cached: x{speedup:.2f}; resubmit "
              f"x{resub_x:.2f}", file=sys.stderr)
    print(f"[servebench] identity cache-on vs cache-off: "
          f"[{'OK' if identical else 'FAIL'}]", file=sys.stderr)
    if args.json:
        rounds_block = {
            "requested": n,
            "completed": r_on.rounds.get("completed"),
            "per_round": r_on.rounds.get("per_round"),
            "per_round_nocache": r_off.rounds.get("per_round"),
            "round2plus_nocache_mean_s": (round(off_r2, 4)
                                          if off_r2 is not None else None),
            "round2plus_cached_mean_s": (round(on_r2, 4)
                                         if on_r2 is not None else None),
            "round2_speedup_x": speedup,
        }
        cache_block = {
            "identical": identical,
            "hit_rate": hit_rate,
            "resubmit": {"hit_rate": hit_rate2,
                         "per_round": r_on2.rounds.get("per_round"),
                         "speedup_x": resub_x},
            "snapshot": cache_snap,
        }
        cb = r_on.rounds.get("cache") or {}
        cache_block.update(hits=cb.get("hits"), misses=cb.get("misses"))
        artifact = {"mode": "rounds", "jobs": 3, "rounds": rounds_block,
                    "cache": cache_block, "pass": not fail}
        if audit_snap is not None:
            artifact["audit"] = {k: audit_snap[k] for k in (
                "windows", "sampled", "audited", "mismatches", "repaired")}
            artifact["audit"]["rate"] = args.audit_rate
        _write(args, artifact)
    return _verdict(fail)


def _wave(client, paths, n: int, label: str, **kw) -> dict:
    """N concurrent streamed submits: jobs/s, latency percentiles and
    streamed parts a job."""
    from ..serve.queue import nearest_rank

    lat: list = [None] * n
    nparts = [0] * n

    def submit(i):
        t0 = time.perf_counter()

        def on_part(_frame, _i=i):
            nparts[_i] += 1

        try:
            client.submit(*paths, retries=8, on_part=on_part, **kw)
        except Exception as exc:  # noqa: BLE001 — counted below
            print(f"[servebench] {label} job {i} failed: {exc}",
                  file=sys.stderr)
            return
        lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(n)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    duration = time.perf_counter() - t_start
    done = sorted(v for v in lat if v is not None)
    out = {"jobs": n, "completed": len(done),
           "duration_s": round(duration, 3),
           "jobs_per_s": round(len(done) / max(duration, 1e-9), 3),
           "parts_per_job": round(sum(nparts) / max(n, 1), 2)}
    if done:
        out.update(p50_s=round(nearest_rank(done, 0.50), 4),
                   p95_s=round(nearest_rank(done, 0.95), 4),
                   p99_s=round(nearest_rank(done, 0.99), 4))
    return out


def run_fragment_bench(args) -> int:
    """`--fragment N`: serve-side fragment correction. One warm server
    (fragment groups of 8): one fragment job held byte-identical to a
    solo kF run, a wave of N fragment jobs, and a contig wave on the same
    server as the comparison row (`vs_contig_x`, which must exceed 1).
    Gates: the identity, every wave job completed, vs_contig_x > 1."""
    from ..core.polisher import PolisherType, create_polisher
    from ..serve import PolishClient, PolishServer, make_fragment_dataset
    from .faultcheck import fasta

    n_jobs = max(2, args.fragment)
    fail: list[str] = []
    with tempfile.TemporaryDirectory(prefix="racon_torch_fragbench_") \
            as tmp:
        print(f"[servebench] fragment bench: {n_jobs} fragment jobs vs the "
              "contig workload, one warm server", file=sys.stderr)
        frag_dir = os.path.join(tmp, "frag")
        os.makedirs(frag_dir)
        frag_paths = make_fragment_dataset(frag_dir)
        contig_paths = build_dataset(tmp, args.genome_kb, args.coverage,
                                     args.read_len, args.seed,
                                     contigs=args.contigs)
        # the solo reference at the serve defaults, no serving
        solo_p = create_polisher(*frag_paths, PolisherType.kF, 500, 10.0,
                                 0.3, num_threads=args.threads,
                                 device=args.device)
        solo_p.initialize()
        solo = fasta(solo_p.polish(True))
        n_reads = solo.count(b">")
        srv = PolishServer(socket_path=os.path.join(tmp, "serve.sock"),
                           frag_group=8, **server_kw(args))
        srv.warmup(paths=contig_paths)
        srv.start()
        try:
            client = PolishClient(socket_path=srv.config.socket_path)
            parts: list[dict] = []
            r = client.submit(*frag_paths, fragment=True,
                              on_part=parts.append)
            identical = r.fasta == solo
            if not identical:
                fail.append("serve fragment FASTA diverged from the solo kF "
                            "bytes")
            client.submit(*contig_paths)  # warm the contig job path too
            frag_wave = _wave(client, frag_paths, n_jobs, "fragment",
                              fragment=True)
            contig_wave = _wave(client, contig_paths,
                                max(2, min(n_jobs, args.jobs)), "contig")
        finally:
            srv.drain(timeout=60)

    for label, w in (("fragment", frag_wave), ("contig", contig_wave)):
        if w["completed"] != w["jobs"]:
            fail.append(f"{label} wave completed {w['completed']}/"
                        f"{w['jobs']} jobs")
    vs_contig = round(frag_wave["jobs_per_s"]
                      / max(contig_wave["jobs_per_s"], 1e-9), 3)
    if vs_contig <= 1.0:
        fail.append(f"fragment jobs/s x{vs_contig:.2f} of contig: must be "
                    "above 1")
    print(f"[servebench] fragment identity vs solo kF ({n_reads} reads): "
          f"[{'OK' if identical else 'FAIL'}]", file=sys.stderr)
    print(f"[servebench] fragment wave: {frag_wave['jobs_per_s']:.2f} "
          f"jobs/s (p99 {frag_wave.get('p99_s', 0):.2f}s, "
          f"{frag_wave['parts_per_job']:.1f} parts/job)", file=sys.stderr)
    print(f"[servebench] contig wave:   {contig_wave['jobs_per_s']:.2f} "
          f"jobs/s (p99 {contig_wave.get('p99_s', 0):.2f}s): fragment "
          f"x{vs_contig:.2f} [{'OK' if vs_contig > 1.0 else 'FAIL'}]",
          file=sys.stderr)
    if args.json:
        fragment_block = {
            "identical": identical, "reads": n_reads,
            "jobs_per_s": frag_wave["jobs_per_s"],
            "p50_s": frag_wave.get("p50_s"), "p99_s": frag_wave.get("p99_s"),
            "parts_per_job": frag_wave["parts_per_job"],
            "vs_contig_x": vs_contig, "wave": frag_wave,
            "contig": contig_wave}
        _write(args, {"mode": "fragment", "jobs": n_jobs,
                      "fragment": fragment_block, "pass": not fail})
    return _verdict(fail)


def run_flood_bench(args) -> int:
    """`--flood N`: QoS isolation under load. Two warm in-process
    replicas behind the router; N free-tenant submitters flood it in a
    closed loop while gold waves measure p99 on the idle fabric, under
    the flood with preemption off, and with it on. Then the deadline
    abort (margin 0) on every replica and jobs with unmeetable deadlines,
    each refused typed `deadline-doomed` at admission. Gates: every gold
    job byte-identical to a direct submit, preemptions fired with
    preemption on, every unmeetable job aborted doomed."""
    from ..serve import (DeadlineDoomed, PolishClient, PolishRouter,
                         PolishServer)
    from ..serve.queue import nearest_rank

    n_flood = max(1, args.flood)
    n_gold = max(2, args.jobs)
    fail: list[str] = []
    with tempfile.TemporaryDirectory(prefix="racon_torch_floodbench_") \
            as tmp:
        print(f"[servebench] flood bench: {n_flood} free submitter(s) vs "
              f"{n_gold}-job gold waves, 2 replicas", file=sys.stderr)
        paths = build_dataset(tmp, args.genome_kb, args.coverage,
                              args.read_len, args.seed,
                              contigs=args.contigs)
        servers = []
        router = None
        try:
            t0 = time.perf_counter()
            for k in range(2):
                srv = PolishServer(
                    socket_path=os.path.join(tmp, f"flood_rep{k}.sock"),
                    **server_kw(args))
                srv.warmup(paths=paths)
                srv.start()
                servers.append(srv)
            router = PolishRouter(
                replicas=[s.config.socket_path for s in servers],
                socket_path=os.path.join(tmp, "flood_router.sock"),
                journal=os.path.join(tmp, "flood_router.jsonl")).start()
            client = PolishClient(socket_path=router.config.socket_path)
            print(f"[servebench] fabric warm in "
                  f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)
            # the reference, which also seeds every replica's EMA
            solo = client.submit(*paths, tenant="gold", priority=10)

            def gold_wave(tag: str) -> float:
                lat: list[float] = []
                for _ in range(n_gold):
                    t = time.perf_counter()
                    r = client.submit(*paths, tenant="gold", priority=10,
                                      retries=8)
                    lat.append(time.perf_counter() - t)
                    if r.fasta != solo.fasta:
                        fail.append(f"{tag}: gold FASTA diverged from the "
                                    "direct submit bytes")
                return nearest_rank(sorted(lat), 0.99)

            def flood_phase(tag: str, preempt: bool) -> tuple[float, int]:
                for srv in servers:
                    srv.config.preempt = preempt
                stop = threading.Event()
                flood_done = [0] * n_flood
                flood_bad: list[str] = []

                def flood(slot: int):
                    mine = PolishClient(
                        socket_path=router.config.socket_path)
                    while not stop.is_set():
                        try:
                            r = mine.submit(*paths, tenant="free",
                                            priority=0, retries=8)
                        except Exception as exc:  # noqa: BLE001
                            flood_bad.append(f"{type(exc).__name__}: {exc}")
                            return
                        if r.fasta != solo.fasta:
                            flood_bad.append("free FASTA diverged")
                            return
                        flood_done[slot] += 1

                threads = [threading.Thread(target=flood, args=(i,))
                           for i in range(n_flood)]
                for t in threads:
                    t.start()
                time.sleep(1.0)  # the flood owns the fabric first
                p99 = gold_wave(tag)
                stop.set()
                for t in threads:
                    t.join(timeout=180)
                for srv in servers:
                    srv.config.preempt = False
                if flood_bad:
                    fail.append(f"{tag}: flood submitter died "
                                f"({flood_bad[0]})")
                print(f"[servebench] {tag}: gold p99 {p99:.2f}s "
                      f"({sum(flood_done)} free jobs completed under the "
                      "wave)", file=sys.stderr)
                return p99, sum(flood_done)

            p99_idle = gold_wave("flood idle-baseline")
            print(f"[servebench] flood idle-baseline: gold p99 "
                  f"{p99_idle:.2f}s", file=sys.stderr)
            p99_nopre, _ = flood_phase("flood preempt-off", False)
            pre0 = sum(s.qos["preemptions"] for s in servers)
            p99_pre, free_done = flood_phase("flood preempt-on", True)
            preemptions = sum(s.qos["preemptions"] for s in servers) - pre0
            if preemptions < 1:
                fail.append("preempt-on flood phase fired zero preemptions: "
                            "gold never displaced free")
            for srv in servers:
                srv.queue.abort_margin = 0.0
            doomed_n, doomed_saved = 0, 0.0
            try:
                for _ in range(n_gold):
                    try:
                        client.submit(*paths, tenant="free", deadline_s=0.05)
                        fail.append("unmeetable-deadline job was NOT "
                                    "aborted doomed (it ran to completion)")
                    except DeadlineDoomed as exc:
                        doomed_n += 1
                        doomed_saved += max(exc.predicted_s, 0.0)
            finally:
                for srv in servers:
                    srv.queue.abort_margin = None
            aborted = sum(s.qos["doomed_at_admission"]
                          + s.qos["doomed_mid_run"] for s in servers)
            print(f"[servebench] doomed-abort: {doomed_n}/{n_gold} "
                  f"unmeetable jobs aborted at admission, "
                  f"~{doomed_saved:.2f} predicted device-seconds saved "
                  f"({aborted} replica-side aborts)", file=sys.stderr)
        finally:
            if router is not None:
                router.drain(timeout=60)
            for srv in servers:
                srv.drain(timeout=60)

    flat = round(p99_pre / max(p99_idle, 1e-9), 3)
    nopre_x = round(p99_nopre / max(p99_idle, 1e-9), 3)
    qos_block = {
        "replicas": 2, "flood_submitters": n_flood, "gold_jobs": n_gold,
        "free_jobs_completed": free_done,
        "gold_p99_idle_s": round(p99_idle, 3),
        "gold_p99_flood_nopreempt_s": round(p99_nopre, 3),
        "gold_p99_flood_preempt_s": round(p99_pre, 3),
        "gold_p99_flat": flat, "gold_p99_nopreempt_x": nopre_x,
        "preemptions": preemptions, "doomed_submitted": n_gold,
        "doomed_aborted": doomed_n,
        "doomed_abort_saved_s": round(doomed_saved, 3),
    }
    print(f"[servebench] gold p99: idle {p99_idle:.2f}s, flood no-preempt "
          f"{p99_nopre:.2f}s (x{nopre_x:.2f}), flood preempt "
          f"{p99_pre:.2f}s (x{flat:.2f})", file=sys.stderr)
    if args.json:
        _write(args, {"mode": "flood", "jobs": n_gold, "qos": qos_block,
                      "pass": not fail})
    return _verdict(fail)


def run_ramp_bench(args) -> int:
    """`--ramp N`: elastic autoscaling under a ramped open-loop load. One
    warm replica process behind the router, the autoscaler armed with
    ceiling N over a pool of warm spare processes on the sockets it will
    ask for (so a scale-up costs the healthz handshake, not a start).
    Poisson arrivals ramp from 1x (`--ramp-qps0`, or 0.35x one replica's
    measured capacity) to 10x; then a slow trickle while the idle fleet
    drains back to one replica. Fails on a lost job, a byte divergence, a
    ramp that never scaled up, or a fleet that did not drain back."""
    from ..serve import PolishClient, PolishRouter
    from ..serve.autoscale import (AutoscaleConfig, Autoscaler,
                                   spawn_replica, stop_replica)
    from ..serve.queue import nearest_rank

    n_max = max(2, args.ramp)
    n_jobs = max(8, args.ramp_jobs)
    fail: list[str] = []
    samples: list[dict] = []
    with tempfile.TemporaryDirectory(prefix="racon_torch_rampbench_") \
            as tmp:
        print(f"[servebench] ramp bench: 1->{n_max} replicas, {n_jobs} "
              "Poisson jobs ramping 1x->10x", file=sys.stderr)
        paths = build_dataset(tmp, args.genome_kb, args.coverage,
                              args.read_len, args.seed,
                              contigs=args.contigs)
        t0 = time.perf_counter()
        base_sock = os.path.join(tmp, "ramp_base.sock")
        base = spawn_replica(base_sock, replica_flags(args))
        pool: dict = {}
        live: dict = {}
        router = None
        scaler = None
        try:
            for i in range(1, n_max):
                spec = os.path.join(tmp, f"autoscale_{i}.sock")
                pool[spec] = spawn_replica(spec, replica_flags(args))
            for sock, proc in [(base_sock, base), *pool.items()]:
                wait_replica(sock, proc)
                PolishClient(socket_path=sock).submit(*paths)  # warm it
            print(f"[servebench] base + {len(pool)} warm spare "
                  f"process(es) in {time.perf_counter() - t0:.2f}s",
                  file=sys.stderr)
            router = PolishRouter(
                replicas=base_sock,
                socket_path=os.path.join(tmp, "ramp_router.sock"),
                journal=os.path.join(tmp, "ramp_router.jsonl"),
                # two shards a job keep the sub-contig speed-up while the
                # fleet spreads whole jobs under concurrent load
                max_shards=2, health_interval_s=0.25).start()

            def spawn(spec):
                proc = pool.pop(spec, None)
                if proc is None:  # past the prebuilt pool: a cold spawn
                    proc = spawn_replica(spec, replica_flags(args))
                live[spec] = proc
                return spec

            def stop(handle):
                proc = live.pop(handle, None)
                if proc is not None:
                    stop_replica(proc)

            client = PolishClient(socket_path=router.config.socket_path)
            solo = client.submit(*paths, tenant="gold")
            idle: list[float] = []
            for _ in range(3):
                t = time.perf_counter()
                r = client.submit(*paths, tenant="gold")
                idle.append(time.perf_counter() - t)
                if r.fasta != solo.fasta:
                    fail.append("idle-baseline FASTA diverged")
            p99_idle = nearest_rank(sorted(idle), 0.99)
            qps0 = args.ramp_qps0 or 0.35 / max(statistics.mean(idle), 1e-9)
            print(f"[servebench] idle gold p99 {p99_idle:.2f}s; offered "
                  f"rate {qps0:.2f} -> {qps0 * 10:.2f} jobs/s",
                  file=sys.stderr)
            scaler = Autoscaler(
                router,
                config=AutoscaleConfig(
                    min_replicas=1, max_replicas=n_max, interval_s=0.2,
                    up_pressure=1.1, up_sustain_s=0.3, down_idle_s=2.0,
                    cooldown_s=1.0, socket_dir=tmp, ready_timeout_s=30.0,
                    hold_s=10.0),
                spawn=spawn, stop=stop).start()
            stop_sampling = threading.Event()
            t_wave0 = time.perf_counter()

            def sample():
                while not stop_sampling.is_set():
                    snap = scaler.snapshot()
                    samples.append(
                        {"t_s": round(time.perf_counter() - t_wave0, 2),
                         "replicas": 1 + snap["spawned"],
                         "pressure": round(snap["pressure"], 2)})
                    stop_sampling.wait(0.25)

            sampler = threading.Thread(target=sample, daemon=True)
            sampler.start()
            rng = random.Random(args.seed)
            lat: list = [None] * n_jobs
            arrive: list = [None] * n_jobs
            shards: list = [None] * n_jobs
            lost: list[str] = []

            def submit(i):
                t = time.perf_counter()
                arrive[i] = t - t_wave0
                try:
                    r = PolishClient(
                        socket_path=router.config.socket_path).submit(
                            *paths, tenant="gold", retries=8)
                except Exception as exc:  # noqa: BLE001 — a lost job
                    lost.append(f"ramp job {i}: {type(exc).__name__}: "
                                f"{exc}")
                    return
                lat[i] = time.perf_counter() - t
                shards[i] = (r.router or {}).get("shards")
                if r.fasta != solo.fasta:
                    fail.append(f"ramp job {i} FASTA diverged")

            threads = []
            for i in range(n_jobs):
                rate = qps0 * (1.0 + 9.0 * i / max(n_jobs - 1, 1))
                time.sleep(rng.expovariate(rate))
                th = threading.Thread(target=submit, args=(i,))
                th.start()
                threads.append(th)
            for th in threads:
                th.join()
            ramp_done = sorted(v for v in lat if v is not None)
            p99_ramp = (nearest_rank(ramp_done, 0.99) if ramp_done
                        else float("inf"))
            peak = max((s["replicas"] for s in samples), default=1)
            print(f"[servebench] ramp: {len(ramp_done)}/{n_jobs} jobs, gold "
                  f"p99 {p99_ramp:.2f}s, "
                  f"{scaler.snapshot()['scale_ups']} scale-up(s), peak "
                  f"{peak} replicas", file=sys.stderr)
            # scale-down under a live trickle
            trickle_n = n_max + 1
            for i in range(trickle_n):
                time.sleep(3.0)
                try:
                    r = client.submit(*paths, tenant="gold", retries=8)
                    if r.fasta != solo.fasta:
                        fail.append(f"trickle job {i} FASTA diverged")
                except Exception as exc:  # noqa: BLE001 — a lost job
                    lost.append(f"trickle job {i}: {type(exc).__name__}: "
                                f"{exc}")
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline and scaler.spawned:
                time.sleep(0.25)
            snap = scaler.snapshot()
            drained = snap["spawned"] == 0
            stop_sampling.set()
            sampler.join(timeout=5)
        finally:
            if scaler is not None:
                scaler.close()
            if router is not None:
                router.drain(timeout=60)
            stop_replica(base)
            for proc in [*live.values(), *pool.values()]:
                stop_replica(proc)

    for msg in lost:
        fail.append(f"job lost: {msg}")
    if snap["scale_ups"] < 1:
        fail.append("the ramp never scaled up: the offered load stayed "
                    "inside one replica (raise --ramp-jobs or lower "
                    "--ramp-qps0)")
    if snap["scale_downs"] < 1 or not drained:
        fail.append(f"the fleet did not drain back to the floor "
                    f"({snap['spawned']} spawned replica(s) left, "
                    f"{snap['scale_downs']} scale-down(s))")
    flat = round(p99_ramp / max(p99_idle, 1e-9), 3)
    autoscale_block = {
        "replicas_min": 1, "replicas_max": n_max, "jobs": n_jobs,
        "completed": len(ramp_done), "jobs_lost": len(lost),
        "qps0": round(qps0, 3), "qps_peak": round(qps0 * 10.0, 3),
        "scale_ups": snap["scale_ups"], "scale_downs": snap["scale_downs"],
        "spawn_failures": snap["spawn_failures"],
        "drained_to_min": drained, "trickle_jobs": trickle_n,
        "gold_p99_idle_s": round(p99_idle, 3),
        "gold_p99_ramp_s": round(p99_ramp, 3), "gold_p99_flat": flat,
        "replicas_over_time": samples,
        "ramp_jobs": [
            {"i": i,
             "arrive_s": round(arrive[i], 2) if arrive[i] else None,
             "lat_s": round(lat[i], 2) if lat[i] else None,
             "shards": shards[i]}
            for i in range(n_jobs)],
        "device_latency_ms": args.device_latency_ms,
        "device_latency_x": args.device_latency_x,
        "host_poa_chunk": args.host_poa_chunk,
    }
    print(f"[servebench] autoscale: {snap['scale_ups']} up / "
          f"{snap['scale_downs']} down, {len(lost)} jobs lost, gold p99 "
          f"idle {p99_idle:.2f}s vs ramp {p99_ramp:.2f}s (x{flat:.2f})",
          file=sys.stderr)
    if args.json:
        _write(args, {"mode": "ramp", "jobs": n_jobs,
                      "autoscale": autoscale_block, "pass": not fail})
    return _verdict(fail)


def run_openloop(client, paths, qps: float, n_jobs: int, seed: int) -> dict:
    """One open-loop wave: Poisson arrivals at `qps`, every job streamed;
    latency percentiles, time to first byte and achieved throughput."""
    from ..serve.queue import nearest_rank

    rng = random.Random(seed)
    lat: list = [None] * n_jobs
    ttfb: list = [None] * n_jobs
    threads = []

    def submit(i):
        t0 = time.perf_counter()

        def on_part(frame, _i=i, _t=t0):
            if ttfb[_i] is None:
                ttfb[_i] = time.perf_counter() - _t

        try:
            client.submit(*paths, retries=8, on_part=on_part)
        except Exception as exc:  # noqa: BLE001 — counted below
            print(f"[servebench] openloop job {i} failed: {exc}",
                  file=sys.stderr)
            # lat and ttfb over the same population
            ttfb[i] = None
            return
        lat[i] = time.perf_counter() - t0

    t_start = time.perf_counter()
    for i in range(n_jobs):
        time.sleep(rng.expovariate(qps))
        t = threading.Thread(target=submit, args=(i,))
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    duration = time.perf_counter() - t_start
    done = sorted(v for v in lat if v is not None)
    tb = sorted(v for v in ttfb if v is not None)
    out = {"qps": qps, "jobs": n_jobs, "completed": len(done),
           "duration_s": round(duration, 3),
           "achieved_qps": round(len(done) / max(duration, 1e-9), 3)}
    if done:
        out.update(p50_s=round(nearest_rank(done, 0.50), 4),
                   p95_s=round(nearest_rank(done, 0.95), 4),
                   p99_s=round(nearest_rank(done, 0.99), 4))
    if tb:
        out["ttfb_p50_s"] = round(nearest_rank(tb, 0.50), 4)
    return out


def saturation_knee(curve: list[dict]) -> float | None:
    """The highest swept rate the server still absorbs (achieved >= 90%
    of offered), stopping at the first rate that fails; None when even
    the lowest rate saturates it."""
    knee = None
    for pt in sorted(curve, key=lambda p: p["qps"]):
        if pt["achieved_qps"] < 0.9 * pt["qps"]:
            break
        knee = pt["qps"]
    return knee


def _baseline_view(doc: dict) -> dict:
    """The comparable numbers of a `--baseline` artifact: a servebench
    artifact (openloop.curve / warm keys) or a raw curve dump
    ({"curve": [...]})."""
    curve = (doc.get("openloop") or {}).get("curve") or \
        doc.get("curve") or []
    out = {"design": doc.get("design") or doc.get("mode"), "curve": curve}
    if curve:
        worst = max((p for p in curve if p.get("p99_s")),
                    key=lambda p: p["qps"], default=None)
        if worst:
            out["p99_s"] = worst.get("p99_s")
            out["ttfb_p50_s"] = worst.get("ttfb_p50_s")
    warm = doc.get("warm") or {}
    out.setdefault("p99_s", warm.get("p99_s"))
    out.setdefault("ttfb_p50_s", warm.get("ttfb_p50_s"))
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m racon_tpu_torch.tools.servebench",
        description="warm server jobs against cold one-shot CLI runs, and "
                    "the fleet modes; exit 0 only when every gate holds")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda launches the kernels and raises without a "
                         "card; cpu runs their plain versions")
    ap.add_argument("--jobs", type=int, default=4,
                    help="concurrent warm submissions")
    ap.add_argument("--cold-runs", type=int, default=None,
                    help="sequential cold CLI runs to time (default "
                         "min(jobs, 3))")
    ap.add_argument("--genome-kb", type=int, default=20)
    ap.add_argument("--contigs", type=int, default=4,
                    help="split the genome over this many contigs (default "
                         "4): time to first byte then measures the first "
                         "contig streaming out")
    ap.add_argument("--coverage", type=int, default=20)
    ap.add_argument("--read-len", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("-t", "--threads", type=int, default=2)
    ap.add_argument("-c", "--cudapoa-batches", type=int, default=0)
    ap.add_argument("--cudaaligner-batches", type=int, default=0)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--iteration-windows", type=int, default=None,
                    help="the server's most windows an iteration")
    ap.add_argument("--worker-lanes", type=int, default=None,
                    help="the server's worker lanes (over the CPU "
                         "repeated, or the visible cards round-robin); "
                         "with > 1 the bench also gates that iterations "
                         "overlapped (max_concurrent_iterations >= 2)")
    ap.add_argument("--audit-rate", type=float, default=None,
                    help="arm the identity audit at this sampled fraction "
                         "and A/B it against rate 0 on the same server "
                         "(the `audit` block; any mismatch fails)")
    ap.add_argument("--json", default=None,
                    help="write the JSON artifact here")
    ap.add_argument("--fleet", type=int, default=None,
                    help="this many in-process servers, the wave "
                         "round-robined over them, the fleet aggregator "
                         "polling them mid-wave (the `fleet` block)")
    ap.add_argument("--router", type=int, default=None,
                    help="this many replica processes behind the router, "
                         "swept at 1, 2, 4 ... (the `router` block)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="a rounds=N job cache-off, cache-on and "
                         "resubmitted (the `rounds` / `cache` blocks)")
    ap.add_argument("--fragment", type=int, default=None,
                    help="this many concurrent fragment jobs against a "
                         "contig wave (the `fragment` block)")
    ap.add_argument("--flood", type=int, default=None,
                    help="this many free-tenant submitters flooding two "
                         "routed replicas while gold waves measure p99 "
                         "(the `qos` block)")
    ap.add_argument("--ramp", type=int, default=None,
                    help="Poisson load ramping 1x->10x through a router "
                         "whose autoscaler may grow to this many replicas "
                         "(the `autoscale` block)")
    ap.add_argument("--ramp-jobs", type=int, default=24,
                    help="ramp mode: jobs across the ramp (default 24)")
    ap.add_argument("--device-latency-ms", type=float, default=0.0,
                    help="fleet modes: every replica process sleeps this "
                         "many ms after each pipeline chunk's result wait "
                         "(its --device-latency-s)")
    ap.add_argument("--device-latency-x", type=float, default=0.0,
                    help="fleet modes: every replica process sleeps this "
                         "multiple of each chunk's dispatch time (its "
                         "--device-latency-x)")
    ap.add_argument("--host-poa-chunk", type=int, default=0,
                    help="fleet modes: every replica's windows per host "
                         "POA chunk (its --host-poa-chunk; 0: its "
                         "default)")
    ap.add_argument("--ramp-qps0", type=float, default=None,
                    help="ramp mode: the 1x arrival rate in jobs/s "
                         "(default 0.35x one replica's measured capacity)")
    ap.add_argument("--fleet-poll-s", type=float, default=0.25,
                    help="fleet mode: the aggregator's poll interval")
    ap.add_argument("--qps", type=float, default=None,
                    help="open-loop Poisson arrivals at this rate (jobs/s)")
    ap.add_argument("--qps-jobs", type=int, default=8,
                    help="jobs per open-loop wave (default 8)")
    ap.add_argument("--qps-curve", default=None,
                    help="comma-separated rates to sweep (the saturation "
                         "knee)")
    ap.add_argument("--baseline", default=None,
                    help="embed a prior artifact and print the p99 / ttfb "
                         "comparison")
    ap.add_argument("--check-slo", action="store_true",
                    help="the SLO gate: one wave with per-job deadlines, "
                         "p99, miss rate and a live scrape")
    ap.add_argument("--slo-p99", type=float, default=60.0,
                    help="--check-slo: the p99 bound in seconds")
    ap.add_argument("--slo-miss-rate", type=float, default=0.0,
                    help="--check-slo: the allowed deadline-miss rate")
    ap.add_argument("--deadline", type=float, default=120.0,
                    help="--check-slo: every wave job's deadline_s")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for mode, fn in (("check_slo", check_slo), ("router", run_router_bench),
                     ("rounds", run_rounds_bench),
                     ("fragment", run_fragment_bench),
                     ("flood", run_flood_bench), ("ramp", run_ramp_bench)):
        if getattr(args, mode) not in (None, False):
            return fn(args)
    return run_serve_bench(args)


def run_serve_bench(args) -> int:
    """The default mode (module docstring), with `--fleet`,
    `--audit-rate`, `--qps` / `--qps-curve` and `--baseline`."""
    from ..obs.journal import check_consistency, read_journal
    from ..serve import PolishClient, PolishServer
    from ..serve.queue import nearest_rank
    from .obsreport import check_parts_streamed

    cold_n = args.cold_runs if args.cold_runs is not None \
        else min(args.jobs, 3)
    with tempfile.TemporaryDirectory(prefix="racon_torch_servebench_") \
            as tmp:
        print(f"[servebench] simulating {args.genome_kb} kb at "
              f"{args.coverage}x ...", file=sys.stderr)
        paths = build_dataset(tmp, args.genome_kb, args.coverage,
                              args.read_len, args.seed,
                              contigs=args.contigs)
        t0 = time.perf_counter()
        build_libraries(args.device)
        print(f"[servebench] libraries ready in "
              f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)

        # ---- cold: sequential fresh-process CLI runs
        cold_s: list[float] = []
        cold_out = None
        for i in range(cold_n):
            dt, out = cold_cli_run(paths, args)
            cold_s.append(dt)
            cold_out = out
            print(f"[servebench] cold run {i + 1}/{cold_n}: {dt:.2f}s",
                  file=sys.stderr)

        # ---- warm: the journal rides the measured run and is checked
        # after the drain
        n_replicas = max(1, args.fleet or 1)
        extra = {}
        devices = lane_devices("cpu", 1) if args.device == "cpu" else None
        if args.iteration_windows is not None:
            extra["iteration_windows"] = args.iteration_windows
        if args.worker_lanes is not None:
            extra["worker_lanes"] = args.worker_lanes
            extra["devices"] = devices = lane_devices(args.device,
                                                      args.worker_lanes)
        if args.audit_rate is not None:
            extra["audit_rate"] = args.audit_rate
        servers, clients, journal_paths = [], [], []
        t0 = time.perf_counter()
        for k in range(n_replicas):
            journal_path = os.path.join(tmp, f"journal{k}.jsonl")
            journal_paths.append(journal_path)
            srv = PolishServer(socket_path=os.path.join(tmp,
                                                        f"serve{k}.sock"),
                               journal=journal_path,
                               flight_dir=os.path.join(tmp, "flight"),
                               **server_kw(args), **extra)
            srv.warmup(paths=paths)  # the shapes the jobs use
            srv.start()
            servers.append(srv)
            clients.append(PolishClient(socket_path=srv.config.socket_path))
        server, client = servers[0], clients[0]
        warm_ready_s = time.perf_counter() - t0
        print(f"[servebench] {n_replicas} server(s) warm in "
              f"{warm_ready_s:.2f}s ({server._warm['compiles']} first "
              f"dispatches {server._warm['compile_s']:.2f}s)",
              file=sys.stderr)

        # ---- warm sequential: like for like with the cold runs
        seq_s: list[float] = []
        seq_results: list = []
        for i in range(cold_n):
            t0 = time.perf_counter()
            seq_results.append(client.submit(*paths))
            seq_s.append(time.perf_counter() - t0)
            print(f"[servebench] warm seq run {i + 1}/{cold_n}: "
                  f"{seq_s[-1]:.2f}s", file=sys.stderr)

        # ---- the audit A/B, interleaved on/off so drift cancels
        audit_on_s: list[float] = []
        audit_off_s: list[float] = []
        if args.audit_rate and servers[0].auditor is not None:
            ab_pairs = max(cold_n, 5)
            for _ in range(ab_pairs):
                for rate, sink in ((args.audit_rate, audit_on_s),
                                   (0.0, audit_off_s)):
                    for srv in servers:
                        srv.auditor.set_rate(rate)
                    t0 = time.perf_counter()
                    r = client.submit(*paths)
                    sink.append(time.perf_counter() - t0)
                    if r.fasta != seq_results[0].fasta:
                        raise SystemExit("[servebench] audit A/B run "
                                         "diverged from the audited run")
            for srv in servers:
                srv.auditor.set_rate(args.audit_rate)
            print(f"[servebench] audit A/B ({ab_pairs} interleaved pairs): "
                  f"on {statistics.mean(audit_on_s):.2f}s vs off "
                  f"{statistics.mean(audit_off_s):.2f}s mean",
                  file=sys.stderr)

        # ---- the concurrent wave, streamed
        results: list = [None] * args.jobs
        latencies: list = [0.0] * args.jobs
        first_progress: list = [None] * args.jobs
        first_byte: list = [None] * args.jobs

        def submit(i):
            t = time.perf_counter()

            def on_progress(ev, _i=i, _t=t):
                if first_progress[_i] is None:
                    first_progress[_i] = time.perf_counter() - _t

            def on_part(frame, _i=i, _t=t):
                if first_byte[_i] is None:
                    first_byte[_i] = time.perf_counter() - _t

            results[i] = clients[i % n_replicas].submit(
                *paths, retries=5, on_progress=on_progress,
                on_part=on_part)
            latencies[i] = time.perf_counter() - t

        # ---- fleet mode: the aggregator polls every replica mid-wave
        fleet_polls: list[dict] = []
        agg = None
        stop_polling = threading.Event()

        def poll_fleet():
            while not stop_polling.is_set():
                try:
                    snap = agg.poll()
                    fleet_polls.append(
                        {"poll_s": snap.poll_s, "healthy": snap.healthy,
                         "scrape_s": sum(r.scrape_s
                                         for r in snap.replicas)})
                except Exception as exc:  # noqa: BLE001 — counted
                    fleet_polls.append({"error": str(exc)})
                stop_polling.wait(args.fleet_poll_s)

        poller = None
        if args.fleet:
            from ..obs.fleet import FleetAggregator

            agg = FleetAggregator([s.config.socket_path for s in servers])
            poller = threading.Thread(target=poll_fleet, daemon=True)
        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(args.jobs)]
        scrape_render_pre = sum(s._scrape_render_s for s in servers)
        t_wave = time.perf_counter()
        if poller is not None:
            poller.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wave_s = time.perf_counter() - t_wave
        if poller is not None:
            stop_polling.set()
            poller.join(timeout=5)
            agg.close()
        scrape_render_s = (sum(s._scrape_render_s for s in servers)
                           - scrape_render_pre)

        # ---- open-loop arrivals on the same warm server
        openloop: list[dict] = []
        if args.qps is not None or args.qps_curve:
            rates = []
            if args.qps_curve:
                rates += [float(r) for r in args.qps_curve.split(",")
                          if r.strip()]
            if args.qps is not None and args.qps not in rates:
                rates.append(args.qps)
            for k, rate in enumerate(sorted(set(rates))):
                pt = run_openloop(client, paths, rate, args.qps_jobs,
                                  seed=args.seed + k)
                openloop.append(pt)
                print(f"[servebench] openloop qps={rate:g}: "
                      f"p50 {pt.get('p50_s', float('nan')):.2f}s "
                      f"p99 {pt.get('p99_s', float('nan')):.2f}s "
                      f"ttfb_p50 {pt.get('ttfb_p50_s', float('nan')):.2f}s "
                      f"achieved {pt['achieved_qps']:g}/{rate:g}",
                      file=sys.stderr)

        snap = merge_fleet_snaps([s.stats_snapshot() for s in servers])
        audit_snaps = [s.auditor.snapshot() for s in servers
                       if s.auditor is not None]
        for srv in servers:
            srv.drain(timeout=60)

        # ---- every journal on its own (job ids restart per server)
        journal_entries = []
        journal_problems = []
        for jp in journal_paths:
            entries = read_journal(jp)
            journal_entries += entries
            journal_problems += (check_consistency(entries)
                                 + check_parts_streamed(entries))

    # ---- analysis
    fail: list[str] = []
    all_results = seq_results + [r for r in results if r is not None]
    warm_sorted = sorted(latencies)
    p50 = nearest_rank(warm_sorted, 0.50)
    p95 = nearest_rank(warm_sorted, 0.95)
    p99 = nearest_rank(warm_sorted, 0.99)
    seq_p50 = nearest_rank(sorted(seq_s), 0.50)
    cold_p50 = nearest_rank(sorted(cold_s), 0.50)
    compiles_per_job = [(r.serve.get("batch") or {}).get("compiles", 0)
                        for r in all_results]
    queue_waits = [r.serve["queue_wait_s"] for r in results
                   if r is not None] or [0.0]
    exec_s = [r.serve["exec_s"] for r in results if r is not None] or [0.0]
    if len(all_results) < len(seq_results) + args.jobs:
        fail.append(f"only {len(all_results) - len(seq_results)}/"
                    f"{args.jobs} wave jobs completed")
    if cold_out is not None and any(r.fasta != cold_out
                                    for r in all_results):
        fail.append("warm output diverged from cold CLI bytes")
    if any(compiles_per_job):
        fail.append(f"warm jobs first-dispatched launch shapes: "
                    f"{compiles_per_job}")
    if seq_p50 >= cold_p50:
        fail.append(f"warm p50 {seq_p50:.2f}s did not beat cold p50 "
                    f"{cold_p50:.2f}s")
    ttfp = [v for v in first_progress if v is not None]
    if len(ttfp) < args.jobs:
        fail.append(f"only {len(ttfp)}/{args.jobs} wave jobs received a "
                    "progress frame before their result")
    ttfp_p50 = nearest_rank(sorted(ttfp), 0.50) if ttfp else None
    ttfb = [v for v in first_byte if v is not None]
    if len(ttfb) < args.jobs:
        fail.append(f"only {len(ttfb)}/{args.jobs} wave jobs received a "
                    "result_part frame before their result")
    ttfb_p50 = nearest_rank(sorted(ttfb), 0.50) if ttfb else None
    for p in journal_problems:
        fail.append(f"journal inconsistency: {p}")
    fleet_block = None
    if args.fleet:
        good = [p for p in fleet_polls if "poll_s" in p]
        poll_errors = [p["error"] for p in fleet_polls if "error" in p]
        if not good:
            fail.append("fleet aggregator never completed a poll mid-wave "
                        f"({poll_errors[:3]})")
        else:
            lags = sorted(p["poll_s"] for p in good)
            # the replicas' own exposition-render seconds over the
            # replica-seconds of the wave: what the scrapes cost them
            overhead_pct = (scrape_render_s / max(wave_s, 1e-9)
                            / n_replicas * 100.0)
            unhealthy = sum(1 for p in good if not p["healthy"])
            fleet_block = {
                "replicas": n_replicas, "polls": len(good),
                "poll_errors": len(poll_errors),
                "agg_lag_p50_s": round(nearest_rank(lags, 0.50), 5),
                "agg_lag_max_s": round(lags[-1], 5),
                "scrape_render_s": round(scrape_render_s, 4),
                "scrape_overhead_pct": round(overhead_pct, 3),
                "unhealthy_polls": unhealthy,
            }
            if unhealthy or poll_errors:
                fail.append(f"fleet aggregator saw {unhealthy} unhealthy "
                            f"and {len(poll_errors)} failed polls mid-wave")
    audit_block = None
    if args.audit_rate is not None and audit_snaps:
        def _tot(key):
            return sum(a[key] for a in audit_snaps)

        on_mean = statistics.mean(audit_on_s or seq_s)
        off_mean = statistics.mean(audit_off_s) if audit_off_s else 0.0
        overhead_pct = ((on_mean / off_mean - 1.0) * 100.0
                        if off_mean > 0 else 0.0)
        audit_block = {
            "rate": args.audit_rate, "windows": _tot("windows"),
            "sampled": _tot("sampled"),
            "sampled_frac": round(_tot("sampled")
                                  / max(1, _tot("windows")), 4),
            "audited": _tot("audited"), "mismatches": _tot("mismatches"),
            "demotions": _tot("demotions"), "repaired": _tot("repaired"),
            "shadow_s": round(_tot("shadow_s"), 4),
            "overhead_pct": round(overhead_pct, 3),
            "ab_runs": len(audit_on_s),
            "seq_mean_on_s": round(on_mean, 4),
            "seq_mean_off_s": round(off_mean, 4),
        }
        if audit_block["mismatches"]:
            fail.append(f"audit caught {audit_block['mismatches']} "
                        "mismatches on a clean bench workload")
    baseline = None
    if args.baseline:
        try:
            with open(args.baseline) as fh:
                baseline = _baseline_view(json.load(fh))
        except (OSError, ValueError) as exc:
            fail.append(f"unreadable --baseline {args.baseline}: {exc}")

    b = snap["batcher"]
    print(f"[servebench] warm sequential: p50 {seq_p50:.2f}s vs cold p50 "
          f"{cold_p50:.2f}s (speedup x{cold_p50 / max(seq_p50, 1e-9):.1f}) "
          f"[{'OK' if seq_p50 < cold_p50 else 'FAIL'}]", file=sys.stderr)
    print(f"[servebench] warm concurrent: {args.jobs} jobs in {wave_s:.2f}s "
          f"({wave_s / args.jobs:.2f}s/job): latency p50 {p50:.2f}s p95 "
          f"{p95:.2f}s p99 {p99:.2f}s mean "
          f"{statistics.mean(latencies):.2f}s", file=sys.stderr)
    print(f"[servebench] cold: {len(cold_s)} runs: p50 {cold_p50:.2f}s "
          f"mean {statistics.mean(cold_s):.2f}s", file=sys.stderr)
    print(f"[servebench] first dispatches/job after warm-up: "
          f"{compiles_per_job} "
          f"[{'OK' if not any(compiles_per_job) else 'FAIL'} target 0]",
          file=sys.stderr)
    print(f"[servebench] queue wait mean {statistics.mean(queue_waits):.3f}s"
          f" max {max(queue_waits):.3f}s; exec mean "
          f"{statistics.mean(exec_s):.3f}s", file=sys.stderr)
    if ttfp:
        print(f"[servebench] time-to-first-progress: p50 {ttfp_p50:.3f}s "
              f"max {max(ttfp):.3f}s ({len(ttfp)}/{args.jobs} jobs)",
              file=sys.stderr)
    if ttfb:
        print(f"[servebench] time-to-first-byte (streamed part): p50 "
              f"{ttfb_p50:.3f}s max {max(ttfb):.3f}s vs job p50 "
              f"{p50:.3f}s ({len(ttfb)}/{args.jobs} jobs)", file=sys.stderr)
    if baseline and baseline.get("p99_s"):
        worst = (max((pt for pt in openloop if pt.get("p99_s")),
                     key=lambda pt: pt["qps"], default=None)
                 if openloop else None)
        cand_p99 = worst["p99_s"] if worst else p99
        cand_ttfb = worst.get("ttfb_p50_s") if worst else ttfb_p50
        delta = (1 - cand_p99 / baseline["p99_s"]) * 100
        print(f"[servebench] vs baseline "
              f"({baseline.get('design') or 'prior'}): p99 "
              f"{cand_p99:.2f}s vs {baseline['p99_s']:.2f}s "
              f"({abs(delta):.0f}% {'better' if delta >= 0 else 'WORSE'})"
              + (f", ttfb_p50 {cand_ttfb:.2f}s vs "
                 f"{baseline['ttfb_p50_s']:.2f}s"
                 if cand_ttfb and baseline.get("ttfb_p50_s") else ""),
              file=sys.stderr)
    if audit_block:
        print(f"[servebench] audit: rate {audit_block['rate']:g}: "
              f"{audit_block['sampled']}/{audit_block['windows']} windows "
              f"sampled, shadow {audit_block['shadow_s']:.3f}s, "
              f"{audit_block['mismatches']} mismatches, overhead "
              f"{audit_block['overhead_pct']:+.2f}%", file=sys.stderr)
    if fleet_block:
        print(f"[servebench] fleet: {n_replicas} replicas, "
              f"{fleet_block['polls']} aggregator polls mid-wave: lag p50 "
              f"{fleet_block['agg_lag_p50_s'] * 1e3:.1f}ms max "
              f"{fleet_block['agg_lag_max_s'] * 1e3:.1f}ms, scrape overhead "
              f"{fleet_block['scrape_overhead_pct']:.2f}%", file=sys.stderr)
    n_journal_jobs = len({e.get("job") for e in journal_entries
                          if e.get("job")})
    print(f"[servebench] journal: {len(journal_entries)} events / "
          f"{n_journal_jobs} jobs, {len(journal_problems)} consistency "
          f"problems [{'OK' if not journal_problems else 'FAIL'}]",
          file=sys.stderr)
    print(f"[servebench] device iterations: {b['iterations']} "
          f"({b['shared_iterations']} cross-job, max "
          f"{b['max_jobs_in_iteration']} jobs / "
          f"{b['max_windows_in_iteration']} windows per iteration)",
          file=sys.stderr)
    lanes = b.get("lanes") or []
    lanes_per_replica: dict = {}
    for ln in lanes:
        rep = ln.get("replica", 0)
        lanes_per_replica[rep] = lanes_per_replica.get(rep, 0) + 1
    if max(lanes_per_replica.values(), default=0) > 1:
        concurrent = b.get("max_concurrent_iterations", 0)
        print(f"[servebench] worker lanes: "
              + ", ".join(f"lane {ln['lane']}: {ln['iterations']} its / "
                          f"{ln['busy_s']:.2f}s busy" for ln in lanes)
              + f"; max {concurrent} iterations concurrent "
                f"[{'OK' if concurrent >= 2 else 'FAIL'} overlap]",
              file=sys.stderr)
        if concurrent < 2:
            fail.append("worker lanes never ran iterations concurrently "
                        f"(max_concurrent_iterations {concurrent})")
    elif args.worker_lanes is not None and args.worker_lanes > 1:
        fail.append(f"--worker-lanes {args.worker_lanes} requested but the "
                    f"server ran {max(lanes_per_replica.values(), default=1)}"
                    " lane(s)")

    if args.json:
        artifact = {
            "mode": "serve",
            "jobs": args.jobs,
            "warm": {"seq_p50_s": round(seq_p50, 3),
                     "p50_s": round(p50, 3), "p95_s": round(p95, 3),
                     "p99_s": round(p99, 3),
                     "mean_s": round(statistics.mean(latencies), 3),
                     "wave_s": round(wave_s, 3),
                     "warmup_s": round(warm_ready_s, 3),
                     "queue_wait_mean_s": round(
                         statistics.mean(queue_waits), 4),
                     "ttfp_p50_s": (round(ttfp_p50, 4)
                                    if ttfp_p50 is not None else None),
                     "ttfp_max_s": round(max(ttfp), 4) if ttfp else None,
                     "ttfb_p50_s": (round(ttfb_p50, 4)
                                    if ttfb_p50 is not None else None),
                     "ttfb_max_s": round(max(ttfb), 4) if ttfb else None,
                     "compiles_per_job": compiles_per_job},
            "slo": {k: (snap.get("slo") or {}).get(k) for k in
                    ("deadline_hit", "deadline_miss", "expired",
                     "miss_rate")},
            "journal": {"events": len(journal_entries),
                        "jobs": n_journal_jobs,
                        "consistent": not journal_problems},
            "cold": {"runs": len(cold_s), "p50_s": round(cold_p50, 3),
                     "mean_s": round(statistics.mean(cold_s), 3)},
            "speedup_p50": round(cold_p50 / max(seq_p50, 1e-9), 2),
            "iterations": {k: b.get(k) for k in
                           ("iterations", "shared_iterations", "jobs",
                            "windows", "max_jobs_in_iteration",
                            "max_windows_in_iteration",
                            "max_concurrent_iterations", "host_s")},
            "lanes": lanes,
            "mesh": _mesh_block(b, devices),
            "occupancy": b.get("occupancy", {}),
            "metrics": {"queue": snap["queue"],
                        "batcher": {k: v for k, v in b.items()
                                    if k != "occupancy"}},
            "pass": not fail,
        }
        if audit_block:
            artifact["audit"] = audit_block
        if fleet_block:
            artifact["fleet"] = fleet_block
        if openloop:
            artifact["openloop"] = {"curve": openloop,
                                    "jobs_per_rate": args.qps_jobs,
                                    "knee_qps": saturation_knee(openloop)}
        if baseline is not None:
            artifact["baseline"] = baseline
        _write(args, artifact)
    return _verdict(fail)


if __name__ == "__main__":
    sys.exit(main())
