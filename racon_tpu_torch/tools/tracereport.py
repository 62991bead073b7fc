"""Critical path and cost report over a merged distributed trace.

A routed `submit --trace-out` job (or `PolishClient.submit_traced`)
leaves one Chrome-trace JSON with a process track per participant:
client (pid 1), router (pid 2), one track per replica (pid 3+), all on
the client's clock (serve/client.py `merge_trace`). This tool walks the
shard graph and says which hop bounded the job's wall and where the
time went inside it:

    python -m racon_tpu_torch.tools.tracereport merged.json [--check] [--json]

The critical shard is the `router.shard` span that ended last. The job
wall, `router.plan` start to `router.merge` end, splits into stages:

    plan      the router's target parse and shard plan
    requeue   the critical shard's failed attempts (replica lost,
              requeued), first dispatch to the final one
    hold      the final attempt's wait for a replica while the dispatch
              hold was on (`router.dispatch` spans with `held`)
    wait      the final attempt's wait without the hold (no routable or
              idle replica)
    queue     the replica's queue wait (`serve.queue_wait`, child trace)
    device    the child's iterations' device time (`serve.iteration`
              duration less its measured `host_s`)
    host      the iterations' measured host time (`host_s`)
    gather    the replica's `serve.job` wall outside iterations (align,
              stitch, frame encoding)
    net       the child request's wall outside the replica's job (frames
              and admission)
    merge     the router's assembly of the result
    other     the residual (shard-join gaps, rounding, clock skew)

plus a `wincache` estimate (time not spent, from the rounds cache's
hits, outside the partition). A direct (router-less) trace gives the
same report over queue / device / host / gather. Per-tenant device
seconds come along when the shard batches carry them.

`--check` exits 2 on any problem: the stages sum to the wall and none is
negative beyond the clock bracket; each shard's `serve.iteration` spans
sum to its batch `device_s`; the `router.requeue` instants match the
router block's requeues and every shard of `shards_detail` has its
spans; the span wall agrees with the router block's `wall_s`. It needs
only the file, and imports nothing but the standard library. Its
results are the JAX package's `tools/tracereport.py`'s on the same file.
"""

from __future__ import annotations

import argparse
import json
import sys


def _spans(events, name):
    return [e for e in events
            if e.get("ph") == "X" and e.get("name") == name]


def _instants(events, name):
    return [e for e in events
            if e.get("ph") == "i" and e.get("name") == name]


def _dur_s(ev) -> float:
    return float(ev.get("dur", 0.0)) / 1e6


def _end(ev) -> float:
    return float(ev.get("ts", 0.0)) + float(ev.get("dur", 0.0))


def _arg(ev, key, default=None):
    return (ev.get("args") or {}).get(key, default)


def clock_bracket_s(ctx: dict) -> float:
    """Worst-case cross-track skew: each handshake is good to
    ±rtt/2, and a replica track chains two handshakes."""
    rtt = float(ctx.get("clock_rtt_s") or 0.0)
    worst = max((float(r.get("rtt_s") or 0.0)
                 for r in ctx.get("replicas") or []), default=0.0)
    return (rtt + worst) / 2.0


def load(path: str) -> dict:
    with open(path) as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError(f"{path}: not a Chrome-trace document")
    return doc


def shard_lanes(events, trace_id: str) -> dict[int, dict]:
    """Per-shard view of the router's spans: dispatch attempts and
    shard (child request) spans in time order, plus the child trace id
    every replica-side span carries."""
    lanes: dict[int, dict] = {}
    for name in ("router.dispatch", "router.shard"):
        for ev in _spans(events, name):
            k = _arg(ev, "shard")
            if k is None:
                continue
            lane = lanes.setdefault(
                int(k), {"dispatch": [], "shard": [],
                         "tid": _arg(ev, "trace_id")})
            lane[name.split(".", 1)[1]].append(ev)
    for lane in lanes.values():
        lane["dispatch"].sort(key=lambda e: e.get("ts", 0.0))
        lane["shard"].sort(key=lambda e: e.get("ts", 0.0))
    return lanes


def child_spans(events, tid: str) -> dict:
    """Replica-side spans tagged with one child trace id."""

    def _tagged(name):
        out = []
        for ev in _spans(events, name):
            if _arg(ev, "trace_id") == tid:
                out.append(ev)
            else:
                tids = _arg(ev, "trace_ids") or []
                if isinstance(tids, (list, tuple)) and tid in tids:
                    out.append(ev)
        return out

    return {"queue_wait": _tagged("serve.queue_wait"),
            "job": _tagged("serve.job"),
            "iterations": _tagged("serve.iteration")}


def _iteration_buckets(iters) -> tuple[float, float]:
    """(device_s, host_s) split of the iteration spans: host is the
    measured per-iteration overhead each span carries."""
    device = host = 0.0
    for ev in iters:
        h = float(_arg(ev, "host_s", 0.0) or 0.0)
        d = _dur_s(ev)
        host += min(h, d)
        device += max(0.0, d - h)
    return device, host


def analyze(doc: dict) -> dict:
    """The report body: critical path + stage attribution + checks
    input. Raises ValueError when the document has no job spans."""
    events = doc.get("traceEvents") or []
    ctx = doc.get("trace_context") or {}
    stats = ctx.get("stats") or {}
    trace_id = ctx.get("trace_id") or ""
    plan = _spans(events, "router.plan")
    routed = bool(plan)
    out: dict = {"trace_id": trace_id,
                 "job_id": ctx.get("job_id"),
                 "routed": routed,
                 "bracket_s": clock_bracket_s(ctx)}

    if not routed:
        # direct submit: one replica track, no router hops
        jobs = _spans(events, "serve.job")
        if not jobs:
            raise ValueError("no router.plan or serve.job span - not "
                             "a merged job trace")
        job = jobs[0]
        qws = _spans(events, "serve.queue_wait")
        qw = _dur_s(qws[0]) if qws else 0.0
        iters = _spans(events, "serve.iteration")
        device, host = _iteration_buckets(iters)
        isum = sum(_dur_s(e) for e in iters)
        wall = (_end(job) - (qws[0].get("ts", job.get("ts", 0.0))
                             if qws else job.get("ts", 0.0))) / 1e6
        stages = {"queue": qw, "device": device, "host": host,
                  "gather": max(0.0, _dur_s(job) - isum)}
        stages["other"] = wall - sum(stages.values())
        out.update(wall_s=wall, stages=stages, shards={},
                   critical=None,
                   path=["queue", "device", "gather"])
        out["iteration_span_sums"] = {0: isum}
        return out

    plan = plan[0]
    merges = _spans(events, "router.merge")
    if not merges:
        raise ValueError("routed trace has no router.merge span "
                         "(failed job?)")
    merge = merges[-1]
    wall = (_end(merge) - float(plan.get("ts", 0.0))) / 1e6
    lanes = shard_lanes(events, trace_id)
    shards: dict[int, dict] = {}
    crit_k, crit_end = None, -1.0
    for k, lane in sorted(lanes.items()):
        tid = lane["tid"] or f"{trace_id}.s{k}"
        rep = child_spans(events, tid)
        final_shard = lane["shard"][-1] if lane["shard"] else None
        device, host = _iteration_buckets(rep["iterations"])
        isum = sum(_dur_s(e) for e in rep["iterations"])
        qw = sum(_dur_s(e) for e in rep["queue_wait"])
        jb = sum(_dur_s(e) for e in rep["job"])
        hold = sum(_dur_s(e) for e in lane["dispatch"]
                   if _arg(e, "held"))
        wait = sum(_dur_s(e) for e in lane["dispatch"]
                   if not _arg(e, "held"))
        requeue = 0.0
        if len(lane["dispatch"]) > 1:
            first = float(lane["dispatch"][0].get("ts", 0.0))
            last = lane["dispatch"][-1]
            requeue = (float(last.get("ts", 0.0)) - first) / 1e6
            # the final attempt's own acquisition is hold/wait, not
            # requeue penalty
            hold = _dur_s(last) if _arg(last, "held") else 0.0
            wait = 0.0 if _arg(last, "held") else _dur_s(last)
        info = {"trace_id": tid,
                "replica": (_arg(final_shard, "replica")
                            if final_shard else None),
                "attempts": len(lane["dispatch"]),
                "requeue_s": requeue, "hold_s": hold, "wait_s": wait,
                "queue_s": qw, "device_s": device, "host_s": host,
                "gather_s": max(0.0, jb - isum),
                "net_s": max(0.0, (_dur_s(final_shard)
                                   if final_shard else 0.0) - qw - jb),
                "iteration_span_sum_s": isum,
                "end_us": _end(final_shard) if final_shard else 0.0}
        shards[k] = info
        if final_shard is not None and info["end_us"] > crit_end:
            crit_k, crit_end = k, info["end_us"]
    if crit_k is None:
        raise ValueError("routed trace has no router.shard spans")
    c = shards[crit_k]
    stages = {"plan": _dur_s(plan),
              "requeue": c["requeue_s"], "hold": c["hold_s"],
              "wait": c["wait_s"], "queue": c["queue_s"],
              "device": c["device_s"], "host": c["host_s"],
              "gather": c["gather_s"], "net": c["net_s"],
              "merge": _dur_s(merge)}
    stages["other"] = wall - sum(stages.values())
    out.update(wall_s=wall, stages=stages, shards=shards,
               critical=crit_k,
               path=["plan", f"shard {crit_k}"
                     + (f" @{c['replica']}" if c["replica"] else ""),
                     "merge"])
    out["requeue_instants"] = len(_instants(events, "router.requeue"))
    out["stream_instants"] = len(_instants(events, "router.stream"))
    # per-tenant cost, when the shard batches carry the accounting
    tenants: dict[str, float] = {}
    for d in (stats.get("router") or {}).get("shards_detail") or []:
        batch = d.get("batch") or {}
        if "device_share_s" in batch:
            t = batch.get("tenant") or "<anon>"
            tenants[t] = tenants.get(t, 0.0) + batch["device_share_s"]
    if tenants:
        out["tenant_device_s"] = tenants
    return out


def check(doc: dict, rep: dict) -> list[str]:
    """Self-consistency problems (empty = green)."""
    problems: list[str] = []
    ctx = doc.get("trace_context") or {}
    stats = ctx.get("stats") or {}
    eps = 2.0 * rep["bracket_s"] + 1e-3
    drift = abs(rep["wall_s"] - sum(rep["stages"].values()))
    if drift > 1e-6:
        problems.append(
            f"stage partition does not sum to wall: drift {drift:.6f}s")
    for name, v in rep["stages"].items():
        if v < -eps:
            problems.append(
                f"stage {name} is negative beyond the clock bracket "
                f"({v:.4f}s < -{eps:.4f}s)")
    router = stats.get("router") or {}
    detail = router.get("shards_detail")
    if rep["routed"] and detail is not None:
        for d in detail:
            k = d.get("shard")
            batch = d.get("batch") or {}
            dev = batch.get("device_s")
            shard = rep["shards"].get(k)
            if shard is None:
                problems.append(f"shard {k} in shards_detail has no "
                                "dispatch/shard spans in the trace")
                continue
            if dev is not None and batch.get("iterations"):
                isum = shard["iteration_span_sum_s"]
                tol = max(0.05 * float(dev), 2e-3)
                if abs(isum - float(dev)) > tol:
                    problems.append(
                        f"shard {k}: iteration span sum {isum:.4f}s "
                        f"!= batch device_s {dev:.4f}s (tol "
                        f"{tol:.4f}s)")
    if rep["routed"] and router:
        want = router.get("requeues")
        got = rep.get("requeue_instants", 0)
        if want is not None and got != want:
            problems.append(
                f"router.requeue instants ({got}) != router block "
                f"requeues ({want})")
        wall_stat = router.get("wall_s")
        if wall_stat is not None:
            tol = max(0.10 * float(wall_stat), 0.05)
            if abs(rep["wall_s"] - float(wall_stat)) > tol:
                problems.append(
                    f"span wall {rep['wall_s']:.4f}s disagrees with "
                    f"router wall_s {wall_stat:.4f}s (tol {tol:.4f}s)")
    return problems


def wincache_estimate(ctx_stats: dict, rep: dict) -> float | None:
    """Rounds-cache time-saved estimate: hits x the measured
    per-dispatched-window device cost. None when no cache stats."""
    cache = (ctx_stats.get("rounds") or {}).get("cache")
    if not cache:
        return None
    hits = int(cache.get("hits", 0))
    misses = int(cache.get("misses", 0))
    device = rep["stages"].get("device", 0.0)
    if misses <= 0 or device <= 0:
        return 0.0
    return hits * (device / misses)


def render(rep: dict, saved: float | None) -> str:
    lines = []
    kind = "routed" if rep["routed"] else "direct"
    lines.append(
        f"tracereport: job {rep.get('job_id')} "
        f"(trace {rep.get('trace_id') or '-'}), {kind}, "
        f"{len(rep['shards']) or 1} shard(s), "
        f"wall {rep['wall_s']:.4f}s, "
        f"clock bracket +/-{rep['bracket_s'] * 1e3:.3f}ms")
    lines.append("critical path: " + " -> ".join(rep["path"]))
    lines.append(f"  {'stage':<10} {'seconds':>9} {'% wall':>7}")
    wall = rep["wall_s"] or 1.0
    for name, v in rep["stages"].items():
        lines.append(f"  {name:<10} {v:>9.4f} {100.0 * v / wall:>6.1f}%")
    lines.append(f"  {'sum':<10} {sum(rep['stages'].values()):>9.4f} "
                 f"{100.0:>6.1f}%")
    if saved is not None:
        lines.append(f"  wincache saved ~{saved:.4f}s "
                     "(est., not part of the wall)")
    if len(rep["shards"]) > 1:
        lines.append("shards:")
        for k, s in sorted(rep["shards"].items()):
            mark = " *" if k == rep["critical"] else ""
            lines.append(
                f"  s{k}{mark} @{s['replica']}: "
                f"attempts {s['attempts']}, queue {s['queue_s']:.4f}s, "
                f"device {s['device_s']:.4f}s, host {s['host_s']:.4f}s, "
                f"gather {s['gather_s']:.4f}s")
    for t, v in sorted((rep.get("tenant_device_s") or {}).items()):
        lines.append(f"tenant {t}: {v:.4f} device-seconds")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m racon_tpu_torch.tools.tracereport",
        description="critical-path + cost attribution over a merged "
                    "distributed trace (submit --trace-out)")
    ap.add_argument("trace", help="merged Chrome-trace JSON")
    ap.add_argument("--check", action="store_true",
                    help="run the self-consistency checks; any "
                         "problem exits 2")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of text")
    args = ap.parse_args(argv)
    try:
        doc = load(args.trace)
        rep = analyze(doc)
    except (OSError, ValueError, json.JSONDecodeError) as exc:
        print(f"tracereport: error: {exc}", file=sys.stderr)
        return 1
    ctx_stats = (doc.get("trace_context") or {}).get("stats") or {}
    saved = wincache_estimate(ctx_stats, rep)
    problems = check(doc, rep) if args.check else []
    if args.json:
        body = dict(rep)
        if saved is not None:
            body["wincache_saved_est_s"] = saved
        if args.check:
            body["problems"] = problems
        print(json.dumps(body, indent=2, sort_keys=True))
    else:
        print(render(rep, saved))
    if args.check:
        for p in problems:
            print(f"CHECK: {p}", file=sys.stderr)
        print(f"tracereport --check: "
              f"{'FAIL (' + str(len(problems)) + ' problem(s))' if problems else 'ok'}",
              file=sys.stderr)
        if problems:
            return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
