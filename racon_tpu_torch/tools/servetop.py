"""servetop: a live console over one or many serve replicas and routers.

`top` for the polishing fleet. It polls every endpoint (a unix socket,
a localhost host:port RPC endpoint or an http:// metrics base), merges
the scrapes through obs/fleet.py's `FleetAggregator`, and draws one
screen a poll:

  - the fleet line: queue depth against capacity, inflight jobs, jobs
    completed and failed, deadline hits and misses with the burn rate
    (fast / slow window multiples of the budget, [FIRING] while the
    alert is up), iterations and their rate, first dispatches
    (`compiles`);
  - a row a replica: up, draining, queue, inflight, iterations a second,
    busy lanes, first dispatches, the scrape's round trip;
  - tenant rows (queued jobs, credit, device seconds) and the winner
    table's consults by (engine, decision, dtype);
  - window-cache rows and audit rows, only for replicas that armed them;
  - suffixes on the fleet line, each only once its families exist:
    audit mismatches ([AUDIT-ALERT]), rounds jobs in flight, QoS
    preemptions / doomed / cancelled ([PREEMPT n]), a router's routable
    against configured replicas with requeued shards ([REQUEUED]), and a
    router's autoscaler: scale-ups / scale-downs, the last pressure, and
    [SCALED +n] while n spawned replicas are alive.

On a terminal the screen redraws in place; on a pipe it prints one line
a poll. `--once` polls once, prints the screen and exits (0 when every
endpoint is healthy):

    python -m racon_tpu_torch.tools.servetop --endpoints /tmp/r.sock,/tmp/a.sock
    python -m racon_tpu_torch.tools.servetop --once --endpoints /tmp/a.sock

`--endpoints` is required; no environment variable names them. Each
cell, row, line and screen is the JAX package's `tools/servetop.py`'s
on the same scrapes, but for the autoscale suffix's scale-up and
scale-down counts: the JAX tool reads those counters without their
`_total` suffix and shows 0; this one reads them.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..obs.fleet import FleetAggregator

G = "racon_tpu_serve_"


def _g(parsed, name, default=0.0):
    return (parsed.gauges if parsed else {}).get(name, default)


def _c(parsed, name, default=0.0):
    return (parsed.counters if parsed else {}).get(name, default)


def _series(parsed, name) -> dict:
    """{labels_dict_key_value: value} for one labeled family."""
    if parsed is None:
        return {}
    series = dict(parsed.gauge_series.get(name, {}))
    series.update(parsed.counter_series.get(name, {}))
    return series


def audit_cell(p, prev: dict, dt: float) -> dict | None:
    """One replica's identity-audit cell from the sentinel's scrape
    families, or None when the replica doesn't expose them (audit
    off)."""
    if p is None or "racon_tpu_audit_sampled_total" not in p.counters:
        return None
    sampled = _c(p, "racon_tpu_audit_sampled_total")
    prev_a = prev.get("audit") or {}
    rate = ((sampled - prev_a.get("sampled", sampled)) / dt
            if dt > 0 else 0.0)
    mism = sum(int(v) for _labels, v in
               p.counter_series.get("racon_tpu_audit_mismatches_total",
                                    {}).values())
    healths = [v for _labels, v in
               p.gauge_series.get("racon_tpu_lane_health",
                                  {}).values()]
    return {"sampled": int(sampled), "sampled_rate": rate,
            "mismatches": mism,
            "demotions": int(_c(p, "racon_tpu_audit_demotions_total")),
            "lane_health_min": min(healths) if healths else 1.0,
            "alert": bool(p.gauges.get("racon_tpu_audit_alert", 0))}


def cache_cell(p) -> dict | None:
    """One replica's window-cache cell from the wincache scrape
    families, or None when the replica doesn't expose them (cache
    unarmed — the families are armed-only, like the audit ones)."""
    if p is None or "racon_tpu_serve_wincache_bytes" not in p.gauges:
        return None
    ops = {labels.get("op"): v for labels, v in
           p.counter_series.get("racon_tpu_serve_wincache_ops_total",
                                {}).values()}
    hits = ops.get("hit", 0)
    lookups = hits + ops.get("miss", 0)
    return {"hit_pct": hits / lookups * 100.0 if lookups else 0.0,
            "hits": int(hits),
            "bytes": int(_g(p, "racon_tpu_serve_wincache_bytes")),
            "entries": int(_g(p, "racon_tpu_serve_wincache_entries")),
            "evictions": int(ops.get("eviction", 0)),
            "quarantined": int(ops.get("quarantined", 0))}


def replica_row(rs, prev: dict, dt: float) -> dict:
    """One replica's console row, with rates from the previous poll."""
    p = rs.parsed
    iters = _c(p, G + "batch_iterations_total")
    rate = ((iters - prev.get("iterations", iters)) / dt
            if dt > 0 else 0.0)
    lanes_busy = lanes_total = 0
    if p is not None:
        for name, v in p.gauges.items():
            if name.startswith(G + "lane_") and name.endswith("_busy"):
                lanes_total += 1
                lanes_busy += int(v)
        if not lanes_total:
            lanes_total = int(_g(p, G + "worker_lanes", 1))
    return {"endpoint": rs.endpoint, "ok": rs.ok,
            "draining": rs.draining, "error": rs.error,
            "queue": int(_g(p, G + "queue_depth")),
            "inflight": int(_g(p, G + "inflight")),
            "iterations": iters, "iter_rate": rate,
            "lanes_busy": lanes_busy, "lanes": lanes_total,
            "compiles": int(_c(p, G + "compiles_total")),
            "scrape_ms": rs.scrape_s * 1e3,
            "audit": audit_cell(p, prev, dt),
            "cache": cache_cell(p)}


def tenant_rows(snap) -> list[dict]:
    """Merged per-tenant queued/credit/device-seconds across the
    fleet (device_s from the prorated cost-accounting counter)."""
    tenants: dict[str, dict] = {}

    def _row(t: str) -> dict:
        return tenants.setdefault(
            t, {"queued": 0, "credit": 0.0, "device_s": 0.0})

    for name, key in ((G + "tenant_queue_depth", "queued"),
                      (G + "tenant_credit", "credit")):
        for labels, v in snap.gauge_series.get(name, {}).values():
            _row(labels.get("tenant", ""))[key] += v
    for labels, v in snap.counter_series.get(
            G + "tenant_device_seconds_total", {}).values():
        _row(labels.get("tenant", ""))["device_s"] += v
    return [dict(row, tenant=t or "<anon>")
            for t, row in sorted(tenants.items())]


def autotune_rows(snap) -> list[tuple[str, int]]:
    out = []
    for labels, v in snap.counter_series.get(
            "racon_tpu_sched_autotune_consults_total", {}).values():
        tag = "/".join(x for x in (labels.get("engine", "?"),
                                   labels.get("decision", "?"),
                                   labels.get("dtype", "")) if x)
        out.append((tag, int(v)))
    return sorted(out)


def fleet_line(snap, burn: dict, prev: dict, dt: float) -> str:
    iters = snap.counters.get(G + "batch_iterations_total", 0)
    rate = ((iters - prev.get("iterations", iters)) / dt
            if dt > 0 else 0.0)
    hit = int(snap.counters.get(G + "jobs_deadline_hit_total", 0))
    miss = int(snap.counters.get(G + "jobs_deadline_miss_total", 0))
    return (f"fleet  queue {int(snap.gauges.get(G + 'queue_depth', 0))}"
            f"/{int(snap.gauges.get(G + 'queue_capacity', 0))}"
            f"  inflight {int(snap.gauges.get(G + 'inflight', 0))}"
            f"  completed {int(snap.counters.get(G + 'jobs_completed_total', 0))}"
            f" ({int(snap.counters.get(G + 'jobs_failed_total', 0))} failed)"
            f"  slo {hit}+/{miss}-"
            f"  burn {burn.get('fast', 0):g}x/{burn.get('slow', 0):g}x"
            f"{' [FIRING]' if burn.get('firing') else ''}"
            f"  iters {int(iters)} ({rate:.1f}/s)"
            f"  compiles {int(snap.counters.get(G + 'compiles_total', 0))}"
            + _fleet_audit(snap) + _fleet_rounds(snap)
            + _fleet_preempt(snap) + _fleet_router(snap)
            + _fleet_autoscale(snap))


def _fleet_audit(snap) -> str:
    """Fleet-level audit suffix (empty when no replica audits): the
    federated mismatch total plus [AUDIT-ALERT] while any replica's
    racon_tpu_audit_alert gauge is up."""
    if "racon_tpu_audit_sampled_total" not in snap.counters:
        return ""
    mism = sum(int(v) for _labels, v in snap.counter_series.get(
        "racon_tpu_audit_mismatches_total", {}).values())
    return (f"  audit {mism} mism"
            + ("  [AUDIT-ALERT]"
               if snap.gauges.get("racon_tpu_audit_alert", 0) else ""))


def _fleet_rounds(snap) -> str:
    """Iterative-rounds suffix (empty until some replica ran a
    rounds=N job — the families are armed-only): rounds jobs in flight
    now, plus the lifetime completed-rounds / rounds-jobs counters."""
    if "racon_tpu_serve_rounds_inflight" not in snap.gauges:
        return ""
    inflight = int(snap.gauges.get("racon_tpu_serve_rounds_inflight",
                                   0))
    jobs = int(snap.counters.get("racon_tpu_serve_rounds_jobs_total",
                                 0))
    done = int(snap.counters.get(
        "racon_tpu_serve_rounds_completed_total", 0))
    return f"  rounds {inflight} infl ({done}r/{jobs}j)"


def _fleet_preempt(snap) -> str:
    """QoS suffix (empty until some replica arms preemption / abort
    margin / burst tokens or fires a QoS event — the families are
    armed-only): lifetime preemptions, doomed-aborts and cancels, plus
    [PREEMPT] while any job is parked right now."""
    if "racon_tpu_serve_preemptions_total" not in snap.counters:
        return ""
    pre = int(snap.counters.get("racon_tpu_serve_preemptions_total", 0))
    doomed = int(snap.counters.get(
        "racon_tpu_serve_aborted_doomed_total", 0))
    cancelled = int(snap.counters.get(
        "racon_tpu_serve_cancelled_total", 0))
    parked = int(snap.gauges.get("racon_tpu_serve_preempted_inflight",
                                 0))
    return (f"  qos {pre}p/{doomed}d/{cancelled}c"
            + (f"  [PREEMPT {parked}]" if parked else ""))


def _fleet_router(snap) -> str:
    """Router suffix (empty when no polled endpoint is a shard-aware
    router, serve/router.py): routable vs configured replica counts
    behind the router, the draining count mid rolling restart, and the
    outstanding requeued shards — [REQUEUED] while any shard lost to a
    dead replica is still waiting to finish on a survivor."""
    if "racon_tpu_router_replicas" not in snap.gauges:
        return ""
    total = int(snap.gauges.get("racon_tpu_router_replicas", 0))
    routable = int(snap.gauges.get(
        "racon_tpu_router_replicas_routable", 0))
    draining = int(snap.gauges.get(
        "racon_tpu_router_replicas_draining", 0))
    requeued = int(snap.gauges.get(
        "racon_tpu_router_requeued_outstanding", 0))
    return (f"  router {routable}/{total} routable"
            + (f" ({draining} drn)" if draining else "")
            + f"  requeued {requeued}"
            + ("  [REQUEUED]" if requeued else ""))


def _fleet_autoscale(snap) -> str:
    """Elastic-fleet suffix (empty unless a polled router armed the
    autoscaler, serve/autoscale.py — the families are armed-only):
    lifetime scale-ups/scale-downs, the last polled backlog pressure
    (queued+inflight jobs per routable replica), and [SCALED +n] while
    n autoscaler-owned replicas are alive right now."""
    if "racon_tpu_router_autoscale_spawned" not in snap.gauges:
        return ""
    # counters are exposed with their `_total` suffix (the JAX package's
    # tools/servetop.py reads the names without it, and so shows 0u/0d)
    ups = int(snap.counters.get(
        "racon_tpu_router_autoscale_scale_ups_total", 0))
    downs = int(snap.counters.get(
        "racon_tpu_router_autoscale_scale_downs_total", 0))
    spawned = int(snap.gauges.get(
        "racon_tpu_router_autoscale_spawned", 0))
    pressure = snap.gauges.get("racon_tpu_router_autoscale_pressure",
                               0.0)
    return (f"  autoscale {ups}u/{downs}d pressure {pressure:g}"
            + (f"  [SCALED +{spawned}]" if spawned else ""))


def render_screen(snap, burn: dict, rows: list[dict], prev: dict,
                  dt: float) -> str:
    up = sum(1 for r in snap.replicas if r.ok)
    lines = [f"racon-tpu servetop — {len(snap.replicas)} replica(s), "
             f"{up} up · {time.strftime('%H:%M:%S')} · poll "
             f"{snap.poll_s * 1e3:.0f}ms",
             fleet_line(snap, burn, prev, dt), ""]
    lines.append(f"{'replica':<36} {'up':>2} {'drn':>3} {'queue':>5} "
                 f"{'infl':>4} {'it/s':>6} {'lanes':>5} {'cmpl':>4} "
                 f"{'ms':>5}")
    for row in rows:
        if row["error"]:
            lines.append(f"{row['endpoint']:<36}  -  DOWN  "
                         f"{row['error']}")
            continue
        lines.append(
            f"{row['endpoint']:<36} {'y' if row['ok'] else 'n':>2} "
            f"{'y' if row['draining'] else '-':>3} "
            f"{row['queue']:>5} {row['inflight']:>4} "
            f"{row['iter_rate']:>6.1f} "
            f"{row['lanes_busy']}/{row['lanes']:<3} "
            f"{row['compiles']:>4} {row['scrape_ms']:>5.1f}")
    tenants = tenant_rows(snap)
    if tenants:
        lines.append("")
        lines.append(f"{'tenant':<20} {'queued':>6} {'credit':>8} "
                     f"{'dev-s':>8}")
        for t in tenants:
            lines.append(f"{t['tenant']:<20} {int(t['queued']):>6} "
                         f"{t['credit']:>8.2f} "
                         f"{t.get('device_s', 0.0):>8.2f}")
    tunes = autotune_rows(snap)
    if tunes:
        lines.append("")
        lines.append("autotune  " + "  ".join(
            f"{tag}={n}" for tag, n in tunes))
    cache_rows = [(r["endpoint"], r["cache"]) for r in rows
                  if r.get("cache")]
    if cache_rows:
        lines.append("")
        lines.append(f"{'wincache':<36} {'hit%':>6} {'MiB':>7} "
                     f"{'entr':>5} {'evict':>5} {'quar':>4}")
        for endpoint, c in cache_rows:
            lines.append(
                f"{endpoint:<36} {c['hit_pct']:>6.1f} "
                f"{c['bytes'] / (1 << 20):>7.2f} {c['entries']:>5} "
                f"{c['evictions']:>5} {c['quarantined']:>4}")
    audit_rows = [(r["endpoint"], r["audit"]) for r in rows
                  if r.get("audit")]
    if audit_rows:
        lines.append("")
        lines.append(f"{'audit':<36} {'smp/s':>6} {'mism':>5} "
                     f"{'demot':>5} {'laneh':>6}")
        for endpoint, a in audit_rows:
            lines.append(
                f"{endpoint:<36} {a['sampled_rate']:>6.1f} "
                f"{a['mismatches']:>5} {a['demotions']:>5} "
                f"{a['lane_health_min']:>6.2f}"
                + ("  [ALERT]" if a["alert"] else ""))
    return "\n".join(lines)


def render_line(snap, burn: dict, prev: dict, dt: float) -> str:
    """The one-line-per-poll pipe mode."""
    up = sum(1 for r in snap.replicas if r.ok)
    return (f"[servetop] up={up}/{len(snap.replicas)} "
            + fleet_line(snap, burn, prev, dt))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m racon_tpu_torch.tools.servetop",
        description="live serve-fleet console (see module docstring)")
    ap.add_argument("--endpoints", required=True,
                    help="comma-separated endpoints: unix socket paths, "
                         "localhost host:port RPC or http:// metrics bases")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="poll interval seconds (default 2)")
    ap.add_argument("--timeout", type=float, default=2.0,
                    help="per-replica scrape timeout seconds")
    ap.add_argument("--once", action="store_true",
                    help="poll once, print, exit (0 = all replicas "
                         "healthy)")
    ap.add_argument("--no-tty", action="store_true",
                    help="force the one-line-per-poll pipe mode")
    args = ap.parse_args(argv)

    endpoints = [e.strip() for e in args.endpoints.split(",") if e.strip()]
    try:
        agg = FleetAggregator(endpoints, timeout_s=args.timeout)
    except ValueError as exc:
        print(f"[servetop] error: {exc}", file=sys.stderr)
        return 2

    tty = sys.stdout.isatty() and not args.no_tty and not args.once
    prev: dict = {}
    prev_rows: dict = {}
    t_prev = None
    try:
        while True:
            snap = agg.poll()
            now = time.monotonic()
            dt = (now - t_prev) if t_prev is not None else 0.0
            t_prev = now
            burn = agg.burn.state()
            rows = [replica_row(r, prev_rows.get(r.endpoint, {}), dt)
                    for r in snap.replicas]
            if tty:
                sys.stdout.write("\x1b[H\x1b[2J")
                print(render_screen(snap, burn, rows, prev, dt))
            elif args.once:
                print(render_screen(snap, burn, rows, prev, dt))
            else:
                print(render_line(snap, burn, prev, dt), flush=True)
            prev = {"iterations": snap.counters.get(
                G + "batch_iterations_total", 0)}
            prev_rows = {row["endpoint"]: row for row in rows}
            if args.once:
                return 0 if snap.healthy else 1
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
