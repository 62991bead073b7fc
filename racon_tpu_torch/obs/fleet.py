"""The fleet's observability plane: scrape federation and SLO burn rates.

Each server's observability (its histograms, the `scrape` RPC, the
flight ring, the journal) is local to its process. This module merges
several of them:

  - `FleetAggregator` polls any number of replica endpoints (the unix or
    TCP `scrape` / `healthz` RPC of serve/protocol.py, or an `http://`
    `/metrics` and `/healthz` pair), parses each body back into typed
    series through obs/prom.py's strict parser, and merges them:
    counters and gauges sum per (name, labels); histograms rebuild
    through `Histogram.from_export` and fold through the same
    `Histogram.merge` the in-process path uses, so the fleet's quantiles
    are those of the pooled per-replica buckets (with the exact min and
    max of the `_min` / `_max` sidecars). Bucket exemplars survive the
    merge, last write wins.
  - The merged view is exposed three ways: a federated `/metrics` and
    `/healthz` HTTP endpoint (healthy = every replica reachable and not
    draining, per-replica detail in the JSON body), a machine-readable
    snapshot (`to_json()`, the body of `python -m racon_tpu_torch fleet
    --json`), and the router's own `/metrics`, which federates its
    replicas through one aggregator (serve/router.py).
  - `BurnRateTracker` is a fast/slow dual-window burn-rate monitor over
    the cumulative `deadline_hit` / `deadline_miss` counters (the SRE
    multiwindow shape: it fires only when both the fast and the slow
    window burn the error budget faster than `threshold` times, so a
    single straggler cannot page and a sustained breach cannot hide).
    The server samples it on every deadline-carrying job (the queue's
    `on_slo` hook), the aggregator on every poll; a change of state
    journals a typed `alert` line, and the scrape carries
    `racon_tpu_slo_burn_rate`, `..._burn_rate_slow` and `..._burn_alert`.

The endpoints, the budget, the two windows and the threshold are
parameters (`endpoints=` and the `fleet --endpoints` flag, the server's
`slo_*` keywords and `serve` flags); no environment variable sets them.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import threading
import time
from collections import deque

from . import prom
from .hist import HistogramSet

#: the merged counters the fleet's burn tracker reads
HIT_COUNTER = "racon_tpu_serve_jobs_deadline_hit_total"
MISS_COUNTER = "racon_tpu_serve_jobs_deadline_miss_total"

#: the defaults: allowed deadline-miss rate, the two window lengths in
#: seconds and the burn multiple that fires
DEFAULT_BUDGET = 0.01
DEFAULT_FAST_S = 60.0
DEFAULT_SLOW_S = 600.0
DEFAULT_THRESHOLD = 2.0


class BurnRateTracker:
    """Fast/slow dual-window SLO burn-rate monitor (module docstring).

    Feed it cumulative deadline_hit / deadline_miss samples through
    `sample()`; it returns the windowed burn rates (the window's miss
    rate over the error budget), the firing state, and whether the state
    just changed (the journal's alert edge). `seed_zero` plants a (0, 0)
    baseline at the first sample: right for a tracker born with its
    counters (the server); one attaching to counters mid-life leaves it
    False, so the existing totals are the baseline."""

    def __init__(self, budget: float = DEFAULT_BUDGET,
                 fast_s: float = DEFAULT_FAST_S,
                 slow_s: float = DEFAULT_SLOW_S,
                 threshold: float = DEFAULT_THRESHOLD,
                 seed_zero: bool = False):
        self.budget = max(1e-9, float(budget))
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self.threshold = float(threshold)
        self._samples: deque = deque()
        self._lock = threading.Lock()
        self.firing = False
        self.fast = 0.0
        self.slow = 0.0
        #: planted lazily at the first sample's own clock, so callers
        #: that drive `t` (tests, replayed journals) keep one timeline
        self._seed_zero = seed_zero

    def _burn_locked(self, now: float, window: float) -> float:
        """Miss rate over `window`, as a multiple of the budget. The
        baseline is the newest sample at or before the window start (else
        the oldest), so a short history reads as its full length rather
        than as zero."""
        if len(self._samples) < 2:
            return 0.0
        cutoff = now - window
        base = self._samples[0]
        for s in self._samples:
            if s[0] > cutoff:
                break
            base = s
        latest = self._samples[-1]
        dh = latest[1] - base[1]
        dm = latest[2] - base[2]
        total = dh + dm
        if total <= 0 or dm <= 0:
            return 0.0
        return (dm / total) / self.budget

    def sample(self, hit: int, miss: int, t: float | None = None) -> dict:
        """Record one cumulative sample and re-evaluate. Returns {fast,
        slow, firing, changed, threshold}."""
        now = time.monotonic() if t is None else t
        with self._lock:
            if self._seed_zero:
                self._seed_zero = False
                self._samples.append((now - 1e-9, 0, 0))
            # a counter that went down was reset (a restart): the older
            # samples no longer compare, so rebase on the new totals
            # rather than let negative deltas hide an ongoing breach
            if self._samples and (hit < self._samples[-1][1]
                                  or miss < self._samples[-1][2]):
                self._samples.clear()
            self._samples.append((now, int(hit), int(miss)))
            # keep one sample at or before the slow window's start as
            # its baseline; anything older no window reaches
            while (len(self._samples) > 2
                   and self._samples[1][0] <= now - self.slow_s):
                self._samples.popleft()
            self.fast = self._burn_locked(now, self.fast_s)
            self.slow = self._burn_locked(now, self.slow_s)
            firing = (self.fast >= self.threshold
                      and self.slow >= self.threshold)
            changed = firing != self.firing
            self.firing = firing
            return {"fast": round(self.fast, 4),
                    "slow": round(self.slow, 4),
                    "firing": firing, "changed": changed,
                    "threshold": self.threshold}

    def state(self) -> dict:
        with self._lock:
            return {"fast": round(self.fast, 4),
                    "slow": round(self.slow, 4),
                    "firing": self.firing,
                    "threshold": self.threshold,
                    "budget": self.budget}


# ---------------------------------------------------------------- endpoints
class Endpoint:
    """One replica address, in one of three spellings:

      - `http://host:port[/base]`: HTTP, GET `<base>/metrics` and
        `<base>/healthz` (a server's `--metrics-port`, or another
        aggregator: federation composes);
      - `host:port`, `:port` or `port`: the TCP RPC (`scrape` and
        `healthz` frames);
      - anything with a path separator: the unix-socket RPC."""

    def __init__(self, spec: str):
        self.spec = spec.strip()
        if not self.spec:
            raise ValueError("empty fleet endpoint")
        if self.spec.startswith(("http://", "https://")):
            self.kind = "http"
            self.base = self.spec.rstrip("/")
            if self.base.endswith("/metrics"):
                self.base = self.base[: -len("/metrics")]
        elif "/" in self.spec or os.path.sep in self.spec:
            self.kind = "unix"
        else:
            self.kind = "tcp"
            host, _, port = self.spec.rpartition(":")
            try:
                self.port = int(port)
            except ValueError:
                raise ValueError(
                    f"fleet endpoint {spec!r}: expected host:port, a "
                    "unix socket path, or an http:// URL") from None
            self.host = host or "127.0.0.1"

    def _rpc(self, req: dict, timeout: float) -> dict:
        from ..serve.protocol import recv_frame, send_frame

        if self.kind == "unix":
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            addr = self.spec
        else:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            addr = (self.host, self.port)
        sock.settimeout(timeout)
        try:
            sock.connect(addr)
            send_frame(sock, req)
            resp = recv_frame(sock)
        finally:
            with contextlib.suppress(OSError):
                sock.close()
        if not isinstance(resp, dict):
            raise OSError("replica closed mid-request")
        if resp.get("type") == "error":
            raise OSError(f"replica error: {resp.get('message')}")
        return resp

    def _http_get(self, path: str, timeout: float) -> tuple[int, bytes]:
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(self.base + path,
                                        timeout=timeout) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as exc:
            # a 503 with a body is a valid healthz answer, not a failure
            return exc.code, exc.read()

    def scrape(self, timeout: float = 2.0) -> str:
        if self.kind == "http":
            status, body = self._http_get("/metrics", timeout)
            if status != 200:
                raise OSError(f"/metrics answered {status}")
            return body.decode("utf-8", "replace")
        return self._rpc({"type": "scrape"}, timeout)["text"]

    def healthz(self, timeout: float = 2.0) -> dict:
        """{ok, draining, ...}, the same on every transport."""
        if self.kind == "http":
            status, body = self._http_get("/healthz", timeout)
            try:
                doc = json.loads(body.decode("utf-8", "replace"))
            except ValueError:
                # a plain "ok" / "draining" body
                text = body.decode("utf-8", "replace").strip()
                doc = {"draining": text == "draining"}
            doc["ok"] = status == 200 and not doc.get("draining")
            return doc
        resp = self._rpc({"type": "healthz"}, timeout)
        resp.setdefault("ok", not resp.get("draining"))
        return resp


# -------------------------------------------------------------- aggregation
class ReplicaSample:
    """One replica's poll: its parsed scrape and health, or the error
    that made it unreachable."""

    __slots__ = ("endpoint", "ok", "draining", "error", "scrape_s",
                 "parsed", "health")

    def __init__(self, endpoint: str):
        self.endpoint = endpoint
        self.ok = False
        self.draining = False
        self.error: str | None = None
        self.scrape_s = 0.0
        self.parsed: prom.Scrape | None = None
        self.health: dict = {}


class FleetSnapshot:
    """One poll's merged view (FleetAggregator.poll)."""

    __slots__ = ("t_wall", "poll_s", "replicas", "counters", "gauges",
                 "counter_series", "gauge_series", "hists", "burn")

    def __init__(self):
        self.t_wall = time.time()
        self.poll_s = 0.0
        self.replicas: list[ReplicaSample] = []
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.counter_series: dict[str, dict] = {}
        self.gauge_series: dict[str, dict] = {}
        self.hists = HistogramSet()
        self.burn: dict = {}

    @property
    def healthy(self) -> bool:
        return bool(self.replicas) and all(
            r.ok and not r.draining for r in self.replicas)


class FleetAggregator:
    """Polls replica endpoints, merges their expositions and serves the
    federated view (module docstring)."""

    def __init__(self, endpoints: list[str], timeout_s: float = 2.0,
                 journal=None, burn: BurnRateTracker | None = None):
        if not endpoints:
            raise ValueError("no fleet endpoints (pass endpoints= or "
                             "--endpoints)")
        self.endpoints = [Endpoint(s) for s in endpoints]
        self.timeout_s = timeout_s
        self.burn = burn or BurnRateTracker()
        #: an obs.journal.Journal (or any `.record(event, **fields)`
        #: sink) that takes a typed `alert` on each burn-state change
        self.journal = journal
        self.polls = 0
        self._last: FleetSnapshot | None = None
        self._lock = threading.Lock()
        self._http = None
        self._poller: threading.Thread | None = None
        self._stop = threading.Event()

    def add_endpoint(self, spec: str) -> None:
        """Add one endpoint to the polled set. The list is replaced, not
        mutated: a concurrent poll sees the old or the new set whole."""
        with self._lock:
            if any(ep.spec == spec for ep in self.endpoints):
                return
            self.endpoints = self.endpoints + [Endpoint(spec)]

    def remove_endpoint(self, spec: str) -> None:
        with self._lock:
            self.endpoints = [ep for ep in self.endpoints
                              if ep.spec != spec]

    def poll(self) -> FleetSnapshot:
        snap = FleetSnapshot()
        t0 = time.perf_counter()
        for ep in list(self.endpoints):
            rs = ReplicaSample(ep.spec)
            t1 = time.perf_counter()
            try:
                rs.parsed = prom.parse(ep.scrape(self.timeout_s))
                rs.health = ep.healthz(self.timeout_s)
                rs.draining = bool(rs.health.get("draining"))
                rs.ok = bool(rs.health.get("ok", not rs.draining))
            except (OSError, ValueError, KeyError) as exc:
                rs.error = f"{type(exc).__name__}: {exc}"
            rs.scrape_s = time.perf_counter() - t1
            snap.replicas.append(rs)
        self._merge(snap)
        snap.poll_s = time.perf_counter() - t0
        hit = int(snap.counters.get(HIT_COUNTER, 0))
        miss = int(snap.counters.get(MISS_COUNTER, 0))
        snap.burn = self.burn.sample(hit, miss)
        if snap.burn["changed"] and self.journal is not None:
            with contextlib.suppress(Exception):
                self.journal.record(
                    "alert", kind="slo-burn", scope="fleet",
                    state="firing" if snap.burn["firing"] else "clear",
                    burn_fast=snap.burn["fast"],
                    burn_slow=snap.burn["slow"],
                    threshold=snap.burn["threshold"],
                    deadline_hit=hit, deadline_miss=miss)
        with self._lock:
            self._last = snap
            self.polls += 1
        return snap

    @staticmethod
    def _merge(snap: FleetSnapshot) -> None:
        for rs in snap.replicas:
            if rs.parsed is None:
                continue
            for name, v in rs.parsed.counters.items():
                snap.counters[name] = snap.counters.get(name, 0) + v
            for name, v in rs.parsed.gauges.items():
                snap.gauges[name] = snap.gauges.get(name, 0) + v
            for store, src in ((snap.counter_series,
                                rs.parsed.counter_series),
                               (snap.gauge_series,
                                rs.parsed.gauge_series)):
                for name, series in src.items():
                    dst = store.setdefault(name, {})
                    for key, (labels, v) in series.items():
                        old = dst.get(key)
                        dst[key] = (labels, (old[1] if old else 0) + v)
            for name in rs.parsed.hists:
                mine = snap.hists.get(name)
                theirs = rs.parsed.histogram(name)
                if mine is None:
                    snap.hists._hists[name] = theirs
                else:
                    mine.merge(theirs)

    def last(self) -> FleetSnapshot | None:
        with self._lock:
            return self._last

    def healthz(self) -> tuple[bool, dict]:
        """(healthy, detail): healthy = every replica reachable and not
        draining, with per-replica detail."""
        snap = self.last() or self.poll()
        detail = {
            "ok": snap.healthy,
            "replicas": [
                {"endpoint": r.endpoint, "ok": r.ok,
                 "draining": r.draining, "error": r.error}
                for r in snap.replicas],
            "burn": self.burn.state()}
        return snap.healthy, detail

    def prometheus_text(self) -> str:
        """The federated scrape body: every merged series under its own
        name, plus the fleet's own and its burn-rate gauges."""
        snap = self.last() or self.poll()
        counters: dict = dict(snap.counters)
        for name, series in snap.counter_series.items():
            counters[name] = prom.Labeled(list(series.values()))
        gauges: dict = dict(snap.gauges)
        for name, series in snap.gauge_series.items():
            gauges[name] = prom.Labeled(list(series.values()))
        # the replicas' own burn gauges summed mean nothing, and would
        # repeat the fleet tracker's families below (a Prometheus server
        # refuses a body with a repeated family)
        for name in ("racon_tpu_slo_burn_rate",
                     "racon_tpu_slo_burn_rate_slow",
                     "racon_tpu_slo_burn_alert"):
            gauges.pop(name, None)
        up = sum(1 for r in snap.replicas if r.ok)
        gauges["fleet.replicas"] = (
            len(snap.replicas), "configured replica endpoints")
        gauges["fleet.replicas_up"] = (
            up, "replicas reachable and not draining at the last poll")
        gauges["fleet.healthy"] = snap.healthy
        gauges["fleet.replica_up"] = prom.Labeled(
            [({"replica": r.endpoint}, r.ok) for r in snap.replicas])
        gauges["fleet.scrape_seconds"] = prom.Labeled(
            [({"replica": r.endpoint}, round(r.scrape_s, 6))
             for r in snap.replicas],
            "per-replica scrape+parse round-trip at the last poll")
        gauges["fleet.poll_seconds"] = round(snap.poll_s, 6)
        burn = self.burn.state()
        gauges["slo.burn_rate"] = (
            burn["fast"], "fast-window SLO burn rate (miss-rate / "
            "budget) over the merged fleet counters")
        gauges["slo.burn_rate_slow"] = burn["slow"]
        gauges["slo.burn_alert"] = (
            burn["firing"], "1 while both burn windows exceed the "
            "threshold")
        return prom.render(counters, gauges, snap.hists)

    def to_json(self) -> dict:
        """The machine-readable fleet snapshot (the `fleet --json` body):
        per-replica health and headline series, merged totals, merged
        latency quantiles, the burn state."""
        snap = self.last() or self.poll()

        def headline(parsed: prom.Scrape | None) -> dict:
            if parsed is None:
                return {}
            g, c = parsed.gauges, parsed.counters
            return {
                "queue_depth": g.get("racon_tpu_serve_queue_depth"),
                "inflight": g.get("racon_tpu_serve_inflight"),
                "uptime_s": g.get("racon_tpu_serve_uptime_seconds"),
                "completed": c.get("racon_tpu_serve_jobs_completed_total"),
                "failed": c.get("racon_tpu_serve_jobs_failed_total"),
                "deadline_miss": c.get(MISS_COUNTER),
                "iterations": c.get(
                    "racon_tpu_serve_batch_iterations_total")}

        hists = {}
        for name, h in snap.hists.items():
            hists[name] = h.snapshot()
            ex = h.bucket_exemplars()
            if ex:
                hists[name]["exemplars"] = {
                    prom._le(le): e for le, e in sorted(ex.items())}
        return {
            "t": round(snap.t_wall, 3),
            "poll_s": round(snap.poll_s, 6),
            "healthy": snap.healthy,
            "replicas": [
                dict({"endpoint": r.endpoint, "ok": r.ok,
                      "draining": r.draining, "error": r.error,
                      "scrape_s": round(r.scrape_s, 6)},
                     **headline(r.parsed))
                for r in snap.replicas],
            "merged": {"counters": {k: snap.counters[k]
                                    for k in sorted(snap.counters)},
                       "gauges": {k: snap.gauges[k]
                                  for k in sorted(snap.gauges)}},
            "latency": hists,
            "burn": self.burn.state()}

    def start_http(self, port: int) -> int:
        """Serve the federated `/metrics` and `/healthz` on localhost HTTP
        (0 = ephemeral; returns the bound port). A handler error answers
        500 and never stops the aggregator."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        agg = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                try:
                    path = self.path.split("?", 1)[0]
                    if path in ("/metrics", "/"):
                        body = agg.prometheus_text().encode()
                        self.send_response(200)
                        self.send_header("Content-Type", prom.CONTENT_TYPE)
                    elif path == "/healthz":
                        ok, detail = agg.healthz()
                        body = (json.dumps(detail, sort_keys=True)
                                + "\n").encode()
                        self.send_response(200 if ok else 503)
                        self.send_header("Content-Type",
                                         "application/json")
                    else:
                        self.send_error(404)
                        return
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except Exception as exc:  # noqa: BLE001 — see docstring
                    with contextlib.suppress(Exception):
                        self.send_error(500,
                                        f"{type(exc).__name__}: {exc}")

            def log_message(self, *args):
                pass

        httpd = ThreadingHTTPServer(("127.0.0.1", max(0, port)), _Handler)
        httpd.daemon_threads = True
        self._http = httpd
        threading.Thread(target=httpd.serve_forever,
                         name="racon-tpu-torch-fleet-http",
                         daemon=True).start()
        return httpd.server_address[1]

    def run(self, interval_s: float) -> None:
        """Poll in a background daemon thread every `interval_s`."""

        def loop():
            while not self._stop.is_set():
                with contextlib.suppress(Exception):
                    self.poll()
                self._stop.wait(interval_s)

        self._poller = threading.Thread(
            target=loop, name="racon-tpu-torch-fleet-poll", daemon=True)
        self._poller.start()

    def close(self) -> None:
        self._stop.set()
        if self._poller is not None:
            self._poller.join(timeout=2.0)
        if self._http is not None:
            with contextlib.suppress(Exception):
                self._http.shutdown()
                self._http.server_close()
            self._http = None


# --------------------------------------------------------------------- CLI
def fleet_main(argv: list[str]) -> int:
    """`python -m racon_tpu_torch fleet`: one `--json` snapshot, or a
    long-running federated `/metrics` and `/healthz` endpoint."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="racon_tpu_torch fleet",
        description="fleet scrape aggregator: poll N replica endpoints, "
                    "merge their metrics, serve the federated /metrics "
                    "and /healthz view")
    ap.add_argument("--endpoints", default="",
                    help="comma-separated replica endpoints: unix socket "
                         "paths, host:port RPC, or http:// metrics bases")
    ap.add_argument("--port", type=int, default=0,
                    help="serve the federated /metrics and /healthz on "
                         "this localhost HTTP port (0 = ephemeral, "
                         "printed on start)")
    ap.add_argument("--interval", type=float, default=5.0,
                    help="poll interval in seconds (default 5)")
    ap.add_argument("--timeout", type=float, default=2.0,
                    help="per-replica scrape timeout in seconds")
    ap.add_argument("--json", action="store_true",
                    help="poll once, print the fleet snapshot as JSON to "
                         "stdout and exit (0 = healthy)")
    ap.add_argument("--journal", default=None,
                    help="journal path that takes fleet-scope `alert` "
                         "lines on burn-rate changes")
    args = ap.parse_args(argv)

    endpoints = [e.strip() for e in args.endpoints.split(",") if e.strip()]
    journal = None
    try:
        agg = FleetAggregator(endpoints, timeout_s=args.timeout)
        if args.journal:
            from .journal import Journal

            journal = agg.journal = Journal(args.journal)
    except (ValueError, OSError) as exc:
        print(f"[racon_tpu_torch::fleet] error: {exc}", file=sys.stderr)
        return 2
    if args.json:
        snap = agg.poll()
        print(json.dumps(agg.to_json(), indent=2, sort_keys=True))
        if journal is not None:
            journal.close()
        return 0 if snap.healthy else 1
    port = agg.start_http(args.port)
    print(f"[racon_tpu_torch::fleet] federating {len(agg.endpoints)} "
          f"replica(s) on http://127.0.0.1:{port} (/metrics, /healthz; "
          f"poll every {args.interval:g}s)", file=sys.stderr)
    agg.run(args.interval)
    try:
        while True:
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    finally:
        agg.close()
        if journal is not None:
            journal.close()
    return 0
