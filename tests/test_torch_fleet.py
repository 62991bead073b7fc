"""The fleet aggregator in the port (obs/fleet.py), against the JAX package.

Inputs: replicas that answer `scrape` / `healthz` frames with bodies
rendered by the port's obs/prom.py from seeded observations (random.Random
with fixed seeds), and two port servers on the CPU that each served the
one-contig `make_synth_dataset` job. Tolerance: none; quantiles, counts,
JSON documents and exit codes are compared exactly (times left out of the
JSON documents).

What is held:

  - three replicas' merged histogram equals the pooled observations'
    (counts, min, max, every quantile), counters sum, the federated
    `/metrics` parses with one TYPE line a family and `/healthz` answers
    200; the JAX aggregator over the same replicas gives the same merged
    series and `to_json()`;
  - one draining and one unreachable replica make the fleet unhealthy,
    with per-replica detail, and `/healthz` answers 503;
  - endpoint spellings parse as the JAX package's do;
  - `fleet --json` over two port servers prints the JAX aggregator's
    `to_json()` over the same two servers (times left out) and exits 0;
    1 when a replica is unreachable, 2 with no endpoints; no environment
    variable names an endpoint;
  - a deadline-miss flood across polls fires the fleet's burn alert, a
    journaled `alert` line, with the JAX aggregator's burn states.
"""

import contextlib
import io
import json
import random
import socket
import sys
import threading
import urllib.error
import urllib.request

import pytest

from racon_tpu_torch import cli
from racon_tpu_torch.obs import prom
from racon_tpu_torch.obs.fleet import Endpoint, FleetAggregator, fleet_main
from racon_tpu_torch.obs.hist import Histogram, HistogramSet
from racon_tpu_torch.obs.journal import read_journal
from racon_tpu_torch.serve import PolishClient, make_synth_dataset
from racon_tpu_torch.serve.protocol import recv_frame, send_frame
from test_torch_router import _env, start_server  # noqa: F401

#: the keys of a `to_json()` document that hold a time
TIMES = ("t", "poll_s", "scrape_s", "uptime_s")


def fake_replica(path: str, render, draining: bool = False):
    """A replica answering `scrape` with `render()` and `healthz` with its
    drain state, no polisher behind it. Returns its closer."""
    lst = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    lst.bind(path)
    lst.listen(8)
    lst.settimeout(0.2)
    stop = threading.Event()

    def handle(conn):
        try:
            while True:
                req = recv_frame(conn)
                if req is None:
                    return
                if req.get("type") == "scrape":
                    send_frame(conn, {"type": "metrics", "text": render()})
                elif req.get("type") == "healthz":
                    send_frame(conn, {"type": "healthz",
                                      "ok": not draining,
                                      "draining": draining})
                else:
                    send_frame(conn, {"type": "error",
                                      "message": "bad request"})
        except OSError:
            pass
        finally:
            with contextlib.suppress(OSError):
                conn.close()

    def loop():
        while not stop.is_set():
            try:
                conn, _ = lst.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=handle, args=(conn,),
                             daemon=True).start()

    threading.Thread(target=loop, daemon=True).start()

    def close():
        stop.set()
        with contextlib.suppress(OSError):
            lst.close()

    return close


def pooled(values) -> Histogram:
    h = Histogram()
    for v in values:
        h.observe(v)
    return h


def without_times(doc):
    if isinstance(doc, dict):
        return {k: without_times(v) for k, v in doc.items()
                if k not in TIMES}
    if isinstance(doc, list):
        return [without_times(v) for v in doc]
    return doc


@pytest.fixture
def three_replicas(tmp_path):
    rng = random.Random(3)
    obs = [[rng.lognormvariate(-1, 1.6) for _ in range(n)]
           for n in (200, 31, 77)]
    closers, paths = [], []
    for i, values in enumerate(obs):
        hs = HistogramSet()
        for v in values:
            hs.observe("job.latency", v)
        text = prom.render(
            counters={"serve.jobs.deadline_hit": 10 * (i + 1),
                      "serve.jobs.deadline_miss": i,
                      "sched.autotune.consults": prom.Labeled(
                          [({"engine": "session", "decision": "none",
                             "dtype": ""}, i + 1)])},
            # a server's own burn gauges: the federation replaces them
            gauges={"slo.burn_rate": 0.5 * i, "slo.burn_rate_slow": 0.1,
                    "slo.burn_alert": False, "serve.queue_depth": i},
            hists=hs)
        paths.append(str(tmp_path / f"r{i}.sock"))
        closers.append(fake_replica(paths[-1], lambda t=text: t))
    yield paths, obs
    for close in closers:
        close()


def test_merged_quantiles_equal_pooled(three_replicas):
    paths, obs = three_replicas
    agg = FleetAggregator(paths)
    try:
        snap = agg.poll()
        assert snap.healthy
        merged = snap.hists.get("racon_tpu_job_latency_seconds")
        want = pooled(v for part in obs for v in part)
        assert merged.count == want.count == sum(map(len, obs))
        assert merged.counts == want.counts
        assert (merged.min, merged.max) == (want.min, want.max)
        for q in (0.5, 0.9, 0.95, 0.99, 1.0):
            assert merged.quantile(q) == want.quantile(q), q
        assert snap.counters["racon_tpu_serve_jobs_deadline_hit_total"] == 60
        assert snap.counters["racon_tpu_serve_jobs_deadline_miss_total"] == 3
        assert snap.counter_series[
            "racon_tpu_sched_autotune_consults_total"] == {
            '{decision="none",dtype="",engine="session"}': (
                {"decision": "none", "dtype": "", "engine": "session"}, 6)}
        port = agg.start_http(0)
        text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=10).read().decode()
        types = [ln for ln in text.splitlines() if ln.startswith("# TYPE")]
        assert len(types) == len(set(types))
        fed = prom.parse(text)
        assert fed.gauges["racon_tpu_fleet_replicas"] == 3
        assert fed.gauges["racon_tpu_serve_queue_depth"] == 3
        assert fed.histogram("racon_tpu_job_latency_seconds").counts == \
            want.counts
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as resp:
            body = json.loads(resp.read())
        assert body["ok"] is True and len(body["replicas"]) == 3
        doc = agg.to_json()
    finally:
        agg.close()
    jfleet = pytest.importorskip("racon_tpu.obs.fleet")
    jagg = jfleet.FleetAggregator(paths)
    try:
        jsnap = jagg.poll()
        assert jsnap.counters == snap.counters
        assert jsnap.gauges == snap.gauges
        assert jsnap.counter_series == snap.counter_series
        assert without_times(jagg.to_json()) == without_times(doc)
        assert prom.parse(jagg.prometheus_text()).gauges.keys() == \
            fed.gauges.keys()
    finally:
        jagg.close()


def test_unreachable_and_draining_replicas(tmp_path):
    hs = HistogramSet()
    hs.observe("job.latency", 0.1)
    up, drn, gone = (str(tmp_path / f"{n}.sock")
                     for n in ("up", "drn", "gone"))
    closers = [fake_replica(up, lambda: prom.render(hists=hs)),
               fake_replica(drn, lambda: prom.render(hists=hs),
                            draining=True)]
    agg = FleetAggregator([up, drn, gone])
    try:
        snap = agg.poll()
        assert not snap.healthy
        by = {r.endpoint: r for r in snap.replicas}
        assert by[up].ok and not by[up].draining and by[up].error is None
        assert by[drn].draining and not by[drn].ok
        assert not by[gone].ok and by[gone].error
        port = agg.start_http(0)
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                   timeout=10)
        assert exc.value.code == 503
        detail = json.loads(exc.value.read())
        assert detail["ok"] is False
        assert [r["endpoint"] for r in detail["replicas"]] == [up, drn, gone]
        up_gauge = prom.parse(agg.prometheus_text()).gauge_series[
            "racon_tpu_fleet_replica_up"]
        assert sorted(v for _, v in up_gauge.values()) == [0, 0, 1]
        agg.remove_endpoint(gone)
        agg.remove_endpoint(drn)
        agg.add_endpoint(up)  # already there: no second one
        assert agg.poll().healthy and len(agg.endpoints) == 1
    finally:
        agg.close()
        for close in closers:
            close()


@pytest.mark.parametrize("spec", ["/tmp/x.sock", "127.0.0.1:7788", ":7788",
                                  "7788", "http://127.0.0.1:9090/metrics",
                                  "http://127.0.0.1:9090/"])
def test_endpoint_spellings_match_jax(spec):
    jfleet = pytest.importorskip("racon_tpu.obs.fleet")
    mine, theirs = Endpoint(spec), jfleet.Endpoint(spec)
    assert mine.kind == theirs.kind
    for attr in ("base", "host", "port"):
        assert getattr(mine, attr, None) == getattr(theirs, attr, None)


@pytest.mark.parametrize("spec", ["", "not a port"])
def test_endpoint_refuses(spec):
    with pytest.raises(ValueError):
        Endpoint(spec)


@pytest.fixture(scope="module")
def two_servers(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet_servers")
    paths = make_synth_dataset(str(d))
    servers = [start_server(d / f"s{i}.sock", str(d / "at.json"))
               for i in range(2)]
    for srv in servers:
        PolishClient(socket_path=srv.config.socket_path,
                     timeout=120).submit(*paths)
    yield [s.config.socket_path for s in servers]
    for srv in servers:
        assert srv.drain(timeout=30)


def run_fleet(argv, main=fleet_main) -> tuple[int, str]:
    out, buf = sys.stdout, io.StringIO()
    sys.stdout = buf
    try:
        rc = main(argv)
    finally:
        sys.stdout = out
    return rc, buf.getvalue()


def test_fleet_json_equals_jax_to_json(two_servers, monkeypatch):
    monkeypatch.setenv("RACON_TPU_FLEET_ENDPOINTS", "/nonexistent.sock")
    rc, text = run_fleet(["--endpoints", ",".join(two_servers), "--json"])
    assert rc == 0
    mine = json.loads(text)
    jfleet = pytest.importorskip("racon_tpu.obs.fleet")
    jagg = jfleet.FleetAggregator(two_servers)
    try:
        jagg.poll()
        theirs = json.loads(json.dumps(jagg.to_json()))
    finally:
        jagg.close()
    # the scrape counts itself and its render time: those two move with
    # every poll, so they are held by name only
    moving = ("racon_tpu_serve_scrapes_total",
              "racon_tpu_serve_scrape_seconds_total",
              "racon_tpu_serve_uptime_seconds")
    for doc in (mine, theirs):
        for kind in ("counters", "gauges"):
            for name in moving:
                if name in doc["merged"][kind]:
                    doc["merged"][kind][name] = "moves"
    assert without_times(mine) == without_times(theirs)
    assert mine["healthy"] is True and len(mine["replicas"]) == 2
    assert mine["merged"]["counters"][
        "racon_tpu_serve_jobs_completed_total"] == 2
    assert mine["latency"]["racon_tpu_job_latency_seconds"]["count"] == 2
    # the CLI's subcommand is the same entry point
    rc, text = run_fleet(["fleet", "--endpoints", two_servers[0], "--json"],
                         main=cli.main)
    assert rc == 0 and json.loads(text)["healthy"] is True


def test_fleet_json_exit_codes(two_servers, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("RACON_TPU_FLEET_ENDPOINTS", two_servers[0])
    assert fleet_main(["--json"]) == 2  # no endpoints: the env names none
    assert "no fleet endpoints" in capsys.readouterr().err
    rc, text = run_fleet(["--endpoints",
                          f"{two_servers[0]},{tmp_path / 'gone.sock'}",
                          "--json"])
    assert rc == 1
    doc = json.loads(text)
    assert doc["healthy"] is False
    assert [r["ok"] for r in doc["replicas"]] == [True, False]


def test_burn_alert_across_polls_matches_jax(tmp_path):
    state = {"hit": 10, "miss": 0}
    path = str(tmp_path / "slo.sock")
    close = fake_replica(path, lambda: prom.render(counters={
        "serve.jobs.deadline_hit": state["hit"],
        "serve.jobs.deadline_miss": state["miss"]}))
    from racon_tpu_torch.obs.journal import Journal

    journal = str(tmp_path / "fleet.jsonl")
    jfleet = pytest.importorskip("racon_tpu.obs.fleet")
    mine = FleetAggregator([path], journal=Journal(journal))
    theirs = jfleet.FleetAggregator([path])
    try:
        bursts = []
        for hit, miss in ((10, 0), (10, 10), (11, 10)):
            state.update(hit=hit, miss=miss)
            got, want = mine.poll().burn, theirs.poll().burn
            assert {k: got[k] for k in ("firing", "changed", "threshold")} \
                == {k: want[k] for k in ("firing", "changed", "threshold")}
            bursts.append(got)
        assert [b["changed"] for b in bursts] == [False, True, False]
        assert bursts[1]["firing"] and bursts[1]["fast"] >= 2.0
        assert prom.parse(mine.prometheus_text()).gauges[
            "racon_tpu_slo_burn_alert"] == 1
    finally:
        mine.close()
        theirs.close()
        mine.journal.close()
        close()
    alerts = [e for e in read_journal(journal) if e["event"] == "alert"]
    assert [(a["kind"], a["scope"], a["state"]) for a in alerts] == \
        [("slo-burn", "fleet", "firing")]
    assert alerts[0]["deadline_miss"] == 10
