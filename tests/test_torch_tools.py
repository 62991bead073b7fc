"""The operator tools in the port (racon_tpu_torch/tools/: obsreport,
tracereport, servetop), against the JAX package's tools/ scripts.

Inputs: hand-built journals with fixed timestamps and a flight-dump
directory, hand-built merged Chrome traces, hand-built scrape bodies
merged into fleet snapshots with fixed poll times, and a port router
over one CPU server serving the router tests' one-contig
`make_synth_dataset` triple. Tolerance: none; printed text, exit codes,
problem lists, reports and rendered lines are compared exactly, but for
servetop's autoscale counts (below).

What is held:

  - obsreport: the port's `main` prints what JAX `tools/obsreport.py`
    prints and returns its exit code, with and without `--check` and
    for one job, on journals with balanced and unbalanced rounds, a
    preemption without its resume, an `autoscale-down` without its
    `autoscale-up`, alerts and unknown events, an audit mismatch, routed
    parts (segments, read ranges, whole contigs) and dispatch holds, and
    failed jobs with their flight dumps; each `check_*` returns the
    same list;
  - tracereport: `analyze`, `check`, `render` and `main --json` equal
    JAX's on a requeued routed job, a held dispatch, a direct job and a
    trace that fails its checks; a traced routed job on the port's CPU
    router whose shard held for an idle replica passes `check` with a
    `hold` stage above 0;
  - servetop: `audit_cell`, `cache_cell`, `replica_row`, `fleet_line`,
    `render_line` and `render_screen` equal JAX's on the same scrapes,
    audit, cache, rounds, QoS, router and autoscale families included,
    except that the autoscale suffix counts scale-ups and scale-downs
    from their `_total` counters, which the JAX tool reads without the
    suffix (it shows 0u/0d); `main --once` renders a live port server.
"""

import contextlib
import copy
import importlib
import io
import json
import os
import sys
import threading
import time

import pytest

from racon_tpu_torch.obs import prom
from racon_tpu_torch.obs.fleet import (FleetAggregator, FleetSnapshot,
                                       ReplicaSample)
from racon_tpu_torch.serve import (PolishClient, PolishRouter,
                                   make_synth_dataset)
from racon_tpu_torch.serve.autoscale import AutoscaleConfig, Autoscaler
from racon_tpu_torch.tools import obsreport, servetop, tracereport
from test_torch_router import _env, start_server, WAIT  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool(name: str):
    """A script of the JAX package's tools/ directory, as a module."""
    pytest.importorskip("jax")
    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module(name)


def run_main(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


# ------------------------------------------------------------ obsreport
T0 = 1_700_000_000.0


def ev(dt, event, job=None, **kw):
    e = {"t": T0 + dt, "event": event}
    if job is not None:
        e["job"] = job
    e.update(kw)
    return e


def lifecycle(job, t, tail=(), sequences=1, trace=None):
    head = [ev(t, "received", job, **({"trace": trace} if trace else {})),
            ev(t + 0.01, "admitted", job), ev(t + 0.02, "started", job)]
    done = {"service_s": 0.9}
    if sequences is not None:  # a router's lines carry no count
        done["sequences"] = sequences
    return head + list(tail) + [ev(t + 1.0, "finished", job, **done)]


JOURNALS = {
    "rounds": (
        lifecycle("j1", 0.0, [ev(0.1, "round-started", "j1", round=1),
                              ev(0.4, "round-finished", "j1", round=1,
                                 wall_s=0.3, cache_hits=0),
                              ev(0.5, "round-started", "j1", round=2),
                              ev(0.7, "round-finished", "j1", round=2,
                                 wall_s=0.2, cache_hits=40),
                              ev(0.8, "part-streamed", "j1", contig="c",
                                 part=0, bytes=10)], trace="tr1")
        + lifecycle("j2", 2.0, [ev(2.1, "round-started", "j2", round=1),
                                ev(2.3, "round-started", "j2", round=2),
                                ev(2.5, "round-finished", "j2", round=2),
                                ev(2.8, "part-streamed", "j2", contig="c",
                                   part=0, bytes=10)])),
    "preempt": (
        lifecycle("j1", 0.0, [ev(0.2, "preempted", "j1", by="j2"),
                              ev(0.5, "resumed", "j1"),
                              ev(0.6, "part-streamed", "j1", contig="c")])
        + lifecycle("j3", 1.0, [ev(1.2, "preempted", "j3", by="j4"),
                                ev(1.3, "part-streamed", "j3", contig="c")])
        + [ev(3.0, "received", "j5"), ev(3.1, "started", "j5"),
           ev(3.2, "expired", "j5")]),
    "autoscale": (
        [ev(0.0, "router-start", address="/tmp/r.sock", replicas=1)]
        + lifecycle("r1", 0.5, [
            ev(0.6, "shard-dispatched", "r1", shard=0, replica="/a.sock"),
            ev(0.7, "hold", "r1", shard=1, held_s=0.4),
            ev(1.1, "shard-dispatched", "r1", shard=1,
               replica="/d/autoscale_1.sock"),
            ev(1.4, "part-routed", "r1", shard=0, part=0, name="c0"),
            ev(1.45, "part-routed", "r1", shard=1, part=1, name="c1")],
            sequences=None, trace="wave")
        + [ev(0.9, "autoscale-up", replica="/d/autoscale_1.sock",
              reason="pressure", pressure=2.0, replicas=2),
           ev(5.0, "replica-removed", replica="/d/autoscale_1.sock"),
           ev(5.1, "autoscale-down", replica="/d/autoscale_1.sock",
              replicas=1),
           ev(6.0, "autoscale-down", replica="/d/autoscale_1.sock",
              replicas=1),
           ev(7.0, "autoscale-down", replica="/d/autoscale_9.sock",
              replicas=1),
           ev(8.0, "router-stop", clean=True)]),
    "alerts": (
        lifecycle("j1", 0.0, [
            ev(0.3, "part-streamed", "j1", contig="c"),
            ev(0.5, "alert", "j1", kind="slo-burn", state="firing",
               burn_fast=40.0),
            ev(0.5, "audit-mismatch", "j1", window=3, lane=0,
               dump="/tmp/flight/flight_audit_audit-mismatch_1.json"),
            ev(0.55, "audit-lane", "j1", lane=0, state="quarantined"),
            ev(0.6, "deadline-miss", "j1")])
        + [ev(2.0, "received", "j2"),
           ev(2.0, "rejected-quota", "j2", retry_after=0.5),
           ev(3.0, "frobnicated", "j999"),
           ev(3.0, "alert", kind="slo-burn", state="clear")]),
    "routed": (
        lifecycle("r1", 0.0, [
            ev(0.1, "range-plan", "r1", shards=3),
            ev(0.5, "part-routed", "r1", shard=0, name="c", lo=0, hi=4),
            ev(0.6, "part-routed", "r1", shard=1, name="c", lo=4, hi=8),
            ev(0.7, "part-routed", "r1", shard=2, name="c", lo=8,
               hi=10)], sequences=None)
        + lifecycle("r2", 1.0, [
            ev(1.5, "part-routed", "r2", shard=0, name="c", lo=0, hi=4),
            ev(1.6, "part-routed", "r2", shard=1, name="c", lo=5, hi=8)],
            sequences=None)
        + lifecycle("r3", 2.0, [
            ev(2.2, "frag-plan", "r3", shards=2),
            ev(2.5, "part-routed", "r3", shard=0, frag_lo=0, frag_hi=3,
               reads=3),
            ev(2.6, "part-routed", "r3", shard=1, frag_lo=3, frag_hi=3,
               reads=0),
            ev(2.7, "part-routed", "r3", shard=1, frag_lo=3, frag_hi=6,
               reads=2)], sequences=None)
        + lifecycle("r4", 3.0, [
            ev(3.4, "part-routed", "r4", shard=0, part=0, name="a"),
            ev(3.5, "requeued", "r4", shard=0, from_replica="/a.sock"),
            ev(3.6, "part-routed", "r4", shard=0, part=0, name="a")],
            sequences=None)
        # a job whose start fell out of a rotated journal: skipped
        + [ev(4.0, "part-routed", "r9", name="z", lo=3, hi=4),
           ev(4.1, "finished", "r9", sequences=1)]),
    "flight": (
        [ev(0.0, "received", "j1", trace="ft"),
         ev(0.1, "started", "j1"),
         ev(0.2, "failed", "j1", error_type="DeviceError")]
        + lifecycle("j2", 1.0, [ev(1.5, "part-streamed", "j2")])
        + [ev(2.0, "received", "j3"), ev(2.1, "started", "j3"),
           ev(2.2, "deadline-miss", "j3"),
           ev(2.3, "failed", "j3", error_type="deadline-doomed")]),
}


@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    """Each scenario's journal file and a flight directory beside it:
    dumps for a failed and a late job, a stale dump for a job that
    finished, one for a job outside the journal, and an unreadable one."""
    d = tmp_path_factory.mktemp("journals")
    flight = d / "flight"
    flight.mkdir()
    for name, head in (("j1_job-failed", {"job_id": "j1",
                                          "reason": "job-failed",
                                          "error_type": "DeviceError"}),
                       ("j3_deadline-miss", {"job_id": "j3",
                                             "reason": "deadline-miss"}),
                       ("j2_job-failed", {"job_id": "j2",
                                          "reason": "job-failed"}),
                       ("j77_job-failed", {"job_id": "j77",
                                           "reason": "job-failed"})):
        with open(flight / f"flight_{name}.json", "w") as fh:
            json.dump({"flight": head, "traceEvents": [{"ph": "X"}] * 3},
                      fh)
    (flight / "flight_broken_x.json").write_text("{not json")
    paths = {}
    for name, entries in JOURNALS.items():
        paths[name] = str(d / f"{name}.jsonl")
        with open(paths[name], "w") as fh:
            for e in entries:
                fh.write(json.dumps(e) + "\n")
    return paths, str(flight), str(d / "empty_flight")


@pytest.mark.parametrize("name", sorted(JOURNALS))
def test_obsreport_main_matches_jax(journals, name):
    jtool = jax_tool("obsreport")
    paths, flight, empty = journals
    job = JOURNALS[name][0].get("job") or JOURNALS[name][1]["job"]
    for extra in ([], ["--check"], ["--job", job], ["--job", "nope"]):
        for fdir in (flight, empty):
            argv = ["--journal", paths[name], "--flight-dir", fdir, *extra]
            mine, theirs = (run_main(m, argv)
                            for m in (obsreport.main, jtool.main))
            assert mine == theirs, (name, extra, fdir)
    rc, out, _ = run_main(obsreport.main, ["--journal", paths[name],
                                           "--flight-dir", flight,
                                           "--check"])
    want_ok = name in ("alerts", "flight")
    assert (rc == 0) == want_ok and ("consistency: OK" in out) == want_ok


@pytest.mark.parametrize("name", sorted(JOURNALS))
def test_obsreport_checks_match_jax(journals, name):
    jtool = jax_tool("obsreport")
    entries = copy.deepcopy(JOURNALS[name])
    for check in ("check_parts_streamed", "check_parts_routed",
                  "check_rounds", "check_preemptions", "check_autoscale"):
        assert getattr(obsreport, check)(entries) == \
            getattr(jtool, check)(entries), check
    assert obsreport.fleet_events(entries) == jtool.fleet_events(entries)
    assert obsreport.job_timelines(entries) == jtool.job_timelines(entries)
    assert obsreport.load_flight_dumps(journals[1]) == \
        jtool.load_flight_dumps(journals[1])
    if name == "autoscale":
        assert obsreport.check_autoscale(entries) == [
            "autoscale-down for '/d/autoscale_1.sock' without a prior "
            "autoscale-up (or already drained)",
            "autoscale-down for '/d/autoscale_9.sock' without a prior "
            "autoscale-up (or already drained)"]


# ---------------------------------------------------------- tracereport
def span(name, pid, ts, dur, **args):
    return {"name": name, "ph": "X", "pid": pid, "tid": 1, "ts": ts,
            "dur": dur, "args": args}


def instant(name, pid, ts, **args):
    return {"name": name, "ph": "i", "pid": pid, "tid": 1, "ts": ts,
            "s": "t", "args": args}


def replica_spans(pid, tid, t, iters=((100, 400, 0.0001), (550, 300, 0.0))):
    """A child job's replica-side spans starting at `t` (us)."""
    out = [span("serve.queue_wait", pid, t, 80, trace_id=tid),
           span("serve.job", pid, t + 80, 900, trace_id=tid)]
    for off, dur, host in iters:
        out.append(span("serve.iteration", pid, t + off, dur,
                        trace_ids=[tid, "other"], host_s=host))
    return out


def routed_doc(held=False, requeue=False, bad=False) -> dict:
    """A two-shard routed job: plan, dispatch(es), shards, merge, and the
    replicas' child spans, on one clock (us)."""
    ev_ = [span("router.plan", 2, 0, 200, job="r1")]
    detail = []
    for k, pid in ((0, 3), (1, 4)):
        tid = f"wave.s{k}"
        t = 200
        if requeue and k == 1:
            ev_ += [span("router.dispatch", 2, t, 50, shard=k, trace_id=tid,
                         replica="/a.sock", held_s=0.00005, held=False),
                    span("router.shard", 2, t + 50, 300, shard=k,
                         trace_id=tid, replica="/a.sock", outcome="lost"),
                    instant("router.requeue", 2, t + 350, shard=k)]
            t += 400
        hold_us = 3000 if held and k == 1 else 30
        ev_.append(span("router.dispatch", 2, t, hold_us, shard=k,
                        trace_id=tid, replica=f"/r{k}.sock",
                        held_s=hold_us / 1e6, held=held and k == 1))
        t += hold_us
        ev_.append(span("router.shard", 2, t, 1200, shard=k, trace_id=tid,
                        replica=f"/r{k}.sock", outcome="ok", parts=1))
        ev_ += replica_spans(pid, tid, t + 100)
        detail.append({"shard": k, "batch": {
            "device_s": 0.0007 if not bad else 0.5, "iterations": 2,
            "tenant": "gold", "device_share_s": 0.0004}})
        ev_.append(instant("router.stream", 2, t + 1100, shard=k))
    end = max(e["ts"] + e.get("dur", 0) for e in ev_)
    ev_.append(span("router.merge", 2, end + 10, 90, job="r1"))
    wall = (end + 100) / 1e6
    return {"traceEvents": ev_, "trace_context": {
        "trace_id": "wave", "job_id": "r1", "clock_rtt_s": 0.0002,
        "replicas": [{"replica": "/r0.sock", "rtt_s": 0.0001},
                     {"replica": "/r1.sock", "rtt_s": 0.0003}],
        "stats": {"router": {"requeues": (1 if requeue else 0) + bad,
                             "wall_s": wall * (3 if bad else 1),
                             "shards_detail": detail},
                  "rounds": {"cache": {"hits": 5, "misses": 20}}}}}


def direct_doc() -> dict:
    return {"traceEvents": replica_spans(3, "d1", 1000),
            "trace_context": {"trace_id": "d1", "job_id": "7",
                              "clock_rtt_s": 0.0001, "stats": {}}}


TRACES = {"requeue": lambda: routed_doc(requeue=True),
          "held": lambda: routed_doc(held=True),
          "direct": direct_doc,
          "bad": lambda: routed_doc(requeue=True, bad=True)}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_tracereport_matches_jax(name, tmp_path):
    jtool = jax_tool("tracereport")
    doc = TRACES[name]()
    mine, theirs = (tool.analyze(copy.deepcopy(doc))
                    for tool in (tracereport, jtool))
    assert mine == theirs
    assert tracereport.check(doc, mine) == jtool.check(doc, theirs)
    ctx = doc["trace_context"]["stats"]
    saved = tracereport.wincache_estimate(ctx, mine)
    assert saved == jtool.wincache_estimate(ctx, theirs)
    assert tracereport.render(mine, saved) == jtool.render(theirs, saved)
    path = str(tmp_path / "t.json")
    with open(path, "w") as fh:
        json.dump(doc, fh)
    for extra in ([], ["--check"], ["--json", "--check"]):
        assert run_main(tracereport.main, [path, *extra]) == \
            run_main(jtool.main, [path, *extra]), extra
    problems = tracereport.check(doc, mine)
    assert bool(problems) == (name == "bad")
    if name == "held":
        assert mine["stages"]["hold"] == pytest.approx(0.003)
    if name == "requeue":
        assert mine["stages"]["requeue"] > 0 and mine["stages"]["hold"] == 0


def test_routed_trace_with_an_engaged_hold_checks_clean(tmp_path):
    """A traced job routed while the only replica is busy and the
    autoscaler armed with headroom: its shard holds for the replica to go
    idle; the merged trace passes `check` with a `hold` stage."""
    jtool = jax_tool("tracereport")
    paths = make_synth_dataset(str(tmp_path))
    srv = start_server(tmp_path / "rep.sock", str(tmp_path / "at.json"))
    router = PolishRouter(replicas=[srv.config.socket_path],
                          socket_path=str(tmp_path / "r.sock"),
                          health_interval_s=0.2).start()
    Autoscaler(router, AutoscaleConfig(max_replicas=2, hold_s=WAIT,
                                       socket_dir=str(tmp_path)),
               spawn=lambda spec: spec, stop=lambda h: None)  # no loop
    out: dict = {}

    def first():
        out["first"] = PolishClient(socket_path=router.config.socket_path,
                                    timeout=WAIT).submit(*paths)

    def traced():
        out["traced"] = PolishClient(
            socket_path=router.config.socket_path,
            timeout=WAIT).submit_traced(*paths, trace_id="held")

    threads = [threading.Thread(target=first),
               threading.Thread(target=traced)]
    try:
        srv.batcher.hold()
        threads[0].start()
        deadline = time.monotonic() + WAIT
        while router.replicas[0].inflight != 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        threads[1].start()
        while router._dispatch_waiting != 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        time.sleep(0.2)
        srv.batcher.release()
        for t in threads:
            t.join(WAIT)
    finally:
        srv.batcher.release()
        assert router.drain()
        assert srv.drain(timeout=30)
    res, doc = out["traced"]
    assert res.fasta == out["first"].fasta
    rep = tracereport.analyze(doc)
    assert tracereport.check(doc, rep) == []
    assert rep["stages"]["hold"] >= 0.2 and rep["routed"]
    held = [e for e in doc["traceEvents"] if e.get("name") ==
            "router.dispatch"]
    assert [e["args"]["held"] for e in held] == [True]
    assert rep == jtool.analyze(doc)
    assert jtool.check(doc, rep) == []


# ------------------------------------------------------------- servetop
REPLICA_A = """\
# TYPE racon_tpu_serve_queue_depth gauge
racon_tpu_serve_queue_depth 2
# TYPE racon_tpu_serve_queue_capacity gauge
racon_tpu_serve_queue_capacity 16
# TYPE racon_tpu_serve_inflight gauge
racon_tpu_serve_inflight 1
# TYPE racon_tpu_serve_jobs_completed_total counter
racon_tpu_serve_jobs_completed_total 7
# TYPE racon_tpu_serve_jobs_failed_total counter
racon_tpu_serve_jobs_failed_total 1
# TYPE racon_tpu_serve_jobs_deadline_hit_total counter
racon_tpu_serve_jobs_deadline_hit_total 5
# TYPE racon_tpu_serve_jobs_deadline_miss_total counter
racon_tpu_serve_jobs_deadline_miss_total 2
# TYPE racon_tpu_serve_batch_iterations_total counter
racon_tpu_serve_batch_iterations_total 40
# TYPE racon_tpu_serve_compiles_total counter
racon_tpu_serve_compiles_total 3
# TYPE racon_tpu_serve_lane_0_busy gauge
racon_tpu_serve_lane_0_busy 1
# TYPE racon_tpu_serve_lane_1_busy gauge
racon_tpu_serve_lane_1_busy 0
# TYPE racon_tpu_serve_tenant_queue_depth gauge
racon_tpu_serve_tenant_queue_depth{tenant="gold"} 1
racon_tpu_serve_tenant_queue_depth{tenant="silver"} 0
# TYPE racon_tpu_serve_tenant_credit gauge
racon_tpu_serve_tenant_credit{tenant="gold"} 1.5
# TYPE racon_tpu_serve_tenant_device_seconds_total counter
racon_tpu_serve_tenant_device_seconds_total{tenant="gold"} 3.25
# TYPE racon_tpu_sched_autotune_consults_total counter
racon_tpu_sched_autotune_consults_total{engine="session",decision="table",dtype="int16"} 12
racon_tpu_sched_autotune_consults_total{engine="aligner",decision="cold"} 4
# TYPE racon_tpu_audit_sampled_total counter
racon_tpu_audit_sampled_total 100
# TYPE racon_tpu_audit_mismatches_total counter
racon_tpu_audit_mismatches_total{lane="0"} 1
# TYPE racon_tpu_audit_demotions_total counter
racon_tpu_audit_demotions_total 1
# TYPE racon_tpu_lane_health gauge
racon_tpu_lane_health{lane="0"} 0.5
racon_tpu_lane_health{lane="1"} 1
# TYPE racon_tpu_audit_alert gauge
racon_tpu_audit_alert 1
# TYPE racon_tpu_serve_wincache_bytes gauge
racon_tpu_serve_wincache_bytes 1048576
# TYPE racon_tpu_serve_wincache_entries gauge
racon_tpu_serve_wincache_entries 40
# TYPE racon_tpu_serve_wincache_ops_total counter
racon_tpu_serve_wincache_ops_total{op="hit"} 30
racon_tpu_serve_wincache_ops_total{op="miss"} 10
racon_tpu_serve_wincache_ops_total{op="eviction"} 2
racon_tpu_serve_wincache_ops_total{op="quarantined"} 1
# TYPE racon_tpu_serve_rounds_inflight gauge
racon_tpu_serve_rounds_inflight 1
# TYPE racon_tpu_serve_rounds_jobs_total counter
racon_tpu_serve_rounds_jobs_total 2
# TYPE racon_tpu_serve_rounds_completed_total counter
racon_tpu_serve_rounds_completed_total 4
# TYPE racon_tpu_serve_preemptions_total counter
racon_tpu_serve_preemptions_total 3
# TYPE racon_tpu_serve_aborted_doomed_total counter
racon_tpu_serve_aborted_doomed_total 1
# TYPE racon_tpu_serve_cancelled_total counter
racon_tpu_serve_cancelled_total 2
# TYPE racon_tpu_serve_preempted_inflight gauge
racon_tpu_serve_preempted_inflight 1
"""

REPLICA_B = """\
# TYPE racon_tpu_serve_queue_depth gauge
racon_tpu_serve_queue_depth 0
# TYPE racon_tpu_serve_worker_lanes gauge
racon_tpu_serve_worker_lanes 1
# TYPE racon_tpu_serve_batch_iterations_total counter
racon_tpu_serve_batch_iterations_total 9
"""


def router_text(ups: int, downs: int, spawned: int) -> str:
    return f"""\
# TYPE racon_tpu_router_replicas gauge
racon_tpu_router_replicas 2
# TYPE racon_tpu_router_replicas_routable gauge
racon_tpu_router_replicas_routable 1
# TYPE racon_tpu_router_replicas_draining gauge
racon_tpu_router_replicas_draining 1
# TYPE racon_tpu_router_requeued_outstanding gauge
racon_tpu_router_requeued_outstanding 1
# TYPE racon_tpu_router_autoscale_scale_ups_total counter
racon_tpu_router_autoscale_scale_ups_total {ups}
# TYPE racon_tpu_router_autoscale_scale_downs_total counter
racon_tpu_router_autoscale_scale_downs_total {downs}
# TYPE racon_tpu_router_autoscale_spawned gauge
racon_tpu_router_autoscale_spawned {spawned}
# TYPE racon_tpu_router_autoscale_pressure gauge
racon_tpu_router_autoscale_pressure 1.5
"""


def snapshot(fleet_mod, prom_mod, texts) -> object:
    """A fleet snapshot of one package from scrape bodies (None: an
    unreachable endpoint), with fixed poll and scrape times."""
    snap = fleet_mod.FleetSnapshot()
    snap.poll_s = 0.0125
    for i, text in enumerate(texts):
        rs = fleet_mod.ReplicaSample(f"/tmp/rep{i}.sock")
        rs.scrape_s = 0.002 * (i + 1)
        if text is None:
            rs.error = "ConnectionRefusedError: [Errno 111] refused"
        else:
            rs.parsed = prom_mod.parse(text)
            rs.ok = True
            rs.draining = i == 1
        snap.replicas.append(rs)
    fleet_mod.FleetAggregator._merge(snap)
    return snap


@pytest.mark.parametrize("ups,downs,spawned", [(0, 0, 0), (0, 0, 1),
                                               (2, 1, 1)])
def test_servetop_matches_jax(ups, downs, spawned, monkeypatch):
    jtool = jax_tool("servetop")
    jfleet = importlib.import_module("racon_tpu.obs.fleet")
    jprom = importlib.import_module("racon_tpu.obs.prom")
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "12:34:56")
    texts = [REPLICA_A, REPLICA_B, router_text(ups, downs, spawned), None]
    mine = snapshot(sys.modules[FleetSnapshot.__module__], prom, texts)
    theirs = snapshot(jfleet, jprom, texts)
    burn = {"fast": 2.5, "slow": 1.25, "firing": True}
    prev = {"iterations": 30}
    prev_rows = {"/tmp/rep0.sock": {"iterations": 20,
                                    "audit": {"sampled": 80}}}
    rows = {}
    for tag, tool, snap in (("mine", servetop, mine),
                            ("theirs", jtool, theirs)):
        rows[tag] = [tool.replica_row(r, prev_rows.get(r.endpoint, {}), 2.0)
                     for r in snap.replicas]
    assert rows["mine"] == rows["theirs"]
    for rs_m, rs_t in zip(mine.replicas, theirs.replicas):
        assert servetop.audit_cell(rs_m.parsed, {"audit": {"sampled": 80}},
                                   2.0) == \
            jtool.audit_cell(rs_t.parsed, {"audit": {"sampled": 80}}, 2.0)
        assert servetop.cache_cell(rs_m.parsed) == \
            jtool.cache_cell(rs_t.parsed)
    assert servetop.tenant_rows(mine) == jtool.tenant_rows(theirs)
    assert servetop.autotune_rows(mine) == jtool.autotune_rows(theirs)
    got = {"line": servetop.fleet_line(mine, burn, prev, 2.0),
           "pipe": servetop.render_line(mine, burn, prev, 2.0),
           "screen": servetop.render_screen(mine, burn, rows["mine"], prev,
                                            2.0)}
    want = {"line": jtool.fleet_line(theirs, burn, prev, 2.0),
            "pipe": jtool.render_line(theirs, burn, prev, 2.0),
            "screen": jtool.render_screen(theirs, burn, rows["theirs"],
                                          prev, 2.0)}
    suffix = f"  autoscale {ups}u/{downs}d pressure 1.5"
    for key in got:
        assert suffix in got[key]
        # the one difference: the JAX tool reads the counters without
        # their `_total` suffix, so its counts are always 0
        assert got[key].replace(suffix, "  autoscale 0u/0d pressure 1.5") \
            == want[key], key
    assert ("[SCALED +1]" in got["line"]) == bool(spawned)
    for part in ("[FIRING]", "audit 1 mism  [AUDIT-ALERT]",
                 "rounds 1 infl (4r/2j)", "qos 3p/1d/2c  [PREEMPT 1]",
                 "router 1/2 routable (1 drn)  requeued 1  [REQUEUED]"):
        assert part in got["line"], part
    for part in ("wincache", "audit", "tenant", "autotune  ",
                 "/tmp/rep3.sock", "DOWN"):
        assert part in got["screen"], part


def test_servetop_once_renders_a_live_server(tmp_path):
    srv = start_server(tmp_path / "s.sock", str(tmp_path / "at.json"),
                       workers=1)
    try:
        sock = srv.config.socket_path
        rc, out, _ = run_main(servetop.main, ["--once", "--endpoints", sock])
        assert rc == 0
        assert "servetop" in out and "fleet  queue 0/" in out and sock in out
        agg = FleetAggregator([sock])
        assert servetop.replica_row(agg.poll().replicas[0], {}, 0.0)["ok"]
    finally:
        assert srv.drain(timeout=30)
    rc, out, _ = run_main(servetop.main, ["--once", "--endpoints", sock])
    assert rc == 1 and "DOWN" in out
    assert isinstance(ReplicaSample(sock), ReplicaSample)
    assert FleetSnapshot().replicas == []
