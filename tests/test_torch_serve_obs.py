"""The warm server's observability in the port, against the JAX package.

Inputs: the port's `make_synth_dataset` triple (the JAX function's files:
2 kb draft, 400 bp reads, seed 11), served at the server defaults (host
POA, 3/-5/-4) unless a case says otherwise, `RACON_TPU_MAX_DEVICES=1`,
torch at one thread. Tolerance: none on names, event sequences, state
dicts and bytes; the flight dump's span sums hold its stage counters to
5% (their perf_counter endpoints are the same, the dump's microseconds
are rounded).

What is held:

  - obs/fleet.BurnRateTracker gives the JAX tracker's state dicts on the
    same (hit, miss, t) sequences: the dual window, a counter reset, a
    breach only the slow window remembers;
  - the scrape over the socket equals the HTTP `/metrics` body but for
    the self-metered scrape counters and the clocks, both parse
    strictly, and `/healthz` answers the RPC's body;
  - the scrape's family names and label keys equal the JAX server's for
    the same submit sequence, with the audit, the window cache and QoS
    each off and on; an off family is absent. Each server runs on a
    fresh winner-table handle of its own (both render
    `sched.autotune.consults` from a process-global handle), so a
    default handle consulted earlier in the process, on either side or
    both, changes nothing;
  - the journal's per-job event sequence equals the JAX server's for a
    plain, a streamed, a rounds, a rejected-ingest, a preempted and
    resumed, and a cancelled job, and `check_consistency` passes on both;
  - a failed job's flight dump exists before its error arrives, `debug`
    lists it, its stage spans sum to its stage counters, and its latency
    exemplar names it; a late job is counted, dumped and trips the SLO
    burn alert with a journaled `alert`; `audit_ack` clears the audit
    alert and the journal holds both alert lines;
  - a bad explicit flight directory or journal fails start(), a negative
    metrics port is refused (keyword and flag); `exemplars=False` keeps
    exemplars out of the scrape;
  - with the journal, the metrics port, the ring, the audit, the window
    cache, `trace_path` and `metrics_path` all armed, every served FASTA
    equals the JAX package's one-shot run, and the drain leaves no
    tracer armed.

The JAX package is imported inside the fixtures and tests that use it.
"""

import contextlib
import gzip
import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from racon_tpu_torch.errors import RaconError
from racon_tpu_torch.obs import fleet, prom, trace
from racon_tpu_torch.obs.journal import check_consistency, read_journal
from racon_tpu_torch.sched.autotune import get_autotuner, reset_autotuner_cache
from racon_tpu_torch.serve import (JobFailed, PolishClient, PolishServer,
                                   make_synth_dataset)
from racon_tpu_torch.serve.server import serve_main

WAIT = 120


@pytest.fixture(scope="module", autouse=True)
def _env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RACON_TPU_MAX_DEVICES", "1")
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_synth_dataset(str(tmp_path_factory.mktemp("obs")))


@pytest.fixture(scope="module")
def cut_reads(dataset, tmp_path_factory):
    """The reads file cut mid-record: admit-time ingest refuses it."""
    with gzip.open(dataset[0]) as fh:
        data = fh.read()
    path = str(tmp_path_factory.mktemp("cut") / "cut.fasta")
    with open(path, "wb") as fh:
        fh.write(data[:len(data) // 3].rsplit(b"\n", 1)[0][:-5]
                 + b"\n>x\n")
    return path


@pytest.fixture(scope="module")
def jax_oneshot(dataset):
    """The JAX package's one-shot FASTA (host POA) at window length w."""
    jpol = pytest.importorskip("racon_tpu.core.polisher")
    cache: dict = {}

    def run(w=500):
        if w not in cache:
            p = jpol.create_polisher(*dataset, jpol.PolisherType.kC, w,
                                     10.0, 0.3, num_threads=2)
            p.initialize()
            cache[w] = b"".join(b">" + s.name.encode() + b"\n" + s.data
                                + b"\n" for s in p.polish())
        return cache[w]

    return run


def wait_for(cond, what: str) -> None:
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def start(tmp_path, name="s", **kw):
    kw.setdefault("warmup", False)
    srv = PolishServer(socket_path=str(tmp_path / f"{name}.sock"),
                       device="cpu", **kw).start()
    return srv, PolishClient(socket_path=srv.config.socket_path,
                             timeout=WAIT)


def families(text: str) -> dict:
    """name -> (kind, label keys) of a strictly parsed scrape body."""
    s = prom.parse(text)
    out = {n: ("counter", ()) for n in s.counters}
    out.update({n: ("gauge", ()) for n in s.gauges})
    for kind, series in (("counter", s.counter_series),
                         ("gauge", s.gauge_series)):
        for n, ser in series.items():
            out[n] = (kind, tuple(sorted({k for labels, _ in ser.values()
                                          for k in labels})))
    out.update({n: ("histogram", ()) for n in s.hists})
    return out


# the scenario both servers run for the family comparison: a tenanted
# job (first, so its windows run whether the window cache is armed or
# not), a plain job and a rounds job
def light_sequence(cl, dataset) -> None:
    cl.submit(*dataset, tenant="gold", trace_id="light1")
    cl.submit(*dataset, trace_id="light2")
    cl.submit(*dataset, rounds=2, trace_id="light3")


def journal_scenarios(srv, cl, dataset, cut_reads) -> dict:
    """The journal scenarios, on a server with one worker and preemption
    armed: trace id -> its outcome."""
    out: dict = {}

    def go(tag, **kw):
        try:
            out[tag] = cl.submit(*dataset, trace_id=tag, **kw)
        except Exception as exc:  # noqa: BLE001 — held by the callers
            out[tag] = exc

    go("plain")
    go("streamed", on_part=lambda frame: None)
    go("rounds", rounds=2)
    try:
        cl.submit(cut_reads, *dataset[1:], ingest=True,
                  trace_id="badingest")
    except Exception as exc:  # noqa: BLE001 — a typed bad-request
        out["badingest"] = exc
    # a running job preempted by a higher priority, then resumed
    srv.batcher.hold()
    free = threading.Thread(target=go, args=("free",))
    free.start()
    wait_for(lambda: srv.batcher._job_tickets, "the free job pooled")
    gold = threading.Thread(target=go, args=("gold",),
                            kwargs={"priority": 5})
    gold.start()
    wait_for(lambda: srv.qos["preemptions"] == 1, "the preemption")
    srv.batcher.release()
    free.join(WAIT)
    gold.join(WAIT)
    # a queued job cancelled behind a busy worker
    srv.batcher.hold()
    busy = threading.Thread(target=go, args=("busy",))
    busy.start()
    wait_for(lambda: srv.batcher._job_tickets, "the busy job pooled")
    queued = threading.Thread(target=go, args=("queued",))
    queued.start()
    wait_for(lambda: len(srv.queue) == 1, "the queued job")
    assert cl.cancel(trace_id="queued")["cancelled"] == "queued"
    srv.batcher.release()
    busy.join(WAIT)
    queued.join(WAIT)
    return out


def per_trace(path: str) -> dict:
    entries = read_journal(path)
    assert check_consistency(entries) == []
    out: dict = {}
    for e in entries:
        if e.get("trace"):
            out.setdefault(e["trace"], []).append(e["event"])
    return out


def _scrape_variants(srv, scrape) -> dict:
    """The JAX server's families with each feature armed and, by taking
    it away for the one scrape, off."""
    out = {"none": families(scrape())}
    auditor, srv.auditor = srv.auditor, None
    out["audit"] = families(scrape())
    srv.auditor = auditor
    cache, srv.batcher.wincache = srv.batcher.wincache, None
    out["wincache"] = families(scrape())
    srv.batcher.wincache = cache
    srv.config.preempt = False
    out["qos"] = families(scrape())
    srv.config.preempt = True
    # the journal scenarios need every job's windows to pool
    srv.batcher.wincache = None
    return out


@contextlib.contextmanager
def fresh_jax_autotuner(table: str):
    """The JAX package's process-global winner-table handle, fresh and
    pointed at `table` for the block: its server renders
    `sched.autotune.consults` from that handle, so a consult made earlier
    in the process must not reach the scrape."""
    jautotune = pytest.importorskip("racon_tpu.sched.autotune")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RACON_TPU_AUTOTUNE_CACHE", table)
        jautotune.reset_autotuner_cache()
        try:
            yield
        finally:
            jautotune.reset_autotuner_cache()


def jax_families(dataset, d) -> dict:
    """The JAX server of `jax_ref` (its fixture's knobs) on a fresh
    winner-table handle: the light sequence's families with each feature
    off and on. The server is returned still running, with its client."""
    jserve = pytest.importorskip("racon_tpu.serve")
    srv = jserve.PolishServer(socket_path=str(d / "j.sock"), warmup=False,
                              workers=1, preempt=True, audit_rate=1e-9,
                              wincache=True, journal=str(d / "j.jsonl"),
                              flight_dir="")
    srv.start()
    cl = jserve.PolishClient(socket_path=srv.config.socket_path,
                             timeout=WAIT)
    try:
        light_sequence(cl, dataset)
        return srv, cl, _scrape_variants(srv, cl.scrape)
    except BaseException:
        srv.drain(timeout=30)
        raise


@pytest.fixture(scope="module")
def jax_ref(dataset, cut_reads, tmp_path_factory):
    """One JAX server (one worker, preemption, the window cache and a
    journal armed, the audit armed at a rate that samples nothing) on a
    fresh winner-table handle: the light sequence's families with each
    feature off and on, then the journal scenarios."""
    d = tmp_path_factory.mktemp("jax_ref")
    with fresh_jax_autotuner(str(d / "autotune.json")):
        srv, cl, fams = jax_families(dataset, d)
        try:
            outcomes = journal_scenarios(srv, cl, dataset, cut_reads)
        finally:
            srv.drain(timeout=30)
    return {"families": fams, "journal": per_trace(str(d / "j.jsonl")),
            "outcomes": outcomes}


@pytest.fixture(scope="module")
def port_journal(dataset, cut_reads, tmp_path_factory):
    d = tmp_path_factory.mktemp("port_journal")
    srv = PolishServer(socket_path=str(d / "p.sock"), device="cpu",
                       warmup=False, workers=1, preempt=True,
                       journal=str(d / "p.jsonl"), flight_dir="").start()
    try:
        cl = PolishClient(socket_path=srv.config.socket_path, timeout=WAIT)
        outcomes = journal_scenarios(srv, cl, dataset, cut_reads)
    finally:
        assert srv.drain(timeout=30)
    return {"journal": per_trace(str(d / "p.jsonl")), "outcomes": outcomes}


# ------------------------------------------------------------ burn rate
def _dual(tr):
    t0 = 1000.0
    out = [tr.sample(hit=i + 1, miss=0, t=t0 + i) for i in range(5)]
    out += [tr.sample(hit=5, miss=5, t=t0 + 10),
            tr.sample(hit=5, miss=6, t=t0 + 11),
            tr.sample(hit=500, miss=6, t=t0 + 700),
            tr.sample(hit=1000, miss=6, t=t0 + 1400)]
    return out


def _reset(tr):
    return [tr.sample(hit=10, miss=10, t=1000.0),
            tr.sample(hit=4, miss=4, t=1001.0),
            tr.sample(hit=4, miss=8, t=1002.0)]


def _single(tr):
    return [tr.sample(hit=0, miss=5, t=1000.0),
            tr.sample(hit=300, miss=5, t=1300.0)]


@pytest.mark.parametrize("seq,fast_s", [(_dual, 60), (_reset, 60),
                                        (_single, 10)],
                         ids=["dual-window", "counter-reset",
                              "single-window"])
def test_burn_rate_tracker_matches_jax(seq, fast_s):
    jfleet = pytest.importorskip("racon_tpu.obs.fleet")
    kw = dict(budget=0.01, fast_s=fast_s, slow_s=600, threshold=2.0,
              seed_zero=True)
    mine, theirs = fleet.BurnRateTracker(**kw), jfleet.BurnRateTracker(**kw)
    got, want = seq(mine), seq(theirs)
    assert got == want
    assert mine.state() == theirs.state()
    # the edges the sequences exist for fired
    assert any(r["changed"] for r in got) or seq is _single


# --------------------------------------------------------------- scrape
def test_scrape_rpc_equals_http(dataset, tmp_path):
    srv, cl = start(tmp_path, metrics_port=0)
    try:
        assert srv.config.metrics_port > 0  # the ephemeral port published
        cl.submit(*dataset)
        url = f"http://127.0.0.1:{srv.config.metrics_port}"
        rpc = prom.parse(cl.scrape())
        http = prom.parse(urllib.request.urlopen(
            f"{url}/metrics", timeout=10).read().decode())
        own = {"racon_tpu_serve_scrapes_total",
               "racon_tpu_serve_scrape_seconds_total"}
        clocks = {"racon_tpu_serve_uptime_seconds"}
        assert {k: v for k, v in rpc.counters.items() if k not in own} == \
            {k: v for k, v in http.counters.items() if k not in own}
        assert http.counters["racon_tpu_serve_scrapes_total"] == \
            rpc.counters["racon_tpu_serve_scrapes_total"] + 1
        assert {k: v for k, v in rpc.gauges.items() if k not in clocks} == \
            {k: v for k, v in http.gauges.items() if k not in clocks}
        assert set(rpc.hists) == set(http.hists)
        assert all(rpc.hists[n].buckets == http.hists[n].buckets
                   for n in rpc.hists)
        health = json.loads(urllib.request.urlopen(
            f"{url}/healthz", timeout=10).read())
        body = cl.healthz()
        assert {k: v for k, v in health.items() if k != "uptime_s"} == \
            {k: v for k, v in body.items() if k not in ("uptime_s", "type")}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{url}/nope", timeout=10)
        assert cl.ping()["type"] == "pong"
    finally:
        assert srv.drain(timeout=30)


def port_families(dataset, tmp_path, off="none") -> dict:
    """The port's server at `jax_ref`'s knobs with feature `off` taken
    away, on a fresh winner-table handle of its own: the light
    sequence's families."""
    kw = dict(workers=1, preempt=True, audit_rate=1e-9, wincache=True,
              flight_dir="", journal=str(tmp_path / "j.jsonl"),
              autotune_table=str(tmp_path / "autotune.json"))
    if off == "audit":
        kw["audit_rate"] = 0.0
    elif off == "wincache":
        kw["wincache"] = False
    elif off == "qos":
        kw["preempt"] = False
    reset_autotuner_cache()
    srv, cl = start(tmp_path, **kw)
    try:
        light_sequence(cl, dataset)
        return families(cl.scrape())
    finally:
        assert srv.drain(timeout=30)
        reset_autotuner_cache()


@pytest.mark.parametrize("off", ["none", "audit", "wincache", "qos"])
def test_scrape_families_match_jax(jax_ref, dataset, tmp_path, off):
    mine = port_families(dataset, tmp_path, off)
    assert mine == jax_ref["families"][off]
    group = {"none": None, "audit": "racon_tpu_audit_",
             "wincache": "racon_tpu_serve_wincache_",
             "qos": "racon_tpu_serve_preempt"}[off]
    if group is not None:
        assert not any(n.startswith(group) for n in mine)
        assert any(n.startswith(group)
                   for n in jax_ref["families"]["none"])
    else:
        assert "racon_tpu_lane_health" in mine
        assert mine["racon_tpu_lane_health"] == ("gauge", ("lane",))


@pytest.mark.parametrize("consulted", ["jax", "port", "both"])
def test_scrape_families_match_jax_after_default_consults(dataset,
                                                          tmp_path,
                                                          consulted):
    """A default winner-table handle consulted earlier in the process
    (as another test file in the same worker may: one side's consult
    alone gave that side the `sched.autotune.consults` family) must not
    reach either server's scrape: each server runs on a fresh handle,
    and the families stay equal, that family absent from both."""
    jautotune = pytest.importorskip("racon_tpu.sched.autotune")
    if consulted in ("jax", "both"):
        jautotune.get_autotuner().winner("session", (768, 640), ())
    if consulted in ("port", "both"):
        get_autotuner().winner("session", (768, 640), ())
    d = tmp_path / "jax"
    d.mkdir()
    with fresh_jax_autotuner(str(d / "autotune.json")):
        srv, _, fams = jax_families(dataset, d)
        srv.drain(timeout=30)
    (tmp_path / "port").mkdir()
    mine = port_families(dataset, tmp_path / "port")
    assert mine == fams["none"]
    consults = prom.metric_name("sched.autotune.consults") + "_total"
    assert consults not in mine


# -------------------------------------------------------------- journal
@pytest.mark.parametrize("tags", [("plain",), ("streamed",), ("rounds",),
                                  ("badingest",), ("free", "gold"),
                                  ("busy", "queued")],
                         ids=["plain", "streamed", "rounds",
                              "rejected-ingest", "preempted-resumed",
                              "cancelled"])
def test_journal_sequences_match_jax(jax_ref, port_journal, tags):
    for tag in tags:
        mine = port_journal["journal"][tag]
        assert mine == jax_ref["journal"][tag], tag
        assert type(port_journal["outcomes"][tag]).__name__ == \
            type(jax_ref["outcomes"][tag]).__name__
    if tags == ("free", "gold"):
        free = port_journal["journal"]["free"]
        assert free.count("preempted") == free.count("resumed") == 1
    if tags == ("busy", "queued"):
        assert port_journal["journal"]["queued"][-2:] == ["cancelled",
                                                          "expired"]


# --------------------------------------------------- dumps and alerts
def test_failed_job_flight_dump_spans_match_stats(dataset, tmp_path):
    flight = tmp_path / "flight"
    srv, cl = start(tmp_path, workers=1, flight_dir=str(flight))
    try:
        with pytest.raises(JobFailed) as exc_info:
            cl.submit(*dataset, fault_plan="unpack:chunk=0:corrupt",
                      trace_id="poisoned")
        assert exc_info.value.error_type == "ChunkCorrupt"
        # written before the waiter woke
        path = str(flight / f"flight_{exc_info.value.response['job_id']}"
                            "_job-failed.json")
        assert os.path.isfile(path)
        assert cl.debug()["dumps"] == [path]
        doc = json.load(open(path))
        info = doc["flight"]
        assert info["reason"] == "job-failed"
        assert info["error_type"] == "ChunkCorrupt"
        stats = info["stage_stats"]
        assert stats["faults"] == 1 and stats["pack_s"] > 0
        sums: dict = {}
        for ev in doc["traceEvents"]:
            assert {"name", "ph", "pid", "tid"} <= set(ev)
            if ev["ph"] == "X" and ev["name"].startswith("pipeline."):
                stage = ev["name"].split(".", 1)[1]
                sums[stage] = sums.get(stage, 0.0) + ev["dur"] / 1e6
        for stage in ("pack", "device", "unpack", "fallback"):
            assert sums.get(stage, 0.0) == pytest.approx(
                stats[f"{stage}_s"], rel=0.05, abs=1e-3), stage
        s = prom.parse(cl.scrape())
        h = s.histogram("racon_tpu_job_latency_seconds")
        ex = [e for e in h.bucket_exemplars().values() if "flight" in e]
        assert ex and ex[0]["flight"] == path
        assert ex[0]["trace_id"] == "poisoned"
        # the failed job's own histograms joined the server's
        assert s.hists["racon_tpu_pipeline_pack_seconds"].count > 0
        assert srv.stats_snapshot()["flight"]["dumps"] == [path]
        assert cl.ping()["type"] == "pong"
    finally:
        assert srv.drain(timeout=30)


def test_deadline_miss_counted_dumped_and_alerts(dataset, tmp_path):
    flight = tmp_path / "flight"
    jp = str(tmp_path / "j.jsonl")
    srv, cl = start(tmp_path, workers=1, flight_dir=str(flight), journal=jp)
    try:
        # the hang holds the popped job past its deadline: a miss, not
        # an expiry in the queue
        r = cl.submit(*dataset, deadline_s=0.3, trace_id="late",
                      fault_plan="device:chunk=0:hang=0.8")
        assert r.fasta
        snap = cl.stats()
        assert snap["slo"]["deadline_miss"] == 1
        assert snap["slo"]["burn"]["firing"] is True
        dumps = snap["flight"]["dumps"]
        assert len(dumps) == 1 and dumps[0].endswith(
            f"flight_{r.job_id}_deadline-miss.json")
        assert json.load(open(dumps[0]))["flight"]["reason"] == \
            "deadline-miss"
        s = prom.parse(cl.scrape())
        assert s.counters["racon_tpu_serve_jobs_deadline_miss_total"] == 1
        assert s.gauges["racon_tpu_slo_burn_alert"] == 1
        assert s.gauges["racon_tpu_slo_burn_rate"] >= srv.burn.threshold
        ex = [e for e in s.histogram(
            "racon_tpu_job_latency_seconds").bucket_exemplars().values()
            if "flight" in e]
        assert ex and ex[0]["flight"] == dumps[0]
    finally:
        assert srv.drain(timeout=30)
    entries = read_journal(jp)
    assert check_consistency(entries) == []
    late = [e["event"] for e in entries if e.get("trace") == "late"]
    # the alert fires as the queue counts the miss, before the job's own
    # accounting lines, as in the JAX server
    assert late == ["received", "admitted", "started", "part-streamed",
                    "alert", "iterations", "deadline-miss", "finished"]
    alert = next(e for e in entries if e["event"] == "alert")
    assert (alert["kind"], alert["state"], alert["job"]) == (
        "slo-burn", "firing", r.job_id)


def test_audit_ack_clears_alert_and_journals(dataset, jax_oneshot,
                                             tmp_path):
    jp = str(tmp_path / "j.jsonl")
    srv, cl = start(tmp_path, audit_rate=1.0, journal=jp,
                    flight_dir=str(tmp_path / "flight"))
    opts = {"cuda_poa_batches": 1, "window_length": 100}
    try:
        bad = cl.submit(*dataset, options=opts, trace_id="sdc",
                        fault_plan="device:chunk=1:sdc")
        assert bad.fasta == jax_oneshot(100)
        s = prom.parse(cl.scrape())
        assert s.gauges["racon_tpu_audit_alert"] == 1
        assert s.series_sum("racon_tpu_audit_mismatches_total") == 1
        body = cl.audit_ack()
        assert body["audit_ack"]["firing"] is False
        assert body["audit"]["acked"] == 1
        assert prom.parse(cl.scrape()).gauges["racon_tpu_audit_alert"] == 0
    finally:
        assert srv.drain(timeout=60)
    entries = read_journal(jp)
    alerts = [(e["kind"], e["state"]) for e in entries
              if e["event"] == "alert"]
    assert alerts == [("audit-mismatch", "firing"),
                      ("audit-mismatch", "clear")]
    assert [e["trace"] for e in entries
            if e["event"] == "audit-mismatch"] == ["sdc"]


# ------------------------------------------------------- configuration
@pytest.mark.parametrize("what", ["flight_dir", "journal", "metrics_port",
                                  "flag"])
def test_bad_observability_config_refused(tmp_path, what, capsys):
    not_a_dir = tmp_path / "file"
    not_a_dir.write_text("x")
    sock = str(tmp_path / "s.sock")
    if what == "flight_dir":
        with pytest.raises(RaconError, match="flight"):
            PolishServer(socket_path=sock, device="cpu", warmup=False,
                         flight_dir=str(not_a_dir)).start()
    elif what == "journal":
        with pytest.raises(RaconError, match="journal"):
            PolishServer(socket_path=sock, device="cpu", warmup=False,
                         flight_dir="",
                         journal=str(tmp_path / "missing" / "j.jsonl")
                         ).start()
    elif what == "metrics_port":
        with pytest.raises(RaconError, match="metrics port"):
            PolishServer(socket_path=sock, device="cpu", metrics_port=-1)
    else:
        with pytest.raises(SystemExit) as exc_info:
            serve_main(["--device", "cpu", "--socket", sock,
                        "--metrics-port", "-3"])
        assert exc_info.value.code == 2
        assert "invalid metrics port" in capsys.readouterr().err
    # nothing stayed armed, and the default directory is not checked
    assert trace.get_tracer() is None
    assert not PolishServer(socket_path=sock,
                            device="cpu").config.flight_dir_explicit


def test_exemplars_off_keeps_scrape_clean(dataset, tmp_path):
    srv, cl = start(tmp_path, exemplars=False, flight_dir="")
    try:
        cl.submit(*dataset)
        text = cl.scrape()
        assert " # {" not in text
        h = prom.parse(text).histogram("racon_tpu_job_latency_seconds")
        assert h.count == 1 and not h.bucket_exemplars()
    finally:
        assert srv.drain(timeout=30)


def test_everything_armed_fasta_identical_to_jax(dataset, jax_oneshot,
                                                 tmp_path):
    jp, tp, mp = (str(tmp_path / n) for n in ("j.jsonl", "t.json",
                                                "m.json"))
    srv, cl = start(tmp_path, workers=2, metrics_port=0, journal=jp,
                    flight_dir=str(tmp_path / "flight"), audit_rate=1.0,
                    wincache=True, trace_path=tp, metrics_path=mp)
    opts = {"cuda_poa_batches": 1, "window_length": 100}
    try:
        assert trace.get_tracer() is srv._flight
        assert cl.submit(*dataset).fasta == jax_oneshot(500)
        traced, doc = cl.submit_traced(*dataset, options=opts)
        assert traced.fasta == jax_oneshot(100)
        assert doc["traceEvents"] and traced.trace
        assert cl.submit(*dataset, options=opts,
                         stream=True).fasta == jax_oneshot(100)
        a = srv.stats_snapshot()["audit"]
        assert a["mismatches"] == 0 and a["audited"] > 0
    finally:
        assert srv.drain(timeout=60)
    assert trace.get_tracer() is None
    names = {e["name"] for e in json.load(open(tp))["traceEvents"]}
    assert {"serve.iteration", "serve.job", "serve.queue_wait"} <= names
    assert json.load(open(mp))["journal"]["events"] > 0
    assert check_consistency(read_journal(jp)) == []


def test_serve_cli_observability_flags(dataset, tmp_path):
    """`serve` with the observability flags (run on the main thread, which
    its signal handlers need) drains on `shutdown`, its journal and
    metrics written."""
    sock = str(tmp_path / "s.sock")
    jp, mp = str(tmp_path / "j.jsonl"), str(tmp_path / "m.json")
    seen: dict = {}

    def drive():
        cl = PolishClient(socket_path=sock, timeout=WAIT)
        deadline = time.monotonic() + WAIT
        while True:
            try:
                cl.ping()
                break
            except OSError:
                if time.monotonic() > deadline:
                    return
                time.sleep(0.05)
        try:
            cl.submit(*dataset)
            seen["stats"] = cl.stats()
            seen["events"] = len(cl.debug(max_events=0)["events"])
        finally:
            cl.shutdown()

    t = threading.Thread(target=drive)
    t.start()
    rc = serve_main(["--device", "cpu", "--socket", sock, "--no-warmup",
                     "--metrics-port", "0", "--journal", jp,
                     "--flight-dir", "", "--flight-events", "64",
                     "--no-exemplars", "--slo-budget", "0.5",
                     "--cuda-metrics", mp])
    t.join(WAIT)
    assert rc == 0
    assert seen["stats"]["slo"]["burn"]["budget"] == 0.5
    # the ring holds at most its capacity, beside the thread names
    assert 0 < seen["events"] <= 64 + 32
    events = [e["event"] for e in read_journal(jp)]
    assert events[0] == "serve-start" and events[-1] == "serve-stop"
    assert json.load(open(mp))["queue"]["completed"] == 1
    assert trace.get_tracer() is None
