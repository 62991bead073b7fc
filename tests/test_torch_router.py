"""The fleet's router in the port (serve/router.py), against the JAX package.

Inputs: the port's `make_synth_dataset(contigs=4)` triple (the JAX
function's files: four 2 kb drafts, 400 bp reads, seed 11), served by
in-process replicas on the CPU at the server defaults (host POA,
3/-5/-4), `RACON_TPU_MAX_DEVICES=1`, torch at one thread, every server
and router on a winner-table handle of its own. Tolerance: none; bytes,
event sequences, family names and key sets are compared exactly.

What is held:

  - a job routed over 1, 2 and 4 replicas (contig shards) gives the JAX
    package's unsharded FASTA, buffered and streamed, the streamed parts
    renumbered in contig order and each contig once;
  - `_JobMerge` fed the same scripted part / `shard_done` / `requeue`
    sequence (contig, range and fragment frames, hypothesis over the
    grid) forwards the same parts and gives the same `fasta()` as the
    JAX merge;
  - failover: a replica that drops its connection after streaming one
    `result_part` has its shard requeued and the routed part deduped:
    the same bytes, each contig once, `requeued` and `replica-down` in
    the router's journal, which `check_consistency` passes;
  - a rolling restart (drain, restart and rejoin of each replica in turn
    under a wave of jobs) loses no job, and healthz tracks the routable
    count;
  - `RouterConfig` and `router_main` refuse a bad config; the metrics
    port serves the federated body and `/healthz`;
  - a server's progress and result_part frames carry the job's trace
    id; a parent's cancel fans out to its shards; children carry priority,
    tenant, the remaining deadline and `parent` / `shard` / `shards`;
    a traced routed job merges into one trace with a track a replica;
  - against a JAX router over JAX replicas, on the same jobs (contig,
    streamed, window-range, fragment, and a failover): the router's
    journal events per job, its scrape families, its `router` block
    keys and the replicas' `received` child fields are the JAX ones.

The JAX package is imported inside the fixtures and tests that use it.
"""

import contextlib
import copy
import json
import socket
import threading
import time
import urllib.request
from collections import Counter

import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from racon_tpu_torch.errors import RaconError
from racon_tpu_torch.obs.journal import check_consistency, read_journal
from racon_tpu_torch.sched.autotune import reset_autotuner_cache
from racon_tpu_torch.serve import (JobCancelled, PolishClient, PolishRouter,
                                   PolishServer, RouterConfig, ServeError,
                                   make_synth_dataset)
from racon_tpu_torch.serve.protocol import (WIRE_LIMIT, ProtocolError,
                                            recv_frame, send_frame)
from racon_tpu_torch.serve.router import _JobMerge, router_main

WAIT = 120


@pytest.fixture(scope="module", autouse=True)
def _env(tmp_path_factory):
    """One device, one torch thread, and fresh winner-table handles for
    both packages (their servers render `sched.autotune.consults` from a
    process-global handle)."""
    table = str(tmp_path_factory.mktemp("autotune") / "jax.json")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RACON_TPU_MAX_DEVICES", "1")
        mp.setenv("RACON_TPU_AUTOTUNE_CACHE", table)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        reset_autotuner_cache()
        reset_jax_autotuner()
        yield
        reset_autotuner_cache()
        reset_jax_autotuner()
        torch.set_num_threads(threads)


def reset_jax_autotuner() -> None:
    with contextlib.suppress(ImportError):
        from racon_tpu.sched.autotune import reset_autotuner_cache as jreset

        jreset()


# ----------------------------------------------------------------- helpers
def start_server(path, table: str, **kw) -> PolishServer:
    """A port replica on the CPU with its own winner table."""
    kw.setdefault("warmup", False)
    kw.setdefault("workers", 2)
    return PolishServer(socket_path=str(path), device="cpu",
                        autotune_table=table, **kw).start()


def start_router(replicas, path, **kw) -> PolishRouter:
    kw.setdefault("health_interval_s", 0.2)
    return PolishRouter(replicas=[str(r) for r in replicas],
                        socket_path=str(path), **kw).start()


def wait_routable(cl, want: int, deadline_s: float = 30.0) -> dict:
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        with contextlib.suppress(Exception):
            hz = cl.request({"type": "healthz"})
            if hz.get("routable") == want:
                return hz
        time.sleep(0.05)
    raise AssertionError(f"the router never reached routable == {want}")


def jax_polish(paths, fragment: bool = False) -> bytes:
    """The JAX package's unsharded one-shot FASTA of a triple at the
    server defaults."""
    jpol = pytest.importorskip("racon_tpu.core.polisher")
    kind = jpol.PolisherType.kF if fragment else jpol.PolisherType.kC
    p = jpol.create_polisher(*paths, kind, 500, 10.0, 0.3, num_threads=2)
    p.initialize()
    return b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                    for s in p.polish(True))


def submit(cl, paths, **kw) -> dict:
    """A raw submit frame through `request` (the buffered reply)."""
    req = {"type": "submit", "sequences": paths[0], "overlaps": paths[1],
           "target": paths[2]}
    req.update(kw)
    return cl.request(req)


class DyingProxy:
    """A replica in front of a real one (`upstream`, a unix socket): it
    answers every probe as healthy, and a submit is relayed to the
    upstream replica until `after` result_part frames have been relayed,
    then the connection drops (a replica killed mid-shard, as the router
    sees it; `after=0` drops before relaying anything). It dies on its
    first `dies` submits and relays whole after that; `on_submit(conn,
    req)` replaces the relay."""

    def __init__(self, path, upstream=None, after: int = 1, dies: int = 1,
                 on_submit=None):
        self.path = str(path)
        self.upstream = None if upstream is None else str(upstream)
        self.after = after
        self.dies = dies
        self.on_submit = on_submit
        self.submits: list[dict] = []
        self._stop = threading.Event()
        self._lst = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._lst.bind(self.path)
        self._lst.listen(16)
        self._lst.settimeout(0.2)
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._lst.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _relay(self, conn, req, after) -> bool:
        """Relay `req` upstream; False once `after` parts went through
        (the connection is to drop)."""
        up = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            up.connect(self.upstream)
            send_frame(up, req)
            parts = 0
            while True:
                if after is not None and parts >= after:
                    return False
                frame = recv_frame(up, max_frame=WIRE_LIMIT)
                send_frame(conn, frame)
                if frame.get("type") == "result_part":
                    parts += 1
                elif frame.get("type") != "progress":
                    return True
        finally:
            up.close()

    def _handle(self, conn):
        try:
            while True:
                req = recv_frame(conn)
                if req is None:
                    return
                rtype = req.get("type")
                if rtype == "healthz":
                    send_frame(conn, {"type": "healthz", "ok": True,
                                      "draining": False})
                elif rtype == "scrape":
                    send_frame(conn, {"type": "metrics", "text": ""})
                elif rtype == "ping":
                    send_frame(conn, {"type": "pong",
                                      "mono_s": time.perf_counter()})
                elif rtype == "submit":
                    self.submits.append(req)
                    if self.on_submit is not None:
                        self.on_submit(conn, req)
                        return
                    dying = self.dies > 0
                    self.dies -= dying
                    if not self._relay(conn, req,
                                       self.after if dying else None) \
                            or dying:
                        with contextlib.suppress(OSError):
                            conn.shutdown(socket.SHUT_RDWR)
                        return
                else:
                    send_frame(conn, {"type": "ok"})
        except (OSError, ProtocolError):
            return
        finally:
            with contextlib.suppress(OSError):
                conn.close()

    def close(self):
        self._stop.set()
        with contextlib.suppress(OSError):
            self._lst.close()


# ---------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def dataset4(tmp_path_factory):
    return make_synth_dataset(str(tmp_path_factory.mktemp("router_data")),
                              contigs=4)


@pytest.fixture(scope="module")
def jax4(dataset4):
    return jax_polish(dataset4)


@pytest.fixture(scope="module")
def replicas4(tmp_path_factory):
    d = tmp_path_factory.mktemp("router_reps")
    servers = [start_server(d / f"rep{i}.sock", str(d / f"at{i}.json"))
               for i in range(4)]
    yield [s.config.socket_path for s in servers]
    for srv in servers:
        assert srv.drain(timeout=30)


# -------------------------------------------------------------- byte pins
@pytest.mark.parametrize("n", [1, 2, 4])
def test_routed_contig_job_byte_identical_to_jax(dataset4, jax4, replicas4,
                                                 tmp_path, n):
    router = start_router(replicas4[:n], tmp_path / "r.sock")
    try:
        cl = PolishClient(socket_path=router.config.socket_path,
                          timeout=WAIT)
        wait_routable(cl, n)
        raw = submit(cl, dataset4)
        assert raw["fasta"].encode("latin-1") == jax4
        assert raw["router"]["shards"] == n
        assert raw["router"]["requeues"] == 0
        assert raw["router"]["parts"] == 4
        parts: list[dict] = []
        res = cl.submit(*dataset4, on_part=parts.append)
        assert res.fasta == jax4
        assert res.router["shards"] == n
        assert [p["part"] for p in parts] == [0, 1, 2, 3]
        assert len({p["name"] for p in parts}) == 4
        assert b"".join(p["fasta"].encode("latin-1")
                        for p in parts) == jax4
    finally:
        assert router.drain()


def test_server_frames_carry_the_trace_id(dataset4, replicas4):
    """A traced job's progress and result_part frames name its trace id
    (what the router relays on; a job without one gets none)."""
    cl = PolishClient(socket_path=replicas4[0], timeout=WAIT)
    frames: list[dict] = []
    cl.submit(*dataset4, trace_id="direct", on_part=frames.append,
              on_progress=frames.append)
    kinds = {f["type"] for f in frames}
    assert kinds == {"progress", "result_part"}
    assert all(f["trace_id"] == "direct" for f in frames)
    frames.clear()
    cl.submit(*dataset4, on_part=frames.append, on_progress=frames.append)
    assert frames and not any("trace_id" in f for f in frames)


# ------------------------------------------------------------- merge unit
@st.composite
def merge_scripts(draw):
    """A scripted fan-out: the mode, each shard's frames, and one
    interleaving of the shards' attempts (each shard: attempts that
    stream a prefix of its frames then requeue, then the full stream and
    `shard_done`; now and then a parent failure)."""
    mode = draw(st.sampled_from(["contig", "range", "fragment"]))
    n = draw(st.integers(1, 4))
    groups = None
    frames: list[list[dict]] = []
    if mode == "range":
        cuts = sorted(draw(st.sets(st.integers(1, n - 1)))) if n > 1 else []
        bounds = [0, *cuts, n]
        groups = [{"ci": g, "name": f"ctg{g}", "shards": list(range(a, b))}
                  for g, (a, b) in enumerate(zip(bounds, bounds[1:]))]
        for g in groups:
            total = draw(st.integers(1, 8))
            cov = draw(st.integers(0, 30))
            for j, k in enumerate(g["shards"]):
                seg = {"lo": j * 500, "hi": (j + 1) * 500,
                       "total_windows": total,
                       "polished": draw(st.integers(0, 3)),
                       "coverage": cov}
                frame = {"name": g["name"], "fasta": f"ACGT{k}" * (j + 1),
                         "seg": seg}
                if draw(st.integers(0, 19)) == 0:
                    del frame["seg"]  # a replica that ignored the range
                frames.append([frame])
    else:
        lo = 0
        for k in range(n):
            shard = []
            for i in range(draw(st.integers(0, 3))):
                frame = {"name": f"s{k}p{i}",
                         "fasta": f">s{k}p{i}\nACGT{k}{i}\n"}
                if mode == "fragment":
                    reads = draw(st.integers(1, 4))
                    frame.update(frag=[lo, lo + reads], reads=reads)
                    lo += reads
                shard.append(frame)
            frames.append(shard)
    scripts = []
    for k in range(n):
        events = []
        for _ in range(draw(st.integers(0, 2))):
            cut = draw(st.integers(0, len(frames[k])))
            events += [("part", k, f) for f in frames[k][:cut]]
            events.append(("requeue", k, None))
        events += [("part", k, f) for f in frames[k]]
        events.append(("done", k, None))
        scripts.append(events)
    order = []
    while any(scripts):
        k = draw(st.sampled_from([i for i, s in enumerate(scripts) if s]))
        order.append(scripts[k].pop(0))
        if draw(st.integers(0, 39)) == 0:
            order.append(("fail", k, None))
    return {"mode": mode, "n": n, "groups": groups, "order": order,
            "fragment_correction": draw(st.booleans()),
            "drop_unpolished": draw(st.booleans())}


def run_merge(cls, failure_cls, script) -> dict:
    emitted, routed = [], []
    m = cls(script["n"], emit_part=lambda *a: emitted.append(a),
            on_routed=lambda *a, **kw: routed.append((a, kw)),
            groups=copy.deepcopy(script["groups"]),
            fragment_correction=script["fragment_correction"],
            drop_unpolished=script["drop_unpolished"])
    for what, k, frame in script["order"]:
        if what == "part":
            m.on_part(k, copy.deepcopy(frame))
        elif what == "requeue":
            m.requeue(k)
        elif what == "done":
            m.shard_done(k, {"shard": k})
        else:
            m.fail(failure_cls("cancelled", f"shard {k}"))
    return {"emitted": emitted, "routed": routed, "fasta": m.fasta(),
            "total": m.total_routed, "segments": m.segments_routed,
            "reads": m.reads_routed,
            "failure": None if m.failure is None else (m.failure.code,
                                                       str(m.failure))}


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(script=merge_scripts())
def test_job_merge_matches_jax(script):
    jrouter = pytest.importorskip("racon_tpu.serve.router")
    from racon_tpu_torch.serve.router import _ShardFailure

    mine = run_merge(_JobMerge, _ShardFailure, script)
    theirs = run_merge(jrouter._JobMerge, jrouter._ShardFailure, script)
    assert mine == theirs


def test_job_merge_dedupes_a_requeued_shard():
    emitted = []
    m = _JobMerge(2, emit_part=lambda k, i, n, f: emitted.append((i, n)))
    m.on_part(1, {"name": "c", "fasta": "C"})  # a later shard buffers
    assert emitted == []
    m.on_part(0, {"name": "a", "fasta": "A"})
    m.requeue(0)  # its replica died after streaming "a"
    m.on_part(0, {"name": "a", "fasta": "A"})  # the rerun's duplicate
    m.on_part(0, {"name": "b", "fasta": "B"})
    m.shard_done(0, {})
    m.shard_done(1, {})
    assert emitted == [(0, "a"), (1, "b"), (2, "c")]
    assert m.fasta() == "ABC" and m.total_routed == 3


# --------------------------------------------------------------- failover
def test_failover_requeues_and_dedupes(dataset4, jax4, replicas4, tmp_path):
    proxy = DyingProxy(tmp_path / "dying.sock", upstream=replicas4[0],
                       after=1, dies=2)
    journal = str(tmp_path / "router.jsonl")
    router = start_router([proxy.path, replicas4[1]], tmp_path / "r.sock",
                          journal=journal)
    try:
        cl = PolishClient(socket_path=router.config.socket_path,
                          timeout=WAIT)
        wait_routable(cl, 2)
        parts: list[dict] = []
        res = cl.submit(*dataset4, on_part=parts.append)
        assert res.fasta == jax4
        assert res.router["requeues"] >= 1
        assert len(parts) == 4 and len({p["name"] for p in parts}) == 4
        assert proxy.submits  # the dying replica took a shard
        assert cl.request({"type": "healthz"})["requeued_outstanding"] == 0
    finally:
        assert router.drain()
        proxy.close()
    entries = read_journal(journal)
    events = [e["event"] for e in entries]
    assert "replica-down" in events and "requeued" in events
    routed = [e for e in entries if e["event"] == "part-routed"]
    assert sorted(e["part"] for e in routed) == [0, 1, 2, 3]
    assert check_consistency(entries) == []


# -------------------------------------------------------- rolling restart
def test_rolling_restart_loses_no_jobs(dataset4, jax4, tmp_path):
    socks = [str(tmp_path / "a.sock"), str(tmp_path / "b.sock")]
    table = str(tmp_path / "at.json")
    servers = {s: start_server(s, table) for s in socks}
    router = start_router(socks, tmp_path / "r.sock", replica_wait_s=30.0)
    cl = PolishClient(socket_path=router.config.socket_path, timeout=WAIT)
    stop = threading.Event()
    results: list[bytes] = []
    errors: list[Exception] = []

    def wave():
        w = PolishClient(socket_path=router.config.socket_path,
                         timeout=WAIT)
        while not stop.is_set():
            try:
                results.append(w.submit(*dataset4).fasta)
            except Exception as exc:  # noqa: BLE001 — the assertion
                errors.append(exc)
                return

    threads = [threading.Thread(target=wave, daemon=True) for _ in range(2)]
    try:
        wait_routable(cl, 2)
        for t in threads:
            t.start()
        for s in socks:  # drain, restart, rejoin, each in turn
            n_before = len(results)
            assert servers[s].drain(timeout=30)
            assert wait_routable(cl, 1)["ok"]
            servers[s] = start_server(s, table)
            wait_routable(cl, 2)
            deadline = time.monotonic() + WAIT
            while len(results) < n_before + 2 and not errors:
                assert time.monotonic() < deadline
                time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(WAIT)
        assert not errors, f"the wave lost jobs: {errors!r}"
        assert len(results) >= 4 and all(b == jax4 for b in results)
    finally:
        stop.set()
        assert router.drain()
        for srv in servers.values():
            srv.drain(timeout=30)


# ------------------------------------------------------- config and CLI
@pytest.mark.parametrize("kw,match", [
    ({}, "no replicas"),
    ({"replicas": ""}, "no replicas"),
    ({"replicas": "http://127.0.0.1:9100/metrics"}, "metrics base"),
    ({"replicas": "10.1.2.3:4000"}, "localhost"),
    ({"replicas": "/tmp/a.sock", "bogus": 1}, "unknown router option"),
    ({"replicas": "/tmp/a.sock", "health_interval_s": "soon"},
     "invalid router option"),
    ({"replicas": "/tmp/a.sock", "metrics_port": -1}, "metrics_port"),
])
def test_router_config_refuses(kw, match):
    with pytest.raises(RaconError, match=match):
        RouterConfig(**kw)


@pytest.mark.parametrize("argv", [
    ["--replicas", ""],
    ["--replicas", "10.1.2.3:4000"],
    ["--replicas", "http://127.0.0.1:9/metrics"],
    ["--replicas", "/tmp/a.sock", "--metrics-port", "-2"],
])
def test_router_main_refuses_bad_config(argv, capsys, monkeypatch):
    # a knob in the environment changes nothing: there is none
    monkeypatch.setenv("RACON_TPU_ROUTER_REPLICAS", "/tmp/x.sock")
    assert router_main(argv) == 1
    assert "error" in capsys.readouterr().err


def test_router_http_metrics_and_healthz(dataset4, replicas4, tmp_path):
    router = start_router(replicas4[:2], tmp_path / "r.sock",
                          metrics_port=0)
    try:
        cl = PolishClient(socket_path=router.config.socket_path,
                          timeout=WAIT)
        wait_routable(cl, 2)
        cl.submit(*dataset4)
        router._apply_poll(router.fleet.poll())
        base = f"http://127.0.0.1:{router.config.metrics_port}"
        body = urllib.request.urlopen(base + "/metrics",
                                      timeout=10).read().decode()
        for line in ("racon_tpu_router_replicas 2",
                     "racon_tpu_router_replicas_routable 2",
                     "racon_tpu_router_jobs_completed_total 1",
                     "racon_tpu_router_requeued_outstanding 0",
                     "racon_tpu_fleet_replicas 2"):
            assert line in body.splitlines(), line
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            doc = json.loads(r.read().decode())
        assert doc["ok"] and doc["routable"] == 2 and doc["router"]
        assert cl.request({"type": "stats"})["router"]["jobs_completed"] == 1
    finally:
        assert router.drain()


# ---------------------------------------------------------------- QoS
def test_parent_cancel_fans_out_to_shards(dataset4, tmp_path):
    table = str(tmp_path / "at.json")
    servers = [start_server(tmp_path / f"c{i}.sock", table)
               for i in range(2)]
    router = start_router([s.config.socket_path for s in servers],
                          tmp_path / "r.sock")
    out: dict = {}
    try:
        cl = PolishClient(socket_path=router.config.socket_path,
                          timeout=WAIT)
        wait_routable(cl, 2)
        for srv in servers:
            srv.batcher.hold()

        def go():
            try:
                out["res"] = cl.submit(*dataset4, trace_id="cx")
            except Exception as exc:  # noqa: BLE001 — checked below
                out["res"] = exc

        t = threading.Thread(target=go)
        t.start()
        deadline = time.monotonic() + WAIT
        while not all(srv.batcher._job_tickets for srv in servers):
            assert time.monotonic() < deadline, "the shards never pooled"
            time.sleep(0.01)
        body = cl.cancel(trace_id="cx")
        assert body["cancelled"] == "running" and body["shards_cancelled"] == 2
        for srv in servers:
            srv.batcher.release()
        t.join(WAIT)
        assert isinstance(out["res"], JobCancelled)
        with pytest.raises(ServeError) as exc_info:
            cl.cancel(trace_id="cx")
        assert exc_info.value.code == "unknown-job"
    finally:
        for srv in servers:
            srv.batcher.release()
        assert router.drain()
        for srv in servers:
            assert srv.drain(timeout=30)


def test_children_carry_qos_and_parent_fields(dataset4, jax4, tmp_path):
    table = str(tmp_path / "at.json")
    journals = [str(tmp_path / f"j{i}.jsonl") for i in range(2)]
    servers = [start_server(tmp_path / f"q{i}.sock", table, journal=j)
               for i, j in enumerate(journals)]
    router = start_router([s.config.socket_path for s in servers],
                          tmp_path / "r.sock")
    try:
        cl = PolishClient(socket_path=router.config.socket_path,
                          timeout=WAIT)
        wait_routable(cl, 2)
        res = cl.submit(*dataset4, priority=2, tenant="gold",
                        deadline_s=300.0, trace_id="qos")
        assert res.fasta == jax4
    finally:
        assert router.drain()
        for srv in servers:
            assert srv.drain(timeout=30)
    received = [e for j in journals for e in read_journal(j)
                if e["event"] == "received"]
    assert sorted((e["trace"], e["parent"], e["shard"], e["shards"])
                  for e in received) == [("qos.s0", "r1", 0, 2),
                                         ("qos.s1", "r1", 1, 2)]
    for e in received:
        assert e["priority"] == 2 and e["tenant"] == "gold"
        assert 250.0 < e["deadline_s"] <= 300.0


def test_traced_routed_job_has_a_track_a_replica(dataset4, jax4, replicas4,
                                                 tmp_path):
    router = start_router(replicas4[:2], tmp_path / "r.sock")
    try:
        cl = PolishClient(socket_path=router.config.socket_path,
                          timeout=WAIT)
        wait_routable(cl, 2)
        out = str(tmp_path / "t.json")
        res, doc = cl.submit_traced(*dataset4, trace_id="tr",
                                    trace_out=out)
        assert res.fasta == jax4 and json.load(open(out)) == doc
    finally:
        assert router.drain()
    assert res.router["shards"] == 2 and len(res.router["shards_detail"]) == 2
    assert len(res.trace_replicas) == 2
    ctx = doc["trace_context"]
    assert [r["replica"] for r in ctx["replicas"]] == sorted(replicas4[:2])
    assert ctx["stats"]["router"] == res.router
    names = {(e["pid"], e["args"]["name"]) for e in doc["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert {(1, "racon_tpu_torch client"), (2, "racon_tpu_torch router"),
            (3, f"racon_tpu_torch replica {sorted(replicas4[:2])[0]}"),
            (4, f"racon_tpu_torch replica {sorted(replicas4[:2])[1]}")} \
        <= names
    router_spans = {e["name"] for e in doc["traceEvents"]
                    if e.get("pid") == 2 and e.get("ph") == "X"}
    assert {"router.plan", "router.dispatch", "router.shard",
            "router.merge"} <= router_spans
    replica_jobs = [e for e in doc["traceEvents"]
                    if e.get("pid", 0) >= 3 and e.get("name") == "serve.job"]
    assert sorted(e["args"]["trace_id"] for e in replica_jobs) == \
        ["tr.s0", "tr.s1"]


# ------------------------------------------------------ against JAX's router
def router_scenario(cl, fail_cl, paths4, path1, frag) -> dict:
    """The jobs both routers run: trace id -> its result frame."""
    out = {"contig": submit(cl, paths4, trace_id="contig"),
           "streamed": submit(cl, paths4, trace_id="streamed",
                              stream=True),
           "range": submit(cl, path1, trace_id="range"),
           "fragment": submit(cl, frag, trace_id="fragment",
                              mode="fragment")}
    out["failover"] = fail_cl.request({
        "type": "submit", "sequences": paths4[0], "overlaps": paths4[1],
        "target": paths4[2], "trace_id": "failover"})
    return out


def canonical(journal: str) -> dict:
    """Per router job: its trace id, the lifecycle lines in order, every
    event as a multiset (shards run concurrently), and the routed parts
    in order with their receipts (in range mode a segment is journaled
    as it arrives, so those are sorted)."""
    out: dict = {}
    for e in read_journal(journal):
        if not e.get("job"):
            continue
        c = out.setdefault(e["job"], {"trace": e.get("trace"),
                                      "lifecycle": [], "events": Counter(),
                                      "parts": []})
        if e["event"] in ("received", "started", "finished", "failed"):
            c["lifecycle"].append(e["event"])
        elif e["event"] == "part-routed":
            c["parts"].append(tuple(e.get(k) for k in (
                "shard", "part", "name", "bytes", "lo", "hi", "frag_lo",
                "frag_hi", "reads")))
        c["events"][e["event"]] += 1
    for c in out.values():
        if c["events"]["range-plan"]:
            c["parts"].sort()
    return out


def received_children(journals) -> list:
    return sorted(tuple(e.get(k) for k in (
        "trace", "parent", "shard", "shards", "range_lo", "range_hi",
        "mode", "frag_lo", "frag_hi"))
        for j in journals for e in read_journal(j)
        if e["event"] == "received")


@pytest.fixture(scope="module")
def fleet_data(dataset4, tmp_path_factory):
    from racon_tpu_torch.serve import make_fragment_dataset

    return {"paths4": dataset4,
            "path1": make_synth_dataset(
                str(tmp_path_factory.mktemp("one_contig"))),
            "frag": make_fragment_dataset(
                str(tmp_path_factory.mktemp("fragment")))}


def run_fleet(serve_mod, make_server, d, data) -> dict:
    """Two replicas (journaled) behind a router, and a dying replica in
    front of the first behind a second router, both journaled; the
    scenario's results, the routers' journals, the scrape and the
    replicas' child fields."""
    journals = [str(d / f"rep{i}.jsonl") for i in range(2)]
    servers = [make_server(str(d / f"rep{i}.sock"), journals[i])
               for i in range(2)]
    socks = [s.config.socket_path for s in servers]
    proxy = DyingProxy(d / "dying.sock", upstream=socks[0], after=1,
                       dies=2)
    # a JAX replica's scrape can take 2 s or more on the CPU while its
    # first job traces and compiles, and a probe that times out marks the
    # replica down: the scenario's shard counts would then follow the
    # machine's speed. Both routers wait up to 30 s for a probe.
    routers = [serve_mod.PolishRouter(replicas=",".join(reps),
                                      socket_path=str(d / f"{n}.sock"),
                                      journal=str(d / f"{n}.jsonl"),
                                      health_interval_s=0.2,
                                      probe_timeout_s=30.0).start()
               for n, reps in (("router", socks),
                               ("failrouter", [proxy.path, socks[1]]))]
    try:
        cls = [serve_mod.PolishClient(socket_path=r.config.socket_path,
                                      timeout=WAIT) for r in routers]
        for cl in cls:
            wait_routable(cl, 2)
        results = router_scenario(*cls, data["paths4"], data["path1"],
                                  data["frag"])
        # the scrape renders the router's last completed poll: poll once
        # more, so both routers federate the replicas' state after the
        # scenario, not a poll that began during it
        routers[0]._apply_poll(routers[0].fleet.poll())
        scrape = cls[0].request({"type": "scrape"})["text"]
        stats = cls[0].request({"type": "stats"})
    finally:
        for r in routers:
            r.drain(timeout=30)
        proxy.close()
        for s in servers:
            s.drain(timeout=30)
    return {"results": results, "scrape": scrape, "stats": stats,
            "journal": canonical(str(d / "router.jsonl")),
            "failjournal": canonical(str(d / "failrouter.jsonl")),
            "children": received_children(journals)}


@pytest.fixture(scope="module")
def jax_fleet(fleet_data, tmp_path_factory):
    jserve = pytest.importorskip("racon_tpu.serve")
    reset_jax_autotuner()

    def make(sock, journal):
        return jserve.PolishServer(socket_path=sock, warmup=False,
                                   workers=2, journal=journal).start()

    return run_fleet(jserve, make, tmp_path_factory.mktemp("jax_fleet"),
                     fleet_data)


@pytest.fixture(scope="module")
def port_fleet(fleet_data, tmp_path_factory):
    import racon_tpu_torch.serve as pserve

    d = tmp_path_factory.mktemp("port_fleet")
    reset_autotuner_cache()

    def make(sock, journal):
        return start_server(sock, str(d / "at.json"), journal=journal)

    return run_fleet(pserve, make, d, fleet_data)


def test_routed_jobs_byte_identical_to_jax_router(jax_fleet, port_fleet,
                                                  fleet_data):
    for tag, theirs in jax_fleet["results"].items():
        mine = port_fleet["results"][tag]
        assert mine.get("fasta") == theirs.get("fasta"), tag
        assert [p["fasta"] for p in mine.get("_parts", ())] == \
            [p["fasta"] for p in theirs.get("_parts", ())], tag
    solo = {"contig": jax_polish(fleet_data["paths4"]),
            "range": jax_polish(fleet_data["path1"]),
            "fragment": jax_polish(fleet_data["frag"], fragment=True),
            "failover": jax_polish(fleet_data["paths4"])}
    for tag, want in solo.items():
        assert port_fleet["results"][tag]["fasta"].encode("latin-1") \
            == want, tag


def test_router_block_keys_match_jax(jax_fleet, port_fleet):
    for tag, theirs in jax_fleet["results"].items():
        mine = port_fleet["results"][tag]
        assert set(mine) == set(theirs), tag
        assert set(mine["router"]) == set(theirs["router"]), tag
        for key in ("shards", "replicas", "requeues", "parts", "range",
                    "range_shards", "segments", "fragment", "frag_shards",
                    "reads"):
            assert mine["router"].get(key) == theirs["router"].get(key), \
                (tag, key)
    assert set(port_fleet["stats"]) == set(jax_fleet["stats"])
    assert set(port_fleet["stats"]["router"]) == \
        set(jax_fleet["stats"]["router"])


@pytest.mark.parametrize("which", ["journal", "failjournal"])
def test_router_journal_events_match_jax(jax_fleet, port_fleet, which):
    mine, theirs = port_fleet[which], jax_fleet[which]
    assert set(mine) == set(theirs)
    for tid in theirs:
        assert mine[tid] == theirs[tid], tid
    if which == "failjournal":
        ev = mine["r1"]["events"]
        assert ev["requeued"] == 1 and ev["replica-down"] == 1


def test_replica_child_fields_match_jax(jax_fleet, port_fleet):
    assert port_fleet["children"] == jax_fleet["children"]
    assert ("contig.s1", "r1", 1, 2, None, None, None, None, None) in \
        port_fleet["children"]


def test_router_scrape_families_match_jax(jax_fleet, port_fleet):
    from test_torch_serve_obs import families

    mine, theirs = (families(f["scrape"]) for f in (port_fleet, jax_fleet))
    assert mine == theirs
    assert mine["racon_tpu_router_requeues_total"] == ("counter", ())
    assert mine["racon_tpu_fleet_replica_up"] == ("gauge", ("replica",))
