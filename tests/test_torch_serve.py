"""The port's warm server against the JAX package, on the CPU.

Inputs: the JAX package's `make_synth_dataset` triple (2 kb draft, 400 bp
reads, seed 11) and the port's 3 kb `synth.simulate` triple (seed 7),
scores 5/-4/-8, `RACON_TPU_MAX_DEVICES=1`, `RACON_TPU_STRICT=1`, torch at
one thread. Tolerance: none; every value held is a byte or an integer.

What is held:

  - the port's `make_synth_dataset` writes the JAX function's files, and
    its job queue behaves as the JAX package's (retry-after, FIFO within
    a priority, expiry, drain, weighted fair order, quotas);
  - a served job, buffered, streamed and pooled with another job in
    shared iterations, gives the JAX package's one-shot FASTA at
    `-c 1 --tpualigner-batches 1` (session engine), at `-c 0` (host
    POA), and with the fused engine, whose job never shares an
    iteration with a session job; jobs whose scores differ never merge;
    a job spread over several small iterations keeps its bytes;
  - fault plans: a poisoned job fails typed (`JobFailed`) beside a clean
    job that keeps its bytes, the server goes on; malformed plans (an
    `sdc` with an argument among them) are bad requests; each action
    fires once at its stage;
  - cancel of a queued and of a running job, drain, the typed errors,
    frames that do not parse, `device="cuda"` without a card;
  - the kernels' launch counters lose no count under concurrent threads.

The JAX package is imported inside the fixtures and tests that use it,
so the test on the card (marked `gpu`) needs none.
"""

import os
import random
import socket
import struct
import sys
import threading
import time

import pytest
import torch

from racon_tpu_torch.errors import ChunkCorrupt, DeviceError, RaconError
from racon_tpu_torch.ops import align_kernels, poa_fused_kernels, poa_kernels
from racon_tpu_torch.pipeline import DispatchPipeline, PipelineStats
from racon_tpu_torch.resilience import FaultPlan
from racon_tpu_torch.serve import (JobCancelled, JobFailed, PolishClient,
                                   PolishServer, ServeError, ServerDraining,
                                   WindowBatcher, make_synth_dataset)
from racon_tpu_torch.serve import queue as port_queue
from racon_tpu_torch.serve.protocol import MAGIC, recv_frame, send_frame
from racon_tpu_torch.synth import simulate, write_dataset

SCORES = (5, -4, -8)
WAIT = 120


@pytest.fixture(scope="module", autouse=True)
def _env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RACON_TPU_MAX_DEVICES", "1")
        mp.setenv("RACON_TPU_STRICT", "1")
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


def fasta(polished) -> bytes:
    return b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                    for s in polished)


def wait_for(cond, what: str, timeout: float = WAIT) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


@pytest.fixture(scope="module")
def synth2(tmp_path_factory):
    jax_server = pytest.importorskip("racon_tpu.serve.server")
    return jax_server.make_synth_dataset(str(tmp_path_factory.mktemp("s2")))


@pytest.fixture(scope="module")
def sim3(tmp_path_factory):
    _, draft, reads, paf = simulate(random.Random(7), 3000, 8, 2000, 0.12,
                                    0.10)
    return write_dataset(str(tmp_path_factory.mktemp("s3")), draft, reads,
                         paf)


@pytest.fixture(scope="module")
def jax_oneshot():
    """The JAX package's one-shot FASTA: (paths, poa batches, aligner
    batches, engine, scores) -> bytes, each computed once."""
    jpol = pytest.importorskip("racon_tpu.core.polisher")
    cache: dict = {}

    def run(paths, c, aligner=0, engine=None, scores=SCORES):
        key = (tuple(paths), c, aligner, engine, scores)
        if key not in cache:
            kw = {"tpu_engine": engine} if engine else {}
            p = jpol.create_polisher(*paths, jpol.PolisherType.kC, 500, 10.0,
                                     0.3, True, *scores, num_threads=2,
                                     tpu_poa_batches=c,
                                     tpu_banded_alignment=False,
                                     tpu_aligner_batches=aligner, **kw)
            p.initialize()
            cache[key] = fasta(p.polish())
        return cache[key]

    return run


def start_server(tmp_path_factory, **kw) -> PolishServer:
    kw.setdefault("warmup", False)
    sock = str(tmp_path_factory.mktemp("sock") / "s.sock")
    return PolishServer(socket_path=sock, device="cpu", match=SCORES[0],
                        mismatch=SCORES[1], gap=SCORES[2], **kw).start()


@pytest.fixture(scope="module")
def host_server(tmp_path_factory):
    """Host POA and host alignment (the JAX server's defaults), warm."""
    srv = start_server(tmp_path_factory, workers=2, warmup=True)
    yield srv
    srv.drain(timeout=30)


@pytest.fixture(scope="module")
def client(host_server):
    return PolishClient(socket_path=host_server.config.socket_path,
                        timeout=WAIT)


# ------------------------------------------------------------- dataset
@pytest.mark.parametrize("contigs", [1, 2])
def test_make_synth_dataset_files_equal_jax(tmp_path, monkeypatch, contigs):
    jax_server = pytest.importorskip("racon_tpu.serve.server")
    # gzip stamps the write time into each file's header
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    mine = make_synth_dataset(str(tmp_path / "port"), contigs=contigs)
    theirs = jax_server.make_synth_dataset(str(tmp_path / "jax"),
                                           contigs=contigs)
    for a, b in zip(mine, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a


# ---------------------------------------------------------------- queue
def _job(qm, i, priority=0, deadline_s=None, tenant=""):
    return qm.Job(f"{tenant}{i}", "s", "o", "t", {}, priority=priority,
                  deadline_s=deadline_s, tenant=tenant)


def _q_retry_after(qm):
    q = qm.JobQueue(maxsize=2, workers=1)
    q.submit(_job(qm, 0))
    q.submit(_job(qm, 1))
    with pytest.raises(qm.QueueFull) as exc_info:
        q.submit(_job(qm, 2))
    assert exc_info.value.retry_after > 0
    return (q.counters["rejected_full"], q.counters["admitted"])


def _q_fifo_within_priority(qm):
    q = qm.JobQueue(maxsize=8)
    for i, prio in enumerate((0, 0, 5, 5)):
        q.submit(_job(qm, i, priority=prio))
    order = [q.pop(timeout=0.1).id for _ in range(4)]
    assert order == ["2", "3", "0", "1"]
    return order


def _q_deadline_expired(qm):
    q = qm.JobQueue(maxsize=8)
    expired = _job(qm, 0, deadline_s=0.01)
    q.submit(expired)
    q.submit(_job(qm, 1))
    time.sleep(0.05)
    assert q.pop(timeout=0.5).id == "1"
    assert expired.event.is_set()
    return (q.counters["expired"], expired.response["code"])


def _q_drain(qm):
    q = qm.JobQueue(maxsize=8)
    q.submit(_job(qm, 0))
    q.drain()
    with pytest.raises(qm.Draining):
        q.submit(_job(qm, 1))
    return (q.pop(timeout=0.1).id, q.counters["rejected_draining"])


def _q_drr_interleave(qm):
    q = qm.JobQueue(maxsize=32)
    for i in range(6):
        q.submit(_job(qm, i, tenant="heavy"))
    for i in range(2):
        q.submit(_job(qm, i, tenant="light"))
    pos = q.position(q._classes[0].tenants["light"][0])
    order = [q.pop(timeout=0.1).id for _ in range(8)]
    assert pos <= 3 and order.index("light0") <= 3
    assert order.index("light1") <= 5
    heavy = [j for j in order if j.startswith("heavy")]
    assert heavy == sorted(heavy)
    return (pos, order)


def _q_drr_weighted_ratio(qm):
    q = qm.JobQueue(maxsize=32, tenant_weights={"heavy": 1, "gold": 3})
    for i in range(6):
        q.submit(_job(qm, i, tenant="heavy"))
    for i in range(3):
        q.submit(_job(qm, i, tenant="gold"))
    order = [q.pop(timeout=0.1).id for _ in range(9)]
    assert {j for j in order[:4] if j.startswith("gold")} == {
        "gold0", "gold1", "gold2"}
    return order


def _q_priority_beats_weight(qm):
    q = qm.JobQueue(maxsize=32, tenant_weights={"vip": 100})
    q.submit(_job(qm, 0, tenant="vip"))
    q.submit(_job(qm, 0, priority=5, tenant="urgent"))
    order = [q.pop(timeout=0.1).id for _ in range(2)]
    assert order == ["urgent0", "vip0"]
    return order


def _q_single_tenant_fifo(qm):
    q = qm.JobQueue(maxsize=8)
    for i in range(4):
        q.submit(_job(qm, i))
    order = [q.pop(timeout=0.1).id for _ in range(4)]
    assert order == ["0", "1", "2", "3"]
    return order


def _q_tenant_quota(qm):
    q = qm.JobQueue(maxsize=8, tenant_quota=2)
    q.submit(_job(qm, 1, tenant="heavy"))
    q.submit(_job(qm, 2, tenant="heavy"))
    with pytest.raises(qm.TenantQuotaExceeded) as exc_info:
        q.submit(_job(qm, 3, tenant="heavy"))
    assert exc_info.value.retry_after > 0
    q.submit(_job(qm, 1, tenant="light"))
    assert q.pop(timeout=0.5) is not None
    q.submit(_job(qm, 4, tenant="heavy"))
    return (q.counters["rejected_quota"], q.counters["admitted"])


QUEUE_CASES = {f.__name__[3:]: f for f in (
    _q_retry_after, _q_fifo_within_priority, _q_deadline_expired, _q_drain,
    _q_drr_interleave, _q_drr_weighted_ratio, _q_priority_beats_weight,
    _q_single_tenant_fifo, _q_tenant_quota)}


@pytest.mark.parametrize("case", sorted(QUEUE_CASES))
def test_queue_behaves_as_jax(case):
    """Each case's assertions hold on the port's queue, and its outcome
    equals the JAX package's queue's on the same calls."""
    jax_queue = pytest.importorskip("racon_tpu.serve.queue")
    assert QUEUE_CASES[case](port_queue) == QUEUE_CASES[case](jax_queue)


# ------------------------------------------------------- served = one-shot
@pytest.mark.parametrize("data", ["synth2", "sim3"])
def test_host_poa_job_equals_jax_oneshot(client, jax_oneshot, request,
                                         data):
    """-c 0: buffered and streamed (with progress frames) jobs give the
    JAX package's one-shot bytes."""
    paths = request.getfixturevalue(data)
    want = jax_oneshot(paths, 0)
    assert want.startswith(b">")
    assert client.submit(*paths).fasta == want
    parts, progress = [], []
    r = client.submit(*paths, on_part=parts.append,
                      on_progress=progress.append)
    assert r.streamed and r.fasta == want
    assert b"".join(p["fasta"].encode("latin-1") for p in parts) == want
    assert {"start", "consensus", "stitch"} <= {p["phase"] for p in progress}
    batch = r.serve["batch"]
    assert batch["iterations"] == len(batch["iteration_ids"]) >= 1
    assert batch["k1_launches"] == batch["k2_launches"] == 0


def test_device_paths_pooled_equal_jax_oneshot(tmp_path_factory, synth2,
                                               jax_oneshot):
    """The session engine (-c 1 with the device aligner): a buffered and
    a streamed job pooled behind hold() share an iteration and both give
    the JAX package's one-shot bytes; a fused-engine job pooled beside
    them gives JAX's fused bytes and never shares their iteration."""
    srv = start_server(tmp_path_factory, workers=3, cuda_poa_batches=1,
                       cuda_aligner_batches=1)
    try:
        cl = PolishClient(socket_path=srv.config.socket_path, timeout=WAIT)
        out: dict = {}
        parts: list = []
        jobs = {"buffered": {}, "streamed": {"on_part": parts.append},
                "fused": {"options": {"cuda_engine": "fused",
                                      "cuda_fused": "1"}}}

        def go(name):
            out[name] = cl.submit(*synth2, **jobs[name])

        srv.batcher.hold()
        threads = [threading.Thread(target=go, args=(n,)) for n in jobs]
        for t in threads:
            t.start()
        wait_for(lambda: sum(map(len, srv.batcher._job_tickets.values()))
                 == 3, "the three jobs never pooled")
        srv.batcher.release()
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
        want = jax_oneshot(synth2, 1, 1)
        assert out["buffered"].fasta == want
        assert out["streamed"].fasta == want and out["streamed"].streamed
        assert b"".join(p["fasta"].encode("latin-1") for p in parts) == want
        assert out["fused"].fasta == jax_oneshot(synth2, 1, 1, "fused")
        for name in ("buffered", "streamed"):
            assert out[name].serve["batch"]["shared_iterations"] >= 1
        assert out["fused"].serve["batch"]["shared_iterations"] == 0
        counters = srv.batcher.counters
        assert counters["max_jobs_in_iteration"] == 2
        assert counters["shared_iterations"] == counters["iterations"] - 1
    finally:
        srv.drain(timeout=30)


def test_pooled_and_small_iterations_keep_bytes(sim3, jax_oneshot):
    """Two jobs pooled behind hold() share iterations; with
    iteration_windows=2 a job spreads over several iterations; one
    cached (pipeline, engine) pair serves every iteration of a key."""
    from racon_tpu_torch.core.polisher import PolisherType, create_polisher

    want = jax_oneshot(sim3, 0)

    def build():
        p = create_polisher(*sim3, PolisherType.kC, 500, 10.0, 0.3, True,
                            *SCORES, num_threads=2, device="cpu")
        p.initialize()
        return p

    for cap in (256, 2):
        batcher = WindowBatcher(iteration_windows=cap)
        pols = [build(), build()]
        batcher.hold()
        threads = [threading.Thread(target=batcher.consensus, args=(p,))
                   for p in pols]
        for t in threads:
            t.start()
        wait_for(lambda: batcher.snapshot()["pending_windows"]
                 == sum(len(p.windows) for p in pols), "never pooled")
        batcher.release()
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
        for p in pols:
            assert fasta(p._stitch(True)) == want
            assert p.serve_batch["shared_iterations"] >= 1
        n = len(pols[0].windows)
        if cap == 2:
            assert pols[0].serve_batch["iterations"] >= n // 2 >= 2
        assert batcher.snapshot()["max_windows_in_iteration"] <= min(cap,
                                                                     2 * n)
        assert len(batcher._engines) == 1
        batcher.close()
        for pipeline, _ in batcher._engines.values():
            assert pipeline._executor is None


def test_jobs_with_different_scores_never_merge(sim3, jax_oneshot):
    from racon_tpu_torch.core.polisher import PolisherType, create_polisher

    batcher = WindowBatcher()
    pols = {}
    for scores in (SCORES, (3, -5, -4)):
        p = create_polisher(*sim3, PolisherType.kC, 500, 10.0, 0.3, True,
                            *scores, num_threads=2, device="cpu")
        p.initialize()
        pols[scores] = p
    batcher.hold()
    threads = [threading.Thread(target=batcher.consensus, args=(p,))
               for p in pols.values()]
    for t in threads:
        t.start()
    wait_for(lambda: batcher.snapshot()["pending_windows"]
             == sum(len(p.windows) for p in pols.values()), "never pooled")
    batcher.release()
    for t in threads:
        t.join(WAIT)
        assert not t.is_alive()
    assert batcher.counters["max_jobs_in_iteration"] == 1
    assert batcher.counters["iterations"] == 2
    outs = []
    for scores, p in pols.items():
        assert p.serve_batch["shared_iterations"] == 0
        outs.append(fasta(p._stitch(True)))
        assert outs[-1] == jax_oneshot(sim3, 0, scores=scores)
    assert outs[0] != outs[1]
    batcher.close()


# ---------------------------------------------------------------- faults
@pytest.mark.parametrize("stage,action,exc", [
    ("pack", "raise", DeviceError), ("device", "raise", DeviceError),
    ("unpack", "corrupt", ChunkCorrupt), ("unpack", "hang=0.05", None)])
@pytest.mark.parametrize("depth", [0, 2])
def test_fault_plan_fires_once_at_its_stage(stage, action, exc, depth):
    plan = FaultPlan.parse(f"{stage}:chunk=1:{action}")
    stats = PipelineStats()
    seen = []
    pl = DispatchPipeline(depth=depth, stats=stats, faults=plan)
    args = (range(3), lambda i: i, lambda i, o: o, lambda h: h,
            lambda i, r: seen.append(i))
    if exc is None:
        pl.run(*args)
        assert seen == [0, 1, 2]
    else:
        with pytest.raises(exc):
            pl.run(*args)
        assert 1 not in seen
    assert stats.snapshot()["faults"] == 1 and not plan.unfired
    seen.clear()
    pl.run(*args)  # one-shot: the same plan fires nothing more
    assert seen == [0, 1, 2] and stats.snapshot()["faults"] == 1


def test_poisoned_job_fails_alone(client, host_server, sim3, jax_oneshot):
    """A device:chunk=0:raise job fails typed while a concurrent clean
    job keeps its bytes; the server then serves the next job."""
    want = jax_oneshot(sim3, 0)
    clean: dict = {}
    solo0 = host_server.batcher.counters["solo_iterations"]
    t = threading.Thread(target=lambda: clean.update(r=client.submit(
        *sim3)))
    t.start()
    with pytest.raises(JobFailed) as exc_info:
        client.submit(*sim3, fault_plan="device:chunk=0:raise")
    assert exc_info.value.error_type == "DeviceError"
    t.join(WAIT)
    assert clean["r"].fasta == want
    assert host_server.batcher.counters["solo_iterations"] == solo0 + 1
    assert client.submit(*sim3).fasta == want
    assert client.ping()["type"] == "pong"


@pytest.mark.parametrize("plan", ["device:chunk=0:sdc=1", "device:chunk=x:raise",
                                  "kernel:chunk=0:raise",
                                  "device:chunk=0:explode",
                                  "device:chunk=0:hang=-1"])
def test_refused_fault_plan_is_bad_request(client, synth2, plan):
    with pytest.raises(ServeError) as exc_info:
        client.submit(*synth2, fault_plan=plan)
    assert exc_info.value.code == "bad-request"
    assert "FaultPlan" in str(exc_info.value)


# ---------------------------------------------------- cancel, drain, errors
def test_cancel_queued_and_running(tmp_path_factory, sim3, jax_oneshot):
    srv = start_server(tmp_path_factory, workers=1)
    try:
        cl = PolishClient(socket_path=srv.config.socket_path, timeout=WAIT)
        out: dict = {}

        def go(name):
            try:
                out[name] = cl.submit(*sim3, trace_id=name)
            except ServeError as exc:
                out[name] = exc

        srv.batcher.hold()
        threads = [threading.Thread(target=go, args=(n,))
                   for n in ("running", "queued")]
        threads[0].start()
        wait_for(lambda: srv.batcher._job_tickets, "job 1 never pooled")
        threads[1].start()
        wait_for(lambda: len(srv.queue) == 1, "job 2 never queued")
        assert cl.cancel(trace_id="queued")["cancelled"] == "queued"
        body = cl.cancel(trace_id="running")
        assert body["cancelled"] == "running" and body["pooled"]
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
        srv.batcher.release()
        for name in ("running", "queued"):
            assert isinstance(out[name], JobCancelled), out[name]
        assert srv.cancelled == 2
        assert srv.queue.counters["expired"] == 1
        assert srv.queue.counters["failed"] == 1
        with pytest.raises(ServeError) as exc_info:
            cl.cancel(trace_id="running")
        assert exc_info.value.code == "unknown-job"
        assert cl.submit(*sim3).fasta == jax_oneshot(sim3, 0)
    finally:
        srv.drain(timeout=30)


def test_drain_finishes_inflight_then_rejects(tmp_path_factory, sim3,
                                              jax_oneshot):
    srv = start_server(tmp_path_factory, workers=1)
    cl = PolishClient(socket_path=srv.config.socket_path, timeout=WAIT)
    out: dict = {}
    srv.batcher.hold()
    t = threading.Thread(target=lambda: out.update(r=cl.submit(*sim3)))
    t.start()
    wait_for(lambda: srv.batcher._job_tickets, "the job never pooled")
    # a connection opened before the drain still reaches the queue
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(WAIT)
    sock.connect(srv.config.socket_path)
    send_frame(sock, {"type": "ping"})
    assert recv_frame(sock)["type"] == "pong"
    drained: dict = {}
    d = threading.Thread(target=lambda: drained.update(ok=srv.drain(60)))
    d.start()
    wait_for(lambda: srv.queue.draining, "drain never started")
    early = PolishClient(timeout=WAIT)
    early._connect = lambda: sock
    with pytest.raises(ServerDraining):
        early.submit(*sim3)
    srv.batcher.release()
    d.join(WAIT)
    t.join(WAIT)
    assert drained["ok"] and out["r"].fasta == jax_oneshot(sim3, 0)
    assert srv.queue.counters["completed"] == 1
    with pytest.raises((ServeError, OSError)):
        cl.submit(*sim3)


@pytest.mark.parametrize("kw,words", [
    ({"options": {"wndow_length": 500}}, "wndow_length"),
    ({"options": {"match": "five"}}, "match"),
    ({"options": {"cuda_engine": "warp"}}, "cuda_engine"),
    ({"tenant": "no spaces"}, "tenant"),
    ({"target": "/nonexistent/draft.fasta.gz"}, "not found")])
def test_bad_submit_is_typed(client, synth2, kw, words):
    paths = dict(zip(("sequences", "overlaps", "target"), synth2))
    paths.update({k: kw.pop(k) for k in list(kw) if k in paths})
    with pytest.raises(ServeError) as exc_info:
        client.submit(*paths.values(), **kw)
    assert exc_info.value.code == "bad-request"
    assert words in str(exc_info.value)


def test_connection_survives_bad_frames(host_server):
    path = host_server.config.socket_path
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(WAIT)
    sock.connect(path)
    try:
        bad = b"!garbage!"
        sock.sendall(struct.pack(">4sI", MAGIC, len(bad)) + bad)
        resp = recv_frame(sock)
        assert resp["type"] == "error" and resp["code"] == "bad-frame"
        send_frame(sock, {"type": "frobnicate"})
        assert recv_frame(sock)["code"] == "bad-request"
        send_frame(sock, {"type": "stats"})
        stats = recv_frame(sock)
        assert stats["type"] == "stats" and stats["device"] == "cpu"
    finally:
        sock.close()
    for payload in (struct.pack(">4sI", MAGIC, 1000) + b"partial",
                    b"GET / HTTP/1.1\r\n\r\n"):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(path)
        s.sendall(payload)
        s.close()
    cl = PolishClient(socket_path=path, timeout=WAIT)
    assert cl.ping()["type"] == "pong"
    assert cl.healthz()["ok"] and host_server._warm is not None


def test_cuda_server_without_card_raises_at_start(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    srv = PolishServer(socket_path=str(tmp_path / "s.sock"), warmup=False)
    with pytest.raises(RaconError, match="no CUDA device"):
        srv.start()
    assert not os.path.exists(str(tmp_path / "s.sock"))


# ------------------------------------------------------- launch counters
@pytest.mark.parametrize("mod", [poa_kernels, align_kernels,
                                 poa_fused_kernels],
                         ids=["K1", "K2", "K3"])
def test_launch_counters_lose_no_count_under_threads(mod):
    n_threads, n = 16, 2000
    before = mod.counter.total
    seen = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def hammer(i):
            base = mod.counter.on_thread()
            for _ in range(n):
                mod.counter.count(("hammer", i % 2))
            seen.append(mod.counter.on_thread() - base)

        threads = [threading.Thread(target=hammer, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    assert mod.launches - before == n_threads * n
    assert mod.launches_by_shape[("hammer", 0)] == \
        mod.launches_by_shape[("hammer", 1)] == n_threads * n // 2
    assert seen == [n] * n_threads
    mod.reset_launches()
    assert mod.launches == 0 and not mod.launches_by_shape


# ------------------------------------------------------------- on the card
@pytest.mark.gpu
def test_served_job_on_card_equals_oneshot(tmp_path_factory, sim3):
    """On the card: the 3 kb triple served with K1 and K2 (a buffered and
    a streamed job pooled) gives the one-shot port's bytes, and the
    response counts the job's launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from racon_tpu_torch.core.polisher import PolisherType, create_polisher

    p = create_polisher(*sim3, PolisherType.kC, 500, 10.0, 0.3, True,
                        *SCORES, num_threads=2, cuda_poa_batches=1,
                        cuda_banded_alignment=False, cuda_aligner_batches=1,
                        device="cuda")
    p.initialize()
    want = fasta(p.polish())
    sock = str(tmp_path_factory.mktemp("gpu") / "s.sock")
    srv = PolishServer(socket_path=sock, match=SCORES[0],
                       mismatch=SCORES[1], gap=SCORES[2],
                       cuda_poa_batches=1, cuda_aligner_batches=1).start()
    try:
        cl = PolishClient(socket_path=sock, timeout=WAIT)
        out: dict = {}
        srv.batcher.hold()
        threads = [threading.Thread(target=lambda k=k, s=s: out.update(
            {k: cl.submit(*sim3, stream=s)}))
            for k, s in (("buffered", False), ("streamed", True))]
        for t in threads:
            t.start()
        wait_for(lambda: sum(map(len, srv.batcher._job_tickets.values()))
                 == 2, "the jobs never pooled")
        srv.batcher.release()
        for t in threads:
            t.join(WAIT)
        for r in out.values():
            assert r.fasta == want
            batch = r.serve["batch"]
            assert batch["shared_iterations"] >= 1
            assert batch["k1_launches"] > 0 and batch["k2_launches"] > 0
    finally:
        srv.drain(timeout=60)
