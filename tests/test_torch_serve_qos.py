"""Preemption, the deadline abort and per-tenant device seconds in the
port's server, against the JAX package, on the CPU.

Inputs: `make_synth_dataset` (one 2 kb contig, 400 bp reads, seed 11);
the servers at their defaults (host POA and host alignment, scores
3/-5/-4, w 500) with the knob each test names; torch at one thread,
`RACON_TPU_MAX_DEVICES=1`. Tolerance: none for bytes and counts; the
admission estimate is held to 1% as the JAX package's test holds it.

What is held:

  - the queue's admission abort is priority-aware and predicts what the
    JAX package's queue predicts;
  - a running job preempted by a higher-priority one resumes and both
    give the JAX one-shot FASTA, window cache off and on; the `qos`
    counters show one preemption and one resume, each tenant's device
    seconds are above 0 and each tenanted result carries its share;
  - a job doomed at admission and one doomed mid-run (at an iteration
    boundary, the feeder held past its deadline) fail typed
    `deadline-doomed` and the server goes on;
  - with no QoS knob the stats, result and batcher bodies have exactly
    the keys they had before QoS was ported.

The JAX package is imported inside the fixtures and tests that use it.
"""

import threading
import time

import pytest
import torch

from racon_tpu_torch.serve import (DeadlineDoomed, PolishClient,
                                   PolishServer, make_synth_dataset)
from racon_tpu_torch.serve import queue as port_queue

WAIT = 120

#: the keys a QoS-free server answered with before QoS was ported, with
#: the audit's block (None when off) and the lanes' keys the batcher
#: snapshot has had since the worker lanes were ported
STATS_KEYS = {"uptime_s", "warm", "inflight", "draining", "device",
              "cancelled", "queue", "batcher", "slo", "audit"}
RESULT_KEYS = {"type", "job_id", "sequences", "metrics", "serve", "fasta"}
BATCH_KEYS = {"iterations", "iteration_ids", "shared_iterations", "windows",
              "solo", "compiles", "compile_s", "device_s", "host_s",
              "k1_launches", "k2_launches", "k3_launches"}
BATCHER_KEYS = {"iterations", "solo_iterations", "shared_iterations", "jobs",
                "windows", "max_jobs_in_iteration",
                "max_windows_in_iteration", "host_s", "busy", "busy_s",
                "pending_windows", "compiles", "compile_s", "occupancy",
                "pipeline", "max_concurrent_iterations", "audit_s",
                "lane_quarantines", "lane_rejoins", "lane_reprobes",
                "worker_lanes", "lanes"}


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
    return make_synth_dataset(str(tmp_path_factory.mktemp("qos")))


@pytest.fixture(scope="module")
def solo_bytes(dataset):
    """The JAX package's one-shot FASTA at the servers' defaults."""
    jpol = pytest.importorskip("racon_tpu.core.polisher")
    p = jpol.create_polisher(*dataset, jpol.PolisherType.kC, 500, 10.0, 0.3,
                             num_threads=2)
    p.initialize()
    return b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                    for s in p.polish())


def serve(tmp_path, **kw):
    srv = PolishServer(socket_path=str(tmp_path / "s.sock"), device="cpu",
                       warmup=False, **kw).start()
    return srv, PolishClient(socket_path=srv.config.socket_path,
                             timeout=WAIT)


def wait_for(cond, what: str) -> None:
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


# ---------------------------------------------------------------- queue
def test_doomed_admission_is_priority_aware_as_jax():
    jq = pytest.importorskip("racon_tpu.serve.queue")
    got = []
    for qm in (port_queue, jq):
        q = qm.JobQueue(32, workers=1, abort_margin=0.0)
        q._ema_service_s = 5.0
        for i in range(3):
            q.submit(qm.Job(f"free{i}", "s", "o", "t", {}))
        # nothing at or above priority 5 waits: one service time, 5 s,
        # fits the 12 s
        q.submit(qm.Job("gold", "s", "o", "t", {}, priority=5,
                        deadline_s=12.0))
        # at priority 0 four jobs wait ahead: 25 s, doomed
        with pytest.raises(qm.DeadlineDoomed) as exc_info:
            q.submit(qm.Job("late", "s", "o", "t", {}, deadline_s=12.0))
        assert exc_info.value.phase == "admission"
        assert exc_info.value.remaining_s <= 12.0
        got.append(exc_info.value.predicted_s)
    assert got[0] == pytest.approx(25.0, rel=0.01)
    assert got[0] == pytest.approx(got[1], rel=0.01)


# ----------------------------------------------------------- preemption
@pytest.mark.parametrize("wincache", [False, True])
def test_preempt_resume_keeps_bytes(dataset, solo_bytes, tmp_path,
                                    wincache):
    srv, cl = serve(tmp_path, workers=1, preempt=True, wincache=wincache)
    results: dict = {}
    errors: list = []

    def go(tag, **kw):
        try:
            results[tag] = cl.submit(*dataset, tenant=tag, **kw)
        except Exception as exc:  # noqa: BLE001 — asserted below
            errors.append(exc)

    try:
        srv.batcher.hold()
        free = threading.Thread(target=go, args=("free",))
        free.start()
        wait_for(lambda: srv.batcher._job_tickets, "the free job pooled")
        gold = threading.Thread(target=go, args=("gold",),
                                kwargs={"priority": 5})
        gold.start()
        wait_for(lambda: srv.qos["preemptions"] == 1,
                 "the gold job preempting the free one")
        wait_for(lambda: len(srv.batcher._job_tickets) == 2,
                 "the gold job pooled")
        snap = srv.batcher.snapshot()
        assert snap["withdrawn_jobs"] == 1 and snap["parked_windows"] > 0
        srv.batcher.release()
        free.join(WAIT)
        gold.join(WAIT)
        assert not errors, errors
        assert results["free"].fasta == results["gold"].fasta == solo_bytes
        stats = srv.stats_snapshot()
        qos = stats["qos"]
        assert (qos["preemptions"], qos["resumes"],
                qos["preempted_inflight"]) == (1, 1, 0)
        assert set(stats["tenant_device_seconds"]) == {"free", "gold"}
        assert all(v > 0 for v in stats["tenant_device_seconds"].values())
        for tag in ("free", "gold"):
            batch = results[tag].serve["batch"]
            assert batch["tenant"] == tag and batch["device_share_s"] > 0
        assert "parked_windows" not in stats["batcher"]
    finally:
        srv.batcher.release()
        assert srv.drain(timeout=30)


# ------------------------------------------------------- deadline abort
def test_doomed_at_admission_typed(dataset, solo_bytes, tmp_path):
    srv, cl = serve(tmp_path, workers=1, abort_margin=0.0)
    try:
        srv.queue._ema_service_s = 100.0
        with pytest.raises(DeadlineDoomed) as exc_info:
            cl.submit(*dataset, deadline_s=0.5)
        assert exc_info.value.predicted_s == pytest.approx(100.0, rel=0.05)
        assert exc_info.value.remaining_s <= 0.5
        assert srv.stats_snapshot()["qos"]["doomed_at_admission"] == 1
        srv.queue._ema_service_s = 1.0
        assert cl.submit(*dataset).fasta == solo_bytes
    finally:
        assert srv.drain(timeout=30)


def test_doomed_mid_run_at_iteration_boundary(dataset, solo_bytes,
                                              tmp_path):
    """Held past its deadline, the job dies at the first iteration
    boundary after the release, not at its end."""
    srv, cl = serve(tmp_path, workers=1, abort_margin=0.0,
                    iteration_windows=2)
    caught: list = []

    def go():
        try:
            cl.submit(*dataset, deadline_s=2.5)
        except Exception as exc:  # noqa: BLE001 — asserted below
            caught.append(exc)

    try:
        srv.batcher.hold()
        t = threading.Thread(target=go)
        t.start()
        wait_for(lambda: srv.batcher._job_tickets, "the job pooled")
        time.sleep(3.0)
        srv.batcher.release()
        t.join(WAIT)
        assert len(caught) == 1 and isinstance(caught[0], DeadlineDoomed)
        assert caught[0].response["error_type"] == "DeadlineDoomed"
        qos = srv.stats_snapshot()["qos"]
        assert (qos["doomed_mid_run"], qos["doomed_at_admission"]) == (1, 0)
        assert cl.submit(*dataset).fasta == solo_bytes
    finally:
        srv.batcher.release()
        assert srv.drain(timeout=30)


# ----------------------------------------------------------- QoS off
def test_qos_off_shapes_unchanged(dataset, solo_bytes, tmp_path):
    srv, cl = serve(tmp_path, workers=1)
    try:
        r = cl.request({"type": "submit", "sequences": dataset[0],
                        "overlaps": dataset[1], "target": dataset[2]})
        assert set(r) == RESULT_KEYS
        assert r["fasta"].encode("latin-1") == solo_bytes
        assert set(r["serve"]["batch"]) == BATCH_KEYS
        stats = cl.stats()
        assert set(stats) == STATS_KEYS | {"type"}
        assert set(stats["batcher"]) == BATCHER_KEYS
        assert "abort_margin_s" not in stats["queue"]
    finally:
        assert srv.drain(timeout=30)
