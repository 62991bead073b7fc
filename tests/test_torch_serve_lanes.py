"""The port's worker lanes (racon_tpu_torch/serve/batcher.py) against the
JAX package's, on the CPU.

Inputs: the port's `make_synth_dataset` triple (one 2 kb contig, 400 bp
reads, seed 11), windows made from seeds, and the JAX package's
`make_synth_dataset` for its one-shot FASTA; servers at scores 3/-5/-4,
w 500, host POA and host alignment; torch at one thread,
`RACON_TPU_MAX_DEVICES=1`. Tolerance: none; every value held is a byte,
an integer or a flag.

What is held:

  - `WindowBatcher(worker_lanes=K, devices=[cpu] * N)` cuts the list as
    the JAX batcher cuts `jax.devices("cpu")[:N]`: the same lane count
    and devices per lane;
  - a quarantined lane whose re-probe reproduces the oracle bytes
    rejoins at health 1.0 with its engines rebuilt; a failed probe keeps
    it quarantined while its sibling serves, and the last lane rejoins
    degraded at 0.5; a fault-plan job avoids the quarantined lane;
    `flush_lane_engines` flags every lane, which rebuilds at its next
    use, and invalidates the window cache;
  - twelve jobs at once over four lanes with a short switch interval
    lose no window and count every iteration;
  - a two-lane server over `[cpu] * 2`: two concurrent jobs (one
    buffered, one streamed) over small iterations give the JAX one-shot
    FASTA, both lanes ran, the lanes' iterations sum to the batcher's; a
    fault-plan job fails typed on one lane while a clean job keeps its
    bytes, and the server serves on;
  - `worker_lanes=2` with the server's own device list (one CPU) clamps
    to one lane, as in JAX; `device="cuda"` with two lanes and no card
    raises at `start()`.

Every wait is bounded. The JAX package is imported inside the fixtures
and tests that use it.
"""

import random
import threading
import time
import types

import pytest
import torch

from racon_tpu_torch.core.window import WindowType, create_window
from racon_tpu_torch.ops.oracle import OracleExecutor, snapshot_window
from racon_tpu_torch.sched.autotune import Autotuner
from racon_tpu_torch.serve import (JobFailed, PolishClient, PolishServer,
                                   WindowBatcher, WindowCache,
                                   make_synth_dataset)

WAIT = 120
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RACON_TPU_MAX_DEVICES", "1")
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


def wait_for(cond, what: str, timeout: float = WAIT) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def make_windows(n=1, seed=3, length=60, depth=4):
    """Small consensus-ready windows: a backbone and mutated layers."""
    rng = random.Random(seed)
    windows = []
    for k in range(n):
        bb = "".join(rng.choice("ACGT") for _ in range(length))
        w = create_window(0, k, WindowType.kNGS, bb.encode(), b"!" * length)
        for _ in range(depth):
            layer = "".join(c if rng.random() > 0.05 else rng.choice("ACGT")
                            for c in bb)
            w.add_layer(layer.encode(), None, 0, length - 1)
        windows.append(w)
    return windows


def host_params(tmp_path):
    """The host engine's polisher parameters, as the batcher keys them."""
    return types.SimpleNamespace(
        match=3, mismatch=-5, gap=-4, window_length=500, trim=True,
        num_threads=1, cuda_poa_batches=0, cuda_banded_alignment=False,
        cuda_aligner_band_width=0, cuda_engine="session", cuda_fused="auto",
        fused_fallback="session", score_dtype="auto", pack_bases=True,
        pipeline_depth=0, device=CPU,
        autotuner=Autotuner(str(tmp_path / "t.json")))


class _ProbeAuditor:
    """The auditor's probe and lane events, for the re-probe path."""

    armed = True

    def __init__(self, probe):
        self._probe = probe
        self.events: list = []

    def probe(self):
        return self._probe

    def lane_event(self, lane, state, **fields):
        self.events.append((lane, state))


@pytest.fixture
def two_lanes():
    b = WindowBatcher(worker_lanes=2, devices=[CPU] * 2)
    with b._cond:
        lanes = b._lanes_locked()
    yield b, lanes
    b.close(timeout=5)


def truth_probe(tmp_path):
    p = host_params(tmp_path)
    snap = snapshot_window(make_windows()[0])
    ex = OracleExecutor("cpu")
    truth = ex.consensus(p, [snap])[0]
    ex.close()
    return p, snap, truth


# ------------------------------------------------------------- partition
@pytest.mark.parametrize("lanes,n", [(1, 4), (2, 2), (2, 5), (3, 8),
                                     (4, 2)])
def test_lane_partition_equals_jax(lanes, n):
    jax = pytest.importorskip("jax")
    jb = pytest.importorskip("racon_tpu.serve.batcher")
    port = WindowBatcher(worker_lanes=lanes, devices=[CPU] * n)
    ref = jb.WindowBatcher(worker_lanes=lanes,
                           devices=jax.devices("cpu")[:n])
    with port._cond:
        got = [ln.runner.n_devices for ln in port._lanes_locked()]
    with ref._cond:
        want = [ln.runner.n_devices for ln in ref._lanes_locked()]
    assert got == want and sum(got) == n
    assert port.snapshot()["worker_lanes"] == ref.snapshot()["worker_lanes"]
    assert [ln["n_devices"] for ln in port.snapshot()["lanes"]] == want
    port.close(timeout=5)
    ref.close(timeout=5)


# ------------------------------------------------------ quarantine logic
def test_quarantine_reprobe_rejoins(two_lanes, tmp_path):
    b, lanes = two_lanes
    p, snap, truth = truth_probe(tmp_path)
    b.auditor = _ProbeAuditor((p, snap, truth.consensus, truth.polished))
    b.quarantine_lane(1)
    assert lanes[1].quarantined and lanes[1].health == 0.0
    assert lanes[1].flush_engines
    # the quarantine started the lanes' feeders, whose loop re-probes
    wait_for(lambda: b.snapshot()["lane_rejoins"] == 1, "never rejoined")
    assert not lanes[1].quarantined and lanes[1].health == 1.0
    assert not lanes[1].flush_engines and lanes[1].engines
    snap_b = b.snapshot()
    assert (snap_b["lane_quarantines"], snap_b["lane_reprobes"]) == (1, 1)
    assert b.auditor.events == [(1, "quarantined"), (1, "rejoined")]
    assert lanes[0].reprobes == 0 and lanes[1].reprobes == 1


def test_failed_probe_stays_quarantined_then_last_lane_degrades(
        two_lanes, tmp_path):
    b, lanes = two_lanes
    p, snap, _ = truth_probe(tmp_path)
    b.auditor = _ProbeAuditor((p, snap, b"NOT-THE-ORACLE", True))
    b._stop = True  # no feeder: the probes below run here
    b.quarantine_lane(1)
    assert b._reprobe_lane(lanes[1]) is False
    assert lanes[1].quarantined and lanes[1].health == 0.0
    b.quarantine_lane(0)
    assert b._reprobe_lane(lanes[0]) is True
    assert not lanes[0].quarantined and lanes[0].health == 0.5
    assert lanes[1].quarantined
    assert b.auditor.events == [(1, "quarantined"), (1, "reprobe-failed"),
                                (0, "quarantined"), (0, "degraded")]
    snap_b = b.snapshot()
    assert snap_b["lane_rejoins"] == 0 and snap_b["lane_reprobes"] == 2
    assert [ln["health"] for ln in snap_b["lanes"]] == [0.5, 0.0]


def test_fault_plan_job_avoids_quarantined_lane(two_lanes, tmp_path):
    """Lane 0 quarantined: a fault-plan job (whose fault never fires)
    runs its solo pass on lane 1's runner."""
    from racon_tpu_torch.core.polisher import PolisherType, create_polisher

    b, lanes = two_lanes
    b._stop = True  # no feeder re-probes lane 0 meanwhile
    b.quarantine_lane(0)
    paths = make_synth_dataset(str(tmp_path), contigs=1)
    pol = create_polisher(*paths, PolisherType.kC, 500, 10.0, 0.3,
                          device="cpu", fault_plan="unpack:chunk=99:raise")
    pol.initialize()
    b.consensus(pol)
    assert pol.device_runner is lanes[1].runner
    assert [ln.iterations for ln in lanes] == [0, 1]
    assert pol.serve_batch["solo"] and b.counters["solo_iterations"] == 1
    assert all(w.polished for w in pol.windows if len(w.sequences) >= 3)


def test_flush_lane_engines_flags_and_rebuilds_every_lane(two_lanes,
                                                         tmp_path):
    b, lanes = two_lanes
    b.wincache = WindowCache()
    p = host_params(tmp_path)
    for lane in lanes:
        with lane.lock:
            b._lane_engine(lane, ("k",), p)
        assert lane.engines
    pipelines = [pl for ln in lanes for pl, _ in ln.engines.values()]
    b.flush_lane_engines()
    assert all(ln.flush_engines for ln in lanes)
    assert b.wincache.snapshot()["invalidations"] == 1
    for lane in lanes:
        with lane.lock:
            b._fresh_engines_locked(lane)
        assert not lane.engines and not lane.flush_engines
    assert all(pl._executor is None for pl in pipelines)


# ------------------------------------------------------------ the server
@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_synth_dataset(str(tmp_path_factory.mktemp("lanes")))


def test_lanes_lose_no_window_under_thread_stress(dataset):
    """Twelve jobs' consensus passes at once over four lanes with
    two-window iterations and a short switch interval: every job gets
    the consensus of its solo pass, and the lanes' iterations and the
    batcher's windows add up."""
    import sys

    from racon_tpu_torch.core.polisher import PolisherType, create_polisher

    def build():
        p = create_polisher(*dataset, PolisherType.kC, 500, 10.0, 0.3,
                            num_threads=1, device="cpu")
        p.initialize()
        return p

    solo = build()
    WindowBatcher().consensus(solo)
    want = [(w.consensus, w.polished) for w in solo.windows]
    pols = [build() for _ in range(12)]
    b = WindowBatcher(iteration_windows=2, worker_lanes=4,
                      devices=[CPU] * 4)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=b.consensus, args=(p,))
                   for p in pols]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
        b.close(timeout=5)
    for p in pols:
        assert [(w.consensus, w.polished) for w in p.windows] == want
    snap = b.snapshot()
    assert sum(ln["iterations"] for ln in snap["lanes"]) == \
        snap["iterations"]
    assert snap["windows"] == 12 * len(want)
    assert snap["pending_windows"] == 0


@pytest.fixture(scope="module")
def solo_bytes(dataset):
    """The JAX package's one-shot FASTA at the servers' defaults."""
    jpol = pytest.importorskip("racon_tpu.core.polisher")
    p = jpol.create_polisher(*dataset, jpol.PolisherType.kC, 500, 10.0, 0.3,
                             num_threads=2)
    p.initialize()
    return b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                    for s in p.polish())


def start(tmp_path, **kw):
    kw.setdefault("warmup", False)
    srv = PolishServer(socket_path=str(tmp_path / "s.sock"), device="cpu",
                       **kw).start()
    return srv, PolishClient(socket_path=srv.config.socket_path,
                             timeout=WAIT)


def test_two_lane_server_equals_jax_oneshot(dataset, solo_bytes, tmp_path):
    srv, cl = start(tmp_path, workers=2, worker_lanes=2,
                    devices=[CPU] * 2, iteration_windows=2)
    try:
        out: dict = {}
        parts: list = []
        jobs = {"buffered": {}, "streamed": {"on_part": parts.append}}

        def go(name):
            out[name] = cl.submit(*dataset, **jobs[name])

        srv.batcher.hold()
        threads = [threading.Thread(target=go, args=(n,)) for n in jobs]
        for t in threads:
            t.start()
        wait_for(lambda: sum(map(len, srv.batcher._job_tickets.values()))
                 == 2, "the two jobs never pooled")
        srv.batcher.release()
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
        assert out["buffered"].fasta == solo_bytes
        assert out["streamed"].fasta == solo_bytes
        assert b"".join(p["fasta"].encode("latin-1")
                        for p in parts) == solo_bytes
        snap = srv.batcher.snapshot()
        assert snap["worker_lanes"] == 2
        assert [ln["n_devices"] for ln in snap["lanes"]] == [1, 1]
        assert all(ln["iterations"] >= 1 for ln in snap["lanes"])
        assert sum(ln["iterations"] for ln in snap["lanes"]) == \
            snap["iterations"]
        assert snap["max_concurrent_iterations"] >= 1
        assert all(ln["health"] == 1.0 for ln in snap["lanes"])
        assert srv.stats_snapshot()["audit"] is None
    finally:
        assert srv.drain(timeout=60)


def test_fault_plan_job_fails_alone_on_one_lane(dataset, solo_bytes,
                                                tmp_path):
    srv, cl = start(tmp_path, workers=2, worker_lanes=2, devices=[CPU] * 2)
    try:
        clean: dict = {}
        t = threading.Thread(target=lambda: clean.update(
            r=cl.submit(*dataset)))
        t.start()
        with pytest.raises(JobFailed) as exc_info:
            cl.submit(*dataset, fault_plan="device:chunk=0:raise")
        assert exc_info.value.error_type == "DeviceError"
        t.join(WAIT)
        assert not t.is_alive()
        assert clean["r"].fasta == solo_bytes
        assert srv.batcher.counters["solo_iterations"] == 1
        assert cl.submit(*dataset).fasta == solo_bytes
        snap = srv.batcher.snapshot()
        assert sum(ln["iterations"] for ln in snap["lanes"]) == \
            snap["iterations"]
    finally:
        assert srv.drain(timeout=60)


def test_lanes_clamp_to_the_server_device(dataset, solo_bytes, tmp_path):
    """Without a device list the lanes come from the job's polisher: one
    CPU, so `worker_lanes=2` serves on one lane, as the JAX batcher
    clamps to its device count."""
    srv, cl = start(tmp_path, worker_lanes=2)
    try:
        assert cl.submit(*dataset).fasta == solo_bytes
        snap = srv.batcher.snapshot()
        assert snap["worker_lanes"] == 1 and len(snap["lanes"]) == 1
    finally:
        assert srv.drain(timeout=60)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_cuda_lanes_without_card_raise_at_start(tmp_path):
    from racon_tpu_torch.errors import DeviceError

    srv = PolishServer(socket_path=str(tmp_path / "s.sock"), device="cuda",
                       worker_lanes=2, warmup=False)
    with pytest.raises(DeviceError):
        srv.start()
    srv = PolishServer(socket_path=str(tmp_path / "t.sock"), device="cpu",
                       worker_lanes=2, devices=["cuda:0", "cuda:0"],
                       warmup=False)
    with pytest.raises(DeviceError):
        srv.start()
