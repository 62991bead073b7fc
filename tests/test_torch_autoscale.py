"""The elastic fleet in the port (serve/autoscale.py and the router's
add_replica / remove_replica, dispatch hold and armed-only surfaces),
against the JAX package.

Inputs: scripted fleet signals (queue depth, router inflight jobs, held
shards, burn alert, clock), made from seeds with random.Random, over a
fake router with injected spawn / stop; the router tests' one-contig
`make_synth_dataset` triple (a 2 kb draft, 400 bp reads, seed 11) served
on the CPU at the server defaults (host POA, 3/-5/-4), torch at one
thread, every server on a winner table of its own. Tolerance: none;
decisions, calls, journal events, snapshots, key and family sets and
bytes are compared exactly.

What is held:

  - the JAX package's unit cases, in the port: scale-up only on
    sustained pressure, within the ceiling and the cooldown; spawn
    failures counted and never routed; scale-down only after sustained
    idle, only of spawned replicas, unrouted before stopped, blocked by
    inflight jobs and held shards; held shards as pressure; the hold's
    pick and headroom; the snapshot; the armed-only healthz block and
    scrape families; every option a keyword, parsed strictly, and the
    JAX package's environment variables ignored;
  - the port's and the JAX package's autoscalers, fed the same seeded
    script over the same fake router, take the same decisions, make the
    same spawn and stop calls, journal the same events and give equal
    snapshots;
  - a port and a JAX router, unarmed and armed, expose the same healthz
    keys and `racon_tpu_router_*` families;
  - a wave of three jobs through a port router over one CPU server and
    an autoscaler with its default spawn: one real replica process
    (`--device cpu`) joins and takes a shard, every job's FASTA is the
    JAX one-shot CLI's, the replica is then stopped and exits, no job is
    lost, and the router's journal passes `check_consistency` and the
    port's `obsreport.check_autoscale`;
  - `router --autoscale*` refuses bad values and a `--socket` or
    `--port` in `--autoscale-replica-args` with exit code 1.
"""

import contextlib
import importlib
import io
import os
import random
import shutil
import tempfile
import threading
import time
import types
import urllib.request

import pytest

from racon_tpu_torch.errors import RaconError
from racon_tpu_torch.obs.journal import check_consistency, read_journal
from racon_tpu_torch.serve import (PolishClient, PolishRouter, PolishServer,
                                   make_synth_dataset)
from racon_tpu_torch.serve.autoscale import (AutoscaleConfig, Autoscaler,
                                             replica_log, replica_log_tail,
                                             wait_replica_ready)
from racon_tpu_torch.serve.router import router_main
from racon_tpu_torch.tools.obsreport import check_autoscale
from test_torch_router import _env, start_server, WAIT  # noqa: F401


def jax_module(name: str):
    pytest.importorskip("jax")
    return importlib.import_module(name)


# ---------------------------------------------------------------- fakes
class _Replica:
    def __init__(self):
        self.routable = True


class _Fleet:
    def __init__(self):
        self.snap = None

    def last(self):
        return self.snap


class _Journal:
    def __init__(self):
        self.events: list[tuple] = []

    def record(self, event, **kw):
        self.events.append((event, kw))


class _Router:
    """The sliver of PolishRouter the autoscaler reads and drives."""

    def __init__(self, n: int = 1):
        self.fleet = _Fleet()
        self._state_lock = threading.Lock()
        self.replicas = [_Replica() for _ in range(n)]
        self._inflight_jobs = 0
        self._requeued_outstanding = 0
        self._dispatch_waiting = 0
        self.journal = None
        self.autoscaler = None
        self.added: list[str] = []
        self.removed: list[str] = []

    def add_replica(self, spec):
        self.added.append(spec)
        self.replicas.append(_Replica())

    def remove_replica(self, spec):
        self.removed.append(spec)
        self.replicas.pop()


def _snap(queue_depths, firing=False):
    reps = [types.SimpleNamespace(ok=True,
                                  health={"queue_depth": q, "inflight": 0})
            for q in queue_depths]
    return types.SimpleNamespace(replicas=reps,
                                 burn={"firing": True} if firing else None)


def _scaler(router, tmp_path, monkeypatch, ready=True, spawn=None,
            stop=None, cls=Autoscaler, cfg_cls=AutoscaleConfig, **kw):
    monkeypatch.setattr(cls, "_wait_ready", lambda self, spec: ready)
    base = dict(min_replicas=1, max_replicas=3, up_pressure=2.0,
                up_sustain_s=1.0, down_idle_s=2.0, cooldown_s=0.0,
                interval_s=999.0, socket_dir=str(tmp_path))
    base.update(kw)
    spawned: list[str] = []
    stopped: list[str] = []
    sc = cls(router, cfg_cls(**base),
             spawn=spawn or (lambda spec: spawned.append(spec) or spec),
             stop=stop or (lambda h: stopped.append(h)))
    return sc, spawned, stopped


# --------------------------------------------------------------- config
def test_autoscale_config_keyword_strict_parse():
    with pytest.raises(RaconError, match="min_replicas"):
        AutoscaleConfig(min_replicas="two")
    with pytest.raises(RaconError, match="up_pressure"):
        AutoscaleConfig(up_pressure="hot")
    cfg = AutoscaleConfig(max_replicas="8", down_idle_s=5.5)
    assert cfg.max_replicas == 8 and cfg.down_idle_s == 5.5
    assert cfg.min_replicas == 1  # defaults survive alongside
    assert (cfg.interval_s, cfg.up_pressure, cfg.up_sustain_s,
            cfg.cooldown_s, cfg.ready_timeout_s, cfg.hold_s,
            cfg.replica_args) == (1.0, 2.0, 2.0, 3.0, 20.0, 5.0, [])
    with pytest.raises(RaconError, match="unknown autoscale option"):
        AutoscaleConfig(bogus=1)
    with pytest.raises(RaconError, match="bad fleet bounds"):
        AutoscaleConfig(min_replicas=5, max_replicas=2)


def test_autoscale_environment_changes_nothing(monkeypatch):
    """The JAX package's environment twins do nothing in the port."""
    for name, value in (("RACON_TPU_ROUTER_AUTOSCALE_MIN", "3"),
                        ("RACON_TPU_ROUTER_AUTOSCALE_MAX", "9"),
                        ("RACON_TPU_ROUTER_AUTOSCALE_HOLD_S", "forever")):
        monkeypatch.setenv(name, value)
    cfg = AutoscaleConfig()
    assert (cfg.min_replicas, cfg.max_replicas, cfg.hold_s) == (1, 4, 5.0)


@pytest.mark.parametrize("args", ["--socket /tmp/x.sock",
                                  ["--port=7000"], "-c 1 --sock /tmp/y"])
def test_replica_args_may_not_name_the_socket(args):
    with pytest.raises(RaconError, match="replica_args may not set"):
        AutoscaleConfig(replica_args=args)
    cfg = AutoscaleConfig(replica_args="--device cpu -m 5 -x -4 -g -8")
    assert cfg.replica_args == ["--device", "cpu", "-m", "5", "-x", "-4",
                                "-g", "-8"]


# ------------------------------------------------------------- scale up
def test_scale_up_requires_sustained_pressure(tmp_path, monkeypatch):
    router = _Router(n=1)
    router.journal = _Journal()
    router.fleet.snap = _snap([5])  # pressure 5/1
    sc, spawned, _ = _scaler(router, tmp_path, monkeypatch)
    assert sc.step(now=0.0) is None  # pressure noted, not sustained
    assert sc.step(now=0.5) is None
    assert sc.step(now=1.1) == "up"
    assert spawned and spawned[0].endswith("autoscale_1.sock")
    assert router.added == spawned
    assert sc.counters["scale_ups"] == 1
    assert [e for e, _ in router.journal.events] == ["autoscale-up"]


def test_pressure_burst_that_subsides_never_scales(tmp_path, monkeypatch):
    router = _Router(n=1)
    router.fleet.snap = _snap([5])
    sc, spawned, _ = _scaler(router, tmp_path, monkeypatch)
    assert sc.step(now=0.0) is None
    router.fleet.snap = _snap([0])  # burst over: the sustain clock resets
    assert sc.step(now=0.9) is None
    router.fleet.snap = _snap([5])
    assert sc.step(now=1.5) is None  # sustain restarted, not elapsed
    assert spawned == [] and sc.counters["scale_ups"] == 0


def test_scale_up_respects_ceiling_and_cooldown(tmp_path, monkeypatch):
    router = _Router(n=3)  # already at max_replicas
    router.fleet.snap = _snap([9, 9, 9])
    sc, spawned, _ = _scaler(router, tmp_path, monkeypatch)
    assert sc.step(now=0.0) is None
    assert sc.step(now=5.0) is None
    assert spawned == []

    router = _Router(n=1)
    router.fleet.snap = _snap([9])
    sc, spawned, _ = _scaler(router, tmp_path, monkeypatch, cooldown_s=5.0)
    sc.step(now=0.0)
    assert sc.step(now=1.1) == "up"
    assert sc.step(now=1.2) is None  # sustain restarts
    assert sc.step(now=2.5) is None  # sustained again, but cooling down
    assert sc.step(now=7.0) == "up"  # cooldown elapsed
    assert len(spawned) == 2


def test_spawn_failure_counts_and_never_routes(tmp_path, monkeypatch):
    router = _Router(n=1)
    router.fleet.snap = _snap([9])

    def boom(_spec):
        raise OSError("fork failed")

    sc, _, _ = _scaler(router, tmp_path, monkeypatch, spawn=boom)
    sc.step(now=0.0)
    assert sc.step(now=1.5) is None
    assert sc.counters["spawn_failures"] == 1
    assert router.added == [] and sc.spawned == []

    # spawned but never answered healthz: stopped, counted, not routed
    router = _Router(n=1)
    router.fleet.snap = _snap([9])
    sc, spawned, stopped = _scaler(router, tmp_path, monkeypatch,
                                   ready=False)
    sc.step(now=0.0)
    assert sc.step(now=1.5) is None
    assert sc.counters["spawn_failures"] == 1
    assert spawned and stopped == spawned and router.added == []


def test_close_stops_a_replica_still_in_its_ready_wait(tmp_path):
    """close() during a scale-up: the child that has not answered healthz
    yet is stopped before close() returns, and never routed."""
    router = _Router(n=1)
    router.fleet.snap = _snap([9])
    handle = types.SimpleNamespace(poll=lambda: None)
    stopped: list = []

    def slow_stop(h):  # a drain that outlasts a short join
        time.sleep(2.5)
        stopped.append(h)

    sc = Autoscaler(router, AutoscaleConfig(
        min_replicas=1, max_replicas=2, up_pressure=2.0, up_sustain_s=0.0,
        cooldown_s=0.0, interval_s=0.01, ready_timeout_s=60.0,
        socket_dir=str(tmp_path)),
        spawn=lambda spec: handle, stop=slow_stop).start()
    deadline = time.monotonic() + 10
    while sc._spawning is None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert sc._spawning is handle
    sc.close()
    assert not sc._thread.is_alive()
    assert stopped and all(h is handle for h in stopped)
    assert router.added == [] and sc.spawned == []


# ----------------------------------------------------------- scale down
def test_scale_down_unroutes_before_stopping(tmp_path, monkeypatch):
    router = _Router(n=1)
    router.journal = _Journal()
    router.fleet.snap = _snap([5])
    order: list[str] = []

    def stop(handle):  # the ordering that loses no job: unroute first
        assert handle in router.removed
        order.append(handle)

    sc, spawned, _ = _scaler(router, tmp_path, monkeypatch, stop=stop)
    sc.step(now=0.0)
    assert sc.step(now=1.1) == "up"
    router.fleet.snap = _snap([0, 0])  # the fleet fully idle
    assert sc.step(now=2.0) is None  # idle noted, not sustained
    assert sc.step(now=4.1) == "down"
    assert order == spawned and router.removed == spawned
    assert sc.counters["scale_downs"] == 1 and sc.spawned == []
    assert [e for e, _ in router.journal.events] \
        == ["autoscale-up", "autoscale-down"]


def test_never_drains_operator_replicas(tmp_path, monkeypatch):
    router = _Router(n=2)  # both the operator's
    router.fleet.snap = _snap([0, 0])
    sc, _, stopped = _scaler(router, tmp_path, monkeypatch)
    assert sc.step(now=0.0) is None
    assert sc.step(now=100.0) is None  # idle forever: owns nothing
    assert stopped == [] and router.removed == []


def test_inflight_jobs_block_scale_down(tmp_path, monkeypatch):
    router = _Router(n=1)
    router.fleet.snap = _snap([5])
    sc, _, stopped = _scaler(router, tmp_path, monkeypatch)
    sc.step(now=0.0)
    assert sc.step(now=1.1) == "up"
    router.fleet.snap = _snap([0, 0])
    router._inflight_jobs = 1  # the router still owes a client a merge
    assert sc.step(now=2.0) is None
    assert sc.step(now=10.0) is None
    router._inflight_jobs = 0
    sc.step(now=11.0)
    assert sc.step(now=13.1) == "down"
    assert len(stopped) == 1


def test_held_shards_count_as_pressure(tmp_path, monkeypatch):
    """A shard holding for an idle replica is backlog: the router's
    `_dispatch_waiting` drives the pressure, so the hold summons the
    replica it waits for."""
    router = _Router(n=1)
    router.fleet.snap = _snap([0])
    sc, spawned, _ = _scaler(router, tmp_path, monkeypatch)
    assert sc.step(now=0.0) is None  # truly idle: no pressure
    router._dispatch_waiting = 3  # three shards holding
    sc.step(now=1.0)
    assert sc._last_pressure == 3.0
    assert sc.step(now=2.1) == "up"
    assert len(spawned) == 1
    # holding shards also block a scale-down (they are not idle)
    router._dispatch_waiting = 1
    router.fleet.snap = _snap([0, 0])
    assert sc.step(now=20.0) is None


def test_dispatch_hold_insists_on_idle_replica(tmp_path):
    """With max_inflight=1 only an idle replica qualifies, and the
    headroom is true only while an armed autoscaler is below its
    ceiling."""
    router = PolishRouter(replicas=str(tmp_path / "rep.sock"),
                          socket_path=str(tmp_path / "r.sock"))
    assert router._scaleup_headroom() is False  # unarmed: never hold
    r = router._pick_replica(set(), max_inflight=1)
    assert r is not None and r.inflight == 1
    assert router._pick_replica(set(), max_inflight=1) is None
    assert router._pick_replica(set()) is not None
    cfg = AutoscaleConfig(min_replicas=1, max_replicas=2,
                          socket_dir=str(tmp_path))
    assert cfg.hold_s == 5.0  # on by default; 0 turns it off
    Autoscaler(router, cfg, spawn=lambda spec: spec, stop=lambda h: None)
    assert router._scaleup_headroom() is True  # 1 replica < max 2
    assert router.add_replica(str(tmp_path / "rep2.sock")) is True
    assert router.add_replica(str(tmp_path / "rep2.sock")) is False
    assert router._scaleup_headroom() is False  # at the ceiling
    assert router.remove_replica(str(tmp_path / "rep2.sock")) is True
    assert router.remove_replica(str(tmp_path / "rep2.sock")) is False
    assert [ep.spec for ep in router.fleet.endpoints] == \
        [str(tmp_path / "rep.sock")]


def test_hold_s_keyword_strict_parse():
    with pytest.raises(RaconError, match="hold_s"):
        AutoscaleConfig(hold_s="forever")
    assert AutoscaleConfig(hold_s="2.5").hold_s == 2.5
    assert AutoscaleConfig(hold_s=0).hold_s == 0.0
    with pytest.raises(RaconError, match="hold_s"):
        AutoscaleConfig(hold_s=-1.0)


def test_snapshot_shape(tmp_path, monkeypatch):
    router = _Router(n=1)
    router.fleet.snap = _snap([4])
    sc, _, _ = _scaler(router, tmp_path, monkeypatch)
    sc.step(now=0.0)
    assert sc.snapshot() == {"min": 1, "max": 3, "spawned": 0,
                             "pressure": 4.0, "scale_ups": 0,
                             "scale_downs": 0, "spawn_failures": 0}


# ------------------------------------------------- armed-only exposure
def test_router_surfaces_autoscale_only_when_armed(tmp_path, monkeypatch):
    srv = start_server(tmp_path / "rep.sock", str(tmp_path / "at.json"),
                       workers=1)
    router = PolishRouter(replicas=srv.config.socket_path,
                          socket_path=str(tmp_path / "r.sock"),
                          metrics_port=0, health_interval_s=0.2).start()
    try:
        cl = PolishClient(socket_path=router.config.socket_path)
        base = f"http://127.0.0.1:{router.config.metrics_port}"
        assert "autoscale" not in cl.request({"type": "healthz"})
        body = urllib.request.urlopen(base + "/metrics",
                                      timeout=10).read().decode()
        assert "racon_tpu_router_autoscale" not in body
        # arming (the constructor attaches; no loop) turns both on
        monkeypatch.setattr(Autoscaler, "_wait_ready",
                            lambda self, spec: True)
        Autoscaler(router, AutoscaleConfig(socket_dir=str(tmp_path)),
                   spawn=lambda spec: spec, stop=lambda h: None)
        hz = cl.request({"type": "healthz"})
        assert hz["autoscale"]["min"] == 1
        assert hz["autoscale"]["spawned"] == 0
        body = urllib.request.urlopen(base + "/metrics",
                                      timeout=10).read().decode()
        assert "racon_tpu_router_autoscale_spawned 0" in body
        assert "racon_tpu_router_autoscale_scale_ups" in body
        assert "racon_tpu_router_autoscale_pressure" in body
    finally:
        router.drain()
        srv.drain(timeout=30)


# --------------------------------------------------- decisions vs JAX
def signal_script(seed: int) -> list[tuple]:
    """(queue depth, router inflight, held shards, burn firing, ready,
    now) a step: busy, held and burning stretches in a seeded order, each
    followed by an idle one, on a clock that advances 0.1-1.5 s a step;
    one spawn in five never gets ready."""
    rng = random.Random(seed)
    now, out = 0.0, []
    modes = ["busy", "held", "burn"]
    rng.shuffle(modes)
    for mode in [m for pair in zip(modes, ["idle"] * 3) for m in pair]:
        for _ in range(rng.randint(3, 12)):
            q = {"idle": 0, "busy": rng.randint(0, 6), "held": 0,
                 "burn": rng.randint(0, 1)}[mode]
            inflight = 0 if mode == "idle" else rng.randint(0, 2)
            waiting = rng.randint(1, 3) if mode == "held" else 0
            out.append((q, inflight, waiting, mode == "burn",
                        rng.random() > 0.2, round(now, 3)))
            now += rng.uniform(0.1, 1.5)
    return out


def run_script(mod_autoscale, script, socket_dir) -> dict:
    router = _Router(n=1)
    router.journal = _Journal()
    ready = iter([s[4] for s in script] * 4)
    calls: list[tuple] = []
    sc = mod_autoscale.Autoscaler(router, mod_autoscale.AutoscaleConfig(
        min_replicas=1, max_replicas=3, up_pressure=2.0, up_sustain_s=1.0,
        down_idle_s=3.0, cooldown_s=1.0, interval_s=999.0,
        socket_dir=socket_dir),
        spawn=lambda spec: calls.append(("spawn", spec)) or spec,
        stop=lambda h: calls.append(("stop", h)))
    sc._wait_ready = lambda spec: next(ready)
    steps, snaps = [], []
    for q, inflight, waiting, firing, _, now in script:
        router.fleet.snap = _snap([q] + [0] * (len(router.replicas) - 1),
                                  firing)
        router._inflight_jobs = inflight
        router._dispatch_waiting = waiting
        steps.append(sc.step(now=now))
        snaps.append(sc.snapshot())
    return {"steps": steps, "calls": calls, "snapshots": snaps,
            "added": router.added, "removed": router.removed,
            "journal": [(e, kw.get("replica"), kw.get("reason"))
                        for e, kw in router.journal.events]}


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_decisions_match_jax(seed, tmp_path):
    jax_autoscale = jax_module("racon_tpu.serve.autoscale")
    from racon_tpu_torch.serve import autoscale

    script = signal_script(seed)
    mine = run_script(autoscale, script, str(tmp_path))
    theirs = run_script(jax_autoscale, script, str(tmp_path))
    assert mine == theirs
    assert {"up", "down"} <= set(mine["steps"]), mine["steps"]


# ------------------------------------------------------ surfaces vs JAX
@pytest.fixture(scope="module")
def surfaces(tmp_path_factory):
    """healthz keys and router families of a port and a JAX router, each
    over a server of its own package, unarmed then armed."""
    jserve = jax_module("racon_tpu.serve")
    jauto = jax_module("racon_tpu.serve.autoscale")
    from test_torch_serve_obs import families

    import racon_tpu_torch.serve as pserve
    from racon_tpu_torch.serve import autoscale as pauto

    d = tmp_path_factory.mktemp("surfaces")
    out = {}
    for tag, serve, auto, make in (
            ("port", pserve, pauto,
             lambda s: start_server(s, str(d / "at.json"), workers=1)),
            ("jax", jserve, jauto,
             lambda s: jserve.PolishServer(socket_path=s, warmup=False,
                                           workers=1).start())):
        srv = make(str(d / f"{tag}_rep.sock"))
        router = serve.PolishRouter(replicas=srv.config.socket_path,
                                    socket_path=str(d / f"{tag}_r.sock"),
                                    health_interval_s=0.2).start()
        try:
            cl = serve.PolishClient(socket_path=router.config.socket_path)
            seen = {}
            for state in ("unarmed", "armed"):
                if state == "armed":
                    cfg = auto.AutoscaleConfig(socket_dir=str(d))
                    auto.Autoscaler(router, cfg, spawn=lambda spec: spec,
                                    stop=lambda h: None)
                fams = families(cl.request({"type": "scrape"})["text"])
                seen[state] = {
                    "healthz": set(cl.request({"type": "healthz"})),
                    "families": {n: v for n, v in fams.items()
                                 if n.startswith("racon_tpu_router_")}}
            out[tag] = seen
        finally:
            router.drain()
            srv.drain(timeout=30)
    return out


@pytest.mark.parametrize("state", ["unarmed", "armed"])
def test_router_surfaces_match_jax(surfaces, state):
    mine, theirs = surfaces["port"][state], surfaces["jax"][state]
    assert mine == theirs
    auto = {n for n in mine["families"]
            if n.startswith("racon_tpu_router_autoscale_")}
    if state == "armed":
        assert "autoscale" in mine["healthz"]
        assert auto == {"racon_tpu_router_autoscale_scale_ups_total",
                        "racon_tpu_router_autoscale_scale_downs_total",
                        "racon_tpu_router_autoscale_spawned",
                        "racon_tpu_router_autoscale_pressure"}
    else:
        assert "autoscale" not in mine["healthz"] and not auto


# ------------------------------------------------- one real child, end to end
def jax_cli_fasta(paths) -> bytes:
    """The JAX package's one-shot CLI on a triple at the server defaults."""
    jcli = jax_module("racon_tpu.cli")
    buf = io.BytesIO()
    text = io.TextIOWrapper(buf)
    with contextlib.redirect_stdout(text):
        assert jcli.main(["-t", "2", *paths]) == 0
        text.flush()
    return buf.getvalue()


def wait_for(cond, what: str, deadline_s: float = WAIT):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < deadline_s, f"never: {what}"
        time.sleep(0.05)


def test_wave_scales_up_a_replica_process_and_down(tmp_path):
    paths = make_synth_dataset(str(tmp_path))
    want = jax_cli_fasta(paths)
    table = str(tmp_path / "at.json")
    srv = start_server(tmp_path / "rep.sock", table)
    journal = str(tmp_path / "router.jsonl")
    router = PolishRouter(replicas=[srv.config.socket_path],
                          socket_path=str(tmp_path / "r.sock"),
                          journal=journal, health_interval_s=0.2).start()
    sock_dir = tempfile.mkdtemp(prefix="ras")  # a short socket path
    scaler = Autoscaler(
        router, min_replicas=1, max_replicas=2, interval_s=0.1,
        up_pressure=1.0, up_sustain_s=0.2, down_idle_s=1.0, cooldown_s=0.2,
        hold_s=WAIT, ready_timeout_s=WAIT, socket_dir=sock_dir,
        replica_args=["--device", "cpu", "--no-warmup", "-t", "1",
                      "--workers", "2", "-w", "500", "-m", "3", "-x", "-5",
                      "-g", "-4", "--cuda-autotune-table", table]).start()
    results: dict = {}

    def job(i):
        try:
            cl = PolishClient(socket_path=router.config.socket_path,
                              timeout=WAIT)
            results[i] = cl.submit(*paths, trace_id=f"wave{i}")
        except Exception as exc:  # noqa: BLE001 — asserted below
            results[i] = exc

    threads = [threading.Thread(target=job, args=(i,)) for i in range(3)]
    try:
        # the server's jobs stay in flight until the replica has joined
        # and taken a held shard
        srv.batcher.hold()
        for t in threads:
            t.start()
        wait_for(lambda: scaler.counters["scale_ups"] == 1, "a scale-up")
        child = scaler.spawned[0]
        wait_for(lambda: any(
            e["event"] == "shard-dispatched"
            and e["replica"] == child["spec"]
            for e in read_journal(journal)), "a shard on the child")
        srv.batcher.release()
        for t in threads:
            t.join(WAIT)
        wait_for(lambda: scaler.counters["scale_downs"] == 1,
                 "a scale-down")
        assert child["handle"].poll() is not None  # the process exited
        assert scaler.counters["spawn_failures"] == 0
    finally:
        srv.batcher.release()
        scaler.close()
        assert router.drain()
        assert srv.drain(timeout=30)
        shutil.rmtree(sock_dir, ignore_errors=True)
    for i in range(3):
        assert not isinstance(results[i], Exception), results[i]
        assert results[i].fasta == want
    entries = read_journal(journal)
    events = [e["event"] for e in entries]
    assert events.count("autoscale-up") == 1
    assert events.count("autoscale-down") == 1
    assert events.count("finished") == 3 and "failed" not in events
    assert "hold" in events
    assert check_consistency(entries) == []
    assert check_autoscale(entries) == []


# --------------------------------------------------------------- the CLI
@pytest.mark.parametrize("argv", [
    ["--autoscale-min", "two"],
    ["--autoscale-max", "0"],
    ["--autoscale-min", "3", "--autoscale-max", "2"],
    ["--autoscale-hold", "-1"],
    ["--autoscale-interval", "soon"],
    ["--autoscale-replica-args=--socket /tmp/x.sock"],
    ["--autoscale-replica-args=-c 1 --port 7000"],
])
def test_router_main_refuses_bad_autoscale(argv, tmp_path, capsys):
    sock = str(tmp_path / "r.sock")
    assert router_main(["--replicas", str(tmp_path / "a.sock"), "--socket",
                        sock, "--autoscale", *argv]) == 1
    assert "error" in capsys.readouterr().err
    assert not os.path.exists(sock)  # refused before anything started


# ------------------------------------------- the shared ready-wait helper
def test_wait_replica_ready_helper(tmp_path):
    """wait_replica_ready: True on a live server's first clean healthz;
    False at once for an exited process or a set halt, and after the
    timeout for a socket nobody serves. replica_log_tail reads the end
    of the log spawn_replica writes."""
    spec = str(tmp_path / "nobody.sock")
    exited = types.SimpleNamespace(poll=lambda: 1)
    t0 = time.monotonic()
    assert wait_replica_ready(spec, exited, timeout_s=30.0) is False
    halt = threading.Event()
    halt.set()
    assert wait_replica_ready(spec, None, 30.0, halt) is False
    assert time.monotonic() - t0 < 5.0
    assert wait_replica_ready(spec, None, timeout_s=0.3) is False
    with open(replica_log(spec), "wb") as fh:
        fh.write(b"x" * 50 + b"the end")
    assert replica_log_tail(spec, 7) == "the end"
    assert replica_log_tail(str(tmp_path / "none.sock")) == ""
    sock = str(tmp_path / "live.sock")
    srv = PolishServer(socket_path=sock, device="cpu", warmup=False).start()
    try:
        assert wait_replica_ready(sock, None, timeout_s=30.0) is True
    finally:
        srv.drain(timeout=30)
