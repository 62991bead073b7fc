"""Elastic replicas for the serve router.

`Autoscaler` connects the signals the router already has to the two
actions it already supports. The fleet poll gives each replica's queue
depth and inflight jobs (healthz) and the deadline burn-rate alert
(obs/fleet.py); the router survives replicas joining and leaving
(`add_replica` / `remove_replica`, journal-backed requeue):

  - **Scale-up.** When backlog pressure (queued + inflight jobs per
    routable replica) stays at or above `up_pressure` for
    `up_sustain_s` seconds, or the burn-rate alert fires, and the fleet
    is below `max_replicas`, spawn one warm replica process
    (`python -m racon_tpu_torch serve --socket <dir>/autoscale_<n>.sock
    <replica_args>`), wait for its first clean healthz and join it to
    the routing set. It routes from the router's next poll.
  - **Scale-down.** When the fleet has been fully idle (no backlog, no
    router job in flight) for `down_idle_s` seconds and the autoscaler
    owns a replica above the floor, remove the NEWEST spawned replica
    from the routing set, then send it SIGTERM: the server drains
    (stops admitting, finishes what it runs). A replica that dies
    mid-job anyway has its shard requeued by the router, so scale-down
    loses no job.
  - Only replicas the autoscaler spawned are ever stopped; the
    operator's replicas are a floor it never touches. Each action is
    journaled (`autoscale-up` / `autoscale-down`, outside the
    lifecycle events) and counted in the router's armed-only
    `router.autoscale.*` families.
  - **The dispatch hold.** While the autoscaler is armed and below
    `max_replicas`, a shard whose routable replicas are all busy holds
    in the router's dispatch loop for up to `hold_s` seconds instead of
    queueing on a busy replica, and a held shard counts as backlog: the
    hold summons the replica it waits for. The first replica to go idle
    (or the spawned one, once it routes) takes the shard. Without an
    armed autoscaler dispatch is unchanged.

A spawned replica gets its posture only from `replica_args` (the
port reads no environment variable): pass it the `serve` flags of the
operator's replicas, so its bytes are theirs. It runs on `--device
cuda` unless `replica_args` names a device. Its standard error goes to
`<dir>/autoscale_<n>.log`.

Every knob is an `AutoscaleConfig` keyword and a `router --autoscale-*`
flag. Tests drive `step(now)` with injected `spawn` / `stop` callables:
no processes, no clock.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import shlex
import subprocess
import sys
import tempfile
import threading
import time

from ..errors import RaconError
from ..utils.logger import log_info
from .protocol import ProtocolError

#: the directory that holds the package, put first on a spawned
#: replica's import path so `-m racon_tpu_torch` resolves from any cwd
_PKG_PARENT = str(pathlib.Path(__file__).resolve().parents[2])


def _number(kw: dict, key: str, default, kind):
    raw = kw.pop(key, None)
    if raw is None:
        return default
    try:
        return kind(raw)
    except (TypeError, ValueError):
        what = "an integer" if kind is int else "a number"
        raise RaconError("autoscale",
                         f"{key} must be {what}, got {raw!r}") from None


def _replica_args(raw) -> list[str]:
    if raw is None:
        return []
    args = (shlex.split(raw) if isinstance(raw, str)
            else [str(a) for a in raw])
    for a in args:
        # argparse takes an unambiguous prefix of a long flag too
        flag = a.split("=", 1)[0]
        if len(flag) > 3 and any(full.startswith(flag)
                                 for full in ("--socket", "--port")):
            raise RaconError(
                "autoscale", f"replica_args may not set {flag}: the "
                "autoscaler names each spawned replica's socket")
    return args


class AutoscaleConfig:
    """The autoscaler's knobs, keyword arguments only, with the JAX
    package's defaults. A bad one raises RaconError now."""

    def __init__(self, **kw):
        self.min_replicas = _number(kw, "min_replicas", 1, int)
        self.max_replicas = _number(kw, "max_replicas", 4, int)
        #: loop seconds; backlog per routable replica that counts as
        #: pressure, and how long it must hold; idle seconds before a
        #: drain; least seconds between two actions
        self.interval_s = _number(kw, "interval_s", 1.0, float)
        self.up_pressure = _number(kw, "up_pressure", 2.0, float)
        self.up_sustain_s = _number(kw, "up_sustain_s", 2.0, float)
        self.down_idle_s = _number(kw, "down_idle_s", 10.0, float)
        self.cooldown_s = _number(kw, "cooldown_s", 3.0, float)
        #: the spawned replicas' socket directory ("": a new tempdir)
        self.socket_dir = kw.pop("socket_dir", None) or ""
        #: how long a spawned replica may take to its first clean healthz
        self.ready_timeout_s = _number(kw, "ready_timeout_s", 20.0, float)
        #: how long a shard may hold out for an idle or new replica (0:
        #: no hold)
        self.hold_s = _number(kw, "hold_s", 5.0, float)
        #: `serve` flags for every spawned replica
        self.replica_args = _replica_args(kw.pop("replica_args", None))
        if self.hold_s < 0:
            raise RaconError(
                "autoscale", f"hold_s must be >= 0, got {self.hold_s}")
        if self.min_replicas < 0 or \
                self.max_replicas < max(1, self.min_replicas):
            raise RaconError(
                "autoscale",
                f"bad fleet bounds min={self.min_replicas} "
                f"max={self.max_replicas}")
        if kw:
            raise RaconError(
                "autoscale",
                f"unknown autoscale option(s): {', '.join(sorted(kw))}")


def _default_spawn(spec: str, replica_args: list[str]):
    """Start one warm replica process serving on the unix socket `spec`,
    with the operator's `serve` flags and an explicit device."""
    args = list(replica_args)
    if not any(a.split("=", 1)[0] == "--device" for a in args):
        args += ["--device", "cuda"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PKG_PARENT, env.get("PYTHONPATH")) if p)
    log_path = os.path.splitext(spec)[0] + ".log"
    with open(log_path, "ab") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "racon_tpu_torch", "serve", "--socket",
             spec, *args], stdin=subprocess.DEVNULL,
            stdout=subprocess.DEVNULL, stderr=log, env=env)


def _default_stop(handle) -> None:
    """SIGTERM (the server drains), then SIGKILL if it has not exited in
    15 s (the router's requeue covers even that)."""
    with contextlib.suppress(Exception):
        handle.terminate()
    try:
        handle.wait(timeout=15.0)
    except Exception:  # noqa: BLE001 — escalate; the requeue covers it
        with contextlib.suppress(Exception):
            handle.kill()
            handle.wait(timeout=5.0)


class Autoscaler:
    """The elastic fleet's control loop (module docstring). `spawn(spec)
    -> handle` and `stop(handle)` are injectable; `step(now)` is the
    whole decision and runs without the thread."""

    def __init__(self, router, config: AutoscaleConfig | None = None,
                 spawn=None, stop=None, **overrides):
        self.router = router
        self.config = config if config is not None \
            else AutoscaleConfig(**overrides)
        self._spawn = spawn or (
            lambda spec: _default_spawn(spec, self.config.replica_args))
        self._stop_replica = stop or _default_stop
        self._dir = self.config.socket_dir or tempfile.mkdtemp(
            prefix="racon_tpu_torch_autoscale_")
        #: replicas this loop owns, oldest first: {"spec", "handle", "t",
        #: "ready_s"}; scale-down stops the newest
        self.spawned: list[dict] = []
        self._seq = 0
        self._lock = threading.Lock()
        self._spawning = None
        self._pressure_since: float | None = None
        self._idle_since: float | None = None
        self._last_action_t = float("-inf")
        self._last_pressure = 0.0
        self.counters = {"scale_ups": 0, "scale_downs": 0,
                         "spawn_failures": 0}
        self._thread: threading.Thread | None = None
        self._halt = threading.Event()
        router.autoscaler = self

    # ------------------------------------------------------------ loop
    def start(self) -> "Autoscaler":
        t = threading.Thread(target=self._loop,
                             name="racon-router-autoscale", daemon=True)
        t.start()
        self._thread = t
        cfg = self.config
        log_info(f"[racon_tpu_torch::autoscale] armed: {cfg.min_replicas}-"
                 f"{cfg.max_replicas} replicas, up at pressure "
                 f"{cfg.up_pressure:g} for {cfg.up_sustain_s:g}s, down "
                 f"after {cfg.down_idle_s:g}s idle")
        return self

    def _loop(self) -> None:
        while not self._halt.is_set():
            self._halt.wait(self.config.interval_s)
            if self._halt.is_set():
                return
            try:
                self.step()
            except Exception as exc:  # noqa: BLE001 — the loop runs on
                log_info(f"[racon_tpu_torch::autoscale] step failed "
                         f"({type(exc).__name__}: {exc})")

    def close(self, stop_spawned: bool = True) -> None:
        """Stop the loop; by default also stop every replica this loop
        spawned (the router's tear-down)."""
        self._halt.set()
        if self._thread is not None:
            # a scale-up in its ready wait ends at the halt and stops its
            # child; a scale-down may be in its stop (15 s, then SIGKILL
            # and 5 s wait): outwait both, so no child outlives the loop
            self._thread.join(timeout=30.0)
        pending = self._spawning
        if pending is not None:  # the loop outlived the join
            with contextlib.suppress(Exception):
                self._stop_replica(pending)
        if stop_spawned:
            with self._lock:
                owned, self.spawned = self.spawned, []
            for entry in owned:
                self.router.remove_replica(entry["spec"])
                with contextlib.suppress(Exception):
                    self._stop_replica(entry["handle"])

    # -------------------------------------------------------- decision
    def _signals(self) -> tuple[float, bool, int, int]:
        """(pressure, burn firing, backlog, router inflight) from the
        router's last fleet poll: the autoscaler never probes replicas
        itself."""
        snap = self.router.fleet.last()
        backlog = 0
        if snap is not None:
            for rs in snap.replicas:
                if not rs.ok or not isinstance(rs.health, dict):
                    continue
                backlog += int(rs.health.get("queue_depth", 0) or 0)
                backlog += int(rs.health.get("inflight", 0) or 0)
        burn = getattr(snap, "burn", None) or {}
        firing = bool(burn.get("firing"))
        with self.router._state_lock:
            routable = sum(1 for r in self.router.replicas if r.routable)
            inflight = self.router._inflight_jobs
            outstanding = self.router._requeued_outstanding
            waiting = getattr(self.router, "_dispatch_waiting", 0)
        # shards holding for an idle replica are backlog: counting them
        # is what lets the hold summon the replica it waits for
        backlog += outstanding + waiting
        return backlog / max(1, routable), firing, backlog, inflight

    def step(self, now: float | None = None) -> str | None:
        """One decision; returns "up", "down" or None (what it did).
        `now` is injectable for tests without a clock."""
        now = time.monotonic() if now is None else now
        cfg = self.config
        pressure, firing, backlog, inflight = self._signals()
        self._last_pressure = pressure

        if pressure >= cfg.up_pressure or firing:
            if self._pressure_since is None:
                self._pressure_since = now
        else:
            self._pressure_since = None
        if backlog == 0 and inflight == 0:
            if self._idle_since is None:
                self._idle_since = now
        else:
            self._idle_since = None

        if now - self._last_action_t < cfg.cooldown_s:
            return None
        total = len(self.router.replicas)
        if (self._pressure_since is not None
                and now - self._pressure_since >= cfg.up_sustain_s
                and total < cfg.max_replicas):
            if self._scale_up(reason="burn" if firing else "pressure",
                              pressure=pressure):
                self._last_action_t = now
                self._pressure_since = None
                return "up"
            return None
        if (self._idle_since is not None
                and now - self._idle_since >= cfg.down_idle_s
                and self.spawned
                and total > max(1, cfg.min_replicas)):
            self._scale_down()
            self._last_action_t = now
            self._idle_since = None
            return "down"
        return None

    # --------------------------------------------------------- actions
    def _scale_up(self, reason: str, pressure: float) -> bool:
        with self._lock:
            self._seq += 1
            spec = os.path.join(self._dir, f"autoscale_{self._seq}.sock")
        t0 = time.monotonic()
        try:
            handle = self._spawn(spec)
        except Exception as exc:  # noqa: BLE001 — never kill the loop
            self.counters["spawn_failures"] += 1
            log_info(f"[racon_tpu_torch::autoscale] spawn failed: {exc}")
            return False
        self._spawning = handle
        try:
            ready = self._wait_ready(spec)
        finally:
            self._spawning = None
        if not ready:
            self.counters["spawn_failures"] += 1
            log_info(f"[racon_tpu_torch::autoscale] replica {spec} never "
                     "answered healthz; stopping it")
            with contextlib.suppress(Exception):
                self._stop_replica(handle)
            return False
        entry = {"spec": spec, "handle": handle, "t": time.monotonic(),
                 "ready_s": time.monotonic() - t0}
        with self._lock:
            self.spawned.append(entry)
        self.router.add_replica(spec)
        self.counters["scale_ups"] += 1
        if self.router.journal is not None:
            self.router.journal.record(
                "autoscale-up", replica=spec, reason=reason,
                pressure=round(pressure, 3),
                replicas=len(self.router.replicas))
        log_info(f"[racon_tpu_torch::autoscale] scaled up to "
                 f"{len(self.router.replicas)} replicas ({reason}, "
                 f"pressure {pressure:.2f}, ready in "
                 f"{entry['ready_s']:.2f}s)")
        return True

    def _wait_ready(self, spec: str) -> bool:
        """Poll the new replica's healthz until its first clean answer (ok,
        not draining). A spawned process that exits ends the wait."""
        from .client import PolishClient, ServeError

        deadline = time.monotonic() + self.config.ready_timeout_s
        while time.monotonic() < deadline:
            if self._halt.is_set():
                return False
            poll = getattr(self._spawning, "poll", None)
            if poll is not None and poll() is not None:
                return False
            try:
                doc = PolishClient(socket_path=spec, timeout=2.0).healthz()
                if doc.get("ok") and not doc.get("draining"):
                    return True
            except (ServeError, ProtocolError, OSError):
                pass
            time.sleep(0.1)
        return False

    def _scale_down(self) -> None:
        with self._lock:
            entry = self.spawned.pop()
        # unroute FIRST, then drain: nothing new lands on the replica
        # while it finishes; a death mid-job is the normal requeue
        self.router.remove_replica(entry["spec"])
        with contextlib.suppress(Exception):
            self._stop_replica(entry["handle"])
        self.counters["scale_downs"] += 1
        if self.router.journal is not None:
            self.router.journal.record(
                "autoscale-down", replica=entry["spec"],
                replicas=len(self.router.replicas))
        log_info(f"[racon_tpu_torch::autoscale] scaled down to "
                 f"{len(self.router.replicas)} replicas")

    # -------------------------------------------------------- exposure
    def snapshot(self) -> dict:
        return {"min": self.config.min_replicas,
                "max": self.config.max_replicas,
                "spawned": len(self.spawned),
                "pressure": round(self._last_pressure, 3),
                "scale_ups": self.counters["scale_ups"],
                "scale_downs": self.counters["scale_downs"],
                "spawn_failures": self.counters["spawn_failures"]}
