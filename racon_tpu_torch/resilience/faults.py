"""Deterministic fault injection.

A fault plan is a comma-separated list of armed faults:

    <stage>:chunk=<N>:<action>
    stage  ::= pack | device | unpack | fallback
    action ::= raise | corrupt | hang=<seconds> | sdc

e.g. ``device:chunk=3:raise,unpack:chunk=2:corrupt`` arms a DeviceError
on the 4th device dispatch and a ChunkCorrupt on the 3rd unpack. `chunk`
counts per stage per pipeline run, in submission order; `fallback`
counts the pipeline's host fallback jobs. The first stage to reach the
armed index fires the fault: with the device aligner on, the alignment
phase's pipeline runs first, else the consensus phase's (the host POA
loop and the fused engine run through a pipeline; the session engine
does not). Every fault is one-shot.

Actions: `raise` -> DeviceError, `corrupt` -> ChunkCorrupt, `hang=<s>`
stalls the stage for <s> seconds and the run goes on. The port has no
retry ladder, so a raised fault fails the run (in a server, the job).

`sdc` models silent data corruption: wrong bytes and no error. A
`<stage>:chunk=<N>:sdc` fault is never a stage hook (`fire` skips it);
the consensus engine consumes it at the end of its pass
(`corrupt_consensus`, from ops/poa.BatchPOA.generate_consensus) by
flipping one base of the N-th polished window's consensus. Only the
identity audit (obs/audit.py), which re-executes sampled windows through
the oracle and compares the bytes, can catch it.

A plan is an object handed to one polisher (`create_polisher(...,
fault_plan=)`), whose pipelines share its one-shot faults; no
environment variable arms one.
"""

from __future__ import annotations

import threading
import time

from ..errors import ChunkCorrupt, DeviceError, RaconError

STAGES = ("pack", "device", "unpack", "fallback")
ACTIONS = ("raise", "corrupt", "hang", "sdc")

#: the base an `sdc` flip writes: deterministic (the same plan flips the
#: same bytes) and always a real base, so no format check can see it
_SDC_FLIP = {65: 67, 67: 71, 71: 84, 84: 65}  # A->C->G->T->A


class Fault:
    """One armed fault: fires at most once."""

    __slots__ = ("stage", "chunk", "action", "seconds", "fired")

    def __init__(self, stage: str, chunk: int, action: str,
                 seconds: float = 0.0):
        self.stage = stage
        self.chunk = chunk
        self.action = action
        self.seconds = seconds
        self.fired = False

    def __repr__(self):
        arg = f"={self.seconds:g}" if self.action == "hang" else ""
        return (f"{self.stage}:chunk={self.chunk}:{self.action}{arg}"
                f"{' (fired)' if self.fired else ''}")


class FaultPlan:
    """A parsed fault plan with thread-safe one-shot firing."""

    def __init__(self, faults: list[Fault]):
        self._faults = faults
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        faults: list[Fault] = []
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            parts = entry.split(":")
            if len(parts) != 3:
                raise RaconError(
                    "resilience.FaultPlan",
                    f"invalid fault entry {entry!r} (expected "
                    "<stage>:chunk=<N>:<action>)!")
            stage, chunk_s, action_s = parts
            if stage not in STAGES:
                raise RaconError(
                    "resilience.FaultPlan",
                    f"unknown fault stage {stage!r} (expected one of "
                    f"{', '.join(STAGES)})!")
            if not chunk_s.startswith("chunk="):
                raise RaconError(
                    "resilience.FaultPlan",
                    f"invalid fault target {chunk_s!r} (expected "
                    "chunk=<N>)!")
            try:
                chunk = int(chunk_s[len("chunk="):])
            except ValueError:
                raise RaconError(
                    "resilience.FaultPlan",
                    f"invalid fault chunk index {chunk_s!r}!") from None
            action, _, arg = action_s.partition("=")
            if action not in ACTIONS:
                raise RaconError(
                    "resilience.FaultPlan",
                    f"unknown fault action {action!r} (expected one of "
                    f"{', '.join(ACTIONS)})!")
            seconds = 0.0
            if action == "hang":
                try:
                    seconds = float(arg)
                except ValueError:
                    raise RaconError(
                        "resilience.FaultPlan",
                        f"invalid hang duration {arg!r} (expected "
                        "hang=<seconds>)!") from None
                if seconds <= 0:
                    raise RaconError("resilience.FaultPlan",
                                     "hang duration must be positive!")
            elif arg:
                raise RaconError("resilience.FaultPlan",
                                 f"action {action!r} takes no argument!")
            faults.append(Fault(stage, chunk, action, seconds))
        if not faults:
            raise RaconError("resilience.FaultPlan", "empty fault plan!")
        return cls(faults)

    def fire(self, stage: str, chunk: int, stats=None) -> None:
        """Called by the pipeline as `stage` starts its `chunk`-th item:
        consumes and enacts the first matching unfired fault, counted as
        `faults` in `stats` (a PipelineStats). An `sdc` fault is not a
        stage hook: `corrupt_consensus` consumes it."""
        with self._lock:
            fault = next((f for f in self._faults
                          if not f.fired and f.stage == stage
                          and f.chunk == chunk and f.action != "sdc"),
                         None)
            if fault is None:
                return
            fault.fired = True
        if stats is not None:
            stats.bump("faults")
        if fault.action == "hang":
            time.sleep(fault.seconds)
            return
        exc_cls = ChunkCorrupt if fault.action == "corrupt" else DeviceError
        raise exc_cls("resilience.FaultPlan",
                      f"injected {fault.action} fault at {stage} "
                      f"chunk {chunk}")

    def corrupt_consensus(self, windows, stats=None) -> int:
        """Consume the armed `sdc` faults against a finished consensus
        pass: for each unfired `...:chunk=N:sdc`, flip the middle base of
        the N-th polished window's consensus (in `windows` order), each
        counted as `faults` in `stats`. A fault whose N lies beyond this
        pass stays armed. Returns the windows corrupted."""
        with self._lock:
            armed = [f for f in self._faults
                     if not f.fired and f.action == "sdc"]
            if not armed:
                return 0
            polished = [w for w in windows if w.polished and w.consensus]
            hit = 0
            for fault in armed:
                if fault.chunk >= len(polished):
                    continue
                fault.fired = True
                w = polished[fault.chunk]
                cons = bytearray(w.consensus)
                i = len(cons) // 2
                cons[i] = _SDC_FLIP.get(cons[i], 65)
                w.consensus = bytes(cons)
                hit += 1
        if stats is not None:
            for _ in range(hit):
                stats.bump("faults")
        return hit

    @property
    def unfired(self) -> list[Fault]:
        with self._lock:
            return [f for f in self._faults if not f.fired]
