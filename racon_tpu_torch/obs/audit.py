"""Identity audit: sampled shadow re-execution of finished windows.

The port of the core of the JAX package's racon_tpu/obs/audit.py.
Wrong but well-formed consensus trips no error path, so `WindowAuditor`
re-executes a sample of finished windows at the oracle posture and
compares the bytes:

  - SAMPLING is keyed by content: a window is audited iff the first 8
    bytes of the SHA-256 over its content (backbone, layers, qualities,
    layer positions) fall under `rate` * 2^64. The decision is a pure
    function of the window's bytes, the same in every process and the
    JAX package's bit for bit, and a higher rate only adds windows.
  - SHADOW RE-EXECUTION runs the sampled windows through the oracle
    (ops/oracle.py: int32, unpacked, split; its own engines and
    counters, no winner table) on the auditor's device.
  - A MISMATCH is a confirmed silent corruption. The labeled counter
    (engine, kernel plane `cuda` or `plain`, the production dtype
    posture, bucket) increments; a flight artifact with both byte
    streams lands in `flight_dir`; the winner-table entries of the
    engines implicated are demoted to the oracle candidate through the
    polisher's (or the given) Autotuner, and the table is saved
    atomically, so engines built afterwards dispatch the oracle; the
    window is REPAIRED with the oracle bytes; and the alert fires until
    `ack()`.

In a server (serve/batcher.py) the batcher calls `audit_windows` after
each iteration, shared or solo, once the lane's lock is released and
before the windows are delivered, with the lane and the iteration; the
consequences of a mismatch there go further:

  - the labeled counter carries the `lane`; one `audit.shadow`
    observation per pass lands in `hists`, its bucket's exemplar naming
    the dual-stream artifact when the pass caught a mismatch; a typed
    `audit-mismatch` line lands in `journal` (an obs/journal.Journal);
  - unless `demote=False`, the demotion is followed by
    `batcher.flush_lane_engines()`, so every lane rebuilds its engines
    against the demoted table (and the window cache is invalidated);
  - unless `quarantine=False`, `batcher.quarantine_lane(lane)` takes the
    lane out of service until a re-probe with the latest mismatched
    window (`probe()`) reproduces the oracle bytes on it (`lane_event`
    journals each transition as `audit-lane`);
  - for a window answered by the window cache (`wincache` and
    `cache_keys`, id(window) -> cache key), the entry takes the blame:
    it is evicted and its key quarantined, the lane is labeled `cache`,
    and no engine is demoted and no lane quarantined.

Drive it from Python after a run: keep the windows `Polisher.initialize`
made (`pol.windows` before `pol.polish()`), polish, then
`WindowAuditor(rate, device=pol.device).audit_windows([(w, pol) for w in
windows])`. A repair changes the windows, not FASTA already written.
Called so, without a lane, the labels carry no `lane` and a mismatch
demotes and repairs only.

The port reads no environment: the JAX package's RACON_TPU_AUDIT_RATE,
RACON_TPU_AUDIT_DEMOTE and RACON_TPU_LANE_QUARANTINE are the constructor's
`rate`, `demote` and `quarantine` (and the server's `audit_rate`,
`audit_demote`, `lane_quarantine`).
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
import time

from ..utils.logger import log_info

#: 2^64, the denominator of the content-hash sampling fraction
_HASH_SPACE = float(1 << 64)


def window_sample_fraction(w) -> float:
    """The window's deterministic sample coordinate in [0, 1): the first
    8 bytes of SHA-256 over its full content. A window is audited at rate
    R iff this fraction < R, so the R = 1.0 set holds every smaller
    set."""
    h = hashlib.sha256()
    for seq, qual, (begin, end) in zip(w.sequences, w.qualities,
                                       w.positions):
        h.update(struct.pack("<Iii", len(seq), begin, end))
        h.update(seq)
        if qual:
            h.update(qual)
    return int.from_bytes(h.digest()[:8], "big") / _HASH_SPACE


def _engine_label(p) -> str:
    """Which consensus engine produced the audited bytes: 'host' (the
    native C++ engine) or the device engine's name."""
    if not p.cuda_poa_batches:
        return "host"
    return p.cuda_engine or "session"


#: autotuner engines implicated per production engine label — the set
#: a mismatch demotes. A host-engine mismatch implicates no table entry.
_DEMOTE_ENGINES = {"session": ("session",),
                   "fused": ("fused_loop", "fused", "session")}

#: the polisher attributes the oracle needs to rebuild a window, kept by
#: the probe instead of the polisher itself (and with it its data)
#: (the batcher's engine-key fields, so a lane re-probe can build the
#: engine the mismatched window ran on; the autotuner is a reference)
_PARAM_FIELDS = ("match", "mismatch", "gap", "window_length", "trim",
                 "num_threads", "cuda_poa_batches",
                 "cuda_banded_alignment", "cuda_aligner_band_width",
                 "cuda_engine", "cuda_fused", "fused_fallback",
                 "score_dtype", "pack_bases", "pipeline_depth", "device",
                 "autotuner")


def _slim_params(p):
    import types

    return types.SimpleNamespace(
        **{k: getattr(p, k) for k in _PARAM_FIELDS if hasattr(p, k)})


def _plane(p) -> str:
    """The kernel plane that produced the bytes: the hand kernels on a
    card, their plain versions on the CPU."""
    dev = getattr(p, "device", None)
    return "cuda" if getattr(dev, "type", None) == "cuda" else "plain"


class AuditMismatch:
    """One confirmed silent-corruption event (diagnostics record)."""

    __slots__ = ("job", "trace", "lane", "iteration", "window_id",
                 "rank", "labels", "flight", "demoted", "t")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class WindowAuditor:
    """The sampling auditor (module docstring). `device` is where the
    oracle runs; `autotuner` is the table a mismatch demotes (None: the
    audited polisher's `autotuner`); `on_alert(state, detail)` is called
    on each alert transition. `demote` and `quarantine` switch those
    consequences; `hists` (an obs.hist.HistogramSet) receives the
    `audit.shadow` observations and `journal` (an obs.journal.Journal)
    the `audit-mismatch` and `audit-lane` lines."""

    def __init__(self, rate: float, flight_dir: str | None = None,
                 on_alert=None, device="cuda", autotuner=None,
                 demote: bool = True, quarantine: bool = True, hists=None,
                 journal=None):
        from ..ops.oracle import OracleExecutor

        self.rate = min(1.0, max(0.0, float(rate)))
        self.demote_enabled = bool(demote)
        self.quarantine_enabled = bool(quarantine)
        self.hists = hists
        self.journal = journal
        self.flight_dir = flight_dir
        self.on_alert = on_alert
        self.autotuner = autotuner
        self.oracle = OracleExecutor(device)
        self._lock = threading.Lock()
        self.counters = {"windows": 0, "sampled": 0, "audited": 0,
                         "clean": 0, "mismatches": 0, "repaired": 0,
                         "demotions": 0, "shadow_s": 0.0}
        #: labeled mismatch series: (engine, kernel, dtype, bucket[,
        #: lane]) -> count
        self.mismatch_series: dict[tuple, int] = {}
        self.recent: list[AuditMismatch] = []
        #: the latest mismatched window's content with its oracle bytes
        self._probe = None
        self._alert_firing = False
        self._acked = 0
        self._flight_seq = 0

    # ---------------------------------------------------------- sampling
    @property
    def armed(self) -> bool:
        return self.rate > 0.0

    def set_rate(self, rate: float) -> None:
        """Re-rate; sampling stays a pure function of (content, rate)."""
        self.rate = min(1.0, max(0.0, float(rate)))

    def sampled(self, w) -> bool:
        return window_sample_fraction(w) < self.rate

    # ------------------------------------------------------------- audit
    def audit_windows(self, pairs, lane_index: int = -1,
                      iteration: int = -1, batcher=None, wincache=None,
                      cache_keys=None) -> int:
        """Audit finished windows: `pairs` is [(window, polisher)].
        Samples by content hash, re-executes the sample at the oracle
        posture (one pass per polisher), compares the bytes and fires the
        mismatch consequences (module docstring), the repair included.
        `lane_index` and `iteration` label an iteration of `batcher`'s
        (-1: none); `wincache` with `cache_keys` (id(window) -> cache
        key) marks the windows as cache hits. Returns the number of
        mismatches."""
        from ..ops.oracle import snapshot_window

        rate = self.rate
        chosen = [(w, p) for w, p in pairs
                  if window_sample_fraction(w) < rate]
        with self._lock:
            self.counters["windows"] += len(pairs)
            self.counters["sampled"] += len(chosen)
        if not chosen:
            return 0
        mismatches = 0
        exemplar = None
        t0 = time.perf_counter()
        by_polisher: dict[int, tuple] = {}
        for w, p in chosen:
            by_polisher.setdefault(id(p), (p, []))[1].append(w)
        for p, windows in by_polisher.values():
            snaps = [snapshot_window(w) for w in windows]
            clones = self.oracle.consensus(p, snaps)
            for w, snap, clone in zip(windows, snaps, clones):
                ok = (w.consensus == clone.consensus
                      and w.polished == clone.polished)
                with self._lock:
                    self.counters["audited"] += 1
                    if ok:
                        self.counters["clean"] += 1
                if not ok:
                    mismatches += 1
                    ck = (cache_keys.get(id(w)) if cache_keys is not None
                          else None)
                    exemplar = self._on_mismatch(
                        w, snap, clone, p, lane_index, iteration, batcher,
                        wincache=wincache, cache_key=ck)
        shadow_s = time.perf_counter() - t0
        with self._lock:
            self.counters["shadow_s"] += shadow_s
        if self.hists is not None:
            # one observation per pass; a mismatching pass's bucket
            # carries the exemplar naming its dual-stream artifact
            self.hists.observe("audit.shadow", shadow_s, exemplar=exemplar)
        return mismatches

    def _on_mismatch(self, w, snap, clone, p, lane_index: int = -1,
                     iteration: int = -1, batcher=None, wincache=None,
                     cache_key=None) -> dict | None:
        """The consequences of one confirmed mismatch; returns the
        exemplar of this pass's `audit.shadow` observation. A
        `cache_key` puts the blame on the cache entry, not on the
        device."""
        from_cache = cache_key is not None
        engine = _engine_label(p)
        labels = {"engine": engine,
                  "kernel": _plane(p),
                  "dtype": getattr(p, "score_dtype", "auto"),
                  "bucket": f"{len(w.sequences)}x{len(w.sequences[0])}"}
        if from_cache or lane_index >= 0:
            labels["lane"] = "cache" if from_cache else str(lane_index)
        job = getattr(p, "serve_job_id", None)
        trace = getattr(p, "serve_trace_id", None)
        flight = self._dump_streams(w, clone, labels, job, iteration)
        demoted = (self._demote(engine, p)
                   if self.demote_enabled and not from_cache else [])
        if from_cache and wincache is not None:
            # evict the poisoned bytes and refuse the key for good: the
            # same content dispatches again
            wincache.quarantine(cache_key)
        with self._lock:
            self.counters["mismatches"] += 1
            key = tuple(sorted(labels.items()))
            self.mismatch_series[key] = self.mismatch_series.get(key,
                                                                 0) + 1
            self.counters["demotions"] += len(demoted)
            self._probe = (_slim_params(p), snap, clone.consensus,
                           clone.polished)
            self.recent.append(AuditMismatch(
                job=job, trace=trace, lane=lane_index, iteration=iteration,
                window_id=w.id, rank=w.rank, labels=labels, flight=flight,
                demoted=demoted, t=round(time.time(), 6)))
            del self.recent[:-16]
        if self.journal is not None:
            fields = dict(labels)
            fields.update(iteration=iteration, window=f"{w.id}:{w.rank}",
                          flight=flight, demoted=demoted or None,
                          cache=("entry-quarantined" if from_cache
                                 else None))
            self.journal.record("audit-mismatch", job=job, trace=trace,
                                **fields)
        where = ("cache entry " if from_cache
                 else f"lane {lane_index} iteration {iteration} "
                 if lane_index >= 0 else "")
        log_info(f"[racon_tpu_torch::audit] MISMATCH {where}window "
                 f"{w.id}:{w.rank} "
                 f"({labels['engine']}/{labels['kernel']}/"
                 f"{labels['dtype']} {labels['bucket']}): production "
                 f"bytes diverge from the oracle"
                 + ("; entry evicted and key quarantined"
                    if from_cache else "")
                 + (f"; demoted {len(demoted)} winner entr"
                    f"{'y' if len(demoted) == 1 else 'ies'}"
                    if demoted else "")
                 + (f"; dual-stream dump {flight}" if flight else ""))
        # the caught window ships the oracle bytes
        w.consensus = clone.consensus
        w.polished = clone.polished
        with self._lock:
            self.counters["repaired"] += 1
        self._update_alert()
        if demoted and batcher is not None:
            # every lane's engines cached plans from the demoted table
            batcher.flush_lane_engines()
        if (self.quarantine_enabled and batcher is not None
                and not from_cache and lane_index >= 0):
            batcher.quarantine_lane(lane_index)
        return {k: v for k, v in (("trace_id", trace or job), ("job", job),
                                  ("flight", flight)) if v} or None

    def _demote(self, engine: str, p) -> list[str]:
        """Demote the implicated engines' entries on the backend that
        produced the bytes, through the auditor's or the polisher's
        Autotuner."""
        at = self.autotuner or getattr(p, "autotuner", None)
        if at is None:
            return []
        backend = getattr(getattr(p, "device", None), "type", None)
        demoted: list[str] = []
        try:
            for eng in _DEMOTE_ENGINES.get(engine, ()):
                demoted += at.demote(engine=eng, backend=backend)
        except Exception as exc:  # noqa: BLE001 — demotion is a
            # consequence, never a second failure
            log_info(f"[racon_tpu_torch::audit] warning: winner-table "
                     f"demotion failed ({type(exc).__name__}: {exc})")
        return demoted

    def _dump_streams(self, w, clone, labels: dict, job=None,
                      iteration: int = -1) -> str | None:
        """The dual-stream flight artifact: a Chrome-trace-shaped JSON
        whose `flight` object carries both byte streams. Best effort: a
        full disk loses the artifact, never the verdict."""
        if not self.flight_dir:
            return None
        try:
            os.makedirs(self.flight_dir, exist_ok=True)
            with self._lock:
                self._flight_seq += 1
                seq = self._flight_seq
            path = os.path.join(
                self.flight_dir,
                f"flight_{job or 'audit'}_audit-mismatch_{seq}.json")
            doc = {"traceEvents": [],
                   "displayTimeUnit": "ms",
                   "flight": {
                       "reason": "audit-mismatch",
                       "job_id": job, "iteration": iteration,
                       "window": {"id": w.id, "rank": w.rank},
                       "labels": labels,
                       "produced": w.consensus.decode("latin-1"),
                       "produced_polished": w.polished,
                       "oracle": clone.consensus.decode("latin-1"),
                       "oracle_polished": clone.polished}}
            with open(path, "w") as fh:
                json.dump(doc, fh)
            return path
        except Exception as exc:  # noqa: BLE001 — see docstring
            log_info(f"[racon_tpu_torch::audit] warning: could not write "
                     f"dual-stream dump ({type(exc).__name__}: {exc})")
            return None

    def probe(self):
        """(polisher params, window snapshot, oracle consensus, oracle
        polished) of the latest mismatched window, or None before any."""
        with self._lock:
            return self._probe

    def lane_event(self, lane_index: int, state: str, **fields) -> None:
        """Journal and log one lane health transition (the batcher calls
        it on quarantine, rejoin, failed re-probe and degraded rejoin)."""
        if self.journal is not None:
            self.journal.record("audit-lane", lane=lane_index, state=state,
                                **fields)
        log_info(f"[racon_tpu_torch::audit] lane {lane_index} {state}"
                 + (f" ({', '.join(f'{k}={v}' for k, v in fields.items())})"
                    if fields else ""))

    # ------------------------------------------------------------ alert
    def _update_alert(self) -> None:
        with self._lock:
            firing = self.counters["mismatches"] > self._acked
            changed = firing != self._alert_firing
            self._alert_firing = firing
            detail = {"mismatches": self.counters["mismatches"],
                      "acked": self._acked}
        if changed and self.on_alert is not None:
            try:
                self.on_alert("firing" if firing else "clear", detail)
            except Exception:  # noqa: BLE001 — alerting is decoration
                pass

    @property
    def alert_firing(self) -> bool:
        with self._lock:
            return self._alert_firing

    def ack(self) -> dict:
        """Acknowledge: the alert clears and stays clear until the next
        mismatch."""
        with self._lock:
            self._acked = self.counters["mismatches"]
        self._update_alert()
        with self._lock:
            return {"acked": self._acked, "firing": self._alert_firing}

    # --------------------------------------------------------- exposure
    def mismatch_samples(self) -> list[tuple[dict, int]]:
        """Labeled mismatch counts."""
        with self._lock:
            items = sorted(self.mismatch_series.items())
        return [(dict(key), n) for key, n in items]

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["shadow_s"] = round(out["shadow_s"], 4)
            out["rate"] = self.rate
            out["alert_firing"] = self._alert_firing
            out["acked"] = self._acked
            out["recent"] = [m.as_dict() for m in self.recent[-4:]]
        out["shadow"] = self.oracle.stats()
        return out

    def close(self) -> None:
        self.oracle.close()
