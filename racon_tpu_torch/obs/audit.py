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

Drive it from Python after a run: keep the windows `Polisher.initialize`
made (`pol.windows` before `pol.polish()`), polish, then
`WindowAuditor(rate, device=pol.device).audit_windows([(w, pol) for w in
windows])`. A repair changes the windows, not FASTA already written.

Left for the serve slice, where their callers are: the batcher hooks
(lane quarantine and re-probe, `flush_lane_engines`, `lane_event`, and
the lane and iteration a mismatch is labeled with), the window cache
(`wincache`, `cache_keys`), the journal, the histograms with their
exemplar, the switch that turns demotion off, and the process-wide
environment knobs. A mismatch here always demotes.
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
_PARAM_FIELDS = ("match", "mismatch", "gap", "window_length", "trim",
                 "num_threads", "cuda_poa_batches",
                 "cuda_banded_alignment", "cuda_aligner_band_width",
                 "cuda_engine", "fused_fallback", "pipeline_depth")


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

    __slots__ = ("window_id", "rank", "labels", "flight", "demoted",
                 "t")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class WindowAuditor:
    """The sampling auditor (module docstring). `device` is where the
    oracle runs; `autotuner` is the table a mismatch demotes (None: the
    audited polisher's `autotuner`); `on_alert(state, detail)` is called
    on each alert transition."""

    def __init__(self, rate: float, flight_dir: str | None = None,
                 on_alert=None, device="cuda", autotuner=None):
        from ..ops.oracle import OracleExecutor

        self.rate = min(1.0, max(0.0, float(rate)))
        self.flight_dir = flight_dir
        self.on_alert = on_alert
        self.autotuner = autotuner
        self.oracle = OracleExecutor(device)
        self._lock = threading.Lock()
        self.counters = {"windows": 0, "sampled": 0, "audited": 0,
                         "clean": 0, "mismatches": 0, "repaired": 0,
                         "demotions": 0, "shadow_s": 0.0}
        #: labeled mismatch series: (engine, kernel, dtype, bucket) ->
        #: count
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
    def audit_windows(self, pairs) -> int:
        """Audit finished windows: `pairs` is [(window, polisher)].
        Samples by content hash, re-executes the sample at the oracle
        posture (one pass per polisher), compares the bytes and fires the
        mismatch consequences (module docstring), the repair included.
        Returns the number of mismatches."""
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
                    self._on_mismatch(w, snap, clone, p)
        with self._lock:
            self.counters["shadow_s"] += time.perf_counter() - t0
        return mismatches

    def _on_mismatch(self, w, snap, clone, p) -> None:
        """The consequences of one confirmed mismatch."""
        engine = _engine_label(p)
        labels = {"engine": engine,
                  "kernel": _plane(p),
                  "dtype": getattr(p, "score_dtype", "auto"),
                  "bucket": f"{len(w.sequences)}x{len(w.sequences[0])}"}
        flight = self._dump_streams(w, clone, labels)
        demoted = self._demote(engine, p)
        with self._lock:
            self.counters["mismatches"] += 1
            key = tuple(sorted(labels.items()))
            self.mismatch_series[key] = self.mismatch_series.get(key,
                                                                 0) + 1
            self.counters["demotions"] += len(demoted)
            self._probe = (_slim_params(p), snap, clone.consensus,
                           clone.polished)
            self.recent.append(AuditMismatch(
                window_id=w.id, rank=w.rank, labels=labels, flight=flight,
                demoted=demoted, t=round(time.time(), 6)))
            del self.recent[:-16]
        log_info(f"[racon_tpu_torch::audit] MISMATCH window "
                 f"{w.id}:{w.rank} "
                 f"({labels['engine']}/{labels['kernel']}/"
                 f"{labels['dtype']} {labels['bucket']}): production "
                 f"bytes diverge from the oracle"
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

    def _dump_streams(self, w, clone, labels: dict) -> str | None:
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
            path = os.path.join(self.flight_dir,
                                f"flight_audit_audit-mismatch_{seq}.json")
            doc = {"traceEvents": [],
                   "displayTimeUnit": "ms",
                   "flight": {
                       "reason": "audit-mismatch",
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
