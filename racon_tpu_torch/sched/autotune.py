"""Persisted per-bucket kernel autotuner: profile once, dispatch forever.

The port of the JAX package's racon_tpu/sched/autotune.py. The profilers
time each bucket's candidates on the device they are given and veto any
candidate whose output differs from the oracle candidate's; the winners
persist as a JSON table that the engines read:

  - `profile_session_bucket`: K1 (the session engine's window sweep) at
    int32 and, where the overflow proof holds, int16, per (nodes, len)
    bucket;
  - `profile_aligner_bucket`: K2 (the aligner's wavefront) at both
    widths per (edge, band);
  - `profile_fused_bucket`: K3 as the split posture's chained calls
    against one launch over the whole chain, per (nodes, len, leading
    depth bucket) — the choice `FusedPOA._fused_plan` makes under
    `--cuda-fused auto`.

The port has one kernel plane on a card (the hand kernels) and the plain
versions on the CPU, so an entry's `kernel` names the plane, `cuda` or
`plain`, for the engines `session`, `aligner` and `fused` (whose entries
carry the score dtype the engines dispatch under `--cuda-dtype auto`);
for `fused_loop` it is `split` or `fused`. The oracle candidate is
`<plane>:int32`, and for `fused_loop` `split:<dtype>`.

The table lives at `default_table_path()` unless the caller passes a
path (CLI and wrapper `--cuda-autotune-table`); no environment variable
moves it. Keys are `backend|engine|bucket|params`, the backend being the
torch device type, so a table profiled on a card never feeds a CPU run
and a CPU table never feeds a card run. Engines only read the table: a
cold table dispatches exactly what the postures give without one, and a
bucket already in the table is not profiled again (`fresh=False`).

Each profile times its candidates at the width the engine launches them
(the session's pinned rows, a full aligner batch, the fused engine's
chunk of B windows), and a candidate other than the one a cold table
dispatches wins only when its slowest timed call beats that one's
fastest (`_settle`): the int16 / int32 and split / one-launch gaps are
mostly inside the calls' spread, and there the entry keeps the cold
decision and says `noise`.

`posture_key` and `consult_counts`, whose callers are the serve window
cache, batcher and scrape, come with the serve slice.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading

import numpy as np
import torch

BASENAME = "racon_tpu_torch_autotune.json"

#: schema version: bump when entry semantics change so a stale table is
#: ignored rather than misread
VERSION = 1

#: the most pairs an aligner profile times: a full batch where the byte
#: cap is small (146 pairs at (8192, 896), the chip cells' fullest), this
#: many where the cap runs to thousands of pairs at short edges
ALIGNER_PROFILE_ROWS = 256

#: the largest aligner edge `profile_all` covers: no pair of the chip
#: cells lies beyond it, and edges above it consult cold
MAX_PROFILED_EDGE = 8192


def default_table_path() -> str:
    """Where the winner table lives when the caller names none."""
    return os.path.join(os.path.expanduser("~/.cache/racon_tpu_torch"),
                        BASENAME)


def _backend() -> str:
    """The backend a key names when the caller gives none: the card when
    one is present, else the CPU."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def plane(backend: str) -> str:
    """The kernel plane of a backend: the hand kernels on a card, their
    plain versions on the CPU."""
    return "cuda" if backend == "cuda" else "plain"


class Autotuner:
    """One winner table: load on construction, explicit save, dict
    lookups in between. Entries:

        {"kernel": "cuda"|"plain"|"split"|"fused",
         "dtype": "int16"|"int32",
         "ms": {candidate: mean milliseconds, ...},
         "spread": {candidate: [fastest, slowest], ...},
         "identical": bool}

    plus `"noise": True` where the gap was inside the spread and the
    entry keeps the cold decision, and `"demoted": True` once the audit has demoted the entry. A table
    that fails to parse, or has another VERSION, is read as absent."""

    def __init__(self, path: str | None = None):
        self.path = path or default_table_path()
        self.table: dict[str, dict] = {}
        #: per-decision consult counters: (engine, kernel, dtype) -> times
        #: `winner()` handed that decision out (kernel "none": a cold
        #: bucket)
        self.consults: dict[tuple[str, str, str], int] = {}
        self._lock = threading.Lock()
        try:
            with open(self.path) as fh:
                doc = json.load(fh)
            if (isinstance(doc, dict) and doc.get("version") == VERSION
                    and isinstance(doc.get("winners"), dict)):
                self.table = doc["winners"]
        except (OSError, ValueError):
            pass

    # ------------------------------------------------------------ keys
    @staticmethod
    def key(engine: str, bucket, params=(), backend: str | None = None
            ) -> str:
        b = backend if backend is not None else _backend()
        bs = "x".join(str(v) for v in (bucket if isinstance(
            bucket, (tuple, list)) else (bucket,)))
        ps = ",".join(str(v) for v in params)
        return f"{b}|{engine}|{bs}|{ps}"

    def winner(self, engine: str, bucket, params=(),
               backend: str | None = None) -> dict | None:
        """The measured entry for one bucket on `backend`, or None (cold:
        the engine keeps what its posture gives). Every call bumps the
        consult counter of the decision handed out."""
        ent = self.table.get(self.key(engine, bucket, params, backend))
        decision = (engine, str((ent or {}).get("kernel") or "none"),
                    str((ent or {}).get("dtype") or ""))
        with self._lock:
            self.consults[decision] = self.consults.get(decision, 0) + 1
        return ent

    def consults_snapshot(self) -> dict:
        with self._lock:
            return dict(self.consults)

    def record(self, engine: str, bucket, params, entry: dict,
               backend: str | None = None) -> None:
        self.table[self.key(engine, bucket, params, backend)] = entry

    #: per-engine oracle candidate a demoted entry falls back to, where it
    #: is not the backend's plane (the candidate `_pick` compares against)
    _ORACLE_KERNEL = {"fused_loop": "split"}

    def demote(self, engine: str | None = None, bucket=None, params=None,
               backend: str | None = None) -> list[str]:
        """Rewrite the matching entries of `backend` to the oracle
        candidate (the plane, or `split`, at int32) with `identical`
        False and `demoted` True, then save the table atomically — the
        audit's counterpart of `_pick`'s veto. `engine` / `bucket` /
        `params` narrow the match (None: every entry of the backend or
        engine); entries already at the oracle are left alone. Returns
        the demoted keys. Engines built afterwards in this process see
        the demotion at once (`winner()` reads the same dict); the saved
        table carries it to later processes. An engine already built
        keeps the plans it has cached."""
        b = backend if backend is not None else _backend()
        want_key = (self.key(engine, bucket, params or (), backend=b)
                    if engine is not None and bucket is not None
                    else None)
        demoted: list[str] = []
        for key, ent in list(self.table.items()):
            parts = key.split("|", 2)
            if want_key is not None:
                if key != want_key:
                    continue
            elif (len(parts) < 3 or parts[0] != b
                  or (engine is not None and parts[1] != engine)):
                continue
            if not isinstance(ent, dict):
                continue
            oracle = self._ORACLE_KERNEL.get(parts[1], plane(b))
            if ent.get("kernel") == oracle and ent.get("dtype") == "int32":
                continue
            self.table[key] = {"kernel": oracle, "dtype": "int32",
                               "ms": ent.get("ms", {}),
                               "identical": False, "demoted": True}
            demoted.append(key)
        if demoted:
            try:
                self.save()
            except OSError:
                # the in-process veto stands when the file is unwritable
                pass
        return demoted

    def save(self) -> str:
        """Atomic write (a temporary file, then os.replace), so a reader
        never sees a torn table; returns the path."""
        folder = os.path.dirname(self.path) or "."
        os.makedirs(folder, exist_ok=True)
        doc = {"version": VERSION, "winners": self.table}
        fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(doc, fh, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return self.path

    # ------------------------------------------------------- profiling
    @staticmethod
    def _time(fn, reps: int, device: torch.device, setup=None):
        """-> (milliseconds of each timed call, last output): one warm-up
        call, then `reps` calls, each between two synchronizations of the
        device, so the host clock spans the kernels and not only their
        launches. With `setup`, each call is `fn(setup())` and `setup`
        runs outside the timed span."""
        import time

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        def call():
            arg = setup() if setup is not None else None
            sync()
            t0 = time.perf_counter()
            out = fn(arg) if setup is not None else fn()
            sync()
            return (time.perf_counter() - t0) * 1e3, out

        call()
        times, out = [], None
        for _ in range(max(1, reps)):
            t, out = call()
            times.append(t)
        return times, out

    @staticmethod
    def _settle(times: dict, outs: dict, oracle: str, cold: str) -> dict:
        """`_pick` over the calls' means, then the noise gate: a winner
        other than `cold` (what a cold table dispatches) stands only when
        its slowest timed call beat `cold`'s fastest. Inside that spread
        the entry keeps `cold` and says `noise`, so a table dispatches
        only gaps its own reps resolve. `spread` keeps each candidate's
        fastest and slowest call."""
        entry = Autotuner._pick(
            {k: sum(v) / len(v) for k, v in times.items()}, outs, oracle)
        entry["spread"] = {k: [round(min(v), 3), round(max(v), 3)]
                           for k, v in times.items()}
        best = f"{entry['kernel']}:{entry['dtype']}"
        if (entry["identical"] and best != cold
                and max(times[best]) >= min(times[cold])):
            entry["kernel"], entry["dtype"] = cold.split(":")
            entry["noise"] = True
        return entry

    def profile_session_bucket(self, n_nodes: int, seq_len: int,
                               max_pred: int, match: int, mismatch: int,
                               gap: int, rows: int | None = None,
                               reps: int = 3, seed: int = 7,
                               device: str | torch.device = "cuda"
                               ) -> tuple[dict, bool]:
        """Time K1 for one (nodes, len) bucket at int32 and, where the
        overflow proof holds, int16, on `rows` synthetic linear-graph jobs
        (None: the session engine's batch width for the bucket on
        `device`) in the session's operand form (2-bit packed: the jobs
        are all ACGT). Returns (entry, fresh); fresh=False means the
        table already had the bucket and nothing ran."""
        from ..device import resolve
        from ..ops.dtypes import poa_int16_ok
        from ..ops.encode import pack_2bit, packable
        from ..ops.poa_graph import pinned_rows
        from ..ops.poa_kernels import window_sweep

        dev = resolve(device)
        params = (match, mismatch, gap, max_pred)
        existing = self.winner("session", (n_nodes, seq_len), params,
                               backend=dev.type)
        if existing is not None:
            return existing, False

        rows = rows or pinned_rows(dev, n_nodes, seq_len)
        codes, preds, centers, sinks, seqs, lens, band = _session_jobs(
            n_nodes, seq_len, max_pred, rows, seed)
        nnodes = (codes != 5).sum(axis=1).astype(np.int32)
        packed = (seq_len % 4 == 0 and packable(seqs, lens)
                  and packable(codes, nnodes))
        if packed:
            codes, seqs = pack_2bit(codes), pack_2bit(seqs)
        args = [torch.from_numpy(a).to(dev) for a in (
            codes, preds, centers, sinks, seqs, lens, band, nnodes)]
        dtypes = ["int32"]
        if poa_int16_ok(n_nodes, seq_len, match, mismatch, gap):
            dtypes.append("int16")
        kern = plane(dev.type)
        times: dict[str, list] = {}
        outs: dict[str, np.ndarray] = {}
        for dt in dtypes:
            def run(dt=dt):
                return window_sweep(*args, match, mismatch, gap, dt,
                                    packed).cpu().numpy()

            times[f"{kern}:{dt}"], outs[f"{kern}:{dt}"] = self._time(
                run, reps, dev)
        entry = self._settle(times, outs, f"{kern}:int32",
                             f"{kern}:{dtypes[-1]}")
        self.record("session", (n_nodes, seq_len), params, entry,
                    backend=dev.type)
        return entry, True

    def profile_aligner_bucket(self, edge: int, band: int,
                               rows: int | None = None, reps: int = 3,
                               seed: int = 11,
                               device: str | torch.device = "cuda"
                               ) -> tuple[dict, bool]:
        """Time K2 for one (edge, band) at int32 and, where the overflow
        proof holds, int16, on `rows` synthetic mutated pairs (None: a
        full batch, `BatchAligner.batch_cap` pairs, at most
        ALIGNER_PROFILE_ROWS) with the operands BatchAligner builds.
        Identity covers everything the aligner consumes: the op runs, the
        touched flags and the distances (the last two decide the host
        re-alignment)."""
        from ..device import resolve
        from ..ops.align import BatchAligner, runs_of
        from ..ops.align_kernels import wavefront_align
        from ..ops.dtypes import aligner_int16_ok

        dev = resolve(device)
        existing = self.winner("aligner", (edge, band), (),
                               backend=dev.type)
        if existing is not None:
            return existing, False

        rows = rows or min(ALIGNER_PROFILE_ROWS,
                           BatchAligner.batch_cap(edge, band))
        pairs = _aligner_pairs(edge, rows, seed)
        q, t, ql, tl, offs = BatchAligner(device=dev).operands(
            pairs, edge, band, list(range(len(pairs))))
        packed = q.dtype == torch.uint8
        dtypes = ["int32"]
        if aligner_int16_ok(edge):
            dtypes.append("int16")
        kern = plane(dev.type)
        times: dict[str, list] = {}
        outs: dict[str, tuple] = {}
        for dt in dtypes:
            def run(dt=dt):
                ops, meta = wavefront_align(q, t, ql, tl, offs, band, dt,
                                            packed)
                return ops.cpu().numpy(), meta.cpu().numpy()

            # the decode stays outside the timed calls
            times[f"{kern}:{dt}"], (ops, meta) = self._time(run, reps, dev)
            outs[f"{kern}:{dt}"] = (
                [runs_of(ops[k, :meta[k, 0]][::-1])
                 for k in range(len(pairs))],
                [bool(v) for v in meta[:, 2] > 0], _dist_norm(meta[:, 1]))
        entry = self._settle(times, outs, f"{kern}:int32",
                             f"{kern}:{dtypes[-1]}")
        self.record("aligner", (edge, band), (), entry, backend=dev.type)
        return entry, True

    def profile_fused_bucket(self, n_nodes: int, seq_len: int,
                             depth: int, max_pred: int, match: int,
                             mismatch: int, gap: int,
                             rows: int | None = None, reps: int = 3,
                             seed: int = 13,
                             device: str | torch.device = "cuda"
                             ) -> tuple[dict, bool]:
        """Time K3's two chunk postures for one (nodes, len, depth
        bucket): the split posture's chained calls against one launch
        over the whole chain, on one chunk of `rows` synthetic windows
        (None: the fused engine's chunk width B on `device`) 1.5x the
        bucket deep, so the split posture really chains while the key is
        the chunk's leading chain bucket — what `FusedPOA._fused_plan`
        consults. Each posture is packed once (`FusedPOA.pack_run`) and
        only its launches are timed (`run_packed` on a fresh copy of the
        initial state). The veto compares the finalized consensus (bytes
        and coverages) and the statuses: the two postures' scratch
        layouts may differ, their results may not."""
        from ..device import resolve
        from ..ops.poa_fused import FusedPOA

        dev = resolve(device)
        params = (match, mismatch, gap, max_pred)
        existing = self.winner("fused_loop", (n_nodes, seq_len, depth),
                               params, backend=dev.type)
        if existing is not None:
            return existing, False

        eng = FusedPOA(match, mismatch, gap, device=dev, max_nodes=n_nodes,
                       max_len=seq_len, max_pred=max_pred, batch_rows=rows,
                       fused="0")
        windows = _fused_windows(n_nodes, seq_len,
                                 depth + max(1, depth // 2), eng.B, seed)
        chunk = list(range(len(windows)))
        dt = eng.score_dtype
        times: dict[str, list] = {}
        outs: dict = {}
        for name, fused in (("split", False), ("fused", True)):
            state, calls = eng.pack_run(windows, chunk, fused)
            times[f"{name}:{dt}"], final = self._time(
                lambda s, calls=calls: eng.run_packed(s, calls), reps, dev,
                setup=lambda state=state: tuple(t.clone() for t in state))
            results, statuses = eng.finalize_run(windows, chunk, final)
            outs[f"{name}:{dt}"] = (
                [(r[0], np.asarray(r[1]).tolist()) if r is not None
                 else None for r in results], statuses.tolist())
        entry = self._settle(times, outs, f"split:{dt}", f"split:{dt}")
        self.record("fused_loop", (n_nodes, seq_len, depth), params, entry,
                    backend=dev.type)
        return entry, True

    @staticmethod
    def _pick(ms: dict, outs: dict, oracle: str) -> dict:
        """The fastest candidate whose output equals the oracle
        candidate's; a candidate that differs is disqualified, and
        `identical` is False (a kernel fault, not a speed datum)."""
        ref = outs[oracle]

        def same(o) -> bool:
            if isinstance(ref, np.ndarray):
                return bool(np.array_equal(o, ref))
            return o == ref

        ok = {k: v for k, v in ms.items() if same(outs[k])}
        identical = len(ok) == len(ms)
        best = min(ok, key=ok.get) if ok else oracle
        kernel, dtype = best.split(":")
        return {"kernel": kernel, "dtype": dtype,
                "ms": {k: round(v, 3) for k, v in ms.items()},
                "identical": identical}


def _dist_norm(d) -> list:
    """K2 distances with the unreached sentinel normalized: it is 1 << 28
    at int32 and 1 << 14 at int16, and both mean "(M, N) not reached"."""
    return ["inf" if v >= (1 << 14) else int(v)
            for v in np.asarray(d).astype(np.int64)]


def _session_jobs(n_nodes: int, seq_len: int, max_pred: int, rows: int,
                  seed: int):
    """Linear-chain POA jobs (a sequence as its graph, and a layer with a
    10-base deletion), in the arrays the session densifies: the JAX
    package's profiling jobs."""
    rng = np.random.default_rng(seed)
    codes = np.full((rows, n_nodes), 5, dtype=np.int8)
    preds = np.full((rows, n_nodes, max_pred), -1, dtype=np.int16)
    centers = np.zeros((rows, n_nodes), dtype=np.int16)
    sinks = np.zeros((rows, n_nodes), dtype=np.uint8)
    seqs = np.full((rows, seq_len), 5, dtype=np.int8)
    lens = np.zeros(rows, dtype=np.int32)
    band = np.zeros(rows, dtype=np.int32)
    for k in range(rows):
        t_len = int(rng.integers(n_nodes // 2, n_nodes - 1))
        t = rng.integers(0, 4, t_len).astype(np.int8)
        q = np.concatenate([t[: t_len // 2], t[t_len // 2 + 10:]])
        q = q[:seq_len]
        codes[k, :t_len] = t
        preds[k, 0, 0] = 0
        preds[k, 1:t_len, 0] = np.arange(1, t_len)
        centers[k, :t_len] = np.arange(1, t_len + 1)
        sinks[k, t_len - 1] = 1
        seqs[k, : len(q)] = q
        lens[k] = len(q)
    return codes, preds, centers, sinks, seqs, lens, band


def _fused_windows(n_nodes: int, seq_len: int, depth: int, rows: int,
                   seed: int):
    """Spanning synthetic POA windows (a backbone and substitution-
    mutated layers). Substitutions only: aligned alternates cap the graph
    at 4 nodes a backbone column, so a backbone of n_nodes // 5 never
    overflows the envelope however deep the chunk, and no window leaves
    the device mid-profile."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    bb_len = max(16, min(seq_len - 8, n_nodes // 5))
    windows = []
    for _ in range(rows):
        bb = bases[rng.integers(0, 4, bb_len)].tobytes()
        win = [(bb, None, 0, 0)]
        for _ in range(depth):
            arr = np.frombuffer(bb, np.uint8).copy()
            sub = rng.random(bb_len) < 0.03
            arr[sub] = bases[rng.integers(0, 4, int(sub.sum()))]
            win.append((arr.tobytes(), None, 0, bb_len - 1))
        windows.append(win)
    return windows


def _aligner_pairs(edge: int, rows: int, seed: int):
    """Mutated (query, target) pairs filling about the bucket."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    pairs = []
    for _ in range(rows):
        n = int(rng.integers(max(2, edge // 2), edge))
        t = bases[rng.integers(0, 4, n)]
        keep = rng.random(n) >= 0.05
        sub = rng.random(n) < 0.05
        q = t.copy()
        q[sub] = bases[rng.integers(0, 4, int(sub.sum()))]
        pairs.append((q[keep].tobytes()[:edge], t.tobytes()))
    return pairs


def profile_all(at: Autotuner, scores=((3, -5, -4),),
                device: str | torch.device = "cuda",
                report=None) -> list[tuple]:
    """Profile every key the engines built with their defaults consult,
    at each (match, mismatch, gap) of `scores`, each at the width the
    engine launches it: the session engine's static grid at MAX_PRED,
    every (edge, band) the aligner's auto band rule can dispatch for the
    static edges up to MAX_PROFILED_EDGE, and the fused engine's depth
    buckets at its envelope (N, L, P). Derived shapes
    (`--cuda-adaptive-buckets`) are not covered and consult cold.
    Returns [(engine, key, entry, fresh)]; `report` is called with the
    same four as each entry lands. Save the table afterwards."""
    from ..ops.align import BatchAligner
    from ..ops.poa_fused import DEPTH_BUCKETS
    from ..ops.poa_graph import BUCKETS, MAX_LEN, MAX_NODES, MAX_PRED

    out: list[tuple] = []

    def note(engine, key, res):
        out.append((engine, key) + tuple(res))
        if report is not None:
            report(engine, key, *res)

    for m, x, g in scores:
        for nb, lb in BUCKETS:
            note("session", (nb, lb, m, x, g), at.profile_session_bucket(
                nb, lb, MAX_PRED, m, x, g, device=device))
    for edge in BatchAligner.BUCKETS:
        if edge > MAX_PROFILED_EDGE:
            break
        for band in BatchAligner.auto_bands(edge):
            note("aligner", (edge, band), at.profile_aligner_bucket(
                edge, band, device=device))
    for m, x, g in scores:
        for d in DEPTH_BUCKETS:
            note("fused_loop", (MAX_NODES, MAX_LEN, d, m, x, g),
                 at.profile_fused_bucket(MAX_NODES, MAX_LEN, d, MAX_PRED,
                                         m, x, g, device=device))
    return out


_cached: dict[str, Autotuner] = {}
_cache_lock = threading.Lock()


def get_autotuner(path: str | None = None) -> Autotuner:
    """The process's table handle for `path` (default_table_path() when
    None), loaded once per path: engines built later in the process share
    it, demotions included."""
    path = path or default_table_path()
    with _cache_lock:
        at = _cached.get(path)
        if at is None:
            at = _cached[path] = Autotuner(path)
        return at


def reset_autotuner_cache() -> None:
    """Drop the process cache (after rewriting a table on disk)."""
    with _cache_lock:
        _cached.clear()
