"""Native host library: POA engine, exact aligner, POA session, parsers.

C++ equivalents of the reference's vendored native dependencies: spoa
(POA graph + consensus), edlib (exact NW + CIGAR), the evolving-graph
session that feeds the GPU POA kernel, and a zlib FASTA/FASTQ loader.
The sources in `src/` are this package's own copy; the shared object is
built with g++ at first use into `build/native/` (git-ignored), keyed by
a hash of the sources and the host CPU, and loaded through ctypes.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import platform
import subprocess
import threading

import numpy as np

from .._build import BUILD_DIR, digest, install

_SRC = pathlib.Path(__file__).resolve().parent / "src"
_SOURCES = ("poa.cpp", "myers.cpp", "parse.cpp", "api.cpp", "session.cpp")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _host_fingerprint() -> str:
    """CPU identity for the -march=native build: a binary built on another
    machine must be rebuilt here, not SIGILL at the first AVX instruction."""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    return line
    except OSError:
        pass
    return platform.machine()


def build() -> pathlib.Path:
    """Compile the shared library if no build of these sources for this
    CPU exists yet."""
    srcs = [_SRC / s for s in _SOURCES] + [_SRC / "poa.hpp"]
    key = digest(srcs, [_host_fingerprint()])
    out_dir = BUILD_DIR / "native"
    lib = out_dir / f"libracon_host-{key}.so"
    with _lock:
        if lib.exists():
            return lib
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"{lib.name}.{os.getpid()}.tmp"
        proc = None
        # native codegen is ~20% faster on the POA DP loops; fall back
        # for toolchains without the flag
        for flags in (["-O3", "-march=native", "-funroll-loops"], ["-O3"]):
            cmd = [os.environ.get("CXX", "g++"), *flags, "-std=c++17",
                   "-fPIC", "-shared", "-pthread", "-o", str(tmp),
                   *[str(_SRC / s) for s in _SOURCES], "-lz"]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode == 0:
                break
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build failed ({' '.join(cmd)}):\n{proc.stderr}")
        install(tmp, lib)
    return lib


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p, i32p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)

        lib.rh_edit_distance.restype = i64
        lib.rh_edit_distance.argtypes = [u8p, i64, u8p, i64]
        lib.rh_nw_cigar.restype = i64
        lib.rh_nw_cigar.argtypes = [u8p, i64, u8p, i64, ctypes.c_char_p, i64]
        lib.rh_nw_cigar_batch.restype = None
        lib.rh_nw_cigar_batch.argtypes = [
            u8p, i64p, u8p, i64p, i64, i32, ctypes.c_char_p, i64, i64p,
        ]
        lib.rh_poa_batch.restype = i64
        lib.rh_poa_batch.argtypes = [
            u8p, i64p, u8p, i64p, i32p, i32p, i64p, i64,
            i32p, i32p, i64p,
            i32, i32, i32, i32,
            u8p, u32p, i64, i64p,
        ]
        vp = ctypes.c_void_p
        u8pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
        i64pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))
        lib.rh_sf_open.restype = vp
        lib.rh_sf_open.argtypes = [ctypes.c_char_p, i32]
        lib.rh_sf_chunk.restype = i64
        lib.rh_sf_chunk.argtypes = [vp, i64, ctypes.POINTER(i32),
                                    u8pp, i64pp, u8pp, i64pp, u8pp, i64pp]
        lib.rh_sf_close.restype = None
        lib.rh_sf_close.argtypes = [vp]
        i8p = ctypes.POINTER(ctypes.c_int8)
        i16p = ctypes.POINTER(ctypes.c_int16)
        lib.rh_poa_session_new.restype = i64
        lib.rh_poa_session_new.argtypes = [
            u8p, i64p, u8p, i64p, i32p, i32p, i64p, i64,
            i32, i32, i32, i32, i32, i32, i32,
        ]
        lib.rh_poa_session_prepare.restype = i32
        lib.rh_poa_session_prepare.argtypes = [
            i64, i32, i32, i32p, i32p, i32p, i32p, i32p, i32p, i32p,
            i8p, i16p, i16p, u8p, i8p,
        ]
        lib.rh_poa_session_commit.restype = None
        lib.rh_poa_session_commit.argtypes = [i64, i32, i32, i32p, i32p,
                                              i32p, i32p]
        lib.rh_poa_session_stats.restype = None
        lib.rh_poa_session_stats.argtypes = [i64, i64p]
        lib.rh_poa_session_finish.restype = i64
        lib.rh_poa_session_finish.argtypes = [i64, i32, u8p, u32p, i64,
                                              i64p, i32p]
        lib.rh_poa_session_free.restype = None
        lib.rh_poa_session_free.argtypes = [i64]
        lib.rh_poa_finish_arrays.restype = i64
        lib.rh_poa_finish_arrays.argtypes = [
            i8p, i16p, i32p, i32p, i16p, i32p, i64,
            i32, i32, i32, u8p, u32p, i64, i64p,
        ]
        _lib = lib
    return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _pack_windows(windows):
    """Flatten the poa_batch window layout into the native call arrays."""
    seq_parts, qual_parts = [], []
    seq_off = [0]
    qual_off = [0]
    begins, ends = [], []
    win_off = [0]
    for win in windows:
        for seq, qual, b, e in win:
            seq_parts.append(seq)
            seq_off.append(seq_off[-1] + len(seq))
            if qual is not None:
                qual_parts.append(qual)
                qual_off.append(qual_off[-1] + len(qual))
            else:
                qual_off.append(qual_off[-1])
            begins.append(b)
            ends.append(e)
        win_off.append(win_off[-1] + len(win))
    return (
        np.frombuffer(b"".join(seq_parts) or b"\x00", dtype=np.uint8),
        np.asarray(seq_off, dtype=np.int64),
        np.frombuffer(b"".join(qual_parts) or b"\x00", dtype=np.uint8),
        np.asarray(qual_off, dtype=np.int64),
        np.asarray(begins, dtype=np.int32),
        np.asarray(ends, dtype=np.int32),
        np.asarray(win_off, dtype=np.int64),
    )


class PoaSession:
    """Round-based evolving-graph POA session (the host half of the GPU
    consensus engine — see src/session.cpp and ops/poa_graph.py).

    Lifecycle: construct with the full window batch, then loop
    `prepare()` -> run the returned jobs on the device -> `commit()`
    until prepare returns None, then `finish()`.
    """

    def __init__(self, windows, match: int, mismatch: int, gap: int,
                 max_nodes: int, max_pred: int, max_len: int,
                 max_jobs: int = 256, banded_only: bool = False,
                 n_threads: int = 1):
        self._lib = get_lib()
        self.n_windows = len(windows)
        self.max_nodes = max_nodes
        self.max_pred = max_pred
        self.max_len = max_len
        self.max_jobs = max_jobs
        self.n_threads = n_threads
        packed = _pack_windows(windows)
        self._total_seq_bytes = int(packed[1][-1])
        i32, u8 = ctypes.c_int32, ctypes.c_uint8
        self._handle = int(self._lib.rh_poa_session_new(
            _ptr(packed[0], u8), _ptr(packed[1], ctypes.c_int64),
            _ptr(packed[2], u8), _ptr(packed[3], ctypes.c_int64),
            _ptr(packed[4], i32), _ptr(packed[5], i32),
            _ptr(packed[6], ctypes.c_int64), self.n_windows,
            match, mismatch, gap, max_nodes, max_pred, max_len,
            1 if banded_only else 0))
        J, N, P, L = max_jobs, max_nodes, max_pred, max_len
        self._buf = {
            "win": np.empty(J, dtype=np.int32),
            "layer": np.empty(J, dtype=np.int32),
            "band": np.empty(J, dtype=np.int32),
            "nnodes": np.empty(J, dtype=np.int32),
            "len": np.empty(J, dtype=np.int32),
            "origin": np.empty(J, dtype=np.int32),
            "maxpred": np.empty(J, dtype=np.int32),
            "codes": np.empty((J, N), dtype=np.int8),
            "preds": np.empty((J, N, P), dtype=np.int16),
            "centers": np.empty((J, N), dtype=np.int16),
            "sinks": np.empty((J, N), dtype=np.uint8),
            "seqs": np.empty((J, L), dtype=np.int8),
        }

    def prepare(self, max_jobs: int | None = None):
        """Returns a dict of job arrays (buffers reused across calls — the
        caller must consume/copy before the next prepare) with key "n" =
        job count, or None when no window is ready. `max_jobs` limits this
        call (defaults to the buffer capacity)."""
        b = self._buf
        i32, i8, u8 = ctypes.c_int32, ctypes.c_int8, ctypes.c_uint8
        i16 = ctypes.c_int16
        want = self.max_jobs if max_jobs is None else min(max_jobs,
                                                          self.max_jobs)
        n = int(self._lib.rh_poa_session_prepare(
            self._handle, want, self.n_threads,
            _ptr(b["win"], i32), _ptr(b["layer"], i32), _ptr(b["band"], i32),
            _ptr(b["nnodes"], i32), _ptr(b["len"], i32),
            _ptr(b["origin"], i32), _ptr(b["maxpred"], i32),
            _ptr(b["codes"], i8), _ptr(b["preds"], i16),
            _ptr(b["centers"], i16), _ptr(b["sinks"], u8),
            _ptr(b["seqs"], i8)))
        if n <= 0:
            return None
        return dict(b, n=n)

    def commit(self, win, layer, band, ranks):
        """Commit device results for one dispatched batch. win/layer/band:
        int32 arrays snapshotted at dispatch; ranks: [n, lb] int32 node
        ranks (-1 insertion)."""
        n = len(win)
        win = np.ascontiguousarray(win, dtype=np.int32)
        layer = np.ascontiguousarray(layer, dtype=np.int32)
        band = np.ascontiguousarray(band, dtype=np.int32)
        full = np.full((n, self.max_len), -2, dtype=np.int32)
        full[:, :ranks.shape[1]] = ranks[:n]
        i32 = ctypes.c_int32
        self._lib.rh_poa_session_commit(
            self._handle, n, self.n_threads, _ptr(win, i32),
            _ptr(layer, i32), _ptr(band, i32), _ptr(full, i32))

    def stats(self) -> dict:
        """Session counters: jobs prepared, layers committed, banded
        clipped->full-DP redos, unfit (host-fallback) windows."""
        out = np.zeros(4, dtype=np.int64)
        self._lib.rh_poa_session_stats(self._handle,
                                       _ptr(out, ctypes.c_int64))
        return {"prepared": int(out[0]), "committed": int(out[1]),
                "redos": int(out[2]), "unfit": int(out[3])}

    def finish(self, n_threads: int = 1):
        """Generate consensus for every window. Returns (results, statuses):
        results like poa_batch's [(consensus bytes, coverages array)];
        statuses[w] = 0 device-built, 1 host fallback, 2 backbone-only."""
        cons_cap = 2 * self._total_seq_bytes + 64 * self.n_windows
        cons_off = np.empty(self.n_windows + 1, dtype=np.int64)
        statuses = np.empty(self.n_windows, dtype=np.int32)
        u8, u32 = ctypes.c_uint8, ctypes.c_uint32
        while True:
            cons_data = np.empty(cons_cap, dtype=np.uint8)
            cov_data = np.empty(cons_cap, dtype=np.uint32)
            total = int(self._lib.rh_poa_session_finish(
                self._handle, n_threads, _ptr(cons_data, u8),
                _ptr(cov_data, u32), cons_cap,
                _ptr(cons_off, ctypes.c_int64),
                _ptr(statuses, ctypes.c_int32)))
            if total >= 0:
                break
            cons_cap = -total
        out = []
        for w in range(self.n_windows):
            a, b = int(cons_off[w]), int(cons_off[w + 1])
            out.append((cons_data[a:b].tobytes(), cov_data[a:b].copy()))
        return out, statuses

    def close(self):
        if self._handle:
            self._lib.rh_poa_session_free(self._handle)
            self._handle = 0

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def poa_finish_arrays(codes, preds, predw, nseq, col_of, colkey, n_nodes,
                      n_threads: int = 1):
    """Consensus + coverages from the fused engine's fetched graph arrays
    (ops/poa_fused.py) through the exact host heaviest-bundle
    (rh_poa_finish_arrays). Returns [(consensus bytes, coverages)] per
    window. `colkey` is taken for the interface's symmetry: the columns
    are grouped by col_of alone."""
    lib = get_lib()
    B, N = codes.shape
    P = preds.shape[2]
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    preds = np.ascontiguousarray(preds, dtype=np.int16)
    predw = np.ascontiguousarray(predw, dtype=np.int32)
    nseq = np.ascontiguousarray(nseq, dtype=np.int32)
    col_of = np.ascontiguousarray(col_of, dtype=np.int16)
    n_nodes = np.ascontiguousarray(n_nodes, dtype=np.int32)
    cons_cap = int(n_nodes.sum()) + 64 * B + 64
    cons_off = np.empty(B + 1, dtype=np.int64)
    i8, i16, i32 = ctypes.c_int8, ctypes.c_int16, ctypes.c_int32
    u8, u32 = ctypes.c_uint8, ctypes.c_uint32
    while True:
        cons_data = np.empty(cons_cap, dtype=np.uint8)
        cov_data = np.empty(cons_cap, dtype=np.uint32)
        total = int(lib.rh_poa_finish_arrays(
            _ptr(codes, i8), _ptr(preds, i16), _ptr(predw, i32),
            _ptr(nseq, i32), _ptr(col_of, i16), _ptr(n_nodes, i32),
            B, N, P, n_threads,
            _ptr(cons_data, u8), _ptr(cov_data, u32), cons_cap,
            _ptr(cons_off, ctypes.c_int64)))
        if total >= 0:
            break
        cons_cap = -total
    out = []
    for w in range(B):
        a, b = int(cons_off[w]), int(cons_off[w + 1])
        out.append((cons_data[a:b].tobytes(), cov_data[a:b].copy()))
    return out


class SequenceFile:
    """Streaming native FASTA/FASTQ reader (the bioparser role). Yields
    per-chunk flat buffers; see io/parsers.py for the record wrapper."""

    def __init__(self, path: str, fastq: bool):
        self._lib = get_lib()
        self._path = path
        self._fastq = fastq
        self._handle = self._lib.rh_sf_open(path.encode(), 1 if fastq else 0)
        if not self._handle:
            raise OSError(f"cannot open {path}")

    def chunk(self, max_bytes: int = -1):
        """Returns (records, more) where records is a list of
        (name_bytes, seq_bytes, qual_bytes|None). Raises ValueError on
        malformed input."""
        i32 = ctypes.c_int32
        more = i32(0)
        names = ctypes.POINTER(ctypes.c_uint8)()
        seqs = ctypes.POINTER(ctypes.c_uint8)()
        quals = ctypes.POINTER(ctypes.c_uint8)()
        name_offs = ctypes.POINTER(ctypes.c_int64)()
        seq_offs = ctypes.POINTER(ctypes.c_int64)()
        qual_offs = ctypes.POINTER(ctypes.c_int64)()
        n = self._lib.rh_sf_chunk(
            self._handle, max_bytes, ctypes.byref(more),
            ctypes.byref(names), ctypes.byref(name_offs),
            ctypes.byref(seqs), ctypes.byref(seq_offs),
            ctypes.byref(quals), ctypes.byref(qual_offs))
        if n < 0:
            raise ValueError(f"malformed input {self._path}")
        records = []
        for i in range(n):
            name = ctypes.string_at(
                ctypes.addressof(names.contents) + name_offs[i],
                name_offs[i + 1] - name_offs[i])
            seq = ctypes.string_at(
                ctypes.addressof(seqs.contents) + seq_offs[i],
                seq_offs[i + 1] - seq_offs[i])
            qlen = qual_offs[i + 1] - qual_offs[i]
            qual = (ctypes.string_at(
                ctypes.addressof(quals.contents) + qual_offs[i], qlen)
                if qlen else None)
            records.append((name, seq, qual))
        return records, bool(more.value)

    def close(self):
        if self._handle:
            self._lib.rh_sf_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def _u8(data: bytes | np.ndarray):
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else data
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr


def edit_distance(a: bytes, b: bytes) -> int:
    """Exact edit distance (Myers bit-parallel NW) — the metric role edlib
    plays in the reference's tests."""
    lib = get_lib()
    pa, ka = _u8(a)
    pb, kb = _u8(b)
    return int(lib.rh_edit_distance(pa, len(a), pb, len(b)))


def nw_cigar(query: bytes, target: bytes) -> bytes:
    """Global alignment CIGAR of query vs target, unit costs — the edlib NW
    path role (reference src/overlap.cpp:205-224)."""
    lib = get_lib()
    pq, kq = _u8(query)
    pt, kt = _u8(target)
    cap = 4 * (len(query) + len(target)) + 64
    buf = ctypes.create_string_buffer(cap)
    n = int(lib.rh_nw_cigar(pq, len(query), pt, len(target), buf, cap))
    if n < 0:
        raise RuntimeError("rh_nw_cigar failed")
    return buf.raw[:n]


def nw_cigar_batch(pairs, n_threads: int = 1, progress=None,
                   chunk: int = 256):
    """Globally align many (query, target) pairs on the host thread pool.

    Returns a list of CIGAR bytes (parallel to `pairs`). `progress(n)` is
    called after each internal chunk completes.
    """
    lib = get_lib()
    out: list[bytes | None] = [None] * len(pairs)
    for s in range(0, len(pairs), chunk):
        part = pairs[s:s + chunk]
        q_off = np.zeros(len(part) + 1, dtype=np.int64)
        t_off = np.zeros(len(part) + 1, dtype=np.int64)
        for i, (q, t) in enumerate(part):
            q_off[i + 1] = q_off[i] + len(q)
            t_off[i + 1] = t_off[i] + len(t)
        q_data = np.frombuffer(b"".join(q for q, _ in part) or b"\x00",
                               dtype=np.uint8)
        t_data = np.frombuffer(b"".join(t for _, t in part) or b"\x00",
                               dtype=np.uint8)
        slot = 4 * int(max(q_off[-1] // max(len(part), 1),
                           t_off[-1] // max(len(part), 1)) + 1) + 64
        lens = np.empty(len(part), dtype=np.int64)
        buf = ctypes.create_string_buffer(slot * len(part))
        lib.rh_nw_cigar_batch(
            q_data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            q_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            t_data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            t_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(part), n_threads, buf, slot,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        raw = buf.raw
        for i in range(len(part)):
            if lens[i] >= 0:
                out[s + i] = raw[i * slot:i * slot + int(lens[i])]
            else:
                # slot overflow for this pair only: re-align it singly
                out[s + i] = nw_cigar(*part[i])
        if progress is not None:
            progress(len(part))
    return out


def poa_batch(windows, match: int, mismatch: int, gap: int,
              n_threads: int = 1):
    """Batched per-window POA consensus on the host.

    Args:
      windows: list of windows; each is a list of (seq_bytes, qual_bytes|None,
        begin, end) with element 0 the backbone.

    Returns:
      list of (consensus bytes, coverages uint32 array) per window.
    """
    lib = get_lib()
    n_windows = len(windows)
    if n_windows == 0:
        return []

    (seq_data, seq_off_a, qual_data, qual_off_a, begins_a, ends_a,
     win_off_a) = _pack_windows(windows)

    cons_cap = 2 * int(seq_off_a[-1]) + 64 * n_windows
    cons_off = np.empty(n_windows + 1, dtype=np.int64)
    while True:
        cons_data = np.empty(cons_cap, dtype=np.uint8)
        cov_data = np.empty(cons_cap, dtype=np.uint32)
        total = int(lib.rh_poa_batch(
            seq_data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            seq_off_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            qual_data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            qual_off_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            begins_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ends_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            win_off_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_windows,
            None, None, None,
            match, mismatch, gap, n_threads,
            cons_data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            cov_data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            cons_cap,
            cons_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ))
        if total >= 0:
            break
        cons_cap = -total

    out = []
    for w in range(n_windows):
        a, b = int(cons_off[w]), int(cons_off[w + 1])
        out.append((cons_data[a:b].tobytes(), cov_data[a:b].copy()))
    return out
