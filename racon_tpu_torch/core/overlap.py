"""Overlap record between a query (read) and a target (contig).

Behavioral contract (reference src/overlap.cpp):
  - MHAP constructor: 1-based ids -> 0-based (overlap.cpp:15-27); strand is
    a_rc XOR b_rc; file's own error estimate is IGNORED and recomputed;
  - PAF constructor: names kept, strand from '-' orientation (overlap.cpp:29-42);
  - SAM constructor: full CIGAR walk deriving q_begin/q_end/q_length and
    t_end; strand flips query coordinates into the reverse-complement frame
    (overlap.cpp:44-108); 0x4 flag -> invalid record;
  - error() = 1 - min(q_span, t_span) / max(q_span, t_span)  (overlap.cpp:24-26);
  - transmute() maps names / file-local ids to global sequence indices and
    validates lengths against the loaded sequences (overlap.cpp:129-177);
  - find_breaking_points() walks the alignment path (a CIGAR, or the
    device aligner's run arrays) over a `window_length` grid on
    target coordinates, recording per-window (t, q) of the first match and
    one-past the last match (overlap.cpp:226-292). Here the walk is
    vectorized over match segments (no per-base loop).

Overlaps that arrive without a CIGAR (MHAP/PAF) are aligned by the
polisher: on the host (the edlib role) or in batches on the GPU
(ops/align.py, the GenomeWorks cudaaligner role).
"""

from __future__ import annotations

import numpy as np

from ..errors import RaconError
from ..utils.cigar import parse_cigar, match_segments


class Overlap:
    __slots__ = (
        "q_name", "q_id", "q_begin", "q_end", "q_length",
        "t_name", "t_id", "t_begin", "t_end", "t_length",
        "strand", "length", "error", "cigar", "runs",
        "is_valid", "is_transmuted", "breaking_points",
    )

    def __init__(self):
        self.q_name = ""
        self.q_id = -1
        self.q_begin = 0
        self.q_end = 0
        self.q_length = 0
        self.t_name = ""
        self.t_id = -1
        self.t_begin = 0
        self.t_end = 0
        self.t_length = 0
        self.strand = False
        self.length = 0
        self.error = 0.0
        self.cigar = b""
        # the device aligner's path as run arrays (op bytes, lengths), in
        # place of a CIGAR; None otherwise
        self.runs: tuple[np.ndarray, np.ndarray] | None = None
        self.is_valid = True
        self.is_transmuted = False
        # ndarray [k, 4]: (t_first, q_first, t_last+1, q_last+1) per window hit
        self.breaking_points: np.ndarray | None = None

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_mhap(cls, a_id: int, b_id: int, _error: float, _minmers: int,
                  a_rc: int, a_begin: int, a_end: int, a_length: int,
                  b_rc: int, b_begin: int, b_end: int, b_length: int) -> "Overlap":
        o = cls()
        o.q_id = a_id - 1
        o.q_begin, o.q_end, o.q_length = a_begin, a_end, a_length
        o.t_id = b_id - 1
        o.t_begin, o.t_end, o.t_length = b_begin, b_end, b_length
        o.strand = bool(a_rc ^ b_rc)
        o._compute_error(o.q_end - o.q_begin, o.t_end - o.t_begin)
        return o

    @classmethod
    def from_paf(cls, q_name: str, q_length: int, q_begin: int, q_end: int,
                 orientation: str, t_name: str, t_length: int, t_begin: int,
                 t_end: int, _matches: int, _aln_length: int, _mapq: int) -> "Overlap":
        o = cls()
        o.q_name = q_name
        o.q_begin, o.q_end, o.q_length = q_begin, q_end, q_length
        o.t_name = t_name
        o.t_begin, o.t_end, o.t_length = t_begin, t_end, t_length
        o.strand = orientation == "-"
        o._compute_error(o.q_end - o.q_begin, o.t_end - o.t_begin)
        return o

    @classmethod
    def from_sam(cls, q_name: str, flag: int, t_name: str, pos: int,
                 _mapq: int, cigar: bytes) -> "Overlap":
        o = cls()
        o.q_name = q_name
        o.t_name = t_name
        o.t_begin = pos - 1
        o.strand = bool(flag & 0x10)
        o.is_valid = not (flag & 0x4)
        o.cigar = cigar

        if len(cigar) < 2:
            if o.is_valid:
                raise RaconError("Overlap.from_sam", "missing alignment from SAM object!")
            return o

        ops, lens = parse_cigar(cigar)
        is_m = (ops == ord("M")) | (ops == ord("=")) | (ops == ord("X"))
        is_i = ops == ord("I")
        is_d = (ops == ord("D")) | (ops == ord("N"))
        is_clip = (ops == ord("S")) | (ops == ord("H"))

        q_aln = int(lens[is_m | is_i].sum())
        t_aln = int(lens[is_m | is_d].sum())
        q_clip = int(lens[is_clip].sum())

        # leading clip -> q_begin (reference only honors a clip that is the
        # FIRST op, overlap.cpp:60-69)
        q_begin = int(lens[0]) if len(ops) and is_clip[0] else 0

        o.q_begin = q_begin
        o.q_end = q_begin + q_aln
        o.q_length = q_clip + q_aln
        if o.strand:
            o.q_begin, o.q_end = o.q_length - o.q_end, o.q_length - o.q_begin
        o.t_end = o.t_begin + t_aln
        o.t_length = 0  # filled by transmute from the target sequence
        o._compute_error(q_aln, t_aln)
        return o

    def _compute_error(self, q_span: int, t_span: int) -> None:
        self.length = max(q_span, t_span)
        self.error = 1 - min(q_span, t_span) / float(self.length) if self.length else 0.0

    # -- id resolution ------------------------------------------------------
    def transmute(self, sequences: list, name_to_id: dict, id_to_id: dict) -> None:
        """Resolve q/t to global sequence indices (reference overlap.cpp:129-177).

        Reads are keyed `name + "q"` / `file_index << 1 | 0`; targets
        `name + "t"` / `file_index << 1 | 1`. Unknown names/ids mark the
        overlap invalid; length mismatches are fatal.
        """
        if not self.is_valid or self.is_transmuted:
            return

        if self.q_name:
            qid = name_to_id.get(self.q_name + "q")
            if qid is None:
                self.is_valid = False
                return
            self.q_id = qid
            self.q_name = ""
        else:
            qid = id_to_id.get(self.q_id << 1 | 0)
            if qid is None:
                self.is_valid = False
                return
            self.q_id = qid

        if self.q_length != len(sequences[self.q_id].data):
            raise RaconError(
                "Overlap.transmute",
                "unequal lengths in sequence and overlap file for sequence "
                f"{sequences[self.q_id].name}!",
            )

        if self.t_name:
            tid = name_to_id.get(self.t_name + "t")
            if tid is None:
                self.is_valid = False
                return
            self.t_id = tid
            self.t_name = ""
        else:
            tid = id_to_id.get(self.t_id << 1 | 1)
            if tid is None:
                self.is_valid = False
                return
            self.t_id = tid

        if self.t_length != 0 and self.t_length != len(sequences[self.t_id].data):
            raise RaconError(
                "Overlap.transmute",
                "unequal lengths in target and overlap file for target "
                f"{sequences[self.t_id].name}!",
            )
        # for SAM input the target length comes from the loaded sequence
        self.t_length = len(sequences[self.t_id].data)
        self.is_transmuted = True

    # -- alignment / windows ------------------------------------------------
    def aligned_query_span(self, sequences: list) -> bytes:
        """The query slice that aligns against target[t_begin:t_end] —
        forward or reverse-complement frame depending on strand
        (reference overlap.cpp:192-195)."""
        seq = sequences[self.q_id]
        if self.strand:
            return seq.reverse_complement[self.q_length - self.q_end:
                                          self.q_length - self.q_begin]
        return seq.data[self.q_begin:self.q_end]

    def find_breaking_points(self, sequences: list, window_length: int) -> None:
        """Compute per-window breaking points from the alignment path: the
        device aligner's run arrays (`runs`) when the overlap has them,
        else its CIGAR (SAM input, or set by the host aligner). Frees
        both."""
        if not self.is_transmuted:
            raise RaconError("Overlap.find_breaking_points", "overlap is not transmuted!")
        if self.breaking_points is not None:
            return
        if self.runs is not None:
            ops, lens = self.runs
        elif self.cigar:
            ops, lens = parse_cigar(self.cigar)
        else:
            raise RaconError(
                "Overlap.find_breaking_points",
                "no CIGAR available — overlap must be aligned first!",
            )
        self.breaking_points = self._breaking_points_of(ops, lens, window_length)
        self.cigar = b""
        self.runs = None

    def _breaking_points_of(self, ops: np.ndarray, lens: np.ndarray,
                            window_length: int) -> np.ndarray:
        """Vectorized equivalent of the per-base CIGAR walk of reference
        overlap.cpp:226-292, over the path's runs (parse_cigar's op bytes
        and lengths).

        Window w covers target positions (ends[w-1], ends[w]] where ends are
        `k*window_length - 1` grid points inside (t_begin, t_end) plus
        t_end - 1. For every window containing at least one match column the
        reference records (first_match_t, first_match_q) and
        (last_match_t + 1, last_match_q + 1).
        """
        q_start = (self.q_length - self.q_end) if self.strand else self.q_begin
        t0, q0, seg_len, _t_end, _q_end = match_segments(ops, lens, self.t_begin, q_start)

        if len(t0) == 0:
            return np.empty((0, 4), dtype=np.int64)

        # window end grid (reference overlap.cpp:229-235)
        first_grid = (self.t_begin // window_length + 1) * window_length
        grid = np.arange(first_grid, self.t_end, window_length, dtype=np.int64)
        ends = np.concatenate([grid - 1, [self.t_end - 1]])

        lo = np.concatenate([[np.iinfo(np.int64).min + 1], ends[:-1] + 1])  # window start
        hi = ends                                                            # window end

        seg_last = t0 + seg_len - 1
        # first segment whose last match >= window start
        i = np.searchsorted(seg_last, lo, side="left")
        # last segment whose first match <= window end
        j = np.searchsorted(t0, hi, side="right") - 1

        valid = (i < len(t0)) & (j >= 0) & (i <= j)
        i = np.clip(i, 0, len(t0) - 1)
        j = np.clip(j, 0, len(t0) - 1)

        first_t = np.maximum(t0[i], lo)
        last_t = np.minimum(seg_last[j], hi)
        valid &= (first_t <= hi) & (last_t >= lo)

        first_q = q0[i] + (first_t - t0[i])
        last_q = q0[j] + (last_t - t0[j])

        out = np.stack([first_t, first_q, last_t + 1, last_q + 1], axis=1)
        return out[valid]

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Overlap(q={self.q_name or self.q_id}:{self.q_begin}-{self.q_end}, "
                f"t={self.t_name or self.t_id}:{self.t_begin}-{self.t_end}, "
                f"strand={'-' if self.strand else '+'}, err={self.error:.3f})")
