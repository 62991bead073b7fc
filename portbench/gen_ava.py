"""Dual all-vs-all overlaps of a seeded read set, for read correction
(racon -f): the reads of gen.from_config, and one PAF row for every
ordered pair of distinct reads whose places on the genome share at least
`min_shared` bases, as `minimap2 -x ava-ont --dual=yes` writes them: both
directions of each pair, no read against itself, rows grouped by query.

A row's coordinates are the shared stretch of the truth, carried onto each
read by linear interpolation along it (the read's length over its truth
span); a reverse-strand read is measured from its end. The relative
strand is the two reads' strands XORed. The reads file is also the
targets file.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from portbench import gen


@dataclasses.dataclass
class Rows:
    """PAF rows, each a query read, a target read and their coordinates
    on the reads as stored (numpy arrays, int64 but `strand`), in file
    order."""

    q: np.ndarray
    t: np.ndarray
    strand: np.ndarray     # bool: the query aligns reverse complemented
    q_begin: np.ndarray
    q_end: np.ndarray
    q_length: np.ndarray
    t_begin: np.ndarray
    t_end: np.ndarray

    def __len__(self) -> int:
        return len(self.q)

    def take(self, idx) -> "Rows":
        return Rows(*(getattr(self, f.name)[idx]
                      for f in dataclasses.fields(self)))


def pairs(starts: np.ndarray, ends: np.ndarray, min_shared: int):
    """(a, b), a before b by start: every pair of reads whose truth
    intervals [start, end) share at least `min_shared` bases."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    n = len(s)
    # read i (in start order) meets every later read that starts by
    # e[i] - min_shared: a run of the order
    hi = np.searchsorted(s, e - min_shared, side="right")
    count = np.maximum(hi - np.arange(1, n + 1), 0)
    first = np.repeat(np.arange(n), count)
    step = np.arange(int(count.sum())) - np.repeat(np.cumsum(count) - count,
                                                   count)
    a, b = order[first], order[first + 1 + step]
    shared = np.minimum(ends[a], ends[b]) - np.maximum(starts[a], starts[b])
    keep = shared >= min_shared
    return a[keep], b[keep]


def _on_read(ds: gen.Dataset, r: np.ndarray, lo: np.ndarray,
             hi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The truth stretch [lo, hi) on read r's own coordinates: [begin,
    end), interpolated along the read, from its end when it is reversed."""
    length = np.diff(ds.read_offsets)[r]
    s, e = ds.starts[r], ds.ends[r]
    span = e - s
    fwd_b, fwd_e = (lo - s) * length // span, (hi - s) * length // span
    rev_b, rev_e = (e - hi) * length // span, (e - lo) * length // span
    rev = ds.strands[r]
    return np.where(rev, rev_b, fwd_b), np.where(rev, rev_e, fwd_e)


def rows(ds: gen.Dataset, min_shared: int) -> Rows:
    """Every dual row of the read set, grouped by query (queries in file
    order, each query's targets in file order)."""
    a, b = pairs(ds.starts, ds.ends, min_shared)
    q = np.concatenate([a, b])
    t = np.concatenate([b, a])
    order = np.lexsort((t, q))
    q, t = q[order], t[order]
    lo = np.maximum(ds.starts[q], ds.starts[t])
    hi = np.minimum(ds.ends[q], ds.ends[t])
    q_begin, q_end = _on_read(ds, q, lo, hi)
    t_begin, t_end = _on_read(ds, t, lo, hi)
    return Rows(q=q, t=t, strand=ds.strands[q] ^ ds.strands[t],
                q_begin=q_begin, q_end=q_end,
                q_length=np.diff(ds.read_offsets)[q],
                t_begin=t_begin, t_end=t_end)


def write(ds: gen.Dataset, ovl: Rows, directory: str,
          tag: str) -> tuple[str, str, str]:
    """Writes <tag>_reads.fasta (gen.write's, byte for byte) and
    <tag>_ava.paf; returns (reads, overlaps, targets) in the CLI's order,
    the targets being the reads."""
    reads = gen.write(ds, directory, tag)[0]
    paf = os.path.join(directory, f"{tag}_ava.paf")
    lens = np.diff(ds.read_offsets)
    q_span = ovl.q_end - ovl.q_begin
    t_span = ovl.t_end - ovl.t_begin
    cols = zip(ovl.q.tolist(), ovl.q_length.tolist(), ovl.q_begin.tolist(),
               ovl.q_end.tolist(), np.where(ovl.strand, "-", "+").tolist(),
               ovl.t.tolist(), lens[ovl.t].tolist(), ovl.t_begin.tolist(),
               ovl.t_end.tolist(), np.minimum(q_span, t_span).tolist(),
               np.maximum(q_span, t_span).tolist())
    with open(paf, "w") as fh:
        fh.writelines(f"r{q}\t{ql}\t{qb}\t{qe}\t{s}\tr{t}\t{tl}\t{tb}\t{te}"
                      f"\t{m}\t{n}\t60\n"
                      for q, ql, qb, qe, s, t, tl, tb, te, m, n in cols)
    return reads, paf, reads
