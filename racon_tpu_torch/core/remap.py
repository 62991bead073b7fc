"""In-process re-overlap for polishing rounds (`Polisher.redraft`).

The port's copy of the JAX package's racon_tpu/core/remap.py, the same
algorithm, tie-breaks and PAF bytes. Round k+1 needs read-to-draft
overlaps against round k's freshly stitched contigs; the external
workflow would run a mapper (minimap2) here. This module is the
in-process replacement: a deterministic k-mer anchor mapper whose PAF
rows `io/parsers.PafParser` and `core/overlap.Overlap.from_paf` read.

It is not a general-purpose aligner. It uses the structure a polishing
round has: round k's contigs are a lightly edited copy of the draft the
reads already mapped to, so every read still anchors on one diagonal
with many exact k-mers (at 5% divergence about 0.46 of the 15-mers
survive: hundreds of anchors a read). The algorithm:

  1. index every target k-mer position (k-mers above `max_occ`
     occurrences are dropped, the usual repeat filter);
  2. per read and strand, collect (target, diagonal, qpos, tpos)
     anchors and vote them into `band`-wide diagonal buckets;
  3. the winning bucket pair (a bucket and its right neighbour, so a
     band boundary cannot split a chain) defines the overlap: begins
     and ends are the anchor extremes, so every coordinate lies inside
     its sequence and `q_length` / `t_length` are exact, the two
     invariants `Overlap.transmute` checks.

Deterministic: no RNG, no per-process hash seeds, explicit tie-breaks
(score descending, then target order, then diagonal), so the same
inputs give the same PAF bytes in both packages."""

from __future__ import annotations

_COMP = bytes.maketrans(b"ACGTUacgtuNnKkMmRrYySsWwBbVvHhDd",
                        b"TGCAAtgcaaNnMmKkYyRrSsWwVvBbDdHh")

#: defaults sized for the read-vs-polished-draft regime (see module
#: docstring); k=15 matches the minimap2 map-ont preset's seed length
DEFAULT_K = 15
DEFAULT_BAND = 64
DEFAULT_MIN_ANCHORS = 2
DEFAULT_MAX_OCC = 64


def revcomp(data: bytes) -> bytes:
    return data.translate(_COMP)[::-1]


def build_index(targets, k: int = DEFAULT_K,
                max_occ: int = DEFAULT_MAX_OCC) -> dict:
    """k-mer -> [(target_index, position)] over every target, minus
    k-mers occurring more than `max_occ` times (repeats would vote for
    every copy of themselves and drown the true diagonal)."""
    index: dict[bytes, list] = {}
    for tid, t in enumerate(targets):
        data = t.data
        for pos in range(len(data) - k + 1):
            index.setdefault(data[pos:pos + k], []).append((tid, pos))
    if max_occ > 0:
        for km in [km for km, v in index.items() if len(v) > max_occ]:
            del index[km]
    return index


def _best_group(data: bytes, index: dict, k: int, band: int):
    """The densest (target, diagonal-bucket) anchor group for one
    oriented read: (score, tid, bucket, anchors) or None. Score counts
    anchors in the bucket plus its right neighbor, so a chain that
    straddles a bucket boundary still wins whole."""
    groups: dict[tuple, list] = {}
    for qpos in range(len(data) - k + 1):
        for tid, tpos in index.get(data[qpos:qpos + k], ()):
            groups.setdefault((tid, (tpos - qpos) // band),
                              []).append((qpos, tpos))
    best = None
    for (tid, b), hits in sorted(groups.items()):
        merged = hits + groups.get((tid, b + 1), [])
        score = len(merged)
        # strict > : ties resolve to the sorted-first (tid, bucket)
        if best is None or score > best[0]:
            best = (score, tid, b, merged)
    return best


def remap_read(read, targets, index: dict, k: int = DEFAULT_K,
               band: int = DEFAULT_BAND,
               min_anchors: int = DEFAULT_MIN_ANCHORS) -> str | None:
    """One read's best overlap as a PAF row (or None when the read no
    longer anchors anywhere — it simply stops contributing layers,
    matching how an external mapper would drop it)."""
    fwd = _best_group(read.data, index, k, band)
    rev = _best_group(revcomp(read.data), index, k, band)
    strand, best = "+", fwd
    if rev is not None and (best is None or rev[0] > best[0]):
        strand, best = "-", rev
    if best is None or best[0] < min_anchors:
        return None
    score, tid, _b, anchors = best
    q0 = min(a[0] for a in anchors)
    q1 = max(a[0] for a in anchors) + k
    t0 = min(a[1] for a in anchors)
    t1 = max(a[1] for a in anchors) + k
    q_len = len(read.data)
    if strand == "-":
        # anchors live in the reverse-complement frame; PAF '-' rows
        # carry query coordinates in the FORWARD read frame
        q0, q1 = q_len - q1, q_len - q0
    matches = min(score * k, q1 - q0, t1 - t0)
    aln_len = max(q1 - q0, t1 - t0)
    # stitched contigs carry " LN:i:.. RC:i:.. XC:f:.." name tags, but
    # a FASTA re-parse keeps only the first token — the PAF target name
    # must match THAT or Overlap.transmute drops every row
    t_name = targets[tid].name.split(None, 1)[0]
    return "\t".join(map(str, (
        read.name, q_len, q0, q1, strand,
        t_name, len(targets[tid].data), t0, t1,
        matches, aln_len, 60)))


def remap_overlaps(reads, targets, k: int = DEFAULT_K,
                   band: int = DEFAULT_BAND,
                   min_anchors: int = DEFAULT_MIN_ANCHORS,
                   max_occ: int = DEFAULT_MAX_OCC) -> list[str]:
    """PAF rows for every read that anchors on some target (one best
    hit per read — the kC overlap filter keeps the longest per query
    anyway). Deterministic: same inputs, same rows, same order."""
    index = build_index(targets, k, max_occ)
    rows: list[str] = []
    for read in reads:
        row = remap_read(read, targets, index, k, band, min_anchors)
        if row is not None:
            rows.append(row)
    return rows


def write_paf(rows: list[str], path: str) -> str:
    """Write PAF rows (the extension must be `.paf` — that is what
    routes `create_overlap_parser` to the PAF reader)."""
    with open(path, "w") as fh:
        for row in rows:
            fh.write(row + "\n")
    return path


def write_fasta(sequences, path: str) -> str:
    """Write sequences as plain FASTA, the exact byte shape the serve
    layer streams (`>` + full tagged name + newline + data + newline)."""
    with open(path, "wb") as fh:
        for s in sequences:
            fh.write(b">" + s.name.encode() + b"\n" + s.data + b"\n")
    return path
