"""CIGAR string utilities.

A CIGAR is a run-length encoded alignment path: `<count><op>` pairs where op is
one of M/=/X (match columns), I (insertion to query), D/N (deletion from query),
S/H (clips), P (padding). Parsed once into parallel numpy arrays so downstream
walks (SAM span derivation, breaking-point extraction) are vectorized instead
of per-base loops (reference walks per base: src/overlap.cpp:60-108,244-292).
"""

from __future__ import annotations

import re

import numpy as np

_CIGAR_RE = re.compile(rb"(\d+)([MIDNSHP=X])")

# op codes used internally
OP_TO_CODE = {
    ord("M"): 0, ord("="): 0, ord("X"): 0,  # consume query + target
    ord("I"): 1,                              # consume query
    ord("D"): 2, ord("N"): 2,                 # consume target
    ord("S"): 3, ord("H"): 3,                 # clip (consume neither, here)
    ord("P"): 4,                              # padding
}


def parse_cigar(cigar: bytes | str) -> tuple[np.ndarray, np.ndarray]:
    """Parse CIGAR into (ops, lengths) int arrays. ops are raw ASCII codes."""
    if isinstance(cigar, str):
        cigar = cigar.encode()
    matches = _CIGAR_RE.findall(cigar)
    n = len(matches)
    ops = np.empty(n, dtype=np.uint8)
    lens = np.empty(n, dtype=np.int64)
    for i, (num, op) in enumerate(matches):
        ops[i] = op[0]
        lens[i] = int(num)
    return ops, lens


def match_segments(ops: np.ndarray, lens: np.ndarray, t_start: int, q_start: int):
    """Return (t0, q0, length) arrays — the maximal runs of M/=/X columns —
    plus final (t_end, q_end) pointers, walking the CIGAR from (t_start,
    q_start). Coordinates are 0-based; a segment covers target positions
    [t0, t0+len) paired with query positions [q0, q0+len)."""
    is_m = (ops == ord("M")) | (ops == ord("=")) | (ops == ord("X"))
    is_q = is_m | (ops == ord("I"))
    is_t = is_m | (ops == ord("D")) | (ops == ord("N"))

    dq = np.where(is_q, lens, 0)
    dt = np.where(is_t, lens, 0)
    # coordinate BEFORE each run
    q_at = q_start + np.concatenate(([0], np.cumsum(dq)[:-1]))
    t_at = t_start + np.concatenate(([0], np.cumsum(dt)[:-1]))

    t0 = t_at[is_m]
    q0 = q_at[is_m]
    seg_len = lens[is_m]
    t_end = t_start + int(dt.sum())
    q_end = q_start + int(dq.sum())
    return t0, q0, seg_len, t_end, q_end
