"""Base-space encoding for the device kernels.

Sequences live as ASCII bytes on the host; the kernels work on int8 codes:
A=0, C=1, G=2, T=3, everything else (N, IUPAC) = 4. Code 4 compares equal
to itself, matching the reference's char-equality semantics ('N' vs 'N'
is a match for spoa/edlib). PAD=5 never matches anything, including
itself.
"""

from __future__ import annotations

import numpy as np

A, C, G, T, N, PAD = 0, 1, 2, 3, 4, 5

_LUT = np.full(256, N, dtype=np.int8)
for i, b in enumerate(b"ACGT"):
    _LUT[b] = i


def encode_padded(seqs: list[bytes], length: int) -> tuple[np.ndarray, np.ndarray]:
    """Encode a batch of sequences into a [len(seqs), length] int8 array
    padded with PAD; returns (codes, lengths)."""
    out = np.full((len(seqs), length), PAD, dtype=np.int8)
    lens = np.empty(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        n = min(len(s), length)
        out[i, :n] = _LUT[np.frombuffer(s, dtype=np.uint8)[:n]]
        lens[i] = n
    return out, lens
