"""Sequence record: read or target contig.

Behavioral contract (reference src/sequence.cpp):
  - bases are uppercased on ingest (sequence.cpp:24-27);
  - an all-'!' (all-zero Phred) quality string is dropped entirely
    (sequence.cpp:34-41) so downstream treats the record as quality-less;
  - reverse complement and reversed quality are built lazily on demand
    (sequence.cpp:49-84); non-ACGT bases are left unchanged by complementing;
  - `transmute` releases name/data/quality that later stages will not need
    (sequence.cpp:86-100).

Data and quality are stored as `bytes` (ASCII) — cheap slicing, zero-copy
views into them via memoryview where needed, and direct conversion to numpy
for device encoding.
"""

from __future__ import annotations

# A<->T, C<->G; everything else (N, IUPAC codes) maps to itself
# (reference sequence.cpp:58-75 leaves non-ACGT bases unchanged).
_COMPLEMENT = bytes(
    {ord("A"): ord("T"), ord("T"): ord("A"), ord("C"): ord("G"), ord("G"): ord("C")}.get(i, i)
    for i in range(256)
)


class Sequence:
    """A named nucleotide sequence with optional Phred+33 quality."""

    __slots__ = (
        "name",
        "data",
        "quality",
        "_reverse_complement",
        "_reverse_quality",
    )

    def __init__(self, name: str, data: bytes, quality: bytes = b""):
        self.name = name
        self.data = data.upper()
        # Drop qualities that are all-zero Phred (all '!'), reference
        # sequence.cpp:34-41: they carry no information.
        if quality and any(q != 0x21 for q in quality):
            self.quality = quality
        else:
            self.quality = b""
        self._reverse_complement: bytes | None = None
        self._reverse_quality: bytes | None = None

    # -- lazy reverse complement -------------------------------------------
    @property
    def reverse_complement(self) -> bytes:
        if self._reverse_complement is None:
            self.create_reverse_complement()
        return self._reverse_complement

    @property
    def reverse_quality(self) -> bytes:
        if self._reverse_quality is None:
            self.create_reverse_complement()
        return self._reverse_quality

    def create_reverse_complement(self) -> None:
        """Build (once) the reverse complement and reversed quality."""
        if self._reverse_complement is not None:
            return
        self._reverse_complement = self.data.translate(_COMPLEMENT)[::-1]
        self._reverse_quality = self.quality[::-1]

    def transmute(self, has_name: bool, has_data: bool, has_reverse_data: bool) -> None:
        """Free unneeded fields; precompute revcomp where overlaps need it
        (reference sequence.cpp:86-100)."""
        if not has_name:
            self.name = ""
        if has_reverse_data:
            self.create_reverse_complement()
        if not has_data:
            self.data = b""
            self.quality = b""

    def __len__(self) -> int:
        return len(self.data)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Sequence(name={self.name!r}, len={len(self.data)}, qual={bool(self.quality)})"


def create_sequence(name: str, data: bytes | str) -> Sequence:
    """Factory mirroring reference createSequence (sequence.cpp:13-17).

    Unlike the parser path, this does NOT uppercase or drop quality — it is
    used for already-polished output records (reference uses the 2-arg ctor
    at sequence.cpp:44-47 which stores data verbatim).
    """
    if isinstance(data, str):
        data = data.encode()
    seq = Sequence.__new__(Sequence)
    seq.name = name
    seq.data = data
    seq.quality = b""
    seq._reverse_complement = None
    seq._reverse_quality = None
    return seq
