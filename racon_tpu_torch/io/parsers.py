"""Streaming parsers for FASTA/FASTQ (sequences) and MHAP/PAF/SAM (overlaps),
transparently gzipped.

API mirrors the reference's bioparser contract (vendor, used at
src/polisher.cpp:86-125, 202-203, 229-231, 313); FASTA/FASTQ go through
the native zlib loader (native/src/parse.cpp):

    parser = create_sequence_parser(path, scope)
    more = parser.parse(dst, max_bytes)   # append records; False at EOF
    parser.reset()

`max_bytes` bounds the approximate in-memory size of the records appended per
call (-1 = everything), so multi-GiB read sets stream in reference-sized
chunks (kChunkSize, polisher.cpp:26). Gzip is sniffed from the magic bytes,
not the extension — extensions are validated separately by the polisher
factory exactly like the reference (polisher.cpp:83-133).
"""

from __future__ import annotations

import gzip
import io
import zlib

from ..errors import RaconError
from ..core.sequence import Sequence
from ..core.overlap import Overlap

#: what a truncated or corrupt gzip member raises mid-stream; mapped to a
#: RaconError naming the offending file so the CLI reports it cleanly
#: instead of leaking a raw traceback
_GZIP_ERRORS = (EOFError, zlib.error, gzip.BadGzipFile)


def _open(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        # decompress stream; buffer for fast line iteration
        return io.BufferedReader(gzip.GzipFile(fileobj=f), buffer_size=1 << 20)
    return io.BufferedReader(f, buffer_size=1 << 20)


class _StreamingParser:
    """Base: lazily yields records; parse() drains up to a byte budget."""

    def __init__(self, path: str):
        self.path = path
        self._file = None
        self._gen = None

    def reset(self) -> None:
        if self._file is not None:
            self._file.close()
        self._file = _open(self.path)
        self._gen = self._records(self._file)

    def parse(self, dst: list, max_bytes: int = -1) -> bool:
        """Append records to dst until ~max_bytes of payload is consumed.
        Returns True if the file may have more records, False at EOF."""
        if self._gen is None:
            self.reset()
        total = 0
        try:
            for record, nbytes in self._gen:
                dst.append(record)
                total += nbytes
                if max_bytes != -1 and total >= max_bytes:
                    return True
        except _GZIP_ERRORS as exc:
            raise RaconError(
                type(self).__name__,
                f"truncated or corrupt gzip input {self.path}! "
                f"({type(exc).__name__}: {exc})") from None
        return False

    def _records(self, f):  # pragma: no cover - abstract
        raise NotImplementedError


class MhapParser(_StreamingParser):
    """MHAP: a_id b_id error shared_minmers a_rc a_begin a_end a_length
    b_rc b_begin b_end b_length (space separated)."""

    def _records(self, f):
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            t = line.split()
            if len(t) < 12:
                raise RaconError("MhapParser", f"malformed MHAP file {self.path}!")
            o = Overlap.from_mhap(
                int(t[0]), int(t[1]), float(t[2]), int(t[3]),
                int(t[4]), int(t[5]), int(t[6]), int(t[7]),
                int(t[8]), int(t[9]), int(t[10]), int(t[11]))
            yield o, len(line)


class PafParser(_StreamingParser):
    """PAF: q_name q_len q_begin q_end strand t_name t_len t_begin t_end
    matches aln_len mapq [tags...] (tab separated; tags ignored, matching
    the reference's bioparser)."""

    def _records(self, f):
        for raw in f:
            line = raw.rstrip()
            if not line:
                continue
            t = line.split(b"\t")
            if len(t) < 12:
                raise RaconError("PafParser", f"malformed PAF file {self.path}!")
            o = Overlap.from_paf(
                t[0].decode(), int(t[1]), int(t[2]), int(t[3]),
                t[4].decode(), t[5].decode(), int(t[6]), int(t[7]),
                int(t[8]), int(t[9]), int(t[10]), int(t[11]))
            yield o, len(line)


class SamParser(_StreamingParser):
    """SAM alignments: @-header lines skipped; fields qname flag rname pos
    mapq cigar ... (tab separated)."""

    def _records(self, f):
        for raw in f:
            if raw.startswith(b"@"):
                continue
            line = raw.rstrip()
            if not line:
                continue
            t = line.split(b"\t")
            if len(t) < 11:
                raise RaconError("SamParser", f"malformed SAM file {self.path}!")
            o = Overlap.from_sam(
                t[0].decode(), int(t[1]), t[2].decode(), int(t[3]),
                int(t[4]), t[5])
            yield o, len(line)


class _NativeSequenceParser(_StreamingParser):
    """FASTA/FASTQ via the native zlib loader (native/src/parse.cpp) —
    tokenization and IO in C++, Python only wraps the record slices."""

    def __init__(self, path: str, fastq: bool):
        super().__init__(path)
        self._fastq = fastq
        self._sf = None

    def reset(self) -> None:
        from ..native import SequenceFile

        if self._sf is not None:
            self._sf.close()
        self._sf = SequenceFile(self.path, self._fastq)

    def parse(self, dst: list, max_bytes: int = -1) -> bool:
        if self._sf is None:
            self.reset()
        try:
            records, more = self._sf.chunk(max_bytes)
        except ValueError:
            if self._fastq:
                raise RaconError("FastqParser",
                                 f"malformed FASTQ file {self.path}!") from None
            raise RaconError("FastaParser",
                             f"malformed FASTA file {self.path}!") from None
        for name, seq, qual in records:
            dst.append(Sequence(name.decode(), seq, qual or b""))
        return more


_SEQUENCE_EXTENSIONS_FASTA = (".fasta", ".fasta.gz", ".fna", ".fna.gz", ".fa", ".fa.gz")
_SEQUENCE_EXTENSIONS_FASTQ = (".fastq", ".fastq.gz", ".fq", ".fq.gz")


def create_sequence_parser(path: str, scope: str) -> _StreamingParser:
    """Extension-sniffed sequence parser (reference polisher.cpp:83-99,117-133)
    over the native loader."""
    if path.endswith(_SEQUENCE_EXTENSIONS_FASTA):
        fastq = False
    elif path.endswith(_SEQUENCE_EXTENSIONS_FASTQ):
        fastq = True
    else:
        raise RaconError(scope,
            f"file {path} has unsupported format extension (valid extensions: "
            ".fasta, .fasta.gz, .fna, .fna.gz, .fa, .fa.gz, .fastq, .fastq.gz, "
            ".fq, .fq.gz)!")
    return _NativeSequenceParser(path, fastq)


def create_overlap_parser(path: str, scope: str) -> _StreamingParser:
    """Extension-sniffed overlap parser (reference polisher.cpp:101-115)."""
    if path.endswith((".mhap", ".mhap.gz")):
        return MhapParser(path)
    if path.endswith((".paf", ".paf.gz")):
        return PafParser(path)
    if path.endswith((".sam", ".sam.gz")):
        return SamParser(path)
    raise RaconError(scope,
        f"file {path} has unsupported format extension (valid extensions: "
        ".mhap, .mhap.gz, .paf, .paf.gz, .sam, .sam.gz)!")
