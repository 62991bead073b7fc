"""Admit-time streaming ingest.

The reference's wrapper owns ingest: `racon_wrapper` subsamples reads
with rampler and `racon_preprocess` uniquifies paired-end headers before
racon sees a file. This module gives that role to the server, so a
client ships raw (optionally gzipped) FASTA/FASTQ/SAM files and opts in
per job on the submit frame:

    ingest: true                  validate only: stream-parse all three
                                  inputs on admit, so a malformed file
                                  fails the job at the door, not
                                  mid-polish
    subsample: {reference_length: int, coverage: int[, seed: int]}
                                  subsample on admit through the seeded
                                  `rampler.subsample` (deterministic)
    normalize: true               paired-end header uniquification
                                  through `preprocess.process` (mate 1
                                  -> "1", mate 2 -> "2" suffixes)

Any opt-in implies validation. All parsing streams (bounded chunks
through the port's parsers, gzip sniffed from the magic bytes), so a
read set of many GiB costs one chunk of memory on admit. Failures raise
`IngestError`, typed with the failing stage. Rewritten inputs land in
the caller's `workdir`, named by job id.
"""

from __future__ import annotations

import os

from ..errors import RaconError
from ..io.parsers import create_overlap_parser, create_sequence_parser

#: per-parse byte budget: the admit-time memory bound
CHUNK_BYTES = 4 << 20


class IngestError(RaconError):
    """A typed admit-time ingest failure. `stage` names the phase that
    failed: "spec" (malformed opt-in keys), "validate" (a parse error in
    an input file), "normalize" or "subsample"."""

    def __init__(self, stage: str, message: str):
        self.stage = stage
        super().__init__(f"serve.ingest.{stage}", message)


class IngestSpec:
    """Validated ingest opt-in parsed from a submit frame."""

    __slots__ = ("subsample", "normalize")

    def __init__(self, subsample: dict | None = None,
                 normalize: bool = False):
        self.subsample = subsample
        self.normalize = normalize

    @classmethod
    def from_request(cls, req: dict) -> "IngestSpec":
        """Parse and validate the `ingest` / `subsample` / `normalize`
        submit-frame keys. Raises IngestError("spec") on any malformed
        shape."""
        ing = req.get("ingest")
        if ing is not None and not isinstance(ing, bool):
            raise IngestError("spec", "ingest must be a boolean")
        norm = req.get("normalize")
        if norm is not None and not isinstance(norm, bool):
            raise IngestError("spec", "normalize must be a boolean")
        sub = req.get("subsample")
        if sub is not None:
            if not isinstance(sub, dict):
                raise IngestError(
                    "spec",
                    "subsample must be an object like "
                    "{reference_length, coverage}")
            unknown = set(sub) - {"reference_length", "coverage", "seed"}
            if unknown:
                raise IngestError(
                    "spec",
                    "unknown subsample key(s): "
                    f"{', '.join(sorted(unknown))}")
            for key in ("reference_length", "coverage"):
                val = sub.get(key)
                if isinstance(val, bool) or not isinstance(val, int) \
                        or val <= 0:
                    raise IngestError(
                        "spec",
                        f"subsample.{key} must be a positive integer")
            seed = sub.get("seed")
            if seed is not None and (isinstance(seed, bool)
                                     or not isinstance(seed, int)):
                raise IngestError(
                    "spec", "subsample.seed must be an integer")
        return cls(subsample=dict(sub) if sub else None,
                   normalize=bool(norm))


def _count_sequences(path: str) -> tuple[int, int]:
    """Streaming-validate one sequence file; returns (records, bytes).
    Bounded memory: each CHUNK_BYTES batch of records is discarded
    before the next is parsed."""
    try:
        parser = create_sequence_parser(path, "serve.ingest")
        records = 0
        nbytes = 0
        more = True
        while more:
            chunk: list = []
            more = parser.parse(chunk, CHUNK_BYTES)
            records += len(chunk)
            nbytes += sum(len(s.data) for s in chunk)
    except RaconError as exc:
        raise IngestError("validate", str(exc)) from None
    if records == 0:
        raise IngestError("validate", f"empty sequence file {path}!")
    return records, nbytes


def _count_overlaps(path: str) -> int:
    """Streaming-validate one overlap file; returns the record count."""
    try:
        parser = create_overlap_parser(path, "serve.ingest")
        records = 0
        more = True
        while more:
            chunk: list = []
            more = parser.parse(chunk, CHUNK_BYTES)
            records += len(chunk)
    except RaconError as exc:
        raise IngestError("validate", str(exc)) from None
    if records == 0:
        raise IngestError("validate", f"empty overlap file {path}!")
    return records


def prepare(sequences: str, overlaps: str, target: str,
            spec: IngestSpec, workdir: str, job_id: str,
            trace_id: str | None = None,
            journal=None) -> tuple[str, str, str]:
    """Run the admit-time ingest pipeline for one job: validate all
    three inputs (always), then optionally pair-normalize and/or
    subsample the reads. Returns the (sequences, overlaps, target)
    paths the job should polish: rewritten files live in `workdir`, and
    stages not asked for pass the original paths through. `journal` (an
    obs/journal.Journal) receives the `ingested` / `normalized` /
    `subsampled` lines."""
    n_reads, read_bytes = _count_sequences(sequences)
    n_targets, _ = _count_sequences(target)
    n_overlaps = _count_overlaps(overlaps)
    if journal is not None:
        journal.record("ingested", job=job_id, trace=trace_id,
                       reads=n_reads, read_bytes=read_bytes,
                       targets=n_targets, overlaps=n_overlaps)

    if spec.normalize:
        # paired-end header uniquification (preprocess.process): output
        # is FASTQ by construction (dummy qualities for FASTA input)
        from .. import preprocess

        norm_path = os.path.join(workdir, f"{job_id}_norm.fastq")
        try:
            with open(norm_path, "wb") as fh:
                preprocess.process([sequences], out=fh)
        except RaconError as exc:
            raise IngestError("normalize", str(exc)) from None
        sequences = norm_path
        if journal is not None:
            journal.record("normalized", job=job_id, trace=trace_id,
                           reads=n_reads)

    if spec.subsample is not None:
        from .. import rampler

        sub = spec.subsample
        subdir = os.path.join(workdir, job_id)
        os.makedirs(subdir, exist_ok=True)
        try:
            sub_path = rampler.subsample(
                sequences, sub["reference_length"], sub["coverage"],
                out_directory=subdir, seed=sub.get("seed"))
        except RaconError as exc:
            raise IngestError("subsample", str(exc)) from None
        reads_out, _ = _count_sequences(sub_path)
        if journal is not None:
            journal.record("subsampled", job=job_id, trace=trace_id,
                           reads_in=n_reads, reads_out=reads_out,
                           reference_length=sub["reference_length"],
                           coverage=sub["coverage"],
                           seed=sub.get("seed"))
        sequences = sub_path

    return sequences, overlaps, target
