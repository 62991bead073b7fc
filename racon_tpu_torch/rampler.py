"""Sequence subsampling and splitting: the rampler role.

The reference wrapper shells out to the vendored `rampler` binary for two
operations (scripts/racon_wrapper.py:62-63,87-88):

  subsample <sequences> <reference_length> <coverage>
      randomly sample reads until their total length reaches
      reference_length * coverage; written as `<base>_<coverage>x.<ext>`.
  split <sequences> <chunk_size>
      partition the sequences into consecutive chunks of at most
      `chunk_size` bytes of sequence data, written as `<base>_<i>.<ext>`.

The port's copy of the JAX package's rampler: the same seed order, file
names and bytes, over the port's own parsers (gzip-transparent); it
writes plain FASTA/FASTQ.

    python -m racon_tpu_torch.rampler -o out split reads.fasta.gz 800000
"""

from __future__ import annotations

import os
import random
import sys

from .errors import RaconError
from .io.parsers import create_sequence_parser


def _load(path: str):
    seqs: list = []
    create_sequence_parser(path, "rampler").parse(seqs, -1)
    return seqs


def _base_and_ext(path: str) -> tuple[str, str]:
    base = os.path.basename(path).split(".")[0]
    is_fasta = any(path.endswith(e) for e in
                   (".fasta", ".fasta.gz", ".fa", ".fa.gz",
                    ".fna", ".fna.gz"))
    return base, (".fasta" if is_fasta else ".fastq")


def _write(path: str, seqs, ext: str) -> None:
    with open(path, "wb") as f:
        for s in seqs:
            if ext == ".fastq" and s.quality:
                f.write(b"@" + s.name.encode() + b"\n" + s.data + b"\n+\n"
                        + s.quality + b"\n")
            else:
                f.write(b">" + s.name.encode() + b"\n" + s.data + b"\n")


def _resolve_seed(seed: int | None) -> int:
    """Explicit `seed=` wins; RACON_TPU_SUBSAMPLE_SEED next; 17 last. A
    value there that is not an integer is an error: a silently random
    subsample is the nondeterminism the seed exists to prevent."""
    if seed is not None:
        return int(seed)
    raw = os.environ.get("RACON_TPU_SUBSAMPLE_SEED")
    if raw is None:
        return 17
    try:
        return int(raw)
    except ValueError:
        raise RaconError(
            "rampler.subsample",
            f"invalid RACON_TPU_SUBSAMPLE_SEED {raw!r} (want an "
            "integer)!") from None


def subsample(sequences_path: str, reference_length: int, coverage: int,
              out_directory: str = ".", seed: int | None = None) -> str:
    """Random subsample to ~reference_length * coverage total bases, in
    input order. Returns the output path `<base>_<coverage>x.<ext>`. The
    shuffle is seeded (see _resolve_seed), so the same inputs and seed
    pick the same reads."""
    seed = _resolve_seed(seed)
    seqs = _load(sequences_path)
    base, ext = _base_and_ext(sequences_path)
    if ext == ".fastq" and not all(s.quality for s in seqs):
        ext = ".fasta"

    target = reference_length * coverage
    order = list(range(len(seqs)))
    random.Random(seed).shuffle(order)
    picked = []
    total = 0
    for i in order:
        if total >= target:
            break
        picked.append(i)
        total += len(seqs[i].data)
    picked.sort()

    out = os.path.join(out_directory, f"{base}_{coverage}x{ext}")
    _write(out, [seqs[i] for i in picked], ext)
    return out


def split(sequences_path: str, chunk_size: int,
          out_directory: str = ".") -> list[str]:
    """Partition into consecutive chunks of <= chunk_size sequence bytes
    (any sequence longer than chunk_size gets its own chunk). Returns the
    output paths `<base>_<i>.<ext>`."""
    if chunk_size <= 0:
        raise RaconError("rampler.split", "invalid chunk size!")
    seqs = _load(sequences_path)
    base, ext = _base_and_ext(sequences_path)

    outs: list[str] = []
    chunk: list = []
    chunk_bytes = 0
    for s in seqs:
        if chunk and chunk_bytes + len(s.data) > chunk_size:
            out = os.path.join(out_directory, f"{base}_{len(outs)}{ext}")
            _write(out, chunk, ext)
            outs.append(out)
            chunk, chunk_bytes = [], 0
        chunk.append(s)
        chunk_bytes += len(s.data)
    if chunk:
        out = os.path.join(out_directory, f"{base}_{len(outs)}{ext}")
        _write(out, chunk, ext)
        outs.append(out)
    return outs


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="racon_tpu_torch_rampler",
        description="sequence subsampling/splitting (rampler equivalent)")
    parser.add_argument("-o", "--out-directory", default=".")
    sub = parser.add_subparsers(dest="mode", required=True)
    p_sub = sub.add_parser("subsample")
    p_sub.add_argument("sequences")
    p_sub.add_argument("reference_length", type=int)
    p_sub.add_argument("coverage", type=int)
    p_sub.add_argument("--seed", type=int, default=None,
                       help="shuffle seed (default: "
                            "RACON_TPU_SUBSAMPLE_SEED, else 17)")
    p_spl = sub.add_parser("split")
    p_spl.add_argument("sequences")
    p_spl.add_argument("chunk_size", type=int)

    args = parser.parse_args(argv)
    try:
        if args.mode == "subsample":
            subsample(args.sequences, args.reference_length, args.coverage,
                      args.out_directory, seed=args.seed)
        else:
            split(args.sequences, args.chunk_size, args.out_directory)
    except RaconError as exc:
        print(str(exc), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
