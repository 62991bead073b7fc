"""Paired-end FASTQ header uniquifier: the racon_preprocess role.

Illumina paired-end runs give both mates the same header up to the first
whitespace; racon needs unique names. Like the reference script
(scripts/racon_preprocess.py:11-60): the first occurrence of a name gets
'1' appended, the second '2'; output is FASTQ on stdout. Takes one or two
input files (gzip-transparent, multi-line records through the port's
parser). The port's copy of the JAX package's preprocess, byte for byte
in its output.

    python -m racon_tpu_torch.preprocess mates_1.fastq mates_2.fastq
"""

from __future__ import annotations

import argparse
import sys

from .errors import RaconError
from .io.parsers import create_sequence_parser


def process(paths: list[str], out=None) -> None:
    out = out if out is not None else sys.stdout.buffer
    seen: dict[str, int] = {}
    for path in paths:
        seqs: list = []
        create_sequence_parser(path, "preprocess").parse(seqs, -1)
        for s in seqs:
            name = s.name.split(" ")[0]
            # occurrence index: mate 1 -> "1", mate 2 -> "2"; further
            # repeats keep counting up so names stay unique
            count = seen.get(name, 0) + 1
            seen[name] = count
            name += str(count)
            qual = s.quality if s.quality else b"!" * len(s.data)
            out.write(b"@" + name.encode() + b"\n" + s.data + b"\n+\n"
                      + qual + b"\n")
    out.flush()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="racon_tpu_torch_preprocess",
        description="uniquify paired-end read headers for racon_tpu_torch")
    parser.add_argument("first")
    parser.add_argument("second", nargs="?")
    args = parser.parse_args(argv)
    paths = [args.first] + ([args.second] if args.second else [])
    try:
        process(paths)
    except RaconError as exc:
        print(str(exc), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
