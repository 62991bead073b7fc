"""Wrapper: subsample / split / multi-chunk polishing front end.

The capability of the reference's `racon_wrapper`
(scripts/racon_wrapper.py:57-147): optionally subsample the reads to a
target coverage, optionally split the target sequences into byte-bounded
chunks, then polish chunk by chunk so peak memory stays bounded; with
--num-shards/--shard-id, polish only one contiguous block of the chunks.
The port's copy of the JAX package's wrapper, byte for byte in its
output, with the port CLI's device flags (-c/--cudapoa-batches,
--cudaaligner-batches, -b/--cuda-banded-alignment, --device, --cuda-dtype,
--cuda-engine, --cuda-fused, --cuda-adaptive-buckets,
--cuda-autotune-table). The JAX wrapper arms its scheduler and names its
winner table through the environment; the port has no environment
mirror, so its wrapper takes the flags.

Differences from the reference, both deliberate:
  - rampler is the in-package racon_tpu_torch.rampler (no external
    binary, gzip-transparent);
  - chunks are polished in-process (create_polisher per chunk) instead
    of shelling out, so the kernels, built once, serve every chunk; each
    chunk runs through the dispatch pipeline at its default depth (2),
    as the JAX wrapper's chunks do.

    python -m racon_tpu_torch.wrapper -f --split 800000 --num-shards 4 \\
        --shard-id 0 -c 1 --cudaaligner-batches 1 reads ava.paf reads
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile

from . import rampler
from .device import resolve
from .errors import RaconError


def log(msg: str) -> None:
    print(f"[racon_tpu_torch::wrapper] {msg}", file=sys.stderr)


def run(sequences: str, overlaps: str, target_sequences: str,
        split: int | None = None, subsample: tuple[int, int] | None = None,
        include_unpolished: bool = False, fragment_correction: bool = False,
        window_length: int = 500, quality_threshold: float = 10.0,
        error_threshold: float = 0.3, match: int = 5, mismatch: int = -4,
        gap: int = -8, threads: int = 1, cuda_poa_batches: int = 0,
        cuda_aligner_batches: int = 0, cuda_banded_alignment: bool = False,
        device: str = "cuda", num_shards: int = 1, shard_id: int = 0,
        out=None, score_dtype: str = "auto", cuda_engine: str = "session",
        cuda_fused: str = "auto", adaptive_buckets: bool = False,
        autotune_table: str | None = None) -> list:
    """Polish `target_sequences`, optionally subsampled/split, writing
    FASTA to `out` (default stdout). Returns the chunks' polishers, their
    data freed, for their counters and phase walls.

    `num_shards`/`shard_id` scatter the work at file level: each shard
    polishes a contiguous block of the target chunks (chunks are
    byte-bounded, so blocks are balanced), and concatenating the shard
    outputs in shard order reproduces the unsharded output byte for
    byte. Needs --split so there is more than one chunk to scatter.
    `adaptive_buckets` arms every chunk's occupancy-aware scheduler;
    each chunk's polisher splits its batches over the lanes
    create_polisher gives `device` (every visible card for a bare
    'cuda') and consults the winner table at `autotune_table` (None:
    its default path)."""
    from .core.polisher import PolisherType, create_polisher

    if not (0 <= shard_id < num_shards):
        raise RaconError(
            "wrapper", f"shard_id {shard_id} outside [0, {num_shards})")
    resolve(device)  # no card: raise before any work
    out = out if out is not None else sys.stdout.buffer
    work = tempfile.mkdtemp(prefix="racon_tpu_torch_work_")
    polishers = []
    try:
        if subsample is not None:
            ref_len, coverage = subsample
            log("subsampling sequences")
            sequences = rampler.subsample(sequences, ref_len, coverage, work)

        if split is not None:
            log("splitting target sequences")
            targets = rampler.split(target_sequences, split, work)
            log(f"total number of splits: {len(targets)}")
        else:
            targets = [target_sequences]

        if num_shards > 1:
            if len(targets) < num_shards:
                # every shard must have work: an empty shard's output
                # looks like a failed run to the script that gathers them
                raise RaconError(
                    "wrapper",
                    f"num_shards {num_shards} exceeds the {len(targets)} "
                    "target chunk(s); " +
                    ("use a smaller --split size or fewer shards"
                     if split is not None else
                     "--num-shards needs --split to make chunks to scatter"))
            lo = shard_id * len(targets) // num_shards
            hi = (shard_id + 1) * len(targets) // num_shards
            log(f"shard {shard_id}/{num_shards}: chunks [{lo}, {hi}) of "
                f"{len(targets)}")
            targets = targets[lo:hi]

        for part in targets:
            polisher = create_polisher(
                sequences, overlaps, part,
                PolisherType.kF if fragment_correction else PolisherType.kC,
                window_length, quality_threshold, error_threshold, True,
                match, mismatch, gap, threads, cuda_poa_batches,
                cuda_banded_alignment, cuda_aligner_batches, device=device,
                score_dtype=score_dtype, cuda_engine=cuda_engine,
                cuda_fused=cuda_fused, adaptive_buckets=adaptive_buckets,
                autotune_table=autotune_table)
            polisher.initialize()
            for seq in polisher.polish(not include_unpolished):
                out.write(b">" + seq.name.encode() + b"\n" + seq.data + b"\n")
            out.flush()
            polishers.append(polisher)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return polishers


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="racon_tpu_torch_wrapper",
        description="racon_tpu_torch wrapper adding sequence subsampling "
                    "and target splitting for bounded memory/runtime")
    parser.add_argument("sequences")
    parser.add_argument("overlaps")
    parser.add_argument("target_sequences")
    parser.add_argument("--split", type=int,
                        help="split target sequences into chunks of given "
                             "size in bytes")
    parser.add_argument("--subsample", nargs=2, type=int,
                        metavar=("REFERENCE_LENGTH", "COVERAGE"),
                        help="subsample sequences to coverage given the "
                             "reference length")
    parser.add_argument("-u", "--include-unpolished", action="store_true")
    parser.add_argument("-f", "--fragment-correction", action="store_true",
                        help="fragment correction instead of contig "
                             "polishing (overlaps file should contain "
                             "dual/self overlaps!)")
    parser.add_argument("-w", "--window-length", type=int, default=500)
    parser.add_argument("-q", "--quality-threshold", type=float, default=10.0)
    parser.add_argument("-e", "--error-threshold", type=float, default=0.3)
    parser.add_argument("-m", "--match", type=int, default=5)
    parser.add_argument("-x", "--mismatch", type=int, default=-4)
    parser.add_argument("-g", "--gap", type=int, default=-8)
    parser.add_argument("-t", "--threads", type=int, default=1)
    parser.add_argument("-c", "--cudapoa-batches", type=int, default=0)
    parser.add_argument("--cudaaligner-batches", type=int, default=0)
    parser.add_argument("-b", "--cuda-banded-alignment", action="store_true")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="device of the GPU paths; cuda raises when no "
                             "card is present, cpu runs the kernels' plain "
                             "PyTorch versions")
    parser.add_argument("--cuda-dtype", choices=("auto", "int32", "int16"),
                        default="auto",
                        help="DP score dtype policy: auto shrinks each "
                             "bucket to int16 when its overflow envelope "
                             "proof holds (half the DP bytes, bit-identical "
                             "results) unless the autotuner table measured "
                             "int32 faster there, int32 forces the wide "
                             "oracle everywhere")
    parser.add_argument("--cuda-engine", choices=("session", "fused"),
                        default="session",
                        help="device consensus engine: per-layer "
                             "evolving-graph session or single-launch "
                             "whole-window fused")
    parser.add_argument("--cuda-fused", choices=("auto", "0", "1"),
                        default="auto",
                        help="fused-engine chunk dispatch: 1 = one launch "
                             "per chunk (device-side slicing), 0 = the "
                             "split chained path, auto = the autotuner "
                             "table's winner per depth bucket (split "
                             "where it has none)")
    parser.add_argument("--cuda-adaptive-buckets", action="store_true",
                        help="derive each device engine's shape ladder "
                             "from the run's own job shapes and pack "
                             "shape-sorted batches (occupancy-aware "
                             "scheduler); byte-identical output")
    parser.add_argument("--cuda-autotune-table", default=None,
                        metavar="FILE",
                        help="the autotuner's per-bucket winner table, "
                             "consulted under --cuda-dtype auto and "
                             "--cuda-fused auto (default: ~/.cache/"
                             "racon_tpu_torch/racon_tpu_torch_autotune.json;"
                             " a missing table changes nothing; no "
                             "end-to-end speed-up from a table is "
                             "measured yet)")
    parser.add_argument("--num-shards", type=int, default=1,
                        help="file-level scatter over the --split chunks: "
                             "total shards of this workload (cat shard "
                             "outputs in shard order to gather)")
    parser.add_argument("--shard-id", type=int, default=0,
                        help="this run's shard index in [0, num_shards)")

    args = parser.parse_args(argv)
    try:
        run(args.sequences, args.overlaps, args.target_sequences,
            split=args.split,
            subsample=tuple(args.subsample) if args.subsample else None,
            include_unpolished=args.include_unpolished,
            fragment_correction=args.fragment_correction,
            window_length=args.window_length,
            quality_threshold=args.quality_threshold,
            error_threshold=args.error_threshold,
            match=args.match, mismatch=args.mismatch, gap=args.gap,
            threads=args.threads, cuda_poa_batches=args.cudapoa_batches,
            cuda_aligner_batches=args.cudaaligner_batches,
            cuda_banded_alignment=args.cuda_banded_alignment,
            device=args.device, num_shards=args.num_shards,
            shard_id=args.shard_id, score_dtype=args.cuda_dtype,
            cuda_engine=args.cuda_engine, cuda_fused=args.cuda_fused,
            adaptive_buckets=args.cuda_adaptive_buckets,
            autotune_table=args.cuda_autotune_table)
    except RaconError as exc:
        print(str(exc), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
