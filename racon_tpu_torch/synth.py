"""Seeded synthetic polishing workload: a random genome, a noisy draft,
long reads with ONT-like errors (deletions, insertions and substitutions
each at rate/3), and PAF overlaps from the simulation's coordinates.

The same generator, stream for stream, as the repository's
tools/synthbench.py (`mutate`, `simulate`; Python `random`), so a seed
gives the same bytes here and there; `write_dataset` writes the
reads/overlaps/draft files the CLI takes.

    rng = random.Random(42)
    truth, draft, reads, paf = simulate(rng, 50_000, 20, 8000, 0.12, 0.10)
"""

from __future__ import annotations

import gzip
import os

ACGT = b"ACGT"


def mutate(rng, s, rate):
    out = bytearray()
    for c in s:
        r = rng.random()
        if r < rate / 3:
            continue
        if r < 2 * rate / 3:
            out.append(rng.choice(ACGT))
            out.append(c)
            continue
        if r < rate:
            out.append(rng.choice(ACGT))
            continue
        out.append(c)
    return bytes(out)


def simulate(rng, genome_len, coverage, read_len, read_err, draft_err):
    truth = bytes(rng.choice(ACGT) for _ in range(genome_len))
    draft = mutate(rng, truth, draft_err)

    reads, paf = [], []
    n_reads = genome_len * coverage // read_len
    scale = len(draft) / len(truth)
    for i in range(n_reads):
        start = rng.randrange(0, max(1, genome_len - read_len // 2))
        end = min(genome_len, start + read_len)
        fwd = mutate(rng, truth[start:end], read_err)
        strand = rng.random() < 0.5
        if strand:
            comp = bytes.maketrans(b"ACGT", b"TGCA")
            read = fwd.translate(comp)[::-1]
        else:
            read = fwd
        name = f"read{i}"
        t_begin = int(start * scale)
        t_end = min(len(draft), int(end * scale))
        reads.append((name, read))
        paf.append(f"{name}\t{len(read)}\t0\t{len(read)}\t"
                   f"{'-' if strand else '+'}\tdraft\t{len(draft)}\t"
                   f"{t_begin}\t{t_end}\t{end - start}\t{end - start}\t60")
    return truth, draft, reads, paf


def write_dataset(directory, draft, reads, paf) -> tuple[str, str, str]:
    """Write (reads.fasta.gz, ovl.paf.gz, draft.fasta.gz) as
    tools/synthbench.py does; returns their paths."""
    reads_path = os.path.join(directory, "reads.fasta.gz")
    with gzip.open(reads_path, "wb", compresslevel=1) as f:
        for name, read in reads:
            f.write(b">" + name.encode() + b"\n" + read + b"\n")
    paf_path = os.path.join(directory, "ovl.paf.gz")
    with gzip.open(paf_path, "wb", compresslevel=1) as f:
        f.write(("\n".join(paf) + "\n").encode())
    draft_path = os.path.join(directory, "draft.fasta.gz")
    with gzip.open(draft_path, "wb", compresslevel=1) as f:
        f.write(b">draft\n" + draft + b"\n")
    return reads_path, paf_path, draft_path
