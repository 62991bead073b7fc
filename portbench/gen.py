"""Seeded polishing data in bulk numpy: a random genome, a draft with a
miniasm-like error, long reads with ONT-like errors, one PAF row a read.

The error model is racon_tpu_torch/synth.py's (`mutate`): each base is
deleted, gets a random base inserted before it, or is replaced by a random
base (which may be the same base), each with probability rate/3. The draws
differ: synth.py walks every base in Python, which takes minutes at E. coli
scale; here one call of numpy does each step over the whole read set.

Read lengths are log-normal. They and the reads' places on the genome come
from a stream fixed by the configuration, not by the run's seed: every
seed polishes reads of the same lengths at the same places, so a seed
changes the bases, the errors and the strands, and not the amount of work.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
#: the stream the read lengths and places come from (with the dataset's
#: index)
LENGTH_STREAM = 0x5EED
#: read bases a generator chunk holds, and the threads that make them
CHUNK_BASES = 1 << 23
THREADS = 6


@dataclasses.dataclass
class Dataset:
    """One polishing input: the truth and draft as base codes (0..3), the
    reads' bases and where each came from, and the PAF rows."""

    truth: np.ndarray          # uint8 codes [G]
    draft: np.ndarray          # uint8 codes [D]
    draft_of_truth: np.ndarray  # int64 [G + 1]: truth position -> draft
    read_codes: np.ndarray     # uint8 codes, every read back to back
    read_offsets: np.ndarray   # int64 [R + 1]
    starts: np.ndarray         # int64 [R] truth start of each read
    ends: np.ndarray           # int64 [R] truth end
    strands: np.ndarray        # bool [R]: reverse complement
    t_begins: np.ndarray       # int64 [R] PAF target begin (draft)
    t_ends: np.ndarray         # int64 [R]

    @property
    def n_reads(self) -> int:
        return len(self.starts)

    def read(self, i: int) -> bytes:
        a, b = self.read_offsets[i], self.read_offsets[i + 1]
        return ACGT[self.read_codes[a:b]].tobytes()

    def draft_bytes(self) -> bytes:
        return ACGT[self.draft].tobytes()


def read_lengths(spec: dict, stream: int, n: int | None,
                 total: int | None, cap: int) -> np.ndarray:
    """Log-normal lengths (median, sigma) clipped to [min, min(max, cap)]:
    `n` of them, or as many as first reach `total` bases."""
    rng = np.random.default_rng([LENGTH_STREAM, stream])
    lo, hi = int(spec["min"]), min(int(spec["max"]), cap)
    mu, sigma = np.log(float(spec["median"])), float(spec["sigma"])
    if n is None:
        guess = int(total / np.exp(mu + sigma * sigma / 2) * 1.5) + 16
        lens = np.clip(rng.lognormal(mu, sigma, guess), lo, hi).astype(np.int64)
        n = int(np.searchsorted(np.cumsum(lens), total)) + 1
        return lens[:n]
    return np.clip(rng.lognormal(mu, sigma, n), lo, hi).astype(np.int64)


def mutate(rng: np.random.Generator, codes: np.ndarray, rate: float):
    """synth.mutate's model over a whole array: returns (out, starts) where
    starts[i] is where input base i lands in out (for a deleted base, where
    the next kept one does), and starts[len] = len(out)."""
    r = rng.random(len(codes), dtype=np.float32)
    third = np.float32(rate / 3)
    dele = r < third
    ins = (r >= third) & (r < 2 * third)
    sub = (r >= 2 * third) & (r < np.float32(rate))
    base = codes.copy()
    base[sub] = rng.integers(0, 4, int(sub.sum()), dtype=np.uint8)
    counts = 1 - dele.astype(np.int64) + ins
    starts = np.zeros(len(codes) + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    out = np.repeat(base, counts)
    out[starts[:-1][ins]] = rng.integers(0, 4, int(ins.sum()), dtype=np.uint8)
    return out, starts


def simulate(seed: int, stream: int, genome_length: int, read_error: float,
             draft_error: float, length_spec: dict, coverage: float | None = None,
             n_reads: int | None = None) -> Dataset:
    """One dataset from `seed` (the run's) and `stream` (which dataset of
    the run; also picks the fixed read lengths)."""
    rng = np.random.default_rng([int(seed) & (2**63 - 1), stream])
    truth = rng.integers(0, 4, genome_length, dtype=np.uint8)
    draft, draft_of_truth = mutate(rng, truth, draft_error)

    total = None if coverage is None else int(coverage * genome_length)
    lens = read_lengths(length_spec, stream, n_reads, total, genome_length - 1)
    place = np.random.default_rng([LENGTH_STREAM, stream, 1])
    starts = place.integers(0, genome_length - lens + 1)
    ends = starts + lens
    strands = rng.random(len(lens)) < 0.5

    # the reads in chunks of about CHUNK_BASES, each from its own stream
    # and on its own thread (numpy releases the GIL in these loops)
    cuts = [0]
    acc = 0
    for i, n in enumerate(lens):
        acc += int(n)
        if acc >= CHUNK_BASES:
            cuts.append(i + 1)
            acc = 0
    if cuts[-1] != len(lens):
        cuts.append(len(lens))
    jobs = [(int(seed) & (2**63 - 1), stream, c, truth, starts[a:b],
             lens[a:b], strands[a:b], read_error)
            for c, (a, b) in enumerate(zip(cuts[:-1], cuts[1:]))]
    with ThreadPoolExecutor(THREADS) as pool:
        parts = list(pool.map(_read_chunk, jobs))
    read_codes = np.concatenate([p[0] for p in parts])
    sizes = np.concatenate([np.diff(p[1]) for p in parts])
    offsets = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    return Dataset(truth=truth, draft=draft, draft_of_truth=draft_of_truth,
                   read_codes=read_codes, read_offsets=offsets,
                   starts=starts, ends=ends, strands=strands,
                   t_begins=draft_of_truth[starts],
                   t_ends=draft_of_truth[ends])


def _read_chunk(job):
    """One chunk of reads: their truth bases back to back (reverse
    complemented in place where the strand says so), then mutated.
    Returns (codes, offsets into them)."""
    seed, stream, chunk, truth, starts, lens, strands, rate = job
    rng = np.random.default_rng([seed, stream, 1 + chunk])
    offs = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    k = np.arange(offs[-1], dtype=np.int64) - np.repeat(offs[:-1], lens)
    rev = np.repeat(strands, lens)
    pos = np.repeat(starts, lens) + np.where(rev, np.repeat(lens - 1, lens) - k,
                                             k)
    codes = truth[pos]
    codes = np.where(rev, 3 - codes, codes).astype(np.uint8)
    out, at = mutate(rng, codes, rate)
    return out, at[offs]


def write(ds: Dataset, directory: str, tag: str,
          contig: str = "draft") -> tuple[str, str, str]:
    """Writes <tag>_reads.fasta, <tag>_ovl.paf and <tag>_draft.fasta (one
    line a sequence); returns their paths in the CLI's order."""
    os.makedirs(directory, exist_ok=True)
    reads = os.path.join(directory, f"{tag}_reads.fasta")
    paf = os.path.join(directory, f"{tag}_ovl.paf")
    draft = os.path.join(directory, f"{tag}_draft.fasta")
    ascii_ = ACGT[ds.read_codes]
    o = ds.read_offsets
    with open(reads, "wb") as fh:
        for i in range(ds.n_reads):
            fh.write(b">r%d\n" % i)
            fh.write(memoryview(ascii_[o[i]:o[i + 1]]))
            fh.write(b"\n")
    qlen = np.diff(o)
    dlen = len(ds.draft)
    rows = [f"r{i}\t{qlen[i]}\t0\t{qlen[i]}\t{'-' if ds.strands[i] else '+'}"
            f"\t{contig}\t{dlen}\t{ds.t_begins[i]}\t{ds.t_ends[i]}"
            f"\t{ds.t_ends[i] - ds.t_begins[i]}\t{ds.t_ends[i] - ds.t_begins[i]}"
            f"\t60\n" for i in range(ds.n_reads)]
    with open(paf, "w") as fh:
        fh.writelines(rows)
    with open(draft, "wb") as fh:
        fh.write(b">%s\n" % contig.encode())
        fh.write(ds.draft_bytes())
        fh.write(b"\n")
    return reads, paf, draft


def from_config(cfg: dict, seed: int, stream: int = 0) -> Dataset:
    """The dataset a configuration file describes."""
    return simulate(seed, stream, int(cfg["genome_length"]),
                    float(cfg["read_error"]), float(cfg["draft_error"]),
                    cfg["read_length"], coverage=cfg.get("coverage"),
                    n_reads=cfg.get("reads"))
