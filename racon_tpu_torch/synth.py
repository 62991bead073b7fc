"""Seeded synthetic polishing workload: a random genome, a noisy draft,
long reads with ONT-like errors (deletions, insertions and substitutions
each at rate/3), and PAF overlaps from the simulation's coordinates.

The same generator, stream for stream, as the repository's
tools/synthbench.py (`mutate`, `simulate`; Python `random`), so a seed
gives the same bytes here and there; `write_dataset` writes the
reads/overlaps/draft files the CLI takes. For fragment correction
(`-f`), `simulate_truth` keeps each read's source interval and strand,
`ava_overlaps` makes the all-vs-all PAF rows the reads correct each
other with, and `write_fragment_dataset` writes them. `poa_jobs` makes seeded
window-sweep jobs (numpy) for the kernel's edge cases, `align_pairs`
seeded pairs for the banded aligner's.

    rng = random.Random(42)
    truth, draft, reads, paf = simulate(rng, 50_000, 20, 8000, 0.12, 0.10)
    _, _, reads, _ = simulate_truth(rng, 6000, 10, 2000, 0.12, 0.10)
    paths = write_fragment_dataset(d, reads, ava_overlaps(reads))
"""

from __future__ import annotations

import gzip
import os

import numpy as np

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


def simulate_truth(rng, genome_len, coverage, read_len, read_err,
                   draft_err):
    """simulate's draws, with each read's truth: returns (truth, draft,
    reads, paf) where reads are (name, read, start, end, strand), the
    read drawn from truth[start:end] and reverse-complemented when
    `strand` is True."""
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
        read = revcomp(fwd) if strand else fwd
        name = f"read{i}"
        t_begin = int(start * scale)
        t_end = min(len(draft), int(end * scale))
        reads.append((name, read, start, end, strand))
        paf.append(f"{name}\t{len(read)}\t0\t{len(read)}\t"
                   f"{'-' if strand else '+'}\tdraft\t{len(draft)}\t"
                   f"{t_begin}\t{t_end}\t{end - start}\t{end - start}\t60")
    return truth, draft, reads, paf


def simulate(rng, genome_len, coverage, read_len, read_err, draft_err):
    truth, draft, reads, paf = simulate_truth(rng, genome_len, coverage,
                                              read_len, read_err, draft_err)
    return truth, draft, [(r[0], r[1]) for r in reads], paf


def revcomp(s: bytes) -> bytes:
    return s.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]


def truth_segment(truth: bytes, read) -> bytes:
    """The truth a read of simulate_truth was drawn from, on the read's
    own strand."""
    _, _, start, end, strand = read
    return revcomp(truth[start:end]) if strand else truth[start:end]


def ava_overlaps(reads, min_overlap=1000) -> list[str]:
    """All-vs-all PAF rows between reads of simulate_truth: one row for
    every ordered pair of distinct reads whose truth intervals share at
    least `min_overlap` bases (so both directions are present), grouped
    by query. The strand is relative ('+' when both reads lie on the same
    strand); each read's interval is the shared truth interval scaled
    into the read by len(read) / (end - start), clamped, and mirrored
    onto the read's own forward sequence when it is reverse-stranded."""
    def span(read, a, b):
        _, seq, start, end, strand = read
        n = len(seq)
        scale = n / (end - start)
        x0 = min(n, max(0, int((a - start) * scale)))
        x1 = min(n, max(0, int((b - start) * scale)))
        return (n - x1, n - x0) if strand else (x0, x1)

    paf = []
    for qi, q in enumerate(reads):
        for ti, t in enumerate(reads):
            a, b = max(q[2], t[2]), min(q[3], t[3])
            if qi == ti or b - a < min_overlap:
                continue
            q0, q1 = span(q, a, b)
            t0, t1 = span(t, a, b)
            paf.append(f"{q[0]}\t{len(q[1])}\t{q0}\t{q1}\t"
                       f"{'+' if q[4] == t[4] else '-'}\t{t[0]}\t"
                       f"{len(t[1])}\t{t0}\t{t1}\t{b - a}\t{b - a}\t60")
    return paf


def _write_reads(path, reads) -> None:
    with gzip.open(path, "wb", compresslevel=1) as f:
        for name, read, *_ in reads:
            f.write(b">" + name.encode() + b"\n" + read + b"\n")


def _write_paf(path, paf) -> None:
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(("\n".join(paf) + "\n").encode())


def write_dataset(directory, draft, reads, paf) -> tuple[str, str, str]:
    """Write (reads.fasta.gz, ovl.paf.gz, draft.fasta.gz) as
    tools/synthbench.py does; returns their paths."""
    reads_path = os.path.join(directory, "reads.fasta.gz")
    _write_reads(reads_path, reads)
    paf_path = os.path.join(directory, "ovl.paf.gz")
    _write_paf(paf_path, paf)
    draft_path = os.path.join(directory, "draft.fasta.gz")
    with gzip.open(draft_path, "wb", compresslevel=1) as f:
        f.write(b">draft\n" + draft + b"\n")
    return reads_path, paf_path, draft_path


def write_fragment_dataset(directory, reads, paf) -> tuple[str, str, str]:
    """Write reads.fasta.gz and ava.paf.gz (all-vs-all overlaps, as
    ava_overlaps makes them) for fragment correction; returns the CLI's triple
    (reads, overlaps, reads): the reads are both the sequences and the
    targets."""
    reads_path = os.path.join(directory, "reads.fasta.gz")
    _write_reads(reads_path, reads)
    paf_path = os.path.join(directory, "ava.paf.gz")
    _write_paf(paf_path, paf)
    return reads_path, paf_path, reads_path


def poa_jobs(seed, B, N, L, P, bands, far=0, pad_rows=0, empty_layers=0):
    """B window-sweep jobs in the session's layout, from a seed: what
    real session jobs rarely reach.

    Job 0 has all N nodes and a layer of length L; the others draw both.
    Node k's predecessors (DP rows, rank + 1) are topo-ordered: the chain
    row k - 1, rows a few ranks back, every seventh node at in-degree P,
    and with `far` one edge at least `far` ranks back on every fifth
    node. A tenth of the lists put their padding (-1) between real
    entries. Band centers follow the diagonal with noise reaching past
    column 1 and past the layer's end, and a twentieth of them lie off
    the layer (an empty window). Every third job's centers drift at half
    the diagonal's slope, so a band misses the layer's end and the
    traceback leaves the band (the clipped case the session redoes at
    band 0). Bands cycle through `bands`. The last
    `pad_rows` jobs are node-less padding (nnodes 0), the `empty_layers`
    before them have a layer of length 0.
    Returns (codes, preds, centers, sinks, seq, lens, band, nnodes)."""
    rng = np.random.default_rng(seed)
    codes = np.full((B, N), 5, np.int8)
    preds = np.full((B, N, P), -1, np.int16)
    centers = np.zeros((B, N), np.int16)
    sinks = np.zeros((B, N), np.uint8)
    seq = np.full((B, L), 5, np.int8)
    lens = np.zeros(B, np.int32)
    band = np.zeros(B, np.int32)
    nnodes = np.zeros(B, np.int32)
    for b in range(B - pad_rows):
        nn = N if b == 0 else int(rng.integers(max(1, N // 2), N + 1))
        slen = L if b == 0 else int(rng.integers(L // 2, L + 1))
        if b >= B - pad_rows - empty_layers:
            slen = 0
        bw = bands[b % len(bands)]
        nnodes[b], lens[b], band[b] = nn, slen, bw
        codes[b, :nn] = rng.integers(0, 4, nn)
        seq[b, :slen] = rng.integers(0, 4, slen)
        for k in range(1, nn + 1):
            deg = P if k % 7 == 0 else int(rng.integers(1, 3))
            cand = [k - 1]
            if far and k % 5 == 0 and k > far:
                cand.append(int(rng.integers(0, k - far + 1)))
            while len(cand) < 4 * deg:
                cand.append(int(rng.integers(max(0, k - 12), k)))
            row = list(dict.fromkeys(cand))[:deg]
            rng.shuffle(row)
            slots = (np.sort(rng.choice(P, len(row), replace=False))
                     if k % 10 == 3 else np.arange(len(row)))
            preds[b, k - 1, slots] = row
            slope = 2 if b % 3 == 1 else 1
            c = (k * slen) // (nn * slope) + int(
                rng.integers(-bw // 2 - 8, bw // 2 + 9))
            if k % 20 == 11:
                c = int(rng.integers(-bw - 8, slen + bw + 9))
            centers[b, k - 1] = c
        sinks[b, nn - 1] = 1
        sinks[b, :nn] |= (rng.random(nn) < 0.1).astype(np.uint8)
    return codes, preds, centers, sinks, seq, lens, band, nnodes


#: pair kinds of align_pairs
ALIGN_KINDS = ("band_edge", "skewed", "full", "tiny", "n_bases", "short")


def align_pairs(seed, edge, band, kinds=ALIGN_KINDS):
    """(query, target) pairs for the banded aligner at bucket `edge` and
    band `band`, from a seed: what real overlaps rarely reach. Kinds:

      band_edge  a rotation, and a deletion from the query and one from
                 the target of max(100, 2 band) bases near the start:
                 the true path leaves the band by about half the
                 deletion, so the in-band path rides the band's lower
                 or upper edge (touched is set) at any band narrower
                 than about a sixth of the pair;
      skewed     m >> n and n >> m;
      full       m = n = edge (a mutated pair and a maximal-cost pair);
      tiny       pairs of 1 to 3 bases, so a lane's m + n is far below
                 the batch's largest;
      n_bases    N in the query and in the target;
      short      m and n below a third of the band (band > m + 1).
    """
    import random

    rng = random.Random(seed)

    def rand(k):
        return bytes(rng.choice(ACGT) for _ in range(k))

    length = max(8, edge * 4 // 5)
    base = rand(length)
    pairs = []
    for kind in kinds:
        if kind == "band_edge":
            cut = min(max(100, 2 * band), length // 3)
            short = base[:length // 16] + base[length // 16 + cut:]
            pairs.append((base[length // 4:] + base[:length // 4], base))
            pairs.append((short, base))
            pairs.append((base, short))
        elif kind == "skewed":
            pairs.append((base, base[:max(1, length // 6)]))
            pairs.append((base[length // 3:length // 3 + max(1, length // 8)],
                          base))
        elif kind == "full":
            t = rand(edge)
            q = (mutate(rng, t, 0.1) + rand(edge))[:edge]
            pairs.append((q, t))
            pairs.append((b"A" * edge, b"T" * edge))
        elif kind == "tiny":
            pairs += [(b"ACG", b"AG"), (b"A", b"C")]
        elif kind == "n_bases":
            k = max(1, length // 8)
            pairs.append((b"ACGTNNAC" * k, b"ACGTACGT" * k))
            pairs.append((base, base[:length // 2] + b"N" * 9
                          + base[length // 2 + 9:]))
        elif kind == "short":
            k = max(1, min(edge, band // 3))
            t = rand(k)
            pairs.append((mutate(rng, t, 0.2)[:edge] or b"A", t))
        else:
            raise ValueError(f"unknown pair kind {kind!r}")
    return pairs


def max_pred_distance(preds, nnodes):
    """The largest k - pred over the real rows of every job."""
    k = np.arange(1, preds.shape[1] + 1)[None, :, None]
    real = (preds >= 0) & (k <= nnodes[:, None, None])
    return int(np.where(real, k - preds, 0).max(initial=0))
