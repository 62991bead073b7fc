"""The dual all-vs-all generator: both directions of every pair, no read
against itself, coordinates inside the reads, at least the minimum of
shared truth a pair, and the reads file byte for byte the contig cell's."""

import itertools

import numpy as np
import pytest

from portbench import gen, gen_ava

SPEC = {"median": 1500, "sigma": 0.4, "min": 800, "max": 3000}


@pytest.fixture(scope="module")
def ds():
    return gen.simulate(2**31 + 9, 0, 12000, 0.12, 0.10, SPEC, coverage=8)


@pytest.fixture(scope="module")
def rows(ds):
    return gen_ava.rows(ds, 500)


def shared(ds, a, b):
    return (min(ds.ends[a], ds.ends[b])
            - max(ds.starts[a], ds.starts[b]))


def test_pairs_are_every_pair_sharing_the_minimum(ds, rows):
    want = {(a, b) for a, b in itertools.permutations(range(ds.n_reads), 2)
            if shared(ds, a, b) >= 500}
    got = list(zip(rows.q.tolist(), rows.t.tolist()))
    assert len(got) == len(set(got))
    assert set(got) == want
    # both directions, and no read against itself
    assert all((b, a) in want for a, b in want)
    assert not np.any(rows.q == rows.t)


def test_rows_grouped_by_query(rows):
    assert np.all(np.diff(rows.q) >= 0)
    same = rows.q[1:] == rows.q[:-1]
    assert np.all(np.diff(rows.t)[same] > 0)


def test_coordinates_inside_the_reads(ds, rows):
    lens = np.diff(ds.read_offsets)
    assert np.array_equal(rows.q_length, lens[rows.q])
    assert np.all((0 <= rows.q_begin) & (rows.q_begin < rows.q_end)
                  & (rows.q_end <= lens[rows.q]))
    assert np.all((0 <= rows.t_begin) & (rows.t_begin < rows.t_end)
                  & (rows.t_end <= lens[rows.t]))
    assert np.array_equal(rows.strand, ds.strands[rows.q] ^ ds.strands[rows.t])


def test_coordinates_follow_the_truth(ds, rows):
    """A read's stretch is the shared truth, interpolated along it; a
    reverse-strand read measured from its end."""
    i = int(np.nonzero(ds.strands[rows.t])[0][0])
    q, t = int(rows.q[i]), int(rows.t[i])
    lo = max(ds.starts[q], ds.starts[t])
    hi = min(ds.ends[q], ds.ends[t])
    length = int(ds.read_offsets[t + 1] - ds.read_offsets[t])
    span = int(ds.ends[t] - ds.starts[t])
    assert rows.t_begin[i] == (ds.ends[t] - hi) * length // span
    assert rows.t_end[i] == (ds.ends[t] - lo) * length // span


def test_files(ds, rows, tmp_path):
    reads, paf, targets = gen_ava.write(ds, rows, str(tmp_path / "a"), "x")
    assert targets == reads
    contig_reads = gen.write(ds, str(tmp_path / "c"), "x")[0]
    assert open(reads, "rb").read() == open(contig_reads, "rb").read()
    lines = open(paf).read().splitlines()
    assert len(lines) == len(rows)
    f = lines[0].split("\t")
    assert len(f) == 12
    assert f[0] == f"r{rows.q[0]}" and f[5] == f"r{rows.t[0]}"
    assert [int(x) for x in f[1:4]] == [rows.q_length[0], rows.q_begin[0],
                                        rows.q_end[0]]
    assert f[4] == ("-" if rows.strand[0] else "+")
    assert [int(x) for x in f[7:9]] == [rows.t_begin[0], rows.t_end[0]]


def test_same_seed_same_rows(ds, rows):
    again = gen_ava.rows(gen.simulate(2**31 + 9, 0, 12000, 0.12, 0.10, SPEC,
                                      coverage=8), 500)
    for name in ("q", "t", "strand", "q_begin", "q_end", "t_begin", "t_end"):
        assert np.array_equal(getattr(rows, name), getattr(again, name))


@pytest.mark.parametrize("chunk", [1, 2500, 12000, 10**9])
def test_split_is_the_wrappers_chunks(ds, tmp_path, chunk):
    """The reads cell's slices are the chunks the port's `rampler split`
    (racon_wrapper --split) writes, read for read."""
    from portbench.drivers import fragments
    from racon_tpu_torch import rampler

    path = tmp_path / "reads.fasta"
    path.write_bytes(b"".join(b">r%d\n%s\n" % (i, ds.read(i))
                              for i in range(ds.n_reads)))
    out = tmp_path / f"out{chunk}"
    out.mkdir()
    files = rampler.split(str(path), chunk, str(out))
    counts = [open(f, "rb").read().count(b">") for f in files]
    got = fragments.split(np.diff(ds.read_offsets), chunk)
    assert [hi - lo for lo, hi in got] == counts
    assert got[0][0] == 0 and got[-1][1] == ds.n_reads
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
