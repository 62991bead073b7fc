"""The generator: a seed gives the same bytes, another seed other bases
but the same read lengths, and the error model's rates."""

import numpy as np

from portbench import gen

SPEC = {"median": 1500, "sigma": 0.4, "min": 800, "max": 3000}


def make(seed, stream=0):
    return gen.simulate(seed, stream, 20000, 0.12, 0.10, SPEC, coverage=5)


def test_same_seed_same_data():
    a, b = make(2**31 + 5), make(2**31 + 5)
    for f in ("truth", "draft", "read_codes", "read_offsets", "starts",
              "strands", "t_begins", "t_ends"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_other_seed_same_reads_other_bases():
    a, b = make(1), make(2)
    assert not np.array_equal(a.truth, b.truth)
    assert not np.array_equal(a.read_codes, b.read_codes)
    assert np.array_equal(a.starts, b.starts)
    assert np.array_equal(a.ends, b.ends)
    # another stream of one seed: another dataset
    assert not np.array_equal(make(1, 1).truth, a.truth)


def test_large_and_negative_seeds():
    assert make(2**33 + 1).n_reads == make(-7).n_reads


def test_error_model_rates():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, 400000, dtype=np.uint8)
    out, starts = gen.mutate(rng, codes, 0.12)
    counts = np.diff(starts)
    assert abs((counts == 0).mean() - 0.04) < 0.003      # deletions
    assert abs((counts == 2).mean() - 0.04) < 0.003      # insertions
    kept = counts == 1
    # a substitution draws any base: 3 in 4 change it
    changed = (out[starts[:-1][kept]] != codes[kept]).mean()
    assert abs(changed - 0.03 / 0.96) < 0.003


def test_coordinates_and_reads():
    ds = make(3)
    assert ds.draft_of_truth[0] == 0
    assert ds.draft_of_truth[-1] == len(ds.draft)
    assert np.all(ds.t_begins <= ds.t_ends)
    assert ds.read_offsets[-1] == len(ds.read_codes)
    assert set(ds.read(0)) <= set(b"ACGT")


def test_write(tmp_path):
    ds = make(4)
    reads, paf, draft = gen.write(ds, str(tmp_path), "x", "ctg")
    rows = open(paf).read().splitlines()
    assert len(rows) == ds.n_reads
    f = rows[0].split("\t")
    assert f[0] == "r0" and int(f[1]) == len(ds.read(0)) and f[5] == "ctg"
    lines = open(reads, "rb").read().splitlines()
    assert lines[1] == ds.read(0)
    assert open(draft, "rb").read().splitlines()[1] == ds.draft_bytes()
