"""A device-aligned pair's path as run arrays, from the aligner's decode
to the breaking points (racon_tpu_torch/ops/align.run_arrays,
core/overlap.Overlap.runs, core/polisher.find_overlap_breaking_points).

The walk over run arrays must give the arrays the walk over the same
path's CIGAR gives (parse_cigar), and both the JAX package's
`find_breaking_points` on that CIGAR, array for array, dtype included:
seeded paths on both strands, with the target start on and off a window
grid point or the whole alignment inside one window, leading and
trailing I / D runs, and runs that straddle grid points. On a small
simulated set through the polisher (plain K2 on the CPU), every
overlap's breaking points equal the JAX walk of the CIGAR the runs
re-encode to, the FASTA equals the JAX CLI's, and the counters split the
walks by source. Tolerance: none.
"""

import random

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from racon_tpu import cli as jax_cli  # noqa: E402
from racon_tpu.core.overlap import Overlap as JaxOverlap  # noqa: E402
from racon_tpu.utils.cigar import cigar_from_ops  # noqa: E402
from racon_tpu_torch import cli  # noqa: E402
from racon_tpu_torch.core.overlap import Overlap  # noqa: E402
from racon_tpu_torch.core.polisher import Polisher  # noqa: E402
from racon_tpu_torch.ops.align import run_arrays, run_list  # noqa: E402
from racon_tpu_torch.synth import simulate, write_dataset  # noqa: E402
from racon_tpu_torch.utils.cigar import parse_cigar  # noqa: E402

SCORES = ["-m", "5", "-x", "-4", "-g", "-8"]
#: alignments per case of the walk test
PATHS_PER_CASE = 50


def random_path(rng, wl, max_runs):
    """A forward-order op-code path (0 M, 1 I, 2 D, as K2's traceback
    writes them, reversed) and its generating runs. Runs are short or
    up to three windows long, so many straddle a grid point; half the
    paths start, and half end, with an I or D run."""
    runs = []
    if rng.random() < 0.5:
        runs.append((rng.choice((1, 2)), rng.randint(1, 2 * wl)))
    for _ in range(rng.randint(1, max_runs)):
        code = rng.choice((0, 0, 1, 2))
        n = rng.randint(1, 6) if rng.random() < 0.7 else rng.randint(1, 3 * wl)
        runs.append((code, n))
    if rng.random() < 0.5:
        runs.append((rng.choice((1, 2)), rng.randint(1, 2 * wl)))
    seq = np.concatenate([np.full(n, c, dtype=np.int32) for c, n in runs])
    return seq, runs


def overlaps(rng, seq, strand, place, wl):
    """Two of the port's Overlaps and one of the JAX package's over the
    same path, with the target start on a grid point, off it, or the
    whole target span inside one window."""
    t_span = int(np.count_nonzero(seq != 1))
    q_span = int(np.count_nonzero(seq != 2))
    k = rng.randint(0, 40)
    if place == "on_grid":
        t_begin = k * wl
    elif place == "off_grid":
        t_begin = k * wl + rng.randint(1, wl - 1)
    else:
        t_begin = k * wl + rng.randint(0, max(0, wl - 1 - t_span))
    q_begin = rng.randint(0, 50)
    q_length = q_begin + q_span + rng.randint(0, 50)
    out = []
    for cls in (Overlap, Overlap, JaxOverlap):
        o = cls()
        o.q_begin, o.q_end, o.q_length = q_begin, q_begin + q_span, q_length
        o.t_begin, o.t_end = t_begin, t_begin + t_span
        o.t_length = o.t_end + 100
        o.strand = strand
        o.is_transmuted = True
        out.append(o)
    return out


@pytest.mark.parametrize("strand", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("place", ["on_grid", "off_grid", "in_window"])
def test_runs_walk_equals_cigar_walk_and_jax(strand, place):
    rng = random.Random(f"{strand}-{place}")
    n_inside = 0
    for _ in range(PATHS_PER_CASE):
        wl = rng.choice((8, 20, 50, 500))
        seq, runs = random_path(rng, wl, 2 if place == "in_window" else 40)
        if place == "in_window":
            wl = max(wl, 2 * len(seq))
        cigar = cigar_from_ops([(n, "MID"[c]) for c, n in runs]).encode()
        arrays = run_arrays(seq)
        for got, want in zip(arrays, parse_cigar(cigar)):
            assert np.array_equal(got, want) and got.dtype == want.dtype
        o_runs, o_cigar, jax_o = overlaps(rng, seq, strand, place, wl)
        o_runs.runs = arrays
        o_cigar.cigar = cigar
        jax_o.cigar = cigar
        for o in (o_runs, o_cigar, jax_o):
            o.find_breaking_points([], wl)
        want = jax_o.breaking_points
        for o in (o_runs, o_cigar):
            assert np.array_equal(o.breaking_points, want)
            assert o.breaking_points.dtype == want.dtype
            assert o.runs is None and o.cigar == b""
        first_grid = (o_runs.t_begin // wl + 1) * wl
        n_inside += first_grid >= o_runs.t_end
    if place == "in_window":
        assert n_inside == PATHS_PER_CASE
    else:
        assert n_inside < PATHS_PER_CASE


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("runs")
    _, draft, reads, paf = simulate(random.Random(23), 3000, 8, 2000, 0.12,
                                    0.10)
    return write_dataset(str(d), draft, reads, paf)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("RACON_TPU_MAX_DEVICES", "1")
    monkeypatch.setenv("RACON_TPU_STRICT", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("band", ["0", "16"], ids=["auto", "rejects"])
def test_polisher_walks_runs_as_the_cigar_route(dataset, capsysbinary,
                                                monkeypatch, band):
    """Band 16 sends the pairs whose path leaves the band to the host
    aligner, whose CIGARs take the string walk."""
    walks = []
    polishers = []
    walk = Overlap.find_breaking_points
    find = Polisher.find_overlap_breaking_points

    def find_breaking_points(o, sequences, wl):
        runs = o.runs
        j = JaxOverlap()
        for f in ("q_begin", "q_end", "q_length", "t_begin", "t_end",
                  "strand"):
            setattr(j, f, getattr(o, f))
        j.cigar = (o.cigar if runs is None
                   else cigar_from_ops(run_list(runs)).encode())
        walk(o, sequences, wl)
        want = j._breaking_points_from_cigar(wl)
        walks.append((runs is not None,
                      np.array_equal(o.breaking_points, want)
                      and o.breaking_points.dtype == want.dtype))

    def find_overlap_breaking_points(pol, overlaps):
        polishers.append(pol)
        find(pol, overlaps)

    monkeypatch.setattr(Overlap, "find_breaking_points",
                        find_breaking_points)
    monkeypatch.setattr(Polisher, "find_overlap_breaking_points",
                        find_overlap_breaking_points)
    capsysbinary.readouterr()
    assert jax_cli.main(["-c", "0", "--tpualigner-batches", "1",
                         "--tpualigner-band-width", band, *SCORES,
                         *dataset]) == 0
    want = capsysbinary.readouterr().out
    assert cli.main(["--device", "cpu", "-c", "0", "--cudaaligner-batches",
                     "1", "--cudaaligner-band-width", band, *SCORES,
                     *dataset]) == 0
    got = capsysbinary.readouterr().out
    assert got.startswith(b">draft") and got == want
    (pol,) = polishers
    assert walks and all(same for _, same in walks)
    assert pol.n_bp_runs == sum(from_runs for from_runs, _ in walks)
    assert pol.n_bp_cigar == len(walks) - pol.n_bp_runs
    assert pol.n_bp_runs == pol.n_aligner_device > 0
    assert pol.n_bp_cigar == pol.n_aligner_host_fallback
    assert (pol.n_bp_cigar > 0) == (band == "16")
