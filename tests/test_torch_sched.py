"""The port's occupancy-aware scheduler (racon_tpu_torch/sched/) and its
hooks in the three device engines, against the JAX package's
(racon_tpu/sched/).

Inputs are made from seeds (numpy and random). The port's ladder DPs give
the JAX DPs' edges on seeded histograms (and the brute-force optimum);
each engine derives the JAX engine's ladder from the same pairs and
windows (aligner edges per static bucket, the session engine's
(nodes, len) grid, the fused engine's depth ladder); per bucket the
`jobs` and `useful_cells` equal the JAX package's occupancy counters
(lanes and padding follow each package's batch widths, so they are not
compared); the port's counters keep useful + padded == lanes x capacity
in each engine's units; and results are equal with the scheduler on and
off. Tolerance: none — equality throughout.

The `gpu`-marked tests hold K1, K2 and K3 at derived shapes (a
(nodes, len) grid point, an edge and a depth outside the static ladders)
against their plain versions on the card; they skip without one.
"""

import ast
import itertools
import random

import numpy as np
import pytest
import torch

from racon_tpu_torch.ops import align_kernels, poa_fused_kernels
from racon_tpu_torch.ops import poa_kernels
from racon_tpu_torch.ops.align import BatchAligner
from racon_tpu_torch.ops.poa_fused import FusedPOA
from racon_tpu_torch.ops.poa_graph import DeviceGraphPOA
from racon_tpu_torch.pipeline import DispatchPipeline
from racon_tpu_torch.sched import (BatchScheduler, ladder_1d, ladder_2d,
                                   padded_cost_1d, round_up)
from test_torch_align import run_lists
from test_torch_fused_poa import make_windows, pack

ACGT = b"ACGT"


@pytest.fixture
def jax_sched():
    """The JAX package's scheduler (the JAX-comparing tests only: the
    `gpu` tests run on a machine without JAX)."""
    pytest.importorskip("jax")
    from racon_tpu import sched

    return sched


@pytest.fixture(autouse=True)
def _one_device(monkeypatch):
    monkeypatch.setenv("RACON_TPU_MAX_DEVICES", "1")
    monkeypatch.setenv("RACON_TPU_STRICT", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ ladder DPs

@pytest.mark.parametrize("seed", range(4))
def test_ladder_1d_matches_jax_and_brute_force(seed, jax_sched):
    rng = np.random.default_rng(seed)
    for _ in range(30):
        vals = [int(v) for v in rng.integers(1, 40, rng.integers(1, 10))]
        k = int(rng.integers(1, 5))
        edges = ladder_1d(vals, k)
        assert edges == jax_sched.ladder_1d(vals, k)
        assert 1 <= len(edges) <= k and max(edges) >= max(vals)
        uniq = sorted(set(vals))
        best = min(padded_cost_1d(vals, comb)
                   for r in range(1, min(k, len(uniq)) + 1)
                   for comb in itertools.combinations(uniq, r)
                   if comb[-1] == uniq[-1])
        assert padded_cost_1d(vals, edges) == best


@pytest.mark.parametrize("k", [1, 3, 8])
def test_ladder_1d_quantum_cost_and_thinning_match_jax(k, jax_sched):
    """The aligner's quantum and cost model on a histogram wider than the
    candidate bound (MAX_CANDIDATES), so both packages thin it."""
    rng = np.random.default_rng(k)
    vals = [int(v) for v in rng.integers(100, 65536, 3000)]
    for quantum, cost in ((256, lambda e: 2 * e + 1), (1, None)):
        got = ladder_1d(vals, k, quantum=quantum, cost=cost)
        assert got == jax_sched.ladder_1d(vals, k, quantum=quantum,
                                          cost=cost)
        assert all(e % quantum == 0 for e in got) and max(got) >= max(vals)
        assert (padded_cost_1d(vals, got, cost)
                == jax_sched.padded_cost_1d(vals, got, cost))
    assert ladder_1d([], k) == jax_sched.ladder_1d([], k) == []


@pytest.mark.parametrize("seed", range(3))
def test_ladder_2d_matches_jax(seed, jax_sched):
    """The session engine's grid DP: seeded (nodes, len) histograms at
    its quantum and area model, against the JAX DP; every job fits its
    grid."""
    rng = np.random.default_rng(seed)
    for n_jobs in (1, 7, 60, 400):
        shapes = [(int(a), int(b)) for a, b in zip(
            rng.integers(40, 2048, n_jobs), rng.integers(1, 640, n_jobs))]
        for k in (1, 2, 4):
            kw = dict(quantum_a=64, quantum_b=64,
                      area=lambda ea, eb: ea * (eb + 1))
            grid = ladder_2d(shapes, k, **kw)
            assert grid == jax_sched.ladder_2d(shapes, k, **kw)
            assert 1 <= len(grid) <= k
            for a, b in shapes:
                assert any(ga >= a and gb >= b for ga, gb in grid)
    assert ladder_2d([], 4) == []


def test_round_up_and_scheduler_derivations_match_jax(jax_sched):
    for v, q in ((0, 64), (1, 64), (64, 64), (65, 64), (7937, 256),
                 (3, 1)):
        assert round_up(v, q) == jax_sched.round_up(v, q)
    rng = np.random.default_rng(5)
    lengths = [int(v) for v in rng.integers(1, 9000, 200)]
    shapes = [(int(a), int(b)) for a, b in zip(rng.integers(60, 2600, 80),
                                               rng.integers(1, 700, 80))]
    depths = [int(v) for v in rng.integers(2, 90, 12)]
    for adaptive in (False, True):
        mine = BatchScheduler(adaptive=adaptive)
        theirs = jax_sched.BatchScheduler(adaptive=adaptive)
        for k in (1, 2, 5):
            assert (mine.aligner_ladder(lengths, k, 8192)
                    == theirs.aligner_ladder(lengths, k, 8192))
            assert (mine.poa_grid(shapes, k, 2048, 640)
                    == theirs.poa_grid(shapes, k, 2048, 640))
            assert mine.depth_ladder(depths, k) == theirs.depth_ladder(
                depths, k)
        key = lambda i: lengths[i]  # noqa: E731
        assert mine.order(range(50), key) == theirs.order(range(50), key)
    assert (BatchScheduler.ALIGNER_QUANTUM, BatchScheduler.POA_QUANTUM) == (
        jax_sched.BatchScheduler.ALIGNER_QUANTUM,
        jax_sched.BatchScheduler.POA_QUANTUM)


# ---------------------------------------------------------- the aligner

def noisy_pairs(rng, n, lo, hi):
    def mut(seq):
        out = bytearray()
        for ch in seq:
            r = rng.random()
            if r < 0.03:
                continue
            out.append(rng.choice(ACGT) if r < 0.08 else ch)
            if rng.random() < 0.03:
                out.append(rng.choice(ACGT))
        return bytes(out)

    pairs = []
    for _ in range(n):
        t = bytes(rng.choice(ACGT) for _ in range(rng.randrange(lo, hi)))
        pairs.append((mut(t), t))
    return pairs


def skewed_pairs():
    """Many short pairs, a few in the next static buckets, shuffled so
    arrival order is not length order."""
    rng = random.Random(11)
    pairs = (noisy_pairs(rng, 20, 150, 500) + noisy_pairs(rng, 3, 1100, 1500)
             + noisy_pairs(rng, 2, 2300, 2700))
    rng.shuffle(pairs)
    return pairs


def by_bucket(snap: dict) -> dict:
    return {b: (v["jobs"], v["useful_cells"])
            for b, v in snap["buckets"].items()}


@pytest.mark.parametrize("adaptive", [False, True])
def test_aligner_ladder_and_occupancy_match_jax(adaptive, jax_sched):
    """The (edge, band) groups the port derives are the JAX aligner's
    buckets, with the same jobs and useful cells each; the runs are the
    JAX runs; useful + padded == lanes x (2 edge + 1) x band."""
    from racon_tpu.ops.align import BatchAligner as JaxAligner

    pairs = skewed_pairs()
    js = jax_sched.BatchScheduler(adaptive=adaptive)
    want = JaxAligner(band_width=64, scheduler=js).align(list(pairs))
    sched = BatchScheduler(adaptive=adaptive)
    al = BatchAligner(band_width=64, device="cpu", scheduler=sched)
    assert run_lists(al.align(list(pairs))) == want
    mine = sched.stats.snapshot()["aligner"]
    theirs = js.stats.snapshot()["aligner"]
    assert by_bucket(mine) == by_bucket(theirs)
    assert {(e, b) for e, b, _ in al.chunks(pairs)} == {
        ast.literal_eval(k) for k in mine["buckets"]}
    static = {512, 2048, 4096}
    edges = {ast.literal_eval(k)[0] for k in mine["buckets"]}
    assert (edges == static) != adaptive
    for key, b in mine["buckets"].items():
        edge, band = ast.literal_eval(key)
        assert edge % 256 == 0 and band == 64
        assert (b["useful_cells"] + b["padded_cells"]
                == b["lanes"] * (2 * edge + 1) * band)
        assert b["kernel"] == "plain"
    if adaptive:
        # tighter edges: the occupancy is not below the static ladder's
        static_occ = BatchScheduler()
        BatchAligner(band_width=64, device="cpu",
                     scheduler=static_occ).align(list(pairs))
        assert (mine["occupancy_pct"]
                >= static_occ.stats.snapshot()["aligner"]["occupancy_pct"])


def test_aligner_reuse_starts_from_the_static_ladder():
    """A reused adaptive aligner derives each call's ladder afresh and
    gives the static aligner's runs every time."""
    rng = random.Random(5)
    batches = [noisy_pairs(rng, 10, 150, 400), noisy_pairs(rng, 10, 300, 900)]
    static = BatchAligner(band_width=64, device="cpu")
    adaptive = BatchAligner(band_width=64, device="cpu",
                            scheduler=BatchScheduler(adaptive=True))
    for pairs in batches:
        assert (run_lists(adaptive.align(list(pairs)))
                == run_lists(static.align(list(pairs))))
    snap = adaptive.sched.stats.snapshot()["aligner"]
    assert len(snap["buckets"]) <= 2 * len(BatchAligner.BUCKETS)


# ----------------------------------------------------- the session engine

def session_windows():
    rng = random.Random(5)
    ws = (make_windows(rng, 12, length=80, depth=6)
          + make_windows(rng, 6, length=90, depth=5, spanning=False)
          + make_windows(rng, 4, length=200, depth=7, rate=0.12))
    return [pack(w) for w in ws]


SESSION_KW = dict(max_nodes=384, max_len=256, batch_rows=8)


@pytest.mark.parametrize("adaptive", [False, True])
def test_session_grid_and_occupancy_match_jax(adaptive, jax_sched):
    """DeviceGraphPOA.adapt derives the JAX engine's (nodes, len) grid
    from the same windows; the consensus equals the JAX engine's and the
    per-bucket jobs and useful cells its counters'; useful + padded ==
    lanes x nodes x (len + 1)."""
    from racon_tpu.ops.poa_graph import DeviceGraphPOA as JaxSession

    windows = session_windows()
    js = jax_sched.BatchScheduler(adaptive=adaptive)
    jeng = JaxSession(3, -5, -4, num_threads=1, scheduler=js, **SESSION_KW)
    want, wst = jeng.consensus(windows)
    sched = BatchScheduler(adaptive=adaptive)
    eng = DeviceGraphPOA(3, -5, -4, device="cpu", scheduler=sched,
                         **SESSION_KW)
    got, gst = eng.consensus(windows)
    assert eng.buckets == jeng.buckets
    static = DeviceGraphPOA(3, -5, -4, device="cpu", **SESSION_KW).buckets
    assert (eng.buckets != static) == adaptive
    np.testing.assert_array_equal(gst, wst)
    for (c, v), (wc, wv) in zip(got, want):
        assert c == wc
        np.testing.assert_array_equal(v, wv)
    mine = sched.stats.snapshot()["session"]
    assert by_bucket(mine) == by_bucket(js.stats.snapshot()["session"])
    for key, b in mine["buckets"].items():
        nb, lb = ast.literal_eval(key)
        assert (b["useful_cells"] + b["padded_cells"]
                == b["lanes"] * nb * (lb + 1))
        assert b["shard_useful"] == [b["useful_cells"]]


def test_session_grid_at_full_envelope_matches_jax(jax_sched):
    """adapt() at the default envelope and static grid (the polisher's
    engine) on deeper windows: the same derived grid, the envelope
    bucket appended as the safety net."""
    from racon_tpu.ops.poa_graph import DeviceGraphPOA as JaxSession

    rng = random.Random(8)
    windows = [pack(w) for w in (
        make_windows(rng, 6, length=500, depth=12, rate=0.1)
        + make_windows(rng, 4, length=450, depth=4, spanning=False)
        + make_windows(rng, 3, length=150, depth=20))]
    eng = DeviceGraphPOA(3, -5, -4, device="cpu",
                         scheduler=BatchScheduler(adaptive=True))
    jeng = JaxSession(3, -5, -4,
                      scheduler=jax_sched.BatchScheduler(adaptive=True))
    eng.adapt(windows)
    jeng.adapt(windows)
    assert eng.buckets == jeng.buckets
    assert eng.buckets[-1] == (2048, 640)
    assert all(nb % 64 == 0 and lb % 64 == 0 for nb, lb in eng.buckets)
    assert len(eng.buckets) <= 5


# ------------------------------------------------------- the fused engine

FUSED_KW = dict(max_nodes=768, max_len=384, batch_rows=4,
                depth_buckets=(4, 8))


def fused_windows():
    rng = random.Random(5)
    ws = (make_windows(rng, 6, length=220, depth=7, rate=0.12)
          + make_windows(rng, 3, length=200, depth=3, rate=0.1)
          + make_windows(rng, 2, length=150, depth=11, rate=0.1))
    return [pack(w) for w in ws]


@pytest.mark.parametrize("fused,depth", [("0", 0), ("1", 2)])
def test_fused_depth_ladder_and_occupancy_match_jax(fused, depth, jax_sched):
    """FusedPOA derives the JAX engine's depth ladder from the chunks'
    deepest windows (depths outside (4, 8) here); the results equal the
    JAX engine's with the scheduler on, and the port's with it off; per
    depth bucket the jobs and useful layers equal the JAX counters';
    useful + padded == lanes x depth."""
    from racon_tpu.ops.poa_fused import FusedPOA as JaxFused

    windows = fused_windows()
    js = jax_sched.BatchScheduler(adaptive=True)
    jeng = JaxFused(3, -5, -4, num_threads=1, scheduler=js,
                    use_fused=fused == "1", **FUSED_KW)
    jeng.adapt(windows)
    want, wst = jeng.consensus([list(w) for w in windows])
    outs = {}
    for adaptive in (False, True):
        sched = BatchScheduler(adaptive=adaptive)
        eng = FusedPOA(3, -5, -4, device="cpu", fused=fused,
                       scheduler=sched, **FUSED_KW)
        with DispatchPipeline(depth=depth) as pl:
            outs[adaptive] = eng.consensus(windows, pipeline=pl)
        if adaptive:
            assert eng.depth_buckets == jeng.depth_buckets
            assert eng.depth_buckets != (4, 8)
            mine = sched.stats.snapshot()["fused"]
            assert by_bucket(mine) == by_bucket(
                js.stats.snapshot()["fused"])
            assert sum(b["jobs"] for b in mine["buckets"].values()) == len(
                [w for w in windows if len(w) >= 3])
            for key, b in mine["buckets"].items():
                assert (b["useful_cells"] + b["padded_cells"]
                        == b["lanes"] * int(key))
    for adaptive, (res, st) in outs.items():
        np.testing.assert_array_equal(st, wst)
        for (c, v), (wc, wv) in zip(res, want):
            assert c == wc, adaptive
            np.testing.assert_array_equal(v, wv)


def test_batchpoa_leftover_session_keeps_the_static_grid():
    """The fused engine's leftover windows go through a session engine
    with a NON-adaptive scheduler sharing the run's counters (as in the
    JAX BatchPOA): no grid derived from the envelope tail, its batches
    still counted."""
    from racon_tpu_torch.ops import poa as poa_mod
    from racon_tpu_torch.ops.poa_graph import BUCKETS

    made = []
    real = poa_mod.BatchPOA._session

    def spy(self, scheduler=None):
        eng = real(self, scheduler)
        made.append(eng)
        return eng

    rng = random.Random(21)
    ws = make_windows(rng, 3, length=150, depth=5, rate=0.1)
    ws += make_windows(rng, 1, length=2100, depth=3, rate=0.02)
    sched = BatchScheduler(adaptive=True)
    bp = poa_mod.BatchPOA(3, -5, -4, 500, device_batches=1, device="cpu",
                          engine="fused", scheduler=sched)
    poa_mod.BatchPOA._session = spy
    try:
        bp.generate_consensus(ws, trim=False)
    finally:
        poa_mod.BatchPOA._session = real
    assert len(made) == 1 and not made[0].sched.adaptive
    assert made[0].sched.stats is sched.stats
    assert made[0].buckets == BUCKETS
    snap = sched.stats.snapshot()
    assert "fused" in snap


# ---------------------------------------------------- kernels on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(448, 320), (1600, 576), (64, 64)])
def test_window_sweep_at_derived_grid_matches_plain_on_card(shape):
    """K1 at (nodes, len) grid points the static grid never has, every
    instantiation the point allows, against the plain version."""
    from racon_tpu_torch.ops.dtypes import poa_int16_ok
    from racon_tpu_torch.ops.encode import pack_2bit
    from racon_tpu_torch.ops.poa_graph import graph_aligner
    from racon_tpu_torch.synth import poa_jobs

    dev = _card()
    N, L = shape
    scores = (3, -5, -4)
    args = poa_jobs(N + L, 16, N, L, 8, (0, 256), far=min(200, N // 2),
                    pad_rows=1, empty_layers=1)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args]
    packed = list(t)
    packed[0] = torch.from_numpy(pack_2bit(args[0])).to(dev)
    packed[4] = torch.from_numpy(pack_2bit(args[4])).to(dev)
    widths = ["int32"] + (["int16"] if poa_int16_ok(N, L, *scores) else [])
    for dtype in widths:
        want = graph_aligner(N, L, 8, *scores, dtype)(*t)
        for form, a in ((False, t), (True, packed)):
            got = poa_kernels.window_sweep(*a, *scores, dtype, form)
            assert torch.equal(got, want), (dtype, form)


@pytest.mark.gpu
@pytest.mark.parametrize("edge,band", [(1280, 128), (3328, 384)])
def test_wavefront_at_derived_edge_matches_plain_on_card(edge, band):
    """K2 at edges the static ladder never has (multiples of 256), at a
    static bucket's band, against the plain version."""
    from racon_tpu_torch.ops.align import banded_nw, traceback
    from racon_tpu_torch.synth import align_pairs
    from test_torch_align import operands

    dev = _card()
    pairs = align_pairs(edge, edge, band, ("band_edge", "skewed", "full"))
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
         for a in operands(pairs, edge, band)]
    ops, meta = align_kernels.wavefront_align(*t, band)
    bp, dist = banded_nw(*t, band)
    w_ops, w_meta = traceback(bp, dist, t[4], t[2], t[3], band)
    assert torch.equal(meta, w_meta)
    for k in range(len(pairs)):
        assert torch.equal(ops[k, :meta[k, 0]], w_ops[k, :meta[k, 0]])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["int32", "int16"])
def test_fused_at_derived_depths_matches_plain_on_card(dtype):
    """K3 chained at a derived ladder's odd depths (each chunk's plan
    mixing them) and in one fused launch of their sum, against the plain
    version on every state array."""
    from racon_tpu_torch.ops.poa_fused import STATE, fused_raw
    from test_torch_fused_poa import _calls

    dev = _card()
    scores = (3, -5, -4)
    windows = fused_windows()
    for sliced in (False, True):
        eng = FusedPOA(*scores, device=dev, max_nodes=768, max_len=384,
                       batch_rows=len(windows), depth_buckets=(3, 7),
                       score_dtype=dtype)
        state, calls = _calls(eng, windows, sliced)
        got = tuple(torch.from_numpy(np.array(x)).to(dev) for x in state)
        want = tuple(x.clone() for x in got)
        for d, ops, done in calls:
            o = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in ops]
            lbase = torch.full((eng.B,), done, dtype=torch.int32,
                               device=dev)
            seqs, lens, wts, *slicing = o
            got = poa_fused_kernels.fused_layers(
                got, seqs, lens, wts, tuple(slicing), lbase, *scores,
                score_dtype=dtype)
            want = fused_raw(eng.N, eng.L, d, eng.P, *scores,
                             score_dtype=dtype, device_slice=sliced)(
                *want, seqs, lens, wts, *slicing, lbase)
        for name, g, w in zip(STATE, got, want):
            assert torch.equal(g, w), (name, sliced)
