"""The port's fused whole-window POA program (racon_tpu_torch/ops/
poa_fused.py) against the JAX package's, at int32 scores.

The plain PyTorch `fused_raw` — the CPU path of the CUDA kernel K3
(ops/poa_fused_kernels.fused_layers) — must give all 11 state arrays of
the JAX `fused_raw` (jit on the CPU) exactly, on the split posture (the
host slices each chained call) and the fused one (one call, sliced on the
device), from the same windows packed by each package's own packer:
spanning windows with a rotated adversarial layer, non-spanning layers
(the bpos-range subgraph), a layer that trips the band-clip retry, a
deep window chained over several calls with their layer-index salts, a
node envelope that overflows (`failed`), windows of mixed sizes in one
batch, and the edges the kernel's design leans on: a predecessor exactly
RING (128) ranks back, which passes, and one 129 back, which fails the
ring rule; a full-DP retry at a layer length equal to the engine's L
(the widest ring row); a graph that ends two nodes short of N beside
one that overflows it (the sort of the live nodes only). A predecessor
later in rank order cannot be built at test size: it needs two columns
with one key, and insertion keys only repeat across layers 256 apart
(the salt) between the same neighbours.
tests/test_torch_fused_poa16.py runs the same cases at int16.
The port's `poa_finish_arrays` binding gives the JAX binding's consensus
and coverages on the same arrays. Tolerance: none — integer DP with a
fixed tie order and integer keys.

The `gpu`-marked test holds K3 against the plain version on the card.
JAX is imported inside the tests that compare with it, so that test runs
where JAX is absent.
"""

import random

import numpy as np
import pytest
import torch

from racon_tpu_torch.core.window import Window, WindowType
from racon_tpu_torch.ops import poa_fused_kernels
from racon_tpu_torch.ops.poa_fused import STATE, FusedPOA, fused_raw

ACGT = b"ACGT"


@pytest.fixture(autouse=True)
def _one_device(monkeypatch):
    monkeypatch.setenv("RACON_TPU_MAX_DEVICES", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def make_windows(rng, n_windows, length=60, depth=6, rate=0.08,
                 spanning=True):
    windows = []
    for _ in range(n_windows):
        truth = bytes(rng.choice(ACGT) for _ in range(length))
        bb = mutate(rng, truth, rate)
        w = Window(0, 0, WindowType.kTGS, bb, b"!" * len(bb))
        for _ in range(depth):
            if spanning:
                lay, b, e = mutate(rng, truth, rate), 0, len(bb) - 1
            else:
                b = rng.randrange(0, len(bb) // 3)
                e = rng.randrange(2 * len(bb) // 3, len(bb) - 1)
                lay = mutate(rng, truth[b:e + 1], rate)
            w.add_layer(lay or b"A", None, b, e)
        windows.append(w)
    return windows


def pack(w):
    return [(w.sequences[i], w.qualities[i], w.positions[i][0],
             w.positions[i][1]) for i in range(len(w.sequences))]


def band_clip_windows():
    """A layer whose only true match region lies outside its band, with
    filler that matches nothing in-band: the host's band_clipped rule
    redoes it with the full DP (tests/test_fused_poa.py's construction)."""
    rng = random.Random(79)
    out = []
    for _ in range(3):
        R = bytes(rng.choice(ACGT) for _ in range(100))
        bb = b"A" * 300 + R
        w = Window(0, 0, WindowType.kTGS, bb, b"!" * len(bb))
        for _ in range(2):
            w.add_layer(mutate(rng, R, 0.03) + b"C" * 250, None, 0,
                        len(bb) - 1)
        out.append(w)
    return out


def adversarial_windows():
    """A 300-base insertion that puts a predecessor more than RING ranks
    back (ring_fail on the next layer), a run of growing insertions at
    one place, and a layer with a 30-base deletion, repeated."""
    rng = random.Random(3)
    out = []
    for i in range(3):
        bb = bytes(rng.choice(b"ACG") for _ in range(200))
        w = Window(0, 0, WindowType.kTGS, bb, b"!" * len(bb))
        if i == 0:
            w.add_layer(bb[:100] + b"T" * 300 + bb[100:], None, 0,
                        len(bb) - 1)
            w.add_layer(bb, None, 0, len(bb) - 1)
        elif i == 1:
            for k in range(1, 13):
                w.add_layer(bb[:100] + b"T" * k + bb[100:], None, 0,
                            len(bb) - 1)
        else:
            for _ in range(4):
                w.add_layer(bb[:60] + bb[90:], None, 0, len(bb) - 1)
        out.append(w)
    return out


def ring_distance_windows(insert):
    """A 200-base backbone whose first layer inserts `insert` bases after
    its node 99: node 100's predecessor 99 then lies insert + 1 ranks
    back. At 127 (128 back) the window passes the ring rule; at 128 (129
    back) its second layer sets ring_fail."""
    rng = random.Random(31)
    bb = bytes(rng.choice(b"ACG") for _ in range(200))
    w = Window(0, 0, WindowType.kTGS, bb, b"!" * len(bb))
    w.add_layer(bb[:100] + b"T" * insert + bb[100:], None, 0, len(bb) - 1)
    w.add_layer(bb, None, 0, len(bb) - 1)
    w.add_layer(bb[:50] + bb[60:], None, 0, len(bb) - 1)
    return [w]


def wide_retry_windows(L=640):
    """Layers of exactly L bases whose only true match lies outside their
    band (band_clip_windows' construction at full length): the band-clip
    retry runs the full DP at slen == L, the widest ring row."""
    rng = random.Random(47)
    out = []
    for _ in range(2):
        R = bytes(rng.choice(ACGT) for _ in range(100))
        bb = b"A" * (L - 100) + R
        w = Window(0, 0, WindowType.kTGS, bb, b"!" * len(bb))
        for _ in range(2):
            m = mutate(rng, R, 0.03)
            w.add_layer(m + b"C" * (L - len(m)), None, 0, len(bb) - 1)
        out.append(w)
    return out


def near_full_windows():
    """A window whose graph ends two nodes short of its case's N (144),
    and the same window with one more layer (an 8-base insertion), which
    overflows the node envelope: the sort of the live nodes at nn near N
    (its power-of-two padding above N) and the overflow path."""
    w = make_windows(random.Random(21), 1, length=100, depth=6, rate=0.1)[0]
    bb = w.sequences[0]
    w2 = Window(0, 0, WindowType.kTGS, bb, b"!" * len(bb))
    for i in range(1, len(w.sequences)):
        w2.add_layer(w.sequences[i], None, *w.positions[i])
    w2.add_layer(bb[:50] + b"T" * 8 + bb[50:], None, 0, len(bb) - 1)
    return [w, w2]


def spanning_windows():
    ws = make_windows(random.Random(5), 4, length=220, depth=7, rate=0.12)
    bb = ws[0].sequences[0]
    ws[0].add_layer(bb[110:] + bb[:110], None, 0, len(bb) - 1)
    return ws


#: name -> (windows, N, L, depth buckets, scores)
CASES = {
    "spanning": (spanning_windows, 768, 384, (8,), (3, -5, -4)),
    "subrange": (lambda: make_windows(random.Random(12), 4, length=110,
                                      depth=5, spanning=False, rate=0.1),
                 512, 256, (8,), (3, -5, -4)),
    "band_clip": (band_clip_windows, 1024, 640, (2,), (5, -4, -8)),
    "chained": (lambda: make_windows(random.Random(9), 2, length=220,
                                     depth=11, rate=0.1),
                768, 384, (4,), (3, -5, -4)),
    "overflow": (lambda: make_windows(random.Random(6), 3, length=220,
                                      depth=5, rate=0.1),
                 230, 384, (8,), (3, -5, -4)),
    "mixed": (lambda: (make_windows(random.Random(9), 2, length=220,
                                    depth=11, rate=0.1)
                       + make_windows(random.Random(19), 2, length=90,
                                      depth=3, rate=0.1)),
              768, 384, (4, 8), (3, -5, -4)),
    "ring128": (lambda: ring_distance_windows(127), 512, 384, (8,),
                (3, -5, -4)),
    "ring129": (lambda: ring_distance_windows(128), 512, 384, (8,),
                (3, -5, -4)),
    "wide_retry": (wide_retry_windows, 1280, 640, (2,), (3, -5, -4)),
    "near_full": (near_full_windows, 144, 128, (8,), (3, -5, -4)),
}

#: each case's `failed` flags after its run (the rest build every window)
FAILED = {"overflow": [True] * 3, "ring129": [True],
          "near_full": [False, True]}


def _calls(eng, windows, sliced):
    """(initial state, [(depth, operands, layer base)]) from an engine's
    own packer: each chained call on the split posture, one call over
    the whole chain on the fused one."""
    chunk = list(range(len(windows)))
    if sliced:
        D = sum(eng._chain_plan(max(len(w) - 1 for w in windows)))
        state, ops = eng._pack_chunk_fused(windows, chunk, D)
        return state, [(D, ops, 0)]
    return eng._pack_chunk(windows, chunk)


def port_run(windows, N, L, buckets, scores, dtype, sliced,
             banded_only=False):
    eng = FusedPOA(*scores, device="cpu", max_nodes=N, max_len=L,
                   batch_rows=len(windows), depth_buckets=buckets)
    state, calls = _calls(eng, windows, sliced)
    state = tuple(torch.from_numpy(np.array(x)) for x in state)
    for d, ops, done in calls:
        run = fused_raw(N, L, d, 8, *scores, banded_only=banded_only,
                        score_dtype=dtype, device_slice=sliced)
        state = run(*state, *(torch.from_numpy(np.array(o)) for o in ops),
                    torch.full((len(windows),), done, dtype=torch.int32))
    return [x.numpy() for x in state]


def jax_run(windows, N, L, buckets, scores, dtype, sliced):
    from racon_tpu.ops.poa_fused import FusedPOA as JaxFusedPOA
    from racon_tpu.ops.poa_fused import fused_raw as jax_fused_raw

    eng = JaxFusedPOA(*scores, max_nodes=N, max_len=L,
                      batch_rows=len(windows), depth_buckets=buckets)
    assert eng.B == len(windows)
    state, calls = _calls(eng, windows, sliced)
    for d, ops, done in calls:
        run = jax_fused_raw(N, L, d, 8, *scores, score_dtype=dtype,
                            device_slice=sliced)
        state = run(*state, *ops, np.full(len(windows), done, np.int32))
    return [np.asarray(x) for x in state]


def assert_same_state(got, want):
    for name, g, w in zip(STATE, got, want):
        assert g.dtype == w.dtype, name
        assert np.array_equal(g, w), (
            f"{name} differs at {np.argwhere(g != w)[:5].tolist()}")


def check_case(name, dtype, sliced):
    make, N, L, buckets, scores = CASES[name]
    windows = [pack(w) for w in make()]
    got = port_run(windows, N, L, buckets, scores, dtype, sliced)
    want = jax_run(windows, N, L, buckets, scores, dtype, sliced)
    assert_same_state(got, want)
    return got


@pytest.mark.parametrize("sliced", [False, True], ids=["split", "fused"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_fused_raw_int32(name, sliced):
    state = check_case(name, "int32", sliced)
    failed = state[STATE.index("failed")]
    assert failed.tolist() == FAILED.get(name, [False] * len(failed))


def graph_ranks(codes, col_of, colkey):
    """Each node's rank in the fused program's topological order (the
    sort of column key << 11 | id; free nodes last)."""
    ids = np.arange(len(codes), dtype=np.int64)
    key = np.where(codes >= 0,
                   (colkey[np.clip(col_of, 0, None)] << 11) | ids,
                   (1 << 62) | ids)
    rank = np.empty_like(ids)
    rank[np.argsort(key, kind="stable")] = ids
    return rank


@pytest.mark.parametrize("insert,back", [(127, 128), (128, 129)])
def test_ring_cases_straddle_the_ring(insert, back):
    """Non-vacuity of the ring cases: after the first layer the farthest
    predecessor lies exactly 128 / 129 ranks back (RING = 128), and only
    the second case fails."""
    w = pack(ring_distance_windows(insert)[0])
    state = port_run([w[:2]], 512, 384, (8,), (3, -5, -4), "int32", False)
    codes, preds, col_of, colkey = (state[STATE.index(k)][0] for k in (
        "codes", "preds", "col_of", "colkey"))
    rank = graph_ranks(codes, col_of, colkey)
    live = np.flatnonzero(codes >= 0)
    dist = [rank[v] - rank[u] for v in live for u in preds[v] if u >= 0]
    assert max(dist) == back
    full = check_case(f"ring{back}", "int32", False)
    assert bool(full[STATE.index("failed")][0]) == (back > 128)


def test_wide_retry_case_retries_at_full_length():
    """Non-vacuity of the wide_retry case: every layer is exactly L long
    and the host's band_clipped rule fires (the session engine counts a
    full-DP redo)."""
    from racon_tpu_torch.ops.poa_graph import DeviceGraphPOA

    _, N, L, _, scores = CASES["wide_retry"]
    windows = [pack(w) for w in wide_retry_windows()]
    assert {len(x[0]) for w in windows for x in w[1:]} == {L}
    sess = DeviceGraphPOA(*scores, device="cpu", max_nodes=N, max_len=L,
                          buckets=((N, L),), batch_rows=2)
    sess.consensus(windows)
    assert sess.last_stats["redos"] >= 1, sess.last_stats


def test_near_full_case_ends_two_nodes_short():
    """Non-vacuity of the near_full case: its first window ends with
    N - 2 nodes, its second overflows."""
    make, N, L, buckets, scores = CASES["near_full"]
    state = port_run([pack(w) for w in make()], N, L, buckets, scores,
                     "int32", False)
    assert state[STATE.index("n_nodes")][0] == N - 2
    assert state[STATE.index("failed")].tolist() == [False, True]


def test_band_clip_case_really_retries():
    """Non-vacuity of the band_clip case: the host's band_clipped rule
    really fires on its layers (the session engine, which applies the
    same rule, counts a full-DP redo for every one of them)."""
    from racon_tpu_torch.ops.poa_graph import DeviceGraphPOA

    windows = [pack(w) for w in band_clip_windows()]
    sess = DeviceGraphPOA(5, -4, -8, device="cpu", max_nodes=1024,
                          max_len=640, buckets=((1024, 640),), batch_rows=4)
    sess.consensus(windows)
    assert sess.last_stats["redos"] >= 3, sess.last_stats


def test_chained_case_chains_with_layer_salts():
    """The chained case runs 3 calls of 4 layers on the split posture,
    salting insertion keys with the layer index across the calls."""
    make, N, L, buckets, scores = CASES["chained"]
    eng = FusedPOA(*scores, device="cpu", max_nodes=N, max_len=L,
                   batch_rows=2, depth_buckets=buckets)
    _, calls = _calls(eng, [pack(w) for w in make()], False)
    assert [(d, done) for d, _, done in calls] == [(4, 0), (4, 4), (4, 8)]


def test_poa_finish_arrays_matches_jax_binding():
    """The port's binding of rh_poa_finish_arrays gives the JAX binding's
    consensus and coverages on the same fetched arrays."""
    from racon_tpu.native import poa_finish_arrays as jax_finish

    from racon_tpu_torch.native import poa_finish_arrays

    make, N, L, buckets, scores = CASES["spanning"]
    state = port_run([pack(w) for w in make()], N, L, buckets, scores,
                     "int32", False)
    args = [state[STATE.index(k)] for k in (
        "codes", "preds", "predw", "nseq", "col_of", "colkey", "n_nodes")]
    got = poa_finish_arrays(*args, n_threads=2)
    want = jax_finish(*args, n_threads=2)
    assert len(got) == len(want) == 4
    for (gc, gcov), (wc, wcov) in zip(got, want):
        assert gc == wc and len(gc) > 100
        np.testing.assert_array_equal(gcov, wcov)


@pytest.mark.parametrize("dtype", ["int32", "int16"])
def test_scratch_is_band_compact(dtype):
    """K3's scratch: a score spill at the score dtype holding every row of
    a banded DP at the band's width (272-column rows, a band of 256 keeps
    257 columns) or the last RING rows of a full one, whichever is
    larger, and one int8 backpointer row of L columns (rounded up to 16)
    per node. The CPU path of fused_layers ignores a scratch passed in."""
    want = torch.int16 if dtype == "int16" else torch.int32
    for N, L, cells in ((2048, 640, 2048 * 272), (100, 640, 128 * 640),
                        (144, 120, 144 * 272)):
        spill, bps = poa_fused_kernels.scratch(3, N, L, "cpu", dtype)
        assert spill.dtype == want and tuple(spill.shape) == (3, cells)
        lw = (L + 15) // 16 * 16
        assert bps.dtype == torch.int8 and tuple(bps.shape) == (3, N, lw)
    make, N, L, buckets, scores = CASES["near_full"]
    eng = FusedPOA(*scores, device="cpu", max_nodes=N, max_len=L,
                   batch_rows=2, depth_buckets=buckets, score_dtype=dtype)
    state, calls = _calls(eng, [pack(w) for w in make()], False)
    d, ops, done = calls[0]
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in ops]
    seqs, lens, wts, *slicing = args
    lbase = torch.full((2,), done, dtype=torch.int32)
    runs = []
    for scratch in (None, (torch.zeros(1), torch.zeros(1))):
        st = tuple(torch.from_numpy(np.array(x)) for x in state)
        runs.append(poa_fused_kernels.fused_layers(
            st, seqs, lens, wts, tuple(slicing), lbase, *scores,
            score_dtype=dtype, scratch=scratch))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["int32", "int16"])
def test_fused_kernel_matches_plain_on_card(dtype):
    """K3 on the card against its plain version, every state array, on
    adversarial windows (a predecessor beyond the ring, insertion runs,
    deletions), the band-clip windows and windows of mixed sizes, and on
    the ring128 / ring129 / wide_retry / near_full cases at their own
    envelopes, on both postures (chip_smoke.py runs the same hold on the
    full-size workload's windows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    scores = (3, -5, -4)
    sets = [([pack(w) for w in (adversarial_windows() + band_clip_windows()
                                 + CASES["mixed"][0]())], 1024, 640, (4, 8),
             [True] + [False] * 9)]
    for name in ("ring128", "ring129", "wide_retry", "near_full"):
        make, N, L, buckets, _ = CASES[name]
        ws = [pack(w) for w in make()]
        sets.append((ws, N, L, buckets,
                     FAILED.get(name, [False] * len(ws))))
    for windows, N, L, buckets, failed in sets:
        for sliced in (False, True):
            eng = FusedPOA(*scores, device=dev, max_nodes=N, max_len=L,
                           batch_rows=len(windows), depth_buckets=buckets,
                           score_dtype=dtype)
            assert eng.score_dtype == dtype
            state, calls = _calls(eng, windows, sliced)
            got = tuple(torch.from_numpy(np.array(x)).to(dev) for x in state)
            want = tuple(x.clone() for x in got)
            before = poa_fused_kernels.launches
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
            torch.cuda.synchronize()
            assert poa_fused_kernels.launches == before + len(calls)
            for name, g, w in zip(STATE, got, want):
                assert torch.equal(g, w), (name, sliced, N)
            assert got[STATE.index("failed")].tolist() == failed
