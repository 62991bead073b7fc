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
node envelope that overflows (`failed`), and windows of mixed sizes in
one batch. tests/test_torch_fused_poa16.py runs the same cases at int16.
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
}


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
    # the overflow case's windows all fail on the device; the rest build
    assert failed.all() if name == "overflow" else not failed.any()


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["int32", "int16"])
def test_fused_kernel_matches_plain_on_card(dtype):
    """K3 on the card against its plain version, every state array, on
    adversarial windows (a predecessor beyond the ring, insertion runs,
    deletions), the band-clip windows and windows of mixed sizes, on both
    postures (chip_smoke.py runs the same hold on the full-size
    workload's windows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    scores = (3, -5, -4)
    windows = [pack(w) for w in (adversarial_windows()
                                 + band_clip_windows()
                                 + CASES["mixed"][0]())]
    for sliced in (False, True):
        eng = FusedPOA(*scores, device=dev, max_nodes=1024, max_len=640,
                       batch_rows=len(windows), depth_buckets=(4, 8),
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
            assert torch.equal(g, w), (name, sliced)
        assert bool(got[STATE.index("failed")][0])  # the ring case fails
