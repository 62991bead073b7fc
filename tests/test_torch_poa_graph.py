"""The port's POA graph DP (racon_tpu_torch/ops/poa_graph.py) against the
JAX package's.

The plain PyTorch `graph_aligner` — the CPU path of the CUDA kernel
ops/poa_kernels.window_sweep — must give ranks exactly equal to the JAX
package's XLA `graph_aligner` and to its Pallas `window_sweep` (interpret
mode) on the same inputs, built with numpy from a seed; and the port's
session engine on the CPU must give consensus byte-identical to the
port's host engine. Tolerance: none — integer DP with a fixed tie order.
"""

import random

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from racon_tpu.ops.poa_graph import graph_aligner as jax_graph_aligner
from racon_tpu.ops.poa_pallas import window_sweep as pallas_window_sweep
from racon_tpu_torch.core.window import Window, WindowType
from racon_tpu_torch.native import PoaSession, poa_batch
from racon_tpu_torch.ops import poa_kernels
from racon_tpu_torch.ops.poa_graph import DeviceGraphPOA, graph_aligner
from racon_tpu_torch.ops.poa_kernels import window_sweep

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


def linear_graph_inputs(ts, qs, n_nodes, seq_len, max_pred=4):
    """Linear-chain graphs (sequence-as-graph) densified the way the
    session does."""
    B = len(ts)
    codes = np.full((B, n_nodes), 5, dtype=np.int8)
    preds = np.full((B, n_nodes, max_pred), -1, dtype=np.int16)
    centers = np.zeros((B, n_nodes), dtype=np.int16)
    sinks = np.zeros((B, n_nodes), dtype=np.uint8)
    seqs = np.full((B, seq_len), 5, dtype=np.int8)
    lens = np.zeros(B, dtype=np.int32)
    band = np.zeros(B, dtype=np.int32)
    code_of = np.full(256, 4, dtype=np.int8)
    for i, b in enumerate(ACGT):
        code_of[b] = i
    for k, (t, q) in enumerate(zip(ts, qs)):
        codes[k, :len(t)] = code_of[np.frombuffer(t, np.uint8)]
        preds[k, 0, 0] = 0
        for r in range(1, len(t)):
            preds[k, r, 0] = r
        centers[k, :len(t)] = np.arange(1, len(t) + 1)
        sinks[k, len(t) - 1] = 1
        seqs[k, :len(q)] = code_of[np.frombuffer(q, np.uint8)]
        lens[k] = len(q)
    return codes, preds, centers, sinks, seqs, lens, band


def nnodes_of(codes):
    return (codes != 5).sum(axis=1).astype(np.int32)


def port_ranks(N, L, P, scores, args, nnodes=None):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    if nnodes is None:
        return graph_aligner(N, L, P, *scores)(*t).numpy()
    return window_sweep(*t, torch.from_numpy(nnodes), *scores).numpy()


def jax_ranks(N, L, P, scores, args):
    return np.asarray(jax_graph_aligner(N, L, P, *scores)(*args)).astype(
        np.int32)


def linear_case(seed, n, N=96, L=96, P=4):
    rng = random.Random(seed)
    ts, qs = [], []
    for _ in range(n):
        t = bytes(rng.choice(ACGT) for _ in range(rng.randint(40, N - 8)))
        ts.append(t)
        qs.append(mutate(rng, t, 0.15)[:L])
    return linear_graph_inputs(ts, qs, N, L, max_pred=P)


@pytest.mark.parametrize("bandw", [0, 32])
def test_plain_matches_jax_on_linear_graphs(bandw):
    args = list(linear_case(11 + bandw, 6))
    args[6][:] = bandw
    scores = (5, -4, -8)
    want = jax_ranks(96, 96, 4, scores, args)
    np.testing.assert_array_equal(port_ranks(96, 96, 4, scores, args), want)
    # the wrapper on CPU tensors is the plain version, with node counts
    np.testing.assert_array_equal(
        port_ranks(96, 96, 4, scores, args, nnodes_of(args[0])), want)


def test_plain_matches_pallas_kernel_with_padding_row():
    """The Pallas kernel itself (interpret mode), including a zero-length
    padding row (nnodes == 0), the batch-tail shape."""
    codes, preds, centers, sinks, seqs, lens, band = linear_case(53, 5)
    codes[-1, :] = 5
    seqs[-1, :] = 5
    lens[-1] = 0
    sinks[-1, :] = 0
    preds[-1, :, :] = -1
    band[:2] = 32
    args = (codes, preds, centers, sinks, seqs, lens, band)
    nn = nnodes_of(codes)
    pls = np.asarray(pallas_window_sweep(96, 96, 4, 3, -5, -4,
                                         interpret=True)(*args, nn))
    got = port_ranks(96, 96, 4, (3, -5, -4), args, nn)
    np.testing.assert_array_equal(got, pls)
    assert (got[-1] == -2).all()


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


def test_plain_matches_jax_on_evolving_session_jobs():
    """Every job a real session produces — branching graphs, subgraph
    ranges, band centers — gives identical ranks from both packages; the
    JAX ranks are committed so the graphs keep evolving."""
    rng = random.Random(31)
    packed = [pack(w) for w in
              make_windows(rng, 5, length=70, depth=5, rate=0.12)
              + make_windows(rng, 3, length=70, depth=4, spanning=False,
                             rate=0.1)]
    N, L, P = 192, 128, 8
    session = PoaSession(packed, 3, -5, -4, N, P, L, max_jobs=64)
    rounds = 0
    while True:
        jobs = session.prepare()
        if jobs is None:
            break
        n = jobs["n"]
        args = (jobs["codes"][:n, :N], jobs["preds"][:n, :N, :P],
                jobs["centers"][:n, :N], jobs["sinks"][:n, :N],
                jobs["seqs"][:n, :L], jobs["len"][:n], jobs["band"][:n])
        want = jax_ranks(N, L, P, (3, -5, -4), args)
        np.testing.assert_array_equal(
            port_ranks(N, L, P, (3, -5, -4), args, jobs["nnodes"][:n].copy()),
            want, err_msg=f"round {rounds}")
        session.commit(jobs["win"][:n].copy(), jobs["layer"][:n].copy(),
                       jobs["band"][:n].copy(), want)
        rounds += 1
    assert rounds >= 4
    session.close()


def assert_same_consensus(dev, host):
    for i, ((dc, dcov), (hc, hcov)) in enumerate(zip(dev, host)):
        assert dc == hc, f"window {i} consensus diverged"
        np.testing.assert_array_equal(dcov, hcov, err_msg=f"window {i}")


def test_session_engine_cpu_byte_identical_to_host():
    rng = random.Random(5)
    windows = make_windows(rng, 8, length=80, depth=6)
    windows += make_windows(rng, 6, length=90, depth=5, spanning=False)
    packed = [pack(w) for w in windows]
    eng = DeviceGraphPOA(3, -5, -4, device="cpu", num_threads=2,
                         max_nodes=192, max_len=128,
                         buckets=((96, 96), (192, 128)), batch_rows=8)
    poa_kernels.reset_launches()
    dev, statuses = eng.consensus(packed)
    assert (statuses == 0).all(), statuses.tolist()
    # the plain version ran: the kernel counters stay at zero
    assert poa_kernels.launches == 0 and not poa_kernels.launches_by_shape
    assert_same_consensus(dev, poa_batch(packed, 3, -5, -4, n_threads=2))


def test_session_engine_banded_retry_byte_identical():
    """Homopolymer block swap: same length (so the 256-band is used) but
    the true path drifts far off the band — the clipped -> full-DP retry
    must fire and the consensus must still equal the host engine's."""
    rng = random.Random(11)
    windows = []
    for _ in range(2):
        bb = b"A" * 300 + b"C" * 300
        w = Window(0, 0, WindowType.kTGS, bb, b"!" * len(bb))
        w.add_layer(mutate(rng, bb, 0.05), None, 0, len(bb) - 1)
        w.add_layer(mutate(rng, bb, 0.05), None, 0, len(bb) - 1)
        w.add_layer(b"C" * 300 + b"A" * 300, None, 0, len(bb) - 1)
        windows.append(w)
    packed = [pack(w) for w in windows]
    eng = DeviceGraphPOA(5, -4, -8, device="cpu", max_nodes=1280,
                         max_len=640, buckets=((1280, 640),), batch_rows=8)
    dev, statuses = eng.consensus(packed)
    assert (statuses == 0).all(), statuses.tolist()
    assert eng.last_stats["redos"] >= 2, eng.last_stats
    assert_same_consensus(dev, poa_batch(packed, 5, -4, -8))


def test_session_engine_out_of_envelope_window_on_host():
    """A window beyond the (forced) envelope is built by the host engine
    inside the session (status 1) and counted; output still identical."""
    rng = random.Random(6)
    windows = make_windows(rng, 2, length=60)
    big = Window(0, 0, WindowType.kTGS, b"ACGT" * 25, b"!" * 100)
    big.add_layer(b"ACGT" * 25, None, 0, 99)
    big.add_layer(b"ACGTA" * 20, None, 0, 99)
    windows.append(big)  # 100 nodes > max_nodes=96
    packed = [pack(w) for w in windows]
    eng = DeviceGraphPOA(3, -5, -4, device="cpu", max_nodes=96, max_len=96,
                         buckets=((96, 96),), batch_rows=8)
    dev, statuses = eng.consensus(packed)
    assert statuses.tolist() == [0, 0, 1]
    assert eng.last_stats["unfit"] == 1
    assert_same_consensus(dev, poa_batch(packed, 3, -5, -4))


@pytest.mark.gpu
def test_window_sweep_kernel_matches_plain_on_card():
    """K1 on the card against its plain version (chip_smoke.py runs the
    same check on the full-size workload's real jobs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = list(linear_case(7, 6))
    args[6][:3] = 32
    nn = nnodes_of(args[0])
    dev = torch.device("cuda")
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
         for a in args + [nn]]
    got = window_sweep(*t, 5, -4, -8)
    want = graph_aligner(96, 96, 4, 5, -4, -8)(*t)
    assert torch.equal(got, want)
