"""The port's banded aligner (racon_tpu_torch/ops/align.py) against the
JAX package's.

The plain PyTorch `banded_nw` + `traceback` — the CPU path of the CUDA
kernel ops/align_kernels.wavefront_align — must give the same per-pair
op runs, distances and band-touched flags as the JAX package's XLA
program (`_banded_nw_kernel` + host `_traceback`) and its Pallas kernel
(interpret mode); the port's BatchAligner must return the same results,
rejects included, as the JAX BatchAligner. Tolerance: none.
"""

import random

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from racon_tpu.ops import align_pallas
from racon_tpu.ops.align import BatchAligner as JaxBatchAligner
from racon_tpu.ops.align import _kernel_for, _runs_of, _traceback, _unpack_bp
from racon_tpu_torch.ops import align_kernels
from racon_tpu_torch.ops.align import (BatchAligner, band_offsets,
                                       banded_nw, runs_of, traceback)
from racon_tpu_torch.ops.encode import encode_padded

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


def operands(pairs, edge, band):
    n_waves = 2 * edge + 1
    q_arr, q_lens = encode_padded([p[0] for p in pairs], edge)
    t_arr, t_lens = encode_padded([p[1] for p in pairs], edge)
    offs = np.stack([band_offsets(int(a), int(b), band, n_waves)
                     for a, b in zip(q_lens, t_lens)])
    return q_arr, t_arr, q_lens, t_lens, offs


def jax_decode(ops, edge, band):
    q_arr, t_arr, q_lens, t_lens, offs = ops
    bp, dist = _kernel_for(band, 2 * edge + 1, "int32", False)(
        q_arr, t_arr, q_lens, t_lens, offs)
    runs, touched = _traceback(_unpack_bp(np.asarray(bp)), offs, q_lens,
                               t_lens)
    return runs, touched.tolist(), np.asarray(dist).astype(np.int64).tolist()


def port_decode(ops, band):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in ops]
    out, meta = align_kernels.wavefront_align(*t, band)
    out, meta = out.numpy(), meta.numpy()
    runs = [runs_of(out[k, :meta[k, 0]][::-1]) for k in range(len(meta))]
    return runs, (meta[:, 2] > 0).tolist(), meta[:, 1].astype(np.int64).tolist()


@pytest.mark.parametrize("edge,band", [(512, 64), (1024, 128)])
def test_plain_matches_jax_fuzz(edge, band):
    rng = random.Random(17 + edge)
    pairs = []
    for _ in range(6):
        t = bytes(rng.choice(ACGT) for _ in range(rng.randint(30, edge)))
        pairs.append((mutate(rng, t, 0.15)[:edge], t))
    pairs.append((b"A" * edge, b"T" * edge))   # maximal cost, full bucket
    pairs.append((b"A", b"A"))                 # minimal pair
    pairs.append((b"ACGTNNAC" * 20, b"ACGTACGT" * 20))  # N bases
    ops = operands(pairs, edge, band)
    assert port_decode(ops, band) == jax_decode(ops, edge, band)


def test_band_edge_cases_match_and_trip_the_signal():
    """Pairs whose optimal path rides or crosses the band boundary: the
    touched / cost signals decide host realignment, so they must agree."""
    rng = random.Random(23)
    edge, band = 512, 32
    base = bytes(rng.choice(ACGT) for _ in range(400))
    pairs = [
        (base[100:] + base[:100], base),           # rotation: off-band
        (base[:200] + base[300:], base),           # 100 bp deletion
        (base, base[:150]),                        # very skewed lengths
        (mutate(rng, base, 0.4)[:edge], base),     # mismatch soup
    ]
    ops = operands(pairs, edge, band)
    got = port_decode(ops, band)
    assert got == jax_decode(ops, edge, band)
    assert any(got[1]) or any(d > 0.4 * 400 for d in got[2])


def test_plain_matches_pallas_kernel():
    rng = random.Random(5)
    edge, band = 512, 64
    pairs = []
    for _ in range(4):
        t = bytes(rng.choice(ACGT) for _ in range(rng.randint(100, edge)))
        pairs.append((mutate(rng, t, 0.12)[:edge], t))
    q_arr, t_arr, q_lens, t_lens, offs = operands(pairs, edge, band)
    qx, tx = align_pallas.build_ext(q_arr, t_arr, band)
    ops, meta = align_pallas.wavefront_align(edge, band, "int32", False,
                                             interpret=True)(
        qx, tx, q_lens, t_lens, offs)
    ops, meta = np.asarray(ops), np.asarray(meta)
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (q_arr, t_arr, q_lens, t_lens, offs)]
    bp, dist = banded_nw(*t, band)
    p_ops, p_meta = traceback(bp, dist, t[4], t[2], t[3], band)
    np.testing.assert_array_equal(p_meta.numpy(), meta[:, :3])
    for k in range(len(pairs)):
        np.testing.assert_array_equal(p_ops[k, :meta[k, 0]].numpy(),
                                      ops[k, :meta[k, 0]])
    assert [_runs_of(ops[k, :meta[k, 0]][::-1]) for k in range(len(pairs))] \
        == [runs_of(p_ops[k, :meta[k, 0]].numpy()[::-1])
            for k in range(len(pairs))]


def test_batch_aligner_matches_jax_including_rejects():
    """Mixed buckets, a band-clipped rotation, N bases, an empty pair and
    one beyond the largest bucket: identical accepted runs and rejects."""
    rng = random.Random(31)
    pairs = []
    for n in (100, 500, 600, 1500):
        t = bytes(rng.choice(ACGT) for _ in range(n))
        pairs.append((mutate(rng, t, 0.1), t))
    t = bytes(rng.choice(ACGT) for _ in range(800))
    pairs.append((t[400:] + t[:400], t))          # rotation: rejected
    pairs.append((b"ACGNNNGT" * 40, b"ACGTACGT" * 40))
    pairs.append((b"", b"ACGT"))                  # unbucketable
    pairs.append((b"A" * 70000, b"A" * 70000))    # beyond max bucket
    want = JaxBatchAligner(max_length=65536, use_pallas=False).align(pairs)
    al = BatchAligner(device="cpu")
    align_kernels.reset_launches()
    assert al.align(pairs) == want
    assert want[4] is None and want[-1] is None and want[-2] is None
    assert al.n_unbucketed == 2 and al.n_band_rejects >= 1
    # the plain version ran: the kernel counter stays at zero
    assert align_kernels.launches == 0


@pytest.mark.gpu
def test_wavefront_kernel_matches_plain_on_card():
    """K2 on the card against its plain version (chip_smoke.py runs the
    same check on the full-size workload's real pairs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = random.Random(9)
    pairs = []
    for _ in range(5):
        t = bytes(rng.choice(ACGT) for _ in range(rng.randint(100, 500)))
        pairs.append((mutate(rng, t, 0.12)[:512], t))
    dev = torch.device("cuda")
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
         for a in operands(pairs, 512, 64)]
    ops, meta = align_kernels.wavefront_align(*t, 64)
    bp, dist = banded_nw(*t, 64)
    w_ops, w_meta = traceback(bp, dist, t[4], t[2], t[3], 64)
    assert torch.equal(meta, w_meta)
    for k in range(len(pairs)):
        assert torch.equal(ops[k, :meta[k, 0]], w_ops[k, :meta[k, 0]])
