"""The port's banded aligner (racon_tpu_torch/ops/align.py) against the
JAX package's.

The plain PyTorch `banded_nw` + `traceback` — the CPU path of the CUDA
kernel ops/align_kernels.wavefront_align — must give the same per-pair
op runs, distances and band-touched flags as the JAX package's XLA
program (`_banded_nw_kernel` + host `_traceback`) and its Pallas kernel
(interpret mode); the port's BatchAligner must return the same results,
rejects included, as the JAX BatchAligner. The adversarial families
(synth.align_pairs) reach what real overlaps rarely do: band-edge paths,
skewed lengths, full buckets, tiny pairs beside full ones, N bases, a
band of 900, bands of 2048 and 4096 (the kernel's register path at its
widest team, 512 threads, with 4 and 8 cells a thread), bands above the
query and up to the widest the kernel takes. The `gpu`-marked tests hold the kernel to the plain version on
the card. Tolerance: none.
"""

import random

import numpy as np
import pytest
import torch

from racon_tpu_torch.ops import align_kernels
from racon_tpu_torch.ops.align import (BatchAligner, band_offsets,
                                       banded_nw, run_list, runs_of,
                                       traceback)
from racon_tpu_torch.ops.encode import encode_padded
from racon_tpu_torch.synth import align_pairs

ACGT = b"ACGT"


def run_lists(results):
    """BatchAligner.align()'s results with each pair's run arrays as the
    run list the JAX aligner returns (None, a reject, stays None)."""
    return [None if r is None else run_list(r) for r in results]


def jax_align():
    """The JAX package's aligner modules, imported inside the tests that
    need them, so the card tests also run where JAX is not installed."""
    pytest.importorskip("jax")
    from racon_tpu.ops import align, align_pallas

    return align, align_pallas


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
    jalign, _ = jax_align()
    q_arr, t_arr, q_lens, t_lens, offs = ops
    bp, dist = jalign._kernel_for(band, 2 * edge + 1, "int32", False)(
        q_arr, t_arr, q_lens, t_lens, offs)
    runs, touched = jalign._traceback(jalign._unpack_bp(np.asarray(bp)),
                                      offs, q_lens, t_lens)
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


def assert_plain_matches_pallas(pairs, edge, band):
    """The plain version against the Pallas kernel in interpret mode:
    identical ops[:count], count, distance and touched flag."""
    jalign, align_pallas = jax_align()
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
    assert [jalign._runs_of(ops[k, :meta[k, 0]][::-1])
            for k in range(len(pairs))] \
        == [runs_of(p_ops[k, :meta[k, 0]].numpy()[::-1])
            for k in range(len(pairs))]


def test_plain_matches_pallas_kernel():
    rng = random.Random(5)
    edge, band = 512, 64
    pairs = []
    for _ in range(4):
        t = bytes(rng.choice(ACGT) for _ in range(rng.randint(100, edge)))
        pairs.append((mutate(rng, t, 0.12)[:edge], t))
    assert_plain_matches_pallas(pairs, edge, band)


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
    jalign, _ = jax_align()
    want = jalign.BatchAligner(max_length=65536,
                               use_pallas=False).align(pairs)
    al = BatchAligner(device="cpu")
    align_kernels.reset_launches()
    assert run_lists(al.align(pairs)) == want
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


#: adversarial pair families (synth.align_pairs): bucket edge, band, pair
#: kinds, and whether the Pallas kernel (interpret mode) is held too
FAMILIES = {
    "band_edge": (512, 32, ("band_edge",), True),
    "skewed_lengths": (512, 64, ("skewed",), True),
    "full_bucket": (512, 64, ("full",), False),
    "tiny_beside_full": (512, 64, ("tiny", "full"), True),
    "n_bases": (512, 64, ("n_bases",), True),
    "band_900": (1024, 900, ("band_edge", "tiny"), False),
    "band_2048": (2048, 2048, ("band_edge", "tiny", "full"), False),
    "band_4096": (4096, 4096, ("full", "tiny"), False),
    "band_over_query": (512, 256, ("short", "tiny"), False),
    "band_12000": (512, 12000, ("short", "tiny"), False),
    "max_band": (512, align_kernels.MAX_BAND, ("short", "skewed"), False),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plain_matches_jax_on_adversarial_pairs(family):
    """The plain version against the JAX package's XLA program (and, for
    the small bands, its Pallas kernel) on each adversarial family. The
    JAX program packs four codes a byte, so a band is taken down to a
    multiple of 4 (max_band: MAX_BAND - 2)."""
    edge, band, kinds, pallas = FAMILIES[family]
    band = band // 4 * 4
    pairs = align_pairs(len(family), edge, band, kinds)
    ops = operands(pairs, edge, band)
    got = port_decode(ops, band)
    assert got == jax_decode(ops, edge, band)
    if family == "band_edge":
        assert any(got[1])
    if pallas:
        assert_plain_matches_pallas(pairs, edge, band)


@pytest.mark.gpu
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_wavefront_kernel_matches_plain_on_adversarial_pairs_on_card(family):
    """K2 on the card against its plain version on each adversarial
    family, at the family's own band (max_band: MAX_BAND itself), so
    both the register path and the shared-memory path of the kernel
    run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    edge, band, kinds, _ = FAMILIES[family]
    pairs = align_pairs(len(family), edge, band, kinds)
    dev = torch.device("cuda")
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
         for a in operands(pairs, edge, band)]
    ops, meta = align_kernels.wavefront_align(*t, band)
    bp, dist = banded_nw(*t, band)
    w_ops, w_meta = traceback(bp, dist, t[4], t[2], t[3], band)
    assert torch.equal(meta, w_meta)
    for k in range(len(pairs)):
        assert torch.equal(ops[k, :meta[k, 0]], w_ops[k, :meta[k, 0]])
