"""2-bit operand packing in the port against the JAX package's.

`racon_tpu_torch/ops/encode.py`'s `packable` and `pack_2bit` must be
byte-equal to the JAX numpy functions, and `unpack_2bit` (the plain
inverse the kernels' plain versions use) must invert the packing and
restore PAD beyond each length, as `unpack_2bit_jax` does. Both device
engines pack a batch only when every base of it is ACGT (a batch with an
N ships int8 and is counted so), and their results do not depend on the
form or the score dtype. End to end, fragment correction (`-f -c 1
--cudaaligner-batches 1`) at each `--cuda-dtype` writes the JAX
package's FASTA at the same `--tpu-dtype`. The `gpu`-marked tests hold
each kernel instantiation to its plain version on the card. Tolerance:
none, every value is an integer or a byte.
"""

import importlib
import itertools
import random

import numpy as np
import pytest
import torch

from racon_tpu_torch.ops import align_kernels, dtypes, poa_kernels
from racon_tpu_torch.ops.align import BatchAligner, banded_nw, traceback
from racon_tpu_torch.ops.encode import (PAD, encode_padded, pack_2bit,
                                        packable, unpack_2bit)
from racon_tpu_torch.ops.poa_graph import DeviceGraphPOA, graph_aligner
from racon_tpu_torch.synth import (ALIGN_KINDS, align_pairs, ava_overlaps,
                                   max_pred_distance, poa_jobs,
                                   simulate_truth, write_fragment_dataset)

from test_torch_align import run_lists
from test_torch_dtypes import (BOUNDARY, check_posture_runs, k1_jobs,
                               k2_operands, posture_runs)

ACGT = b"ACGT"
INSTANTIATIONS = list(itertools.product(("int32", "int16"), (False, True)))


def jax_module(name: str):
    pytest.importorskip("jax")
    return importlib.import_module(name)


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    monkeypatch.setenv("RACON_TPU_MAX_DEVICES", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def batches(seed):
    """Code batches of widths that are and are not multiples of 4: ACGT
    only, with an N inside a length, and with a non-PAD code beyond one."""
    rng = random.Random(seed)
    out = []
    for width in (1, 7, 8, 30, 64):
        seqs = [bytes(rng.choice(ACGT) for _ in range(rng.randint(0, width)))
                for _ in range(5)]
        codes, lens = encode_padded(seqs, width)
        out.append((codes, lens))
        if lens.max() > 0:
            k = int(np.argmax(lens))
            n = codes.copy()
            n[k, lens[k] - 1] = 4
            out.append((n, lens))
        if lens.min() < width:
            k = int(np.argmin(lens))
            junk = codes.copy()
            junk[k, lens[k]] = 2
            out.append((junk, lens))
    return out


def test_packing_byte_equal_to_jax():
    jenc = jax_module("racon_tpu.ops.encode")
    for codes, lens in batches(3):
        assert packable(codes, lens) == jenc.packable(codes, lens)
        got = pack_2bit(codes)
        assert got.dtype == np.uint8 and got.shape[1] == -(-codes.shape[1]
                                                          // 4)
        np.testing.assert_array_equal(got, jenc.pack_2bit(codes))


def test_unpack_inverts_packing_and_restores_pad():
    jenc = jax_module("racon_tpu.ops.encode")
    n_packable = 0
    for codes, lens in batches(5):
        width = codes.shape[1]
        packed = pack_2bit(codes)
        got = unpack_2bit(torch.from_numpy(packed), width,
                          torch.from_numpy(lens)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jenc.unpack_2bit_jax(packed, width, lens)))
        if packable(codes, lens):
            n_packable += 1
            np.testing.assert_array_equal(got, codes)
        beyond = np.arange(width)[None, :] >= lens[:, None]
        assert (got[beyond] == PAD).all()
    assert n_packable >= 5


def test_batch_aligner_packs_acgt_batches_and_counts_each_form():
    """An ACGT-only bucket ships packed and an N-containing one int8; the
    runs do not depend on the form or the dtype posture, and each batch
    is counted by (dtype, packed)."""
    rng = random.Random(13)
    acgt = [(s, s[:100] + b"ACG" + s[100:])
            for s in (bytes(rng.choice(ACGT) for _ in range(n))
                      for n in (300, 400, 450))]
    with_n = [(b"ACGTNNGT" * 100, b"ACGTACGT" * 100)]       # edge 1024
    pairs = acgt + with_n
    runs = {}
    for posture, pack in itertools.product(dtypes.POSTURES, (True, False)):
        al = BatchAligner(device="cpu", score_dtype=posture,
                          pack_bases=pack)
        runs[(posture, pack)] = run_lists(al.align(pairs))
        narrow = "int32" if posture == "int32" else "int16"
        want = {(narrow, pack): 1, (narrow, False): 1} if pack else \
            {(narrow, False): 2}
        assert al.batches_by_plan == want, (posture, pack)
        assert sum(al.pairs_by_plan.values()) == len(pairs)
    assert len({repr(r) for r in runs.values()}) == 1
    assert all(r is not None for r in runs[("auto", True)])
    # a bucket beyond the int16 proof stays int32 under every posture
    assert BatchAligner(device="cpu", score_dtype="int16").plan_for(
        8192, 896) == "int32"
    with pytest.raises(ValueError):
        BatchAligner(device="cpu", score_dtype="int8")


def poa_windows(seed, n=6, length=120, depth=6, n_base=False):
    """Windows in the session's packing: a backbone and `depth` noisy
    layers each; with `n_base` the first window's backbone holds an N."""
    rng = random.Random(seed)
    out = []
    for w in range(n):
        truth = bytes(rng.choice(ACGT) for _ in range(length))
        seqs = [truth]
        for _ in range(depth):
            s = bytearray(truth)
            for _ in range(length // 10):
                s[rng.randrange(len(s))] = rng.choice(ACGT)
            seqs.append(bytes(s))
        if n_base and w == 0:
            seqs[0] = seqs[0][:10] + b"N" + seqs[0][11:]
        out.append([(s, None, 0, len(s)) for s in seqs])
    return out


def test_session_engine_packs_and_narrows_without_changing_consensus():
    """DeviceGraphPOA on the CPU at every posture, packing on and off:
    one consensus; int16 on the provable bucket, int32 beyond it; a
    window whose graph holds an N ships its batch int8."""
    windows = poa_windows(21) + poa_windows(22, n=2, n_base=True)
    results = {}
    for posture, pack in itertools.product(dtypes.POSTURES, (True, False)):
        eng = DeviceGraphPOA(5, -4, -8, device="cpu", max_nodes=192,
                             max_len=128, buckets=((192, 128),),
                             batch_rows=4, score_dtype=posture,
                             pack_bases=pack)
        res, statuses = eng.consensus(windows)
        assert (statuses == 0).all()
        results[(posture, pack)] = [(c, cov.tolist()) for c, cov in res]
        dts = {dt for dt, _ in eng.batches_by_plan}
        assert dts == ({"int32"} if posture == "int32" else {"int16"})
        forms = {pk for _, pk in eng.batches_by_plan}
        assert forms == ({True, False} if pack else {False}), \
            eng.batches_by_plan
    assert len({repr(r) for r in results.values()}) == 1
    # (2048, 640) at mp 8 is beyond the proof: int32 under every posture
    eng = DeviceGraphPOA(5, -4, -8, device="cpu", score_dtype="int16")
    assert [eng.plan_for(*b) for b in eng.buckets] == \
        ["int16", "int16", "int16", "int32"]


@pytest.fixture(scope="module")
def small_fragment(tmp_path_factory):
    _, _, reads, _ = simulate_truth(random.Random(7), 3000, 5, 1500, 0.12,
                                    0.10)
    return write_fragment_dataset(str(tmp_path_factory.mktemp("frag")),
                                  reads, ava_overlaps(reads))


def test_cli_postures_byte_identical_to_jax_fragment(small_fragment):
    """kF at auto, int32 and int16: one FASTA, the JAX package's at the
    same posture, int16 taken by both engines under auto and int16."""
    check_posture_runs(posture_runs(small_fragment, ["-f"]), b">read")


# ----------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("score_dtype,packed", INSTANTIATIONS)
@pytest.mark.parametrize("band", [32, align_kernels.MAX_BAND])
def test_wavefront_instantiations_match_plain_on_card(score_dtype, packed,
                                                      band):
    """Each K2 instantiation on the card against its plain version at
    edge 512: the register path (band 32) and the shared-memory path
    (MAX_BAND), adversarial pairs, two clamped end cells."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    kinds = tuple(k for k in ALIGN_KINDS if not (packed and k == "n_bases"))
    pairs = align_pairs(23, 512, band, kinds)
    q, t, ql, tl, offs = k2_operands(pairs, 512, band, clamp_lanes=(0,))
    if packed:
        q, t = pack_2bit(q), pack_2bit(t)
    dev = torch.device("cuda")
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (q, t, ql, tl, offs)]
    ops, meta = align_kernels.wavefront_align(*args, band, score_dtype,
                                              packed)
    bp, dist = banded_nw(*args, band, score_dtype, packed)
    w_ops, w_meta = traceback(bp, dist, args[4], args[2], args[3], band)
    assert torch.equal(meta, w_meta)
    for k in range(len(pairs)):
        assert torch.equal(ops[k, :meta[k, 0]], w_ops[k, :meta[k, 0]])


@pytest.mark.gpu
@pytest.mark.parametrize("score_dtype,packed", INSTANTIATIONS)
@pytest.mark.parametrize("case", ["boundary_scores", "ring_overflow"])
def test_window_sweep_instantiations_match_plain_on_card(score_dtype,
                                                         packed, case):
    """Each K1 instantiation on the card against its plain version: at
    the envelope-boundary scores, and with predecessors farther back
    than the ring of a band-0 job holds at that score width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    if case == "boundary_scores":
        N, L, P, scores = 96, 64, 4, BOUNDARY
        jobs = k1_jobs(3, with_n=not packed)
    else:
        N, L, P, scores = 300, 640, 8, (5, -4, -8)
        jobs = list(poa_jobs(4, 4, N, L, P, (0, 256), far=200, pad_rows=1))
        ring = poa_kernels.ring_rows(N, L, P, L, score_dtype)
        assert max_pred_distance(jobs[1], jobs[7]) > ring
    if packed:
        jobs[0], jobs[4] = pack_2bit(jobs[0]), pack_2bit(jobs[4])
    dev = torch.device("cuda")
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in jobs]
    got = poa_kernels.window_sweep(*args, *scores, score_dtype, packed)
    want = graph_aligner(N, L, P, *scores, score_dtype, packed)(*args)
    assert torch.equal(got, want)
