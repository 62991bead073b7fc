"""The score-dtype posture of the port against the JAX package's.

`racon_tpu_torch/ops/dtypes.py` is a copy of `racon_tpu/ops/dtypes.py`
with the posture as an argument: its overflow proofs and `resolve_dtype`
must agree with the JAX module on a grid of shapes and scores that
crosses each proof's exact boundary. The plain versions of both kernels
at each (int32 | int16) x (int8 | packed) instantiation must equal the
JAX package's programs at the same arguments: `banded_nw` + `traceback`
against the XLA `_banded_nw_kernel` + host `_traceback` (clamped end
cells and an N-containing batch included), `graph_aligner` against the
XLA `graph_aligner(score_dtype, packed_seq)` and the Pallas
`window_sweep(score_dtype, packed)` in interpret mode, at the JAX test's
envelope-boundary scores. End to end, `python -m racon_tpu_torch
--device cpu -c 1 --cudaaligner-batches 1` at `--cuda-dtype` auto,
int32 and int16 writes the same FASTA as `racon_tpu` at `--tpu-dtype` of
the same value (kC here; kF in test_torch_packed.py). The JAX modules are
imported inside the tests. Tolerance: none, every value is an integer.
"""

import contextlib
import importlib
import io
import itertools
import random

import numpy as np
import pytest
import torch

from racon_tpu_torch import cli
from racon_tpu_torch.ops import align_kernels, dtypes, poa_kernels
from racon_tpu_torch.ops.align import band_offsets, runs_of
from racon_tpu_torch.ops.encode import encode_padded, pack_2bit
from racon_tpu_torch.ops.poa_graph import graph_aligner
from racon_tpu_torch.synth import (ALIGN_KINDS, align_pairs, poa_jobs,
                                   simulate, write_dataset)

SCORES = ["-m", "5", "-x", "-4", "-g", "-8"]
#: the JAX test's envelope-boundary scores (tests/test_pallas_poa.py):
#: real path scores within ~1% of NEG16 at (96, 64)
BOUNDARY = (100, -100, -100)


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


# ------------------------------------------------------------ the proofs

#: (n_nodes, seq_len, match, mismatch, gap): the buckets at the CLI's and
#: the wrapper's scores, and each side of the exact boundary
#: (N + L + 2) * mp = 16383 (mp = 3: N + L = 5459) and of the JAX test's
#: (96, 64) at mp = 100
POA_GRID = [(nb, lb, *s) for (nb, lb) in ((320, 256), (768, 640),
                                          (1280, 640), (2048, 640))
            for s in ((3, -5, -4), (5, -4, -8))] + [
    (5000, 459, 3, -3, -2), (5001, 459, 3, -3, -2), (4999, 460, 3, 1, -3),
    (96, 64, *BOUNDARY), (97, 64, *BOUNDARY), (98, 64, *BOUNDARY),
    (0, 0, 8191, 0, 0), (0, 0, 8192, 0, 0), (10, 10, 0, 0, 0)]
EDGES = [1, 512, 1024, 2048, 4096, 8190, 8191, 8192, 16384, 65536]


def test_overflow_proofs_match_jax():
    jd = jax_module("racon_tpu.ops.dtypes")
    assert dtypes.INF16 == jd.INF16 and dtypes.NEG16 == jd.NEG16
    got = [dtypes.poa_int16_ok(*g) for g in POA_GRID]
    assert got == [jd.poa_int16_ok(*g) for g in POA_GRID]
    # the grid does cross the boundary, on both sides
    assert got[8:12] == [True, False, True, True]
    assert dtypes.poa_int16_ok(96, 64, *BOUNDARY)
    assert not dtypes.poa_int16_ok(98, 64, *BOUNDARY)
    got = [dtypes.aligner_int16_ok(e) for e in EDGES]
    assert got == [jd.aligner_int16_ok(e) for e in EDGES]
    assert dtypes.aligner_int16_ok(8191) and not dtypes.aligner_int16_ok(8192)


@pytest.mark.parametrize("mode", dtypes.POSTURES)
def test_resolve_dtype_matches_jax(mode, monkeypatch):
    """The port's explicit posture against the JAX package's
    RACON_TPU_DTYPE knob with no autotuner table entry."""
    jd = jax_module("racon_tpu.ops.dtypes")
    monkeypatch.setenv("RACON_TPU_DTYPE", mode)
    for ok in (False, True):
        assert dtypes.resolve_dtype(ok, mode) == jd.resolve_dtype(ok, None)
    with pytest.raises(ValueError):
        dtypes.resolve_dtype(True, "int8")


# ------------------------------------------------------------------- K2

def k2_operands(pairs, edge, band, clamp_lanes=()):
    """Padded codes, lengths and band offsets; on `clamp_lanes` the band
    is moved one row down from a zero step past mid-path on, so the end
    cell (m, n) lies outside it (the offsets keep steps of 0 or 1)."""
    n_waves = 2 * edge + 1
    q, ql = encode_padded([p[0] for p in pairs], edge)
    t, tl = encode_padded([p[1] for p in pairs], edge)
    offs = np.stack([band_offsets(int(a), int(b), band, n_waves)
                     for a, b in zip(ql, tl)])
    for lane in clamp_lanes:
        mid = (int(ql[lane]) + int(tl[lane])) // 2
        d0 = next(d for d in range(mid, n_waves)
                  if offs[lane, d] == offs[lane, d - 1])
        offs[lane, d0:] += 1
    return q, t, ql, tl, offs


def k2_pairs(packed: bool):
    """Adversarial pairs (synth.align_pairs; the N-base kind only in the
    int8 form) and two balanced pairs whose end cells get clamped."""
    kinds = tuple(k for k in ALIGN_KINDS if not (packed and k == "n_bases"))
    rng = random.Random(11)
    pairs = [(bytes(rng.choice(b"ACGT") for _ in range(n)),
              bytes(rng.choice(b"ACGT") for _ in range(n + 7)))
             for n in (300, 420)]
    return pairs + align_pairs(19, 512, 32, kinds)


@pytest.mark.parametrize("score_dtype,packed",
                         itertools.product(("int32", "int16"),
                                           (False, True)))
def test_plain_k2_matches_jax_xla(score_dtype, packed):
    jalign = jax_module("racon_tpu.ops.align")
    edge, band = 512, 32
    pairs = k2_pairs(packed)
    q, t, ql, tl, offs = k2_operands(pairs, edge, band, clamp_lanes=(0, 1))
    if packed:
        q, t = pack_2bit(q), pack_2bit(t)
    bp, dist = jalign._kernel_for(band, 2 * edge + 1, score_dtype, packed)(
        q, t, ql, tl, offs)
    want_runs, want_touched = jalign._traceback(
        jalign._unpack_bp(np.asarray(bp)), offs, ql, tl)
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (q, t, ql, tl, offs)]
    ops, meta = align_kernels.wavefront_align(*args, band, score_dtype,
                                              packed)
    ops, meta = ops.numpy(), meta.numpy()
    assert [runs_of(ops[k, :meta[k, 0]][::-1])
            for k in range(len(pairs))] == want_runs
    assert (meta[:, 2] > 0).tolist() == want_touched.tolist()
    assert meta[:, 1].tolist() == np.asarray(dist).astype(int).tolist()
    sentinel = dtypes.INF16 if score_dtype == "int16" else 1 << 28
    assert meta[0, 1] == meta[1, 1] == sentinel   # the clamped end cells
    assert (meta[2:, 1] < sentinel).all()


# ------------------------------------------------------------------- K1

def k1_jobs(seed, with_n: bool):
    """Jobs at (96, 64) with in-degree 4, bands 16 and 0, far
    predecessors, a length-0 layer and a padding job; with `with_n` one
    job holds an N node and an N base (so its batch ships int8)."""
    jobs = list(poa_jobs(seed, 4, 96, 64, 4, (16, 0), far=30, pad_rows=1,
                         empty_layers=1))
    if with_n:
        jobs[0][1, 5] = 4
        jobs[4][1, 3] = 4
    return jobs


@pytest.mark.parametrize("score_dtype,packed",
                         itertools.product(("int32", "int16"),
                                           (False, True)))
def test_plain_k1_matches_jax_at_envelope_boundary(score_dtype, packed):
    """graph_aligner at each instantiation against the JAX XLA program of
    the same posture (packed_seq when packed) and the Pallas kernel in
    interpret mode (codes and seq both packed when packed), at scores
    whose real paths sit near NEG16."""
    jpg = jax_module("racon_tpu.ops.poa_graph")
    jpl = jax_module("racon_tpu.ops.poa_pallas")
    N, L, P = 96, 64, 4
    assert dtypes.poa_int16_ok(N, L, *BOUNDARY)
    jobs = k1_jobs(3, with_n=not packed)
    codes, preds, centers, sinks, seq, lens, band, nnodes = jobs
    kw = {} if score_dtype == "int32" else {"score_dtype": score_dtype}
    xla = jpg.graph_aligner(N, L, P, *BOUNDARY, packed_seq=packed, **kw)
    want = np.asarray(xla(codes, preds, centers, sinks,
                          pack_2bit(seq) if packed else seq, lens, band))
    pls = jpl.window_sweep(N, L, P, *BOUNDARY, interpret=True,
                           packed=packed, **kw)
    c, s = (pack_2bit(codes), pack_2bit(seq)) if packed else (codes, seq)
    np.testing.assert_array_equal(
        np.asarray(pls(c, preds, centers, sinks, s, lens, band, nnodes)),
        want)
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (c, preds, centers, sinks, s, lens, band, nnodes)]
    got = graph_aligner(N, L, P, *BOUNDARY, score_dtype, packed)(*args)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    # the wrapper on CPU tensors is the plain version of that posture
    np.testing.assert_array_equal(
        poa_kernels.window_sweep(*args, *BOUNDARY, score_dtype,
                                 packed).numpy(), got.numpy())


def test_plain_k1_int16_equals_int32_across_widths():
    """The cross-width check chip_smoke.py makes on the card, here on the
    plain version: at the boundary scores and at the CLI's, the int16
    ranks equal the int32 ranks (drift below NEG16 never reorders a real
    score here)."""
    for scores, shape in ((BOUNDARY, (96, 64)), ((5, -4, -8), (320, 256))):
        N, L = shape
        jobs = poa_jobs(5, 4, N, L, 8, (64, 0), far=40, pad_rows=1)
        args = [torch.from_numpy(np.ascontiguousarray(a)) for a in jobs]
        wide = graph_aligner(N, L, 8, *scores)(*args)
        narrow = graph_aligner(N, L, 8, *scores, "int16")(*args)
        assert torch.equal(wide, narrow)


# ------------------------------------------------------- CLI end to end

@pytest.fixture(scope="module")
def small_contig(tmp_path_factory):
    _, draft, reads, paf = simulate(random.Random(7), 3000, 5, 1500, 0.12,
                                    0.10)
    return write_dataset(str(tmp_path_factory.mktemp("posture")), draft,
                         reads, paf)


def run_cli(main, argv, posture=None) -> tuple[bytes, str]:
    """A CLI's main in-process under the JAX package's strict
    single-device posture: (stdout FASTA, stderr log). The JAX CLI
    writes --tpu-dtype into RACON_TPU_DTYPE; the monkeypatch undoes it."""
    out, err = io.BytesIO(), io.StringIO()
    text = io.TextIOWrapper(out)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RACON_TPU_STRICT", "1")
        mp.setenv("RACON_TPU_DTYPE", posture or "auto")
        with contextlib.redirect_stdout(text), \
                contextlib.redirect_stderr(err):
            rc = main(argv)
        text.flush()
    assert rc == 0, err.getvalue()[-2000:]
    return out.getvalue(), err.getvalue()


def posture_runs(paths, flags):
    """The port at each --cuda-dtype and the JAX CLI at the same
    --tpu-dtype, `-c 1` and the device aligner on: {posture: (port FASTA,
    port log, JAX FASTA)}."""
    jax_cli = jax_module("racon_tpu.cli")
    out = {}
    for posture in dtypes.POSTURES:
        port, log = run_cli(cli.main, ["--device", "cpu", *flags, "-c", "1",
                                       "--cudaaligner-batches", "1",
                                       "--cuda-dtype", posture, *SCORES,
                                       *paths])
        want, _ = run_cli(jax_cli.main, [*flags, "-c", "1",
                                         "--tpualigner-batches", "1",
                                         "--tpu-dtype", posture, *SCORES,
                                         *paths], posture)
        out[posture] = (port, log, want)
    return out


def check_posture_runs(runs, head: bytes):
    fasta = runs["auto"][0]
    assert fasta.startswith(head)
    for posture, (port, log, want) in runs.items():
        assert port == fasta and want == fasta, posture
        # the polisher's launch split: both engines, by dtype and form
        split = [line for line in log.splitlines()
                 if "batches by score dtype and operand form" in line]
        assert len(split) == 2, log[-2000:]
        if posture == "int32":
            assert not any("int16" in line for line in split), split
        else:
            assert all("int16 packed" in line for line in split), split


def test_cli_postures_byte_identical_to_jax_contig(small_contig):
    """kC at auto, int32 and int16: one FASTA, the JAX package's at the
    same posture; auto and int16 take int16 on the aligner's and the
    session's buckets (the polisher's launch split says so), int32
    never."""
    check_posture_runs(posture_runs(small_contig, []), b">draft LN:i:")
