"""Fragment correction (-f) on the CPU: the port against the JAX package.

On seeded all-vs-all datasets from the port's generator
(`synth.simulate_truth` + `ava_overlaps`), `python -m racon_tpu_torch
--device cpu -f` must write FASTA byte-identical to `racon_tpu -f`
(RACON_TPU_STRICT=1): at `-c 1 --cudaaligner-batches 1` (the kernels'
plain versions against the XLA programs) on a small kTGS set (3 kb
genome, 5x, 1.5 kb reads: on a CPU the plain versions take minutes at
the 6 kb x 10x size), and at `-c 0` on a 6 kb, 10x, 2 kb-read kTGS set
and on the serve layer's 400 bp kNGS set. The overlap filter keeps every
valid overlap under kF (and one per query under kC), the generator's
intervals and strands are checked against noise-free reads, fragment
correction lowers the reads' distance to their truth, and the committed
`tests/data/synth_frag_golden.fasta` (written by `racon_tpu -f -c 1`)
is reproduced by the port's host path. Tolerance: zero, every value is
a byte or an integer.
"""

import contextlib
import gzip
import importlib
import io
import os
import random

import pytest
import torch

from racon_tpu_torch import cli
from racon_tpu_torch.core.polisher import PolisherType, create_polisher
from racon_tpu_torch.native import edit_distance
from racon_tpu_torch.synth import (ava_overlaps, revcomp, simulate_truth,
                                   truth_segment, write_fragment_dataset)

SCORES = ["-m", "5", "-x", "-4", "-g", "-8"]
GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "synth_frag_golden.fasta")
#: simulate_truth's arguments of each dataset: seed, genome length,
#: coverage, read length (12% read error, 10% draft error)
SMALL = (7, 3000, 5, 1500)
TGS = (7, 6000, 10, 2000)
GOLDEN_SET = (42, 40_000, 10, 8000)


def jax_module(name: str):
    """A module of the JAX package, imported by the tests that compare
    with it (the card's test runs without JAX)."""
    pytest.importorskip("jax")
    return importlib.import_module(name)


def fragment_set(directory, seed, genome_len, coverage, read_len):
    truth, _, reads, _ = simulate_truth(random.Random(seed), genome_len,
                                        coverage, read_len, 0.12, 0.10)
    paths = write_fragment_dataset(str(directory), reads,
                                   ava_overlaps(reads))
    return truth, reads, paths


@contextlib.contextmanager
def pinned():
    """The JAX package's strict single-device posture, and one torch
    thread, as the other port tests pin it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RACON_TPU_MAX_DEVICES", "1")
            mp.setenv("RACON_TPU_STRICT", "1")
            yield
    finally:
        torch.set_num_threads(threads)


def run_cli(main, argv) -> bytes:
    """Run a CLI's main in-process; its FASTA (stdout) as bytes."""
    buf = io.BytesIO()
    text = io.TextIOWrapper(buf)
    with pinned(), contextlib.redirect_stdout(text):
        rc = main(argv)
        text.flush()
    assert rc == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return fragment_set(tmp_path_factory.mktemp("small"), *SMALL)


@pytest.fixture(scope="module")
def tgs(tmp_path_factory):
    return fragment_set(tmp_path_factory.mktemp("tgs"), *TGS)


@pytest.fixture(scope="module")
def tgs_port_c0(tgs):
    return run_cli(cli.main, ["--device", "cpu", "-f", "-c", "0", *SCORES,
                              *tgs[2]])


def test_fragment_c1_byte_identical_to_jax(small):
    """-c 1 with the device aligner: the session engine's plain K1 and
    the plain K2 against the JAX package's XLA programs."""
    paths = small[2]
    jax_cli = jax_module("racon_tpu.cli")
    want = run_cli(jax_cli.main, ["-f", "-c", "1", "--tpualigner-batches",
                                  "1", *SCORES, *paths])
    got = run_cli(cli.main, ["--device", "cpu", "-f", "-c", "1",
                             "--cudaaligner-batches", "1", *SCORES, *paths])
    assert got.startswith(b">read") and b"r LN:i:" in got
    assert got == want


def test_fragment_c0_byte_identical_to_jax(tgs, tgs_port_c0):
    jax_cli = jax_module("racon_tpu.cli")
    want = run_cli(jax_cli.main, ["-f", "-c", "0", *SCORES, *tgs[2]])
    assert tgs_port_c0.count(b">") == want.count(b">") > 10
    assert tgs_port_c0 == want


def test_fragment_ngs_byte_identical_to_jax(tmp_path):
    """The serve layer's 400 bp reads: mean length <= 1000, so kNGS
    windows (no coverage trim)."""
    jax_cli = jax_module("racon_tpu.cli")
    server = jax_module("racon_tpu.serve.server")
    paths = server.make_fragment_dataset(str(tmp_path))
    argv = ["-f", "-c", "0", *SCORES, *paths]
    want = run_cli(jax_cli.main, argv)
    got = run_cli(cli.main, ["--device", "cpu", *argv])
    assert got.startswith(b">f") and got == want


def with_rejects(directory, paths) -> tuple[str, str, str]:
    """The dataset's PAF with a self overlap and a high-error overlap
    (spans 800 vs 1,600) at the head of the first query's group, where
    neither can knock out a valid overlap under kC."""
    with gzip.open(paths[1], "rt") as fh:
        rows = fh.read().split("\n")
    f = rows[0].split("\t")
    self_row = "\t".join([f[0], f[1], "0", f[1], "+", f[0], f[1], "0",
                          f[1], f[1], f[1], "60"])
    bad = "\t".join(f[:2] + ["0", "800", "+"] + f[5:7]
                    + ["0", "1600", "800", "1600", "60"])
    path = os.path.join(str(directory), "ava_rejects.paf.gz")
    with gzip.open(path, "wt") as fh:
        fh.write("\n".join([self_row, bad] + rows))
    return paths[0], path, paths[2]


@pytest.mark.parametrize("kind", ["kF", "kC"])
def test_filter_group_keeps_every_valid_overlap_under_kf(tgs, tmp_path,
                                                         kind):
    """kF keeps every overlap but the self and high-error ones; kC one
    per query. Counted by the targets' coverages after initialize, which
    must equal the JAX Polisher's, target by target."""
    jax_polisher = jax_module("racon_tpu.core.polisher")
    paths = with_rejects(tmp_path, tgs[2])
    with gzip.open(paths[1], "rt") as fh:
        rows = [r.split("\t") for r in fh.read().split("\n") if r]
    pols = []
    with pinned():
        for create, types in ((create_polisher, PolisherType),
                              (jax_polisher.create_polisher,
                               jax_polisher.PolisherType)):
            kwargs = {"device": "cpu"} if create is create_polisher else {}
            pol = create(*paths, getattr(types, kind), 500, 10.0, 0.3, True,
                         5, -4, -8, **kwargs)
            pol.initialize()
            pols.append(pol.targets_coverages)
    want = (len(rows) - 2 if kind == "kF"
            else len({r[0] for r in rows}))
    assert sum(pols[0]) == want
    assert pols[0] == pols[1]


def test_generator_overlaps_are_dual_with_true_spans():
    """Noise-free reads: every row's query span, taken onto the forward
    truth strand, is the target's span there, and both are the shared
    truth interval; the strand is relative; both directions are present."""
    truth, _, reads, _ = simulate_truth(random.Random(5), 12_000, 6, 2000,
                                        0.0, 0.0)
    by_name = {r[0]: r for r in reads}
    paf = ava_overlaps(reads, min_overlap=500)
    assert paf and {r[4] for r in reads} == {False, True}
    keys = set()
    for row in paf:
        f = row.split("\t")
        q, t = by_name[f[0]], by_name[f[5]]
        q0, q1, t0, t1 = int(f[2]), int(f[3]), int(f[7]), int(f[8])
        assert q[0] != t[0]
        assert 0 <= q0 < q1 <= len(q[1]) and int(f[1]) == len(q[1])
        assert 0 <= t0 < t1 <= len(t[1]) and int(f[6]) == len(t[1])
        assert f[4] == ("+" if q[4] == t[4] else "-")
        a, b = max(q[2], t[2]), min(q[3], t[3])
        assert b - a >= 500 and int(f[9]) == b - a
        q_fwd = revcomp(q[1][q0:q1]) if q[4] else q[1][q0:q1]
        t_fwd = revcomp(t[1][t0:t1]) if t[4] else t[1][t0:t1]
        assert q_fwd == t_fwd == truth[a:b]
        keys.add((f[0], f[5]))
    assert all((t, q) in keys for q, t in keys)
    n_pairs = sum(1 for i, q in enumerate(reads) for t in reads[i + 1:]
                  if min(q[3], t[3]) - max(q[2], t[2]) >= 500)
    assert len(paf) == 2 * n_pairs


def test_fragment_correction_lowers_distance_to_truth(tgs, tgs_port_c0):
    """The generator's overlaps put each layer where it belongs: the
    corrected reads lie closer to their truth segments (on their own
    strand) than the raw reads do, summed over the reads written."""
    truth, reads, _ = tgs
    by_name = {r[0]: r for r in reads}
    lines = tgs_port_c0.split(b"\n")
    raw = fixed = 0
    for head, seq in zip(lines[0::2], lines[1::2]):
        name = head[1:].split(b" ")[0].decode()
        assert name.endswith("r")
        read = by_name[name[:-1]]
        seg = truth_segment(truth, read)
        raw += edit_distance(read[1], seg)
        fixed += edit_distance(seq, seg)
    assert fixed < raw // 2, (fixed, raw)


def test_golden_reproduced_by_host_path(tmp_path):
    """tests/data/synth_frag_golden.fasta, written by `racon_tpu -f -c 1`
    (session engine, host aligner) on GOLDEN_SET, equals the port's
    `-f -c 0` output on the same data."""
    _, _, paths = fragment_set(tmp_path, *GOLDEN_SET)
    got = run_cli(cli.main, ["--device", "cpu", "-f", "-c", "0", "-t", "4",
                             *SCORES, *paths])
    with open(GOLDEN, "rb") as fh:
        assert got == fh.read()


@pytest.mark.gpu
def test_kernels_match_plain_on_fragment_batches_on_card(small, monkeypatch):
    """On the card, the kF polish of the small set launches K1 and K2;
    every batch they took is held against its plain version at the
    instantiation (score dtype, operand form) it ran (ranks; ops, count,
    distance, touched), and the FASTA equals the host path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from racon_tpu_torch.ops import align_kernels, poa_kernels
    from racon_tpu_torch.ops.align import BatchAligner, banded_nw, traceback
    from racon_tpu_torch.ops.poa_graph import (MAX_PRED, DeviceGraphPOA,
                                               graph_aligner)

    k1_batches, pairs = [], []
    run_bucket = DeviceGraphPOA.run_bucket
    align = BatchAligner.align

    def capture_bucket(self, nb, lb, *args):
        plan = (self.plan_for(nb, lb), args[0].dtype == torch.uint8)
        k1_batches.append(((nb, lb), plan, [a.clone() for a in args]))
        return run_bucket(self, nb, lb, *args)

    def capture_pairs(self, ps, progress=None, **kw):
        pairs.extend(ps)
        return align(self, ps, progress, **kw)

    monkeypatch.setattr(DeviceGraphPOA, "run_bucket", capture_bucket)
    monkeypatch.setattr(BatchAligner, "align", capture_pairs)
    poa_kernels.reset_launches()
    align_kernels.reset_launches()
    got = run_cli(cli.main, ["-f", "-c", "1", "--cudaaligner-batches", "1",
                             *SCORES, *small[2]])
    assert poa_kernels.launches == len(k1_batches) > 0
    assert align_kernels.launches > 0
    for (nb, lb), plan, args in k1_batches:
        want = graph_aligner(nb, lb, MAX_PRED, 5, -4, -8, *plan)(*args)
        assert torch.equal(poa_kernels.window_sweep(*args, 5, -4, -8, *plan),
                           want)
    al = BatchAligner(device="cuda")
    for edge, band, idx in al.chunks(pairs):
        q, t, ql, tl, offs = al.operands(pairs, edge, band, idx)
        plan = (al.plan_for(edge, band), q.dtype == torch.uint8)
        ops, meta = align_kernels.wavefront_align(q, t, ql, tl, offs, band,
                                                  *plan)
        bp, dist = banded_nw(q, t, ql, tl, offs, band, *plan)
        w_ops, w_meta = traceback(bp, dist, offs, ql, tl, band)
        assert torch.equal(meta, w_meta)
        for k in range(len(idx)):
            assert torch.equal(ops[k, :meta[k, 0]], w_ops[k, :meta[k, 0]])
    host = run_cli(cli.main, ["--device", "cpu", "-f", "-c", "0", *SCORES,
                              *small[2]])
    assert got == host
