"""Polishing rounds: core/remap.py and Polisher.redraft of the port against
the JAX package.

  - remap: for the reads of the 3 kb draft (8x, 2 kb reads, seed 7) and
    of its two-contig twin against their polished contigs (tagged
    names), the k-mer index, each read's PAF row (both strands, reads
    that anchor nowhere) and the bytes `write_paf` / `write_fasta` write
    equal the JAX module's;
  - a 3-round `redraft` chain on one warm polisher writes, round by
    round, the JAX package's chained run's FASTA, draft and PAF bytes,
    and a fresh polisher on each round's draft and PAF writes the same
    FASTA; with the device aligner's plain version too;
  - redraft refuses an empty round and a draft no read maps onto.

Tolerance: zero, every value is an integer or a byte.
"""

import os
import random

import pytest
import torch

jax = pytest.importorskip("jax")

from racon_tpu.core import polisher as jax_polisher  # noqa: E402
from racon_tpu.core import remap as jax_remap  # noqa: E402
from racon_tpu.io.parsers import create_sequence_parser as jax_parser  # noqa: E402,E501
from racon_tpu_torch.core import remap  # noqa: E402
from racon_tpu_torch.core.polisher import (PolisherType,  # noqa: E402
                                           create_polisher)
from racon_tpu_torch.core.sequence import create_sequence  # noqa: E402
from racon_tpu_torch.errors import RaconError  # noqa: E402
from racon_tpu_torch.io.parsers import create_sequence_parser  # noqa: E402
from racon_tpu_torch.synth import simulate, write_dataset  # noqa: E402
from test_torch_reuse import write_twin  # noqa: E402

SCORES = (5, -4, -8)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("RACON_TPU_MAX_DEVICES", "1")
    monkeypatch.setenv("RACON_TPU_STRICT", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny")
    _, draft, reads, paf = simulate(random.Random(7), 3000, 8, 2000, 0.12,
                                    0.10)
    return {"tiny": write_dataset(str(d), draft, reads, paf),
            "twin": write_twin(str(tmp_path_factory.mktemp("twin")))}


def port(paths, aligner=0):
    return create_polisher(*paths, PolisherType.kC, 500, 10.0, 0.3, True,
                           *SCORES, cuda_aligner_batches=aligner,
                           device="cpu")


def jax_pol(paths, aligner=0):
    return jax_polisher.create_polisher(
        *paths, jax_polisher.PolisherType.kC, 500, 10.0, 0.3, True,
        *SCORES, tpu_aligner_batches=aligner)


def parse(make_parser, path):
    out = []
    p = make_parser(path, "test")
    p.reset()
    p.parse(out, -1)
    return out


@pytest.mark.parametrize("which", ["tiny", "twin"])
def test_remap_rows_and_bytes_match_jax(sets, which, tmp_path):
    paths = sets[which]
    pol = port(paths)
    pol.initialize()
    polished = pol.polish()
    reads = parse(create_sequence_parser, paths[0])
    jreads = parse(jax_parser, paths[0])
    # a read that anchors nowhere, and one of another genome's strand
    junk = create_sequence("junk", bytes(random.Random(1).choice(b"ACGT")
                                         for _ in range(1500)))
    reads.append(junk)
    jreads.append(junk)
    assert (remap.build_index(polished)
            == jax_remap.build_index(polished))
    assert remap.build_index(polished, 11, 3) == jax_remap.build_index(
        polished, 11, 3)
    index = remap.build_index(polished)
    for r in reads[:6] + [junk]:
        assert (remap.remap_read(r, polished, index)
                == jax_remap.remap_read(r, polished, index))
    assert remap.remap_read(junk, polished, index) is None
    rows = remap.remap_overlaps(reads, polished)
    assert rows == jax_remap.remap_overlaps(jreads, polished)
    assert {row.split("\t")[4] for row in rows} == {"+", "-"}
    assert len(rows) == len(reads) - 1
    for args in ((13, 32, 3, 0), (17, 128, 5, 8)):
        assert (remap.remap_overlaps(reads, polished, *args)
                == jax_remap.remap_overlaps(jreads, polished, *args))
    written = []
    for mod in (remap, jax_remap):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        p = mod.write_paf(rows, str(d / "o.paf"))
        f = mod.write_fasta(polished, str(d / "d.fasta"))
        written.append((open(p, "rb").read(), open(f, "rb").read()))
    assert written[0] == written[1]
    assert remap.revcomp(b"ACGTNacgtn") == jax_remap.revcomp(b"ACGTNacgtn")


def chain(pol, workdir, rounds):
    """`rounds` rounds on one polisher: its FASTA per round, and the
    draft and PAF bytes each redraft wrote."""
    out = []
    for k in range(rounds):
        pol.initialize()
        polished = pol.polish()
        fasta = [(s.name, s.data) for s in polished]
        files = None
        if k + 1 < rounds:
            draft, paf = pol.redraft(polished, workdir, f"r{k + 1}")
            files = (draft, paf, open(draft, "rb").read(),
                     open(paf, "rb").read())
        out.append((fasta, files))
    return out


@pytest.mark.parametrize("which,aligner", [("tiny", 0), ("twin", 0),
                                           ("tiny", 1)])
def test_redraft_chain_matches_jax_and_fresh(sets, which, aligner,
                                             tmp_path):
    rounds = 3 if not aligner else 2
    mine_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    mine_dir.mkdir()
    jax_dir.mkdir()
    mine = chain(port(sets[which], aligner), str(mine_dir), rounds)
    theirs = chain(jax_pol(sets[which], aligner), str(jax_dir), rounds)
    for k, ((fasta, files), (jfasta, jfiles)) in enumerate(zip(mine,
                                                               theirs)):
        assert fasta == jfasta, f"round {k + 1}"
        assert (files is None) == (jfiles is None)
        if files is not None:
            assert files[2:] == jfiles[2:], f"round {k + 1}'s draft or PAF"
            assert os.path.basename(files[0]) == f"r{k + 1}_draft.fasta"
    # a fresh polisher per round on the files redraft wrote
    for k in range(1, rounds):
        draft, paf = mine[k - 1][1][:2]
        fresh = port((sets[which][0], paf, draft), aligner)
        fresh.initialize()
        assert [(s.name, s.data) for s in fresh.polish()] == mine[k][0]
    # the rounds moved the contigs
    assert mine[1][0] != mine[0][0]


def test_redraft_refusals(sets, tmp_path):
    pol = port(sets["tiny"])
    with pytest.raises(RaconError, match="no polished sequences"):
        pol.redraft([], str(tmp_path), "r1")
    stranger = [create_sequence("elsewhere", bytes(
        random.Random(2).choice(b"ACGT") for _ in range(3000)))]
    with pytest.raises(RaconError, match="no reads re-mapped"):
        pol.redraft(stranger, str(tmp_path), "r1")
