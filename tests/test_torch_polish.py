"""End to end on the CPU: the port's CLI against the JAX package's CLI.

On a tiny seeded dataset from the port's simulator (a few kb, ~8x, 2 kb
reads), `python -m racon_tpu_torch --device cpu -c 1
--cudaaligner-batches 1` must write FASTA byte-identical to `racon_tpu
-c 1 --tpualigner-batches 1` (XLA programs, RACON_TPU_STRICT=1), and the
same again at -c 0 (host POA). A 4 kb draft with 21 reads of 1.5 kb,
written as FASTQ (Phred qualities) or FASTA and with its overlaps as
PAF, MHAP or SAM (CIGARs from the host Myers aligner, soft clips, the
reverse flag), pins the parsers and both CLIs on every input format.
Tolerance: zero — every value is an integer or a byte.
"""

import gzip
import os
import random
import sys

import pytest
import torch

jax = pytest.importorskip("jax")

from racon_tpu import cli as jax_cli
from racon_tpu_torch import cli
from racon_tpu_torch.core.polisher import PolisherType, create_polisher
from racon_tpu_torch.errors import RaconError
from racon_tpu_torch.native import nw_cigar
from racon_tpu_torch.synth import (revcomp, simulate, simulate_truth,
                                   write_dataset)

SCORES = ["-m", "5", "-x", "-4", "-g", "-8"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny")
    _, draft, reads, paf = simulate(random.Random(7), 3000, 8, 2000, 0.12,
                                    0.10)
    return write_dataset(str(d), draft, reads, paf)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("RACON_TPU_MAX_DEVICES", "1")
    monkeypatch.setenv("RACON_TPU_STRICT", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run(main, argv, capsysbinary):
    capsysbinary.readouterr()
    assert main(argv) == 0
    return capsysbinary.readouterr().out


@pytest.mark.parametrize("poa_batches", ["1", "0"])
def test_cli_fasta_byte_identical_to_jax(tiny, capsysbinary, poa_batches):
    want = run(jax_cli.main, ["-c", poa_batches, "--tpualigner-batches",
                              "1", *SCORES, *tiny], capsysbinary)
    got = run(cli.main, ["--device", "cpu", "-c", poa_batches,
                         "--cudaaligner-batches", "1", *SCORES, *tiny],
              capsysbinary)
    assert got.startswith(b">draft LN:i:")
    assert got == want


def test_simulator_is_synthbench_stream():
    """The port's simulator copy gives tools/synthbench.py's bytes."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from synthbench import simulate as sb_simulate

    args = (2000, 6, 800, 0.12, 0.10)
    assert simulate(random.Random(42), *args) == \
        sb_simulate(random.Random(42), *args)


def test_cuda_device_without_card_raises(tiny, capsysbinary):
    """--device cuda never carries on on the CPU: with no card it raises
    (the library) and exits 1 with the error (the CLI)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RaconError, match="no CUDA device"):
        create_polisher(*tiny, PolisherType.kC, 500, 10.0, 0.3,
                        cuda_poa_batches=1, device="cuda")
    capsysbinary.readouterr()
    assert cli.main(["-c", "1", *tiny]) == 1
    assert b"no CUDA device" in capsysbinary.readouterr().err


@pytest.fixture(scope="module")
def formats(tmp_path_factory):
    """The 4 kb / 21-read set in every read and overlap format:
    {"fastq" | "fasta" | "paf" | "mhap" | "sam" | "draft": path}."""
    d = tmp_path_factory.mktemp("formats")
    rng = random.Random(11)
    _, draft, reads, paf = simulate_truth(rng, 4000, 8, 1500, 0.12, 0.10)
    assert len(reads) == 21
    paths = {k: str(d / f"{k}.{k}.gz") for k in
             ("fastq", "fasta", "paf", "mhap", "sam")}
    paths["draft"] = str(d / "draft.fasta.gz")
    with gzip.open(paths["draft"], "wb") as f:
        f.write(b">draft\n" + draft + b"\n")
    with gzip.open(paths["fastq"], "wb") as fq, \
            gzip.open(paths["fasta"], "wb") as fa:
        for name, read, *_ in reads:
            qual = bytes(33 + rng.randint(2, 40) for _ in read)
            fq.write(b"@%s\n%s\n+\n%s\n" % (name.encode(), read, qual))
            fa.write(b">%s\n%s\n" % (name.encode(), read))
    sam = [b"@HD\tVN:1.6", b"@SQ\tSN:draft\tLN:%d" % len(draft)]
    mhap = []
    for i, ((name, read, _, _, strand), rec) in enumerate(zip(reads, paf)):
        f = rec.split("\t")
        t0, t1 = int(f[7]), int(f[8])
        mhap.append(f"{i + 1} 1 0.1 100 0 0 {len(read)} {len(read)} "
                    f"{int(strand)} {t0} {t1} {len(draft)}")
        # SAM holds the read on the draft's strand; clip a few bases at
        # both ends and align the rest to the overlap's draft span
        fwd = revcomp(read) if strand else read
        c5, c3 = 7 + i % 5, 11 + i % 3
        cigar = (b"%dS" % c5 + nw_cigar(fwd[c5:len(fwd) - c3],
                                        draft[t0:t1]) + b"%dS" % c3)
        sam.append(b"\t".join([name.encode(), b"16" if strand else b"0",
                               b"draft", b"%d" % (t0 + 1), b"60", cigar,
                               b"*", b"0", b"0", fwd, b"*"]))
    with gzip.open(paths["paf"], "wt") as f:
        f.write("\n".join(paf) + "\n")
    with gzip.open(paths["mhap"], "wt") as f:
        f.write("\n".join(mhap) + "\n")
    with gzip.open(paths["sam"], "wb") as f:
        f.write(b"\n".join(sam) + b"\n")
    return paths


@pytest.mark.parametrize("reads,overlaps,poa", [
    ("fastq", "paf", "0"), ("fastq", "mhap", "0"), ("fastq", "sam", "0"),
    ("fasta", "paf", "0"), ("fasta", "mhap", "0"), ("fasta", "sam", "0"),
    ("fastq", "paf", "1"), ("fasta", "mhap", "1"), ("fastq", "sam", "1"),
])
def test_input_formats_byte_identical_to_jax(formats, capsysbinary, reads,
                                             overlaps, poa):
    """Every read format x overlap format through both CLIs, at -c 0 and
    at -c 1 --cudaaligner-batches 1 (SAM overlaps carry their CIGARs, so
    the aligner has nothing to do there)."""
    triple = [formats[reads], formats[overlaps], formats["draft"]]
    extra = ["--cudaaligner-batches", "1"] if poa == "1" else []
    want = run(jax_cli.main, ["-c", poa,
                              *[x.replace("--cuda", "--tpu") for x in extra],
                              *SCORES, *triple], capsysbinary)
    got = run(cli.main, ["--device", "cpu", "-c", poa, *extra, *SCORES,
                         *triple], capsysbinary)
    assert got.startswith(b">draft LN:i:")
    assert got == want
