"""The port's wrapper, rampler and preprocess against the JAX package's.

`racon_tpu_torch.wrapper` must write the same FASTA as
`racon_tpu.wrapper` for --split, --subsample and --num-shards, in
contig polishing (kC, a three-contig draft) and fragment correction
(kF, all-vs-all reads), at -c 0 and once at `-c 1 --cudaaligner-batches
1 --device cpu` (the kernels' plain versions against the XLA programs);
shards 0 and 1 concatenated must equal the unsharded run; shard
validation fails with the same messages. `rampler.split` / `subsample`
must write the same files (names and bytes), and `preprocess.process`
the same FASTQ. Tolerance: zero, every value is a byte or an integer.
"""

import gzip
import io
import os
import random

import pytest
import torch

jax = pytest.importorskip("jax")

from racon_tpu import preprocess as jax_preprocess
from racon_tpu import rampler as jax_rampler
from racon_tpu import wrapper as jax_wrapper
from racon_tpu.errors import RaconError as JaxRaconError
from racon_tpu_torch import preprocess, rampler, wrapper
from racon_tpu_torch.errors import RaconError
from racon_tpu_torch.synth import simulate
from test_torch_fragment import SMALL, TGS, fragment_set
from test_torch_fragment import run_cli as run_main


def write_gz(path, text: bytes) -> str:
    with gzip.open(path, "wb") as fh:
        fh.write(text)
    return path


@pytest.fixture(scope="module")
def contigs(tmp_path_factory):
    """kC: three 3 kb contigs, each with its own 6x reads and overlaps."""
    d = tmp_path_factory.mktemp("contigs")
    reads, paf, drafts = [], [], []
    for k in range(3):
        _, draft, rs, rows = simulate(random.Random(10 + k), 3000, 6, 1500,
                                      0.12, 0.10)
        for (name, read), row in zip(rs, rows):
            f = row.split("\t")
            f[0], f[5] = f"c{k}_{name}", f"draft{k}"
            reads.append(b">" + f[0].encode() + b"\n" + read + b"\n")
            paf.append("\t".join(f))
        drafts.append(f">draft{k}\n".encode() + draft + b"\n")
    return (write_gz(str(d / "reads.fasta.gz"), b"".join(reads)),
            write_gz(str(d / "ovl.paf.gz"), ("\n".join(paf) + "\n").encode()),
            write_gz(str(d / "draft.fasta.gz"), b"".join(drafts)))


@pytest.fixture(scope="module")
def fragments(tmp_path_factory):
    """kF: 6 kb genome, 10x, 2 kb reads and their all-vs-all overlaps."""
    return fragment_set(tmp_path_factory.mktemp("frag"), *TGS)[2]


@pytest.fixture(scope="module")
def small_fragments(tmp_path_factory):
    """kF at the size the plain versions run at in seconds: 3 kb genome,
    5x, 1.5 kb reads."""
    return fragment_set(tmp_path_factory.mktemp("small"), *SMALL)[2]


#: (mode, dataset, wrapper options)
CASES = {
    "kC-split": ("contigs", ["--split", "5000"]),
    "kC-subsample": ("contigs", ["--subsample", "9000", "3"]),
    "kC-split-subsample": ("contigs", ["--split", "3000", "--subsample",
                                       "9000", "4", "-u"]),
    "kF-split": ("fragments", ["-f", "--split", "20000"]),
    "kF-subsample": ("fragments", ["-f", "--subsample", "6000", "6"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrapper_byte_identical_to_jax(case, request):
    data, opts = CASES[case]
    paths = request.getfixturevalue(data)
    want = run_main(jax_wrapper.main, [*opts, *paths])
    got = run_main(wrapper.main, ["--device", "cpu", *opts, *paths])
    assert got.count(b">") > 2
    assert got == want


@pytest.mark.parametrize("data,opts", [
    ("contigs", ["--split", "3000"]),
    ("fragments", ["-f", "--split", "20000"]),
], ids=["kC", "kF"])
def test_shards_concatenate_to_unsharded(data, opts, request):
    paths = request.getfixturevalue(data)
    whole = run_main(wrapper.main, ["--device", "cpu", *opts, *paths])
    shards = [run_main(wrapper.main,
                       ["--device", "cpu", *opts, "--num-shards", "2",
                        "--shard-id", str(i), *paths]) for i in range(2)]
    want = [run_main(jax_wrapper.main,
                     [*opts, "--num-shards", "2", "--shard-id", str(i),
                      *paths]) for i in range(2)]
    assert all(s.count(b">") > 0 for s in shards)
    assert shards == want
    assert b"".join(shards) == whole


def test_wrapper_c1_byte_identical_to_jax(small_fragments):
    """kF, split into three chunks, with both device paths on (their
    plain versions on the CPU), against the JAX wrapper's XLA programs."""
    opts = ["-f", "--split", "6000", "-t", "2"]
    want = run_main(jax_wrapper.main, [*opts, "-c", "1",
                                       "--tpualigner-batches", "1",
                                       *small_fragments])
    got = run_main(wrapper.main, [*opts, "-c", "1", "--cudaaligner-batches",
                                  "1", "--device", "cpu", *small_fragments])
    assert got.count(b"r LN:i:") > 2
    assert got == want


@pytest.mark.parametrize("kwargs", [
    {"num_shards": 2, "shard_id": 2},
    {"num_shards": 2, "shard_id": -1},
    {"num_shards": 9, "shard_id": 0, "split": 5000},
    {"num_shards": 2, "shard_id": 0},
], ids=["id-past-end", "id-negative", "more-shards-than-chunks",
        "shards-without-split"])
def test_shard_validation_errors_match(contigs, kwargs):
    out = io.BytesIO()
    with pytest.raises(JaxRaconError) as want:
        jax_wrapper.run(*contigs, out=out, **kwargs)
    with pytest.raises(RaconError) as got:
        wrapper.run(*contigs, device="cpu", out=out, **kwargs)
    assert got.value.scope == want.value.scope == "wrapper"
    assert str(got.value).replace("racon_tpu_torch::", "racon_tpu::") == \
        str(want.value)
    assert out.getvalue() == b""


def test_wrapper_without_card_raises(contigs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RaconError, match="no CUDA device"):
        wrapper.run(*contigs, out=io.BytesIO())


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    """Reads with qualities, wrapped over several lines (FASTQ, gzip)."""
    rng = random.Random(3)
    recs = []
    for i in range(40):
        seq = bytes(rng.choice(b"ACGT") for _ in range(rng.randint(50, 400)))
        qual = bytes(rng.randint(35, 70) for _ in seq)
        recs.append(b"@r%d extra\n%s\n%s\n+\n%s\n%s\n" % (
            i, seq[:40], seq[40:], qual[:40], qual[40:]))
    return write_gz(str(tmp_path_factory.mktemp("fq") / "reads.fastq.gz"),
                    b"".join(recs))


def files_of(paths) -> list[tuple[str, bytes]]:
    out = []
    for p in paths if isinstance(paths, list) else [paths]:
        with open(p, "rb") as fh:
            out.append((os.path.basename(p), fh.read()))
    return out


@pytest.mark.parametrize("op", ["split", "subsample", "subsample-seed",
                                "subsample-env"])
@pytest.mark.parametrize("data", ["fragments", "fastq"])
def test_rampler_files_byte_identical(op, data, request, tmp_path,
                                      monkeypatch):
    src = request.getfixturevalue(data)
    src = src[0] if isinstance(src, tuple) else src
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    want_dir.mkdir()
    got_dir.mkdir()
    if op == "split":
        size = 7000 if data == "fragments" else 2500
        want = jax_rampler.split(src, size, str(want_dir))
        got = rampler.split(src, size, str(got_dir))
        assert len(got) > 2
    else:
        kwargs = {"seed": 5} if op == "subsample-seed" else {}
        if op == "subsample-env":
            monkeypatch.setenv("RACON_TPU_SUBSAMPLE_SEED", "23")
        want = jax_rampler.subsample(src, 5000, 2, str(want_dir), **kwargs)
        got = rampler.subsample(src, 5000, 2, str(got_dir), **kwargs)
    assert files_of(got) == files_of(want)


def test_rampler_main_and_bad_seed(fragments, tmp_path, monkeypatch):
    """The entry point writes the library's files; a seed in the
    environment that is not an integer fails in both packages."""
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    want_dir.mkdir()
    got_dir.mkdir()
    assert rampler.main(["-o", str(got_dir), "split", fragments[0],
                         "9000"]) == 0
    want = jax_rampler.split(fragments[0], 9000, str(want_dir))
    got = sorted(str(p) for p in got_dir.iterdir())
    assert files_of(got) == sorted(files_of(want))
    monkeypatch.setenv("RACON_TPU_SUBSAMPLE_SEED", "x1")
    with pytest.raises(JaxRaconError, match="invalid"):
        jax_rampler.subsample(fragments[0], 5000, 2, str(want_dir))
    with pytest.raises(RaconError, match="invalid"):
        rampler.subsample(fragments[0], 5000, 2, str(got_dir))


@pytest.mark.parametrize("inputs", ["pair", "one-fasta"])
def test_preprocess_byte_identical(fastq, fragments, tmp_path, inputs):
    if inputs == "pair":
        paths = [fastq, fastq]
    else:
        paths = [fragments[0]]
    want, got = io.BytesIO(), io.BytesIO()
    jax_preprocess.process(paths, out=want)
    preprocess.process(paths, out=got)
    assert got.getvalue().startswith(b"@")
    assert got.getvalue() == want.getvalue()
    if inputs == "pair":
        assert b"@r01\n" in got.getvalue() and b"@r02\n" in got.getvalue()
    assert run_main(preprocess.main, paths) == want.getvalue()
