"""The port's copy of the C++ host library (racon_tpu_torch/native) against
the JAX package's (racon_tpu/native): the same consensus and coverages,
CIGARs and edit distances on seeded inputs, and the same records from the
native sequence loader. The build entry: `python -m racon_tpu_torch.native
--force` prints the library's path, and the sanitizer build
(`build(debug=True)`, `--debug`) is a file of its own that a process with
the ASan runtime preloaded loads (`load(debug=True)`) and computes the
release build's edit distance with. Tolerance: none."""

import gzip
import os
import random
import subprocess
import sys

import numpy as np
import pytest

from racon_tpu import native as jax_native
from racon_tpu.io.parsers import create_sequence_parser as jax_parser
from racon_tpu_torch import native
from racon_tpu_torch.errors import RaconError
from racon_tpu_torch.io.parsers import create_sequence_parser

ACGT = b"ACGT"


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


def windows(seed, n, length=120, depth=7, qual=False):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        truth = bytes(rng.choice(ACGT) for _ in range(length))
        bb = mutate(rng, truth, 0.1)
        w = [(bb, b"!" * len(bb) if qual else None, 0, 0)]
        for _ in range(depth):
            lay = mutate(rng, truth, 0.1)
            q = bytes(rng.randrange(35, 70) for _ in lay) if qual else None
            w.append((lay, q, 0, len(bb) - 1))
        out.append(w)
    return out


@pytest.mark.parametrize("qual", [False, True])
def test_poa_batch_identical(qual):
    wins = windows(3 + qual, 6, qual=qual)
    got = native.poa_batch(wins, 5, -4, -8, n_threads=2)
    want = jax_native.poa_batch(wins, 5, -4, -8, n_threads=2)
    for (gc, gcov), (wc, wcov) in zip(got, want):
        assert gc == wc
        np.testing.assert_array_equal(gcov, wcov)


def test_aligners_identical():
    rng = random.Random(8)
    pairs = []
    for n in (1, 50, 700, 3000):
        t = bytes(rng.choice(ACGT) for _ in range(n))
        pairs.append((mutate(rng, t, 0.15) or b"A", t))
    for q, t in pairs:
        assert native.nw_cigar(q, t) == jax_native.nw_cigar(q, t)
        assert native.edit_distance(q, t) == jax_native.edit_distance(q, t)
    assert native.nw_cigar_batch(pairs, n_threads=2) == \
        jax_native.nw_cigar_batch(pairs, n_threads=2)


def test_sequence_loader_identical(tmp_path):
    rng = random.Random(2)
    path = tmp_path / "reads.fastq.gz"
    with gzip.open(path, "wb") as fh:
        for i in range(20):
            s = bytes(rng.choice(ACGT) for _ in range(rng.randint(1, 300)))
            q = bytes(rng.randrange(33, 75) for _ in s)
            fh.write(b"@r%d extra\n%s\n+\n%s\n" % (i, s, q))
    got, want = [], []
    create_sequence_parser(str(path), "test").parse(got, -1)
    jax_parser(str(path), "test").parse(want, -1)
    assert [(s.name, s.data, s.quality) for s in got] == \
        [(s.name, s.data, s.quality) for s in want]


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_python(args, env=None):
    full = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    proc = subprocess.run([sys.executable, *args], cwd=REPO, env=full,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()


def test_native_main_builds_and_prints_the_library():
    path = run_python(["-m", "racon_tpu_torch.native", "--force"])[-1]
    assert os.path.isfile(path) and path == str(native.build())
    assert os.path.basename(path).startswith("libracon_host-")


def test_debug_build_loads_under_asan():
    asan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    assert os.path.isabs(asan), "no ASan runtime beside g++"
    debug = run_python(["-m", "racon_tpu_torch.native", "--debug"])[-1]
    assert debug == str(native.build(debug=True)) != str(native.build())
    assert os.path.basename(debug).startswith("libracon_host_debug-")
    rng = random.Random(5)
    a = bytes(rng.choice(b"ACGT") for _ in range(700))
    b = mutate(rng, a, 0.15)
    out = run_python(
        ["-c", "import sys\n"
               "from racon_tpu_torch import native\n"
               "lib = native.load(debug=True)\n"
               f"print(lib._name)\n"
               f"print(native.edit_distance({a!r}, {b!r}))"],
        env={"LD_PRELOAD": asan, "ASAN_OPTIONS": "detect_leaks=0"})
    assert out[-2] == debug
    assert int(out[-1]) == native.edit_distance(a, b) > 0
    # this process loaded the release build: the variant is fixed
    assert native.load() is native.get_lib()
    with pytest.raises(RaconError, match="already loaded"):
        native.load(debug=True)
