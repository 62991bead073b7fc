"""End to end on the CPU: the port's CLI against the JAX package's CLI.

On a tiny seeded dataset from the port's simulator (a few kb, ~8x, 2 kb
reads), `python -m racon_tpu_torch --device cpu -c 1
--cudaaligner-batches 1` must write FASTA byte-identical to `racon_tpu
-c 1 --tpualigner-batches 1` (XLA programs, RACON_TPU_STRICT=1), and the
same again at -c 0 (host POA). Tolerance: zero — every value is an
integer or a byte.
"""

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
from racon_tpu_torch.synth import simulate, write_dataset

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
