"""The port CLI's `--cuda-adaptive-buckets` against the JAX CLI's
`--tpu-adaptive-buckets`: the polished FASTA of a contig run (kC, both
device paths) with the scheduler on equals the port's with it off and
the JAX CLI's with it on, for the session and the fused engine at
pipeline depths 0 and 2; and a fragment-correction run (kF, `-f`) the
same. The scheduler's occupancy line is logged. Inputs are made from
seeds (tests/test_pipeline._synth_dataset; synth.simulate_truth). The
JAX package is pinned to one device (RACON_TPU_MAX_DEVICES=1);
tests/test_torch_mesh.py compares at its 8 virtual devices.
Tolerance: none — the bytes must be equal."""

import random

import pytest
import torch

jax = pytest.importorskip("jax")

from racon_tpu_torch import cli  # noqa: E402
from test_pipeline import _synth_dataset  # noqa: E402
from test_torch_fused_cli import run  # noqa: E402


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("RACON_TPU_MAX_DEVICES", "1")
    monkeypatch.setenv("RACON_TPU_STRICT", "1")
    # the JAX CLI's flags set process-wide environment knobs (the
    # scheduler's, the fused posture's): monkeypatch restores them
    monkeypatch.delenv("RACON_TPU_ADAPTIVE_BUCKETS", raising=False)
    monkeypatch.setenv("RACON_TPU_FUSED", "auto")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return [str(p) for p in _synth_dataset(tmp_path_factory.mktemp("sched"),
                                           random.Random(23))]


@pytest.mark.parametrize("engine,depth", [("session", "0"),
                                          ("session", "2"),
                                          ("fused", "0"), ("fused", "2")])
def test_cli_fasta_sched_on_off_matches_jax(synth, engine, depth):
    from racon_tpu import cli as jax_cli

    flags = ["-c", "1", "--cuda-engine", engine, "--cuda-fused", "1",
             "--cuda-pipeline-depth", depth, "--cudaaligner-batches", "1"]
    want, _ = run(jax_cli.main,
                  [f.replace("--cuda-", "--tpu-").replace(
                      "--cudaaligner", "--tpualigner") for f in flags]
                  + ["--tpu-adaptive-buckets", *synth])
    off, log_off = run(cli.main, ["--device", "cpu", *flags, *synth])
    on, log_on = run(cli.main, ["--device", "cpu", *flags,
                                "--cuda-adaptive-buckets", *synth])
    assert on.startswith(b">") and on == off == want
    assert "batch occupancy (adaptive=on): aligner" in log_on
    assert "batch occupancy (adaptive=off): aligner" in log_off
    assert f"{engine} " in log_on.split("batch occupancy")[1]


def test_fragment_fasta_sched_on_matches_jax(tmp_path):
    """kF (-f, all-vs-all overlaps, the reads their own targets) with
    both device paths: the scheduler on, off and the JAX CLI's."""
    from racon_tpu import cli as jax_cli
    from racon_tpu_torch.synth import (ava_overlaps, simulate_truth,
                                       write_fragment_dataset)

    _, _, reads, _ = simulate_truth(random.Random(5), 3000, 5, 1500, 0.12,
                                    0.10)
    paths = write_fragment_dataset(str(tmp_path), reads,
                                   ava_overlaps(reads))
    flags = ["-f", "-c", "1", "-m", "5", "-x", "-4", "-g", "-8"]
    want, _ = run(jax_cli.main, [*flags, "--tpualigner-batches", "1",
                                 "--tpu-adaptive-buckets", *paths])
    got, log = run(cli.main, ["--device", "cpu", *flags,
                              "--cudaaligner-batches", "1",
                              "--cuda-adaptive-buckets", *paths])
    off, _ = run(cli.main, ["--device", "cpu", *flags,
                            "--cudaaligner-batches", "1", *paths])
    assert got.startswith(b">read") and got == want == off
    assert "batch occupancy (adaptive=on)" in log
