"""The polished FASTA of the port's CLI with the fused engine
(`--device cpu -c 1 --cuda-engine fused`) against the JAX CLI's
(`-c 1 --tpu-engine fused`) on a tests/test_pipeline._synth_dataset
input, at the same chunk posture (`--cuda-fused` / `--tpu-fused`) and
pipeline depth: here the default scores (3/-5/-4: the fused program at
int16 under the overflow proof) at posture 0 / depth 0 and posture 1 /
depth 2; tests/test_torch_fused_cli2.py the other two pairs at 5/-4/-8
(int32) and the fallback to the session and the host engine.
Tolerance: none — the bytes must be equal."""

import io
import random
import sys

import pytest
import torch

from racon_tpu_torch import cli
from test_pipeline import _synth_dataset

SCORES = ["-m", "5", "-x", "-4", "-g", "-8"]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("RACON_TPU_MAX_DEVICES", "1")
    monkeypatch.setenv("RACON_TPU_STRICT", "1")
    # the JAX CLI's --tpu-fused sets RACON_TPU_FUSED for the process:
    # monkeypatch restores it after each test
    monkeypatch.setenv("RACON_TPU_FUSED", "auto")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return [str(p) for p in _synth_dataset(tmp_path_factory.mktemp("fused"),
                                           random.Random(23))]


def run(main, argv):
    """Call a CLI's main; returns its stdout bytes and its stderr."""
    buf = io.BytesIO()
    text = io.TextIOWrapper(buf)
    out, err = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = text, io.StringIO()
    try:
        rc = main(argv)
        text.flush()
        log = sys.stderr.getvalue()
    finally:
        sys.stdout, sys.stderr = out, err
    assert rc == 0, main
    return buf.getvalue(), log


def check_cli(paths, fused, depth, scores):
    from racon_tpu import cli as jax_cli

    want, _ = run(jax_cli.main, ["-c", "1", "--tpu-engine", "fused",
                                 "--tpu-fused", fused,
                                 "--tpu-pipeline-depth", depth, *scores,
                                 *paths])
    got, log = run(cli.main, ["--device", "cpu", "-c", "1", "--cuda-engine",
                              "fused", "--cuda-fused", fused,
                              "--cuda-pipeline-depth", depth, *scores,
                              *paths])
    assert got.startswith(b">") and got == want
    assert "fused engine built" in log
    return log


@pytest.mark.parametrize("fused,depth", [("0", "0"), ("1", "2")])
def test_fused_cli_byte_identical_to_jax_int16(synth, fused, depth):
    log = check_cli(synth, fused, depth, [])
    assert " at int16 " in log
