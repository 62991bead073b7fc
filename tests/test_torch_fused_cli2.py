"""The fused engine's FASTA against the JAX CLI's, continued from
tests/test_torch_fused_cli.py: posture 1 / depth 0 and posture 0 /
depth 2 at 5/-4/-8 (the fused program at int32). Tolerance: none."""

import pytest

from test_torch_fused_cli import (SCORES, _env, check_cli,  # noqa: F401
                                  synth)


@pytest.mark.parametrize("fused,depth", [("1", "0"), ("0", "2")])
def test_fused_cli_byte_identical_to_jax_int32(synth, fused, depth):
    log = check_cli(synth, fused, depth, SCORES)
    assert " at int32 " in log
