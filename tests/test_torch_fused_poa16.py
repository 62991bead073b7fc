"""The port's fused whole-window POA program against the JAX package's at
int16 scores: the cases of tests/test_torch_fused_poa.py, each legal under
ops/dtypes.poa_int16_ok at its (N, L) and scores. The JAX int16 program
computes the DP in int16; the port computes in int32 and stores int16
with the sentinel NEG16, and by the overflow proof the integers agree.
Tolerance: none."""

import pytest

from racon_tpu_torch.ops.dtypes import poa_int16_ok
from racon_tpu_torch.ops.poa_fused import STATE
from test_torch_fused_poa import (CASES, FAILED, _one_device,  # noqa: F401
                                  check_case)


@pytest.mark.parametrize("sliced", [False, True], ids=["split", "fused"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_fused_raw_int16(name, sliced):
    _, N, L, _, scores = CASES[name]
    assert poa_int16_ok(N, L, *scores)
    state = check_case(name, "int16", sliced)
    failed = state[STATE.index("failed")]
    assert failed.tolist() == FAILED.get(name, [False] * len(failed))
