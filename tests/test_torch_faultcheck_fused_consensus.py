"""The fault grid's `depth2+fused` column in the port
(racon_tpu_torch/tools/faultcheck.py) on the CPU, for the consensus rows
(aligner 0); the alignment rows are in
tests/test_torch_faultcheck_fused_align.py.

Inputs: faultcheck's seeded dataset (rng 11), torch at one thread, a
cold winner table; the fused engine's plain program at its full envelope
(N 2048, L 640). Tolerance: none; each cell's verdict is the tool's own.

What is held:

  - the clean gate: the fused engine's one-launch run (`cuda_fused="1"`)
    equals its split run (`"0"`);
  - each quick consensus row is green in the column: the fault fired inside
    the fused engine's pipeline (or the aligner's, before it), the run
    raised the taxonomy's type, no worker thread outlived it, and a clean
    fused run after it gave the fused clean bytes.
"""

import random

import pytest
import torch

from racon_tpu_torch.sched.autotune import reset_autotuner_cache
from racon_tpu_torch.tools import faultcheck

ROWS = [m for m in faultcheck.MATRIX if not m[3] and m[1] == 0]


@pytest.fixture(scope="module", autouse=True)
def _env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    reset_autotuner_cache()
    yield
    reset_autotuner_cache()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fc")
    g = faultcheck.Grid(faultcheck.make_dataset(str(tmp),
                                                random.Random(11)),
                        "cpu", str(tmp / "cold.json"))
    assert g.clean_gates(aligners=(0,), depths=(2,),
                         columns=("depth2+fused",)) == []
    return g


@pytest.mark.parametrize("name,aligner,spec", [m[:3] for m in ROWS],
                         ids=[m[0] for m in ROWS])
def test_fused_cell(grid, name, aligner, spec):
    cell = faultcheck.run_cell(grid, "depth2+fused", aligner, spec)
    assert cell.startswith("pass"), cell
    assert faultcheck.expected_error(spec)[0].__name__ in cell
