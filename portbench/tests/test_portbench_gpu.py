"""One short run of each tiny cell on the card through the port's kernels
(skips without a CUDA device)."""

import pytest

from portbench.tests import tiny


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["tiny.contig", "tiny.reads", "tiny.serve"])
def test_tiny_cell_on_the_card(tmp_path, cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench import run as harness

    base = tiny.copy(tmp_path, device_engines=True)
    result, _ = harness.run(tiny.args(cell, seconds=2.0, trace=1),
                            device="cuda", base=base)
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0
