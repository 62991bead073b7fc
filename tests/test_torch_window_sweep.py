"""The POA window sweep on adversarial jobs: the port's plain version
(racon_tpu_torch/ops/poa_graph.py::graph_aligner, the CPU path of the
CUDA kernel ops/poa_kernels.window_sweep) against the JAX package's XLA
`graph_aligner` and its Pallas `window_sweep` (interpret mode), and the
kernel against the plain version on the card.

Real session jobs are near-linear graphs whose predecessors sit a few
ranks back. The seeded numpy generator `synth.poa_jobs` reaches what
they rarely do: predecessors hundreds of ranks back (past the kernel's
shared-memory ring), in-degree 8, padding holes inside a predecessor
list, band-0 rows at 640 columns, band windows clipped at column 1 and
at the layer's end or empty, layers of length 0 and node-less padding
jobs. The JAX tests import JAX inside themselves, so the card test also
runs where JAX is not installed. Tolerance: none — integer DP with a
fixed tie order.
"""

import numpy as np
import pytest
import torch

from racon_tpu_torch.ops import poa_kernels
from racon_tpu_torch.ops.poa_graph import (BUCKETS, MAX_PRED,
                                           _bytes_per_row, graph_aligner)
from racon_tpu_torch.synth import max_pred_distance, poa_jobs

SCORES = (5, -4, -8)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def plain_ranks(args, N, L, P):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    return graph_aligner(N, L, P, *SCORES)(*t).numpy()


#: (B, N, L, P, bands, far, pad_rows, empty_layers)
CASES = {
    "far_preds_in_degree_8": (4, 320, 64, 8, (32, 0), 150, 0, 0),
    "band0_640_columns": (3, 48, 640, 4, (0,), 0, 0, 0),
    "band256_clipped": (4, 160, 300, 8, (256, 0), 40, 0, 0),
    "band32_clipped_padding_rows": (6, 96, 80, 4, (32,), 0, 2, 1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_on_adversarial_jobs(name):
    pytest.importorskip("jax")
    from racon_tpu.ops.poa_graph import graph_aligner as jax_graph_aligner

    B, N, L, P, bands, far, pad, empty = CASES[name]
    args = poa_jobs(len(name), B, N, L, P, bands, far, pad, empty)
    if far:
        assert max_pred_distance(args[1], args[7]) >= far
    want = np.asarray(jax_graph_aligner(N, L, P, *SCORES)(*args[:7]))
    got = plain_ranks(args, N, L, P)
    np.testing.assert_array_equal(got, want.astype(np.int32))
    # the wrapper on CPU tensors is the plain version, with node counts
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    np.testing.assert_array_equal(
        poa_kernels.window_sweep(*t, *SCORES).numpy(), got)
    if pad:
        assert (got[-pad:] == -2).all()


def test_plain_matches_pallas_kernel_on_adversarial_jobs():
    """The Pallas kernel itself (interpret mode) at a small shape:
    far predecessors, holes, clipped and empty windows, a length-0 layer
    and a padding job."""
    pytest.importorskip("jax")
    from racon_tpu.ops.poa_pallas import window_sweep as pallas_window_sweep

    N, L, P = 40, 48, 4
    args = poa_jobs(3, 5, N, L, P, (16, 0), far=20, pad_rows=1,
                    empty_layers=1)
    pls = np.asarray(pallas_window_sweep(N, L, P, *SCORES,
                                         interpret=True)(*args))
    np.testing.assert_array_equal(plain_ranks(args, N, L, P), pls)


def test_bytes_per_row_prices_band_compact_scratch():
    """A batch row costs its band-compact score spill (int32) and
    backpointer plane (int8), N x L each at the band-0 worst case, plus
    its inputs; no [N+1, L+1] score matrix."""
    got = {b: _bytes_per_row(*b, MAX_PRED) for b in BUCKETS}
    assert got == {(320, 256): 416256, (768, 640): 2473600,
                   (1280, 640): 4122240, (2048, 640): 6595200}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES) + ["ring_overflow"])
def test_kernel_matches_plain_on_adversarial_jobs_on_card(name):
    """K1 on the card against its plain version. `ring_overflow` puts
    predecessors farther back than the job's shared-memory ring holds
    (band 0 at 640 columns), so those rows are read from the spill."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    if name == "ring_overflow":
        B, N, L, P, bands, far, pad, empty = (4, 300, 640, 8, (0, 256),
                                              200, 1, 0)
    else:
        B, N, L, P, bands, far, pad, empty = CASES[name]
    args = poa_jobs(len(name), B, N, L, P, bands, far, pad, empty)
    if name == "ring_overflow":
        ring = poa_kernels.ring_rows(N, L, P, L)
        assert max_pred_distance(args[1], args[7]) > ring
    dev = torch.device("cuda")
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args]
    got = poa_kernels.window_sweep(*t, *SCORES)
    want = graph_aligner(N, L, P, *SCORES)(*t)
    assert torch.equal(got, want)
