"""Wrapper of the POA window-sweep kernel (csrc/poa_window_sweep.cu).

`window_sweep` takes the session's job tensors as they come (int8 codes,
int16 preds/centers, uint8 sinks, int8 layer bases, int32 lengths, band
widths and node counts) and returns int32 ranks [B, L]. On a CUDA tensor
it launches the hand-written kernel and raises if the launch fails; on a
CPU tensor it runs the plain PyTorch version (poa_graph.graph_aligner).
`launches` counts kernel launches, and nothing else; `launches_by_shape`
splits the same count by the batch's (nodes, len) bucket.
"""

from __future__ import annotations

import torch

from .. import _build
from ..errors import DeviceError
from .poa_graph import graph_aligner, scratch_cols

#: kernel launches since import (or the last reset), in all and per
#: (N, L) bucket
launches = 0
launches_by_shape: dict[tuple[int, int], int] = {}

#: the kernel's limits: a team of 128 threads holds a row's window as
#: runs of at most 5 columns, and the predecessor count is a template
#: parameter
MAX_COLS = 128 * 5
PREDS = (4, 8)

_DTYPES = (torch.int8, torch.int16, torch.int16, torch.uint8, torch.int8,
           torch.int32, torch.int32, torch.int32)
_NAMES = ("codes", "preds", "centers", "sinks", "seq", "lens", "band",
          "nnodes")


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_shape.clear()


def ring_rows(n_nodes: int, seq_len: int, max_pred: int, width: int) -> int:
    """Rows of the kernel's shared-memory ring for a job whose row windows
    are `width` columns wide, at this launch shape (band + 1 for a banded
    job, its layer length for band 0). Asks the built kernel library, so
    it needs the CUDA toolkit."""
    return int(_build.kernels().rt_poa_ring_rows(n_nodes, seq_len, max_pred,
                                                 width))


def scratch(B: int, N: int, L: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's device-memory scratch: every job's swept rows,
    band-compact (its window of at most L columns, each row 16-byte
    aligned), int32 scores and int8 backpointers."""
    cols = scratch_cols(L)
    return (torch.empty((B, N, cols), dtype=torch.int32, device=dev),
            torch.empty((B, N, cols), dtype=torch.int8, device=dev))


def window_sweep(codes, preds, centers, sinks, seq, lens, band, nnodes,
                 match: int, mismatch: int, gap: int) -> torch.Tensor:
    """Graph-banded NW of each job's layer against its graph, plus the
    traceback: ranks [B, L] int32 (node rank, -1 insertion, -2 beyond the
    layer's length)."""
    global launches
    B, N = codes.shape
    L = seq.shape[1]
    P = preds.shape[2]
    if codes.device.type == "cpu":
        return graph_aligner(N, L, P, match, mismatch, gap)(
            codes, preds, centers, sinks, seq, lens, band, nnodes)
    args = (codes, preds, centers, sinks, seq, lens, band, nnodes)
    for name, t, dt in zip(_NAMES, args, _DTYPES):
        if t.device != codes.device or t.dtype != dt or not t.is_contiguous():
            raise DeviceError("window_sweep",
                              f"{name}: want a contiguous {dt} tensor on "
                              f"{codes.device}, got {t.dtype} on {t.device}")
    if (preds.shape[:2] != (B, N) or centers.shape != (B, N)
            or sinks.shape != (B, N) or seq.shape[0] != B
            or lens.shape != (B,) or band.shape != (B,)
            or nnodes.shape != (B,)):
        raise DeviceError("window_sweep", "inconsistent job shapes")
    if L > MAX_COLS or P not in PREDS:
        raise DeviceError("window_sweep",
                          f"layer length {L} or in-degree {P} beyond the "
                          f"kernel's limits ({MAX_COLS}, one of {PREDS})")
    if ring_rows(N, L, P, L) < min(N, 2):
        raise DeviceError("window_sweep",
                          f"{N} nodes at in-degree {P} leave no shared "
                          f"memory for two {L}-column rows")
    dev = codes.device
    out = torch.empty((B, L), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    spill, bps = scratch(B, N, L, dev)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rt_poa_window_sweep(
            *(t.data_ptr() for t in args), spill.data_ptr(), bps.data_ptr(),
            out.data_ptr(), B, N, L, P, match, mismatch, gap, stream)
    _build.check(lib, rc, "window_sweep")
    launches += 1
    launches_by_shape[(N, L)] = launches_by_shape.get((N, L), 0) + 1
    return out
