"""Wrapper of the POA window-sweep kernel (csrc/poa_window_sweep.cu).

`window_sweep` takes the session's job tensors as they come (int8 codes,
int16 preds/centers, uint8 sinks, int8 layer bases, int32 lengths, band
widths and node counts; codes and bases 2-bit packed uint8 when
`packed`) and returns int32 ranks [B, L], at score dtype `score_dtype`
('int32', or 'int16' where dtypes.poa_int16_ok holds). On a CUDA tensor
it launches the kernel instantiation of that dtype and operand form and
raises if the launch fails; on a CPU tensor it runs the plain PyTorch
version (poa_graph.graph_aligner) at the same dtype and form.
`launches` counts kernel launches, and nothing else; `launches_by_shape`
splits the same count by the batch's (nodes, len, dtype, packed).
"""

from __future__ import annotations

import torch

from .. import _build
from ..errors import DeviceError
from .dtypes import poa_int16_ok
from .launch_count import LaunchCounter
from .poa_graph import graph_aligner, scratch_cols

#: kernel launches since import (or the last reset): in all
#: (`launches`, read through the module's __getattr__), per
#: (N, L, score dtype, packed) (`launches_by_shape`),
#: and on the calling thread (`counter.on_thread()`)
counter = LaunchCounter()
launches_by_shape = counter.by_shape

#: the kernel's limits: a team of 128 threads holds a row's window as
#: runs of at most 5 columns, and the predecessor count is a template
#: parameter
MAX_COLS = 128 * 5
PREDS = (4, 8)

_NAMES = ("codes", "preds", "centers", "sinks", "seq", "lens", "band",
          "nnodes")


def _score_bytes(score_dtype: str) -> int:
    return 2 if score_dtype == "int16" else 4


def __getattr__(name: str):
    if name == "launches":
        return counter.total
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launches() -> None:
    counter.reset()


def ring_rows(n_nodes: int, seq_len: int, max_pred: int, width: int,
              score_dtype: str = "int32") -> int:
    """Rows of the kernel's shared-memory ring for a job whose row windows
    are `width` columns wide, at this launch shape and score dtype (band
    + 1 for a banded job, its layer length for band 0). Asks the built
    kernel library, so it needs the CUDA toolkit."""
    return int(_build.kernels().rt_poa_ring_rows(
        n_nodes, seq_len, max_pred, width, _score_bytes(score_dtype)))


def scratch(B: int, N: int, L: int, dev, score_dtype: str = "int32"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's device-memory scratch: every job's swept rows,
    band-compact (its window of at most L columns, each row 16-byte
    aligned), scores at the score dtype and int8 backpointers."""
    cols = scratch_cols(L)
    dt = torch.int16 if score_dtype == "int16" else torch.int32
    return (torch.empty((B, N, cols), dtype=dt, device=dev),
            torch.empty((B, N, cols), dtype=torch.int8, device=dev))


def window_sweep(codes, preds, centers, sinks, seq, lens, band, nnodes,
                 match: int, mismatch: int, gap: int,
                 score_dtype: str = "int32",
                 packed: bool = False) -> torch.Tensor:
    """Graph-banded NW of each job's layer against its graph, plus the
    traceback: ranks [B, L] int32 (node rank, -1 insertion, -2 beyond the
    layer's length). With `packed`, codes are [B, ceil(N/4)] and seq
    [B, L/4] uint8 (L a multiple of 4)."""
    B, N, P = preds.shape
    L = seq.shape[1] * 4 if packed else seq.shape[1]
    if codes.device.type == "cpu":
        return graph_aligner(N, L, P, match, mismatch, gap, score_dtype,
                             packed)(codes, preds, centers, sinks, seq, lens,
                                     band, nnodes)
    args = (codes, preds, centers, sinks, seq, lens, band, nnodes)
    op = torch.uint8 if packed else torch.int8
    dtypes = (op, torch.int16, torch.int16, torch.uint8, op, torch.int32,
              torch.int32, torch.int32)
    for name, t, dt in zip(_NAMES, args, dtypes):
        if t.device != codes.device or t.dtype != dt or not t.is_contiguous():
            raise DeviceError("window_sweep",
                              f"{name}: want a contiguous {dt} tensor on "
                              f"{codes.device}, got {t.dtype} on {t.device}")
    cw = (N + 3) // 4 if packed else N
    if (codes.shape != (B, cw) or centers.shape != (B, N)
            or sinks.shape != (B, N) or seq.shape[0] != B
            or lens.shape != (B,) or band.shape != (B,)
            or nnodes.shape != (B,)):
        raise DeviceError("window_sweep", "inconsistent job shapes")
    if L > MAX_COLS or P not in PREDS:
        raise DeviceError("window_sweep",
                          f"layer length {L} or in-degree {P} beyond the "
                          f"kernel's limits ({MAX_COLS}, one of {PREDS})")
    if score_dtype not in ("int32", "int16") or (
            score_dtype == "int16"
            and not poa_int16_ok(N, L, match, mismatch, gap)):
        raise DeviceError("window_sweep",
                          f"score dtype {score_dtype} at ({N}, {L}): not "
                          f"int32, nor int16 under the overflow proof")
    if ring_rows(N, L, P, L, score_dtype) < min(N, 2):
        raise DeviceError("window_sweep",
                          f"{N} nodes at in-degree {P} leave no shared "
                          f"memory for two {L}-column rows")
    dev = codes.device
    out = torch.empty((B, L), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    spill, bps = scratch(B, N, L, dev, score_dtype)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rt_poa_window_sweep(
            *(t.data_ptr() for t in args), spill.data_ptr(), bps.data_ptr(),
            out.data_ptr(), B, N, L, P, match, mismatch, gap,
            _score_bytes(score_dtype), int(packed), stream)
    _build.check(lib, rc, "window_sweep")
    counter.count((N, L, score_dtype, bool(packed)))
    return out
