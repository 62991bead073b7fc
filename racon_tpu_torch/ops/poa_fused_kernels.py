"""Wrapper of the fused whole-window POA kernel K3 (csrc/poa_fused.cu).

`fused_layers` runs D layers of a chunk of windows against their graph
state: the 11 state tensors of ops/poa_fused (codes, preds, predw, nseq,
col_of, colkey, colnodes, bpos, n_nodes, n_cols, failed), the layers
(seqs, lens, wts) and their slicing, either `(rlo, rhi, band)` sliced on
the host (the split posture) or `(begins, ends, bblen, offs)` sliced on
the device (the fused posture), and the per-row layer-index base. On a
CUDA tensor it launches K3 at score dtype `score_dtype`, which updates
the state tensors in place, and raises if the build or the launch fails;
on a CPU tensor it runs the plain PyTorch version (poa_fused.fused_raw).
Either way it returns the state tuple.

`launches` counts kernel launches, and nothing else; `launches_by_shape`
splits the same count by (N, L, D, score dtype, sliced).
"""

from __future__ import annotations

import torch

from .. import _build
from ..errors import DeviceError
from .dtypes import poa_int16_ok
from .poa_fused import STATE, fused_raw
from .poa_graph import RING

#: kernel launches since import (or the last reset), in all and per
#: (N, L, D, score dtype, sliced)
launches = 0
launches_by_shape: dict[tuple[int, int, int, str, bool], int] = {}

#: the kernel's limits: the sort key keeps the node id in 11 bits, and a
#: node holds at most 8 predecessor slots
MAX_NODES = 2048
MAX_PRED = 8

#: shared memory a block may take on Hopper
_MAX_SMEM = 232_448

_STATE_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int32,
                 torch.int16, torch.int64, torch.int16, torch.int16,
                 torch.int32, torch.int32, torch.bool)


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_shape.clear()


def scratch(B: int, N: int, L: int, dev, score_dtype: str = "int32"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's device-memory scratch: each window's DP ring of RING + 1 rows
    at the score dtype and its int8 backpointers, one row per node."""
    dt = torch.int16 if score_dtype == "int16" else torch.int32
    return (torch.empty((B, RING + 1, L + 1), dtype=dt, device=dev),
            torch.empty((B, N, L + 1), dtype=torch.int8, device=dev))


def smem_bytes(N: int, L: int, P: int) -> int:
    """Dynamic shared memory one K3 block takes at this shape. Asks the
    built kernel library, so it needs the CUDA toolkit."""
    return int(_build.kernels().rt_poa_fused_smem(N, L, P))


def fused_layers(state, seqs, lens, wts, slicing, lbase, match: int,
                 mismatch: int, gap: int, banded_only: bool = False,
                 score_dtype: str = "int32"):
    """All D layers of one chained call (or, with a 4-tuple `slicing`,
    of one fused launch) against the chunk's graph state. Returns the
    state tuple."""
    global launches
    B, N, P = state[1].shape
    _, D, L = seqs.shape
    sliced = len(slicing) == 4
    if state[0].device.type == "cpu":
        run = fused_raw(N, L, D, P, match, mismatch, gap,
                        banded_only=banded_only, score_dtype=score_dtype,
                        device_slice=sliced)
        return run(*state, seqs, lens, wts, *slicing, lbase)
    dev = state[0].device
    if sliced:
        ldt = (torch.int32, torch.int32, torch.int32, torch.int32)
        lshape = ((B, D), (B, D), (B,), (B,))
    else:
        ldt = (torch.int16, torch.int16, torch.int32)
        lshape = ((B, D), (B, D), (B, D))
    args = (*state, seqs, lens, wts, *slicing, lbase)
    want = (_STATE_DTYPES + (torch.int8, torch.int32, torch.int8) + ldt
            + (torch.int32,))
    names = STATE + ("seqs", "lens", "wts") + tuple(
        f"slicing[{i}]" for i in range(len(slicing))) + ("lbase",)
    for name, t, dt in zip(names, args, want):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise DeviceError("fused_layers",
                              f"{name}: want a contiguous {dt} tensor on "
                              f"{dev}, got {t.dtype} on {t.device}")
    shapes = ((B, N), (B, N, P), (B, N, P), (B, N), (B, N), (B, N),
              (B, N, 5), (B, N), (B,), (B,), (B,), (B, D, L), (B, D),
              (B, D, L)) + lshape + ((B,),)
    if any(tuple(t.shape) != s for t, s in zip(args, shapes)):
        raise DeviceError("fused_layers", "inconsistent state or layer "
                                          "shapes")
    if N > MAX_NODES or P > MAX_PRED:
        raise DeviceError("fused_layers",
                          f"{N} nodes or in-degree {P} beyond the kernel's "
                          f"limits ({MAX_NODES}, {MAX_PRED})")
    if score_dtype not in ("int32", "int16") or (
            score_dtype == "int16"
            and not poa_int16_ok(N, L, match, mismatch, gap)):
        raise DeviceError("fused_layers",
                          f"score dtype {score_dtype} at ({N}, {L}): not "
                          f"int32, nor int16 under the overflow proof")
    if smem_bytes(N, L, P) > _MAX_SMEM:
        raise DeviceError("fused_layers",
                          f"({N}, {L}, {P}) needs more shared memory than a "
                          f"block may hold")
    if B == 0 or D == 0:
        return state
    ring, bps = scratch(B, N, L, dev, score_dtype)
    lib = _build.kernels()
    ptrs = [t.data_ptr() for t in args]
    if not sliced:
        ptrs.insert(-1, None)  # the fourth slicing operand: offs only
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rt_poa_fused(
            *ptrs, ring.data_ptr(), bps.data_ptr(), B, N, L, D, P, match,
            mismatch, gap, int(banded_only),
            2 if score_dtype == "int16" else 4, int(sliced), stream)
    _build.check(lib, rc, "fused_layers")
    launches += 1
    key = (N, L, D, score_dtype, sliced)
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    return state
