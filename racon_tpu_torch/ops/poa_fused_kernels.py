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
Either way it returns the state tuple. `scratch` (from `scratch()`) lets
a caller keep K3's device scratch for a run, one per stream; the CPU
path ignores it.

`launches` counts kernel launches, and nothing else; `launches_by_shape`
splits the same count by (N, L, D, score dtype, sliced).
"""

from __future__ import annotations

import torch

from .. import _build
from ..errors import DeviceError
from .dtypes import poa_int16_ok
from .launch_count import LaunchCounter
from .poa_fused import STATE, fused_raw
from .poa_graph import RING

#: kernel launches since import (or the last reset): in all
#: (`launches`, read through the module's __getattr__), per
#: (N, L, D, score dtype, sliced) (`launches_by_shape`),
#: and on the calling thread (`counter.on_thread()`)
counter = LaunchCounter()
launches_by_shape = counter.by_shape

#: the kernel's limits: the sort key keeps the node id in 11 bits, a
#: node holds at most 8 predecessor slots, and a thread at most 5 of a
#: row's 128 x 5 columns
MAX_NODES = 2048
MAX_PRED = 8
MAX_LEN = 640

#: spill row stride bound of a band-256 row (csrc/poa_fused.cu kBandCols)
_BAND_COLS = 272

#: shared memory a block may take on Hopper
_MAX_SMEM = 232_448

_STATE_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int32,
                 torch.int16, torch.int64, torch.int16, torch.int16,
                 torch.int32, torch.int32, torch.bool)


def __getattr__(name: str):
    if name == "launches":
        return counter.total
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launches() -> None:
    counter.reset()


def scratch(B: int, N: int, L: int, dev, score_dtype: str = "int32"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's device-memory scratch (csrc/poa_fused.cu spill_cells, lw_of):
    a band-compact score spill per window at the score dtype, every row
    of a banded DP at its window's width (at most 257 columns, rows
    16-byte aligned) or the last RING rows of a full one, and int8
    backpointers, one row of up to L columns (rounded up to 16) per
    node."""
    dt = torch.int16 if score_dtype == "int16" else torch.int32
    lw = (L + 15) // 16 * 16
    return (torch.empty((B, max(N * _BAND_COLS, RING * lw)), dtype=dt,
                        device=dev),
            torch.empty((B, N, lw), dtype=torch.int8, device=dev))


_scratch = scratch  # fused_layers' argument of the same name hides it


def smem_bytes(N: int, L: int, P: int) -> int:
    """Dynamic shared memory one K3 block takes at this shape. Asks the
    built kernel library, so it needs the CUDA toolkit."""
    return int(_build.kernels().rt_poa_fused_smem(N, L, P))


def fused_layers(state, seqs, lens, wts, slicing, lbase, match: int,
                 mismatch: int, gap: int, banded_only: bool = False,
                 score_dtype: str = "int32", scratch=None):
    """All D layers of one chained call (or, with a 4-tuple `slicing`,
    of one fused launch) against the chunk's graph state. `scratch`: a
    (spill, bps) pair from `scratch()` at this shape and score dtype on
    the state's device, reused (the caller keeps one per stream), or None
    to allocate one. Returns the state tuple."""
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
    if N > MAX_NODES or P > MAX_PRED or L > MAX_LEN:
        raise DeviceError("fused_layers",
                          f"{N} nodes, in-degree {P} or length {L} beyond "
                          f"the kernel's limits ({MAX_NODES}, {MAX_PRED}, "
                          f"{MAX_LEN})")
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
    if scratch is None:
        scratch = _scratch(B, N, L, dev, score_dtype)
    spill, bps = scratch
    lib = _build.kernels()
    want_dt = torch.int16 if score_dtype == "int16" else torch.int32
    if (spill.dtype != want_dt or bps.dtype != torch.int8
            or spill.device != dev or bps.device != dev
            or not spill.is_contiguous() or not bps.is_contiguous()
            or tuple(spill.shape) != (B, lib.rt_poa_fused_scratch(N, L, 0))
            or tuple(bps.shape) != (B, N, lib.rt_poa_fused_scratch(N, L, 1))):
        raise DeviceError("fused_layers", "scratch: want scratch(B, N, L, "
                                          "device, score_dtype)")
    ptrs = [t.data_ptr() for t in args]
    if not sliced:
        ptrs.insert(-1, None)  # the fourth slicing operand: offs only
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rt_poa_fused(
            *ptrs, spill.data_ptr(), bps.data_ptr(), B, N, L, D, P, match,
            mismatch, gap, int(banded_only),
            2 if score_dtype == "int16" else 4, int(sliced), stream)
    _build.check(lib, rc, "fused_layers")
    counter.count((N, L, D, score_dtype, sliced))
    return state
