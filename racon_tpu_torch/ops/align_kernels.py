"""Wrapper of the banded wavefront aligner kernel (csrc/align_wavefront.cu).

`wavefront_align` takes the padded int8 code arrays, the lengths and the
per-lane band offsets and returns (ops [B, n_waves] i32 in traceback
order, meta [B, 3] i32 = (count, dist, touched)). On a CUDA tensor it
launches the hand-written kernel and raises if the launch fails; on a CPU
tensor it runs the plain PyTorch version (align.banded_nw + traceback).
`launches` counts kernel launches, and nothing else; `launches_by_shape`
splits the same count by the batch's (edge, band).
"""

from __future__ import annotations

import torch

from .. import _build
from ..errors import DeviceError
from .align import banded_nw, traceback

#: kernel launches since import (or the last reset), in all and per
#: (edge, band)
launches = 0
launches_by_shape: dict[tuple[int, int], int] = {}

#: the widest band the kernel takes: its shared-memory path, at 32 cells
#: a thread, fits this band's two int32 wavefronts, staging rings and edge
#: cells in 231,936 bytes, under the 227 KB a block may have
MAX_BAND = 227 * 1024 // 12

_DTYPES = (torch.int8, torch.int8, torch.int32, torch.int32, torch.int32)
_NAMES = ("q", "t", "q_lens", "t_lens", "offsets")


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_shape.clear()


def scratch(B: int, n_waves: int, band: int, dev) -> torch.Tensor:
    """The kernel's device-memory scratch: the backpointer plane, 16
    cells of 2 bits per int32 word."""
    return torch.empty((B, n_waves, (band + 15) // 16), dtype=torch.int32,
                       device=dev)


def wavefront_align(q, t, q_lens, t_lens, offsets, band: int):
    """Banded edit-distance alignment of each lane's (q, t) pair, with
    its traceback. The offsets are as align.band_offsets makes them:
    0 at wavefront 0, steps of 0 or 1 (the kernel relies on both)."""
    global launches
    if q.device.type == "cpu":
        bp, dist = banded_nw(q, t, q_lens, t_lens, offsets, band)
        return traceback(bp, dist, offsets, q_lens, t_lens, band)
    args = (q, t, q_lens, t_lens, offsets)
    for name, x, dt in zip(_NAMES, args, _DTYPES):
        if x.device != q.device or x.dtype != dt or not x.is_contiguous():
            raise DeviceError("wavefront_align",
                              f"{name}: want a contiguous {dt} tensor on "
                              f"{q.device}, got {x.dtype} on {x.device}")
    B, edge = q.shape
    n_waves = offsets.shape[1]
    if (t.shape != (B, edge) or q_lens.shape != (B,)
            or t_lens.shape != (B,) or offsets.shape[0] != B):
        raise DeviceError("wavefront_align", "inconsistent pair shapes")
    if not 0 < band <= MAX_BAND:
        raise DeviceError("wavefront_align",
                          f"band {band} outside (0, {MAX_BAND}]")
    dev = q.device
    ops = torch.empty((B, n_waves), dtype=torch.int32, device=dev)
    meta = torch.empty((B, 3), dtype=torch.int32, device=dev)
    if B == 0:
        return ops, meta
    bps = scratch(B, n_waves, band, dev)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rt_align_wavefront(
            *(x.data_ptr() for x in args), bps.data_ptr(), ops.data_ptr(),
            meta.data_ptr(), B, edge, band, n_waves, stream)
    _build.check(lib, rc, "wavefront_align")
    launches += 1
    launches_by_shape[(edge, band)] = launches_by_shape.get((edge, band),
                                                            0) + 1
    return ops, meta
