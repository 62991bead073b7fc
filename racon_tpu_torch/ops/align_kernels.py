"""Wrapper of the banded wavefront aligner kernel (csrc/align_wavefront.cu).

`wavefront_align` takes the padded int8 code arrays (or their 2-bit
packing, `packed`), the lengths and the per-lane band offsets and
returns (ops [B, n_waves] i32 in traceback order, meta [B, 3] i32 =
(count, dist, touched)), at score dtype `score_dtype` ('int32', or
'int16' where dtypes.aligner_int16_ok holds). On a CUDA tensor it
launches the kernel instantiation of that dtype and operand form and
raises if the launch fails; on a CPU tensor it runs the plain PyTorch
version (align.banded_nw + traceback) at the same dtype and form.
`launches` counts kernel launches, and nothing else; `launches_by_shape`
splits the same count by the batch's (edge, band, dtype, packed).
"""

from __future__ import annotations

import torch

from .. import _build
from ..errors import DeviceError
from .align import banded_nw, traceback
from .dtypes import aligner_int16_ok
from .launch_count import LaunchCounter

#: kernel launches since import (or the last reset): in all
#: (`launches`, read through the module's __getattr__), per
#: (edge, band, score dtype, packed) (`launches_by_shape`),
#: and on the calling thread (`counter.on_thread()`)
counter = LaunchCounter()
launches_by_shape = counter.by_shape

#: the widest band the kernel takes: its shared-memory path, at 32 cells
#: a thread, fits this band's two int32 wavefronts, staging rings and edge
#: cells in 231,936 bytes, under the 227 KB a block may have (the int32
#: budget bounds both score widths)
MAX_BAND = 227 * 1024 // 12

_NAMES = ("q", "t", "q_lens", "t_lens", "offsets")


def __getattr__(name: str):
    if name == "launches":
        return counter.total
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launches() -> None:
    counter.reset()


def scratch(B: int, n_waves: int, band: int, dev) -> torch.Tensor:
    """The kernel's device-memory scratch: the backpointer plane, 16
    cells of 2 bits per int32 word."""
    return torch.empty((B, n_waves, (band + 15) // 16), dtype=torch.int32,
                       device=dev)


def wavefront_align(q, t, q_lens, t_lens, offsets, band: int,
                    score_dtype: str = "int32", packed: bool = False):
    """Banded edit-distance alignment of each lane's (q, t) pair, with
    its traceback. The offsets are as align.band_offsets makes them:
    0 at wavefront 0, steps of 0 or 1 (the kernel relies on both). q and
    t are [B, edge] int8, or [B, edge / 4] uint8 when `packed`."""
    if q.device.type == "cpu":
        bp, dist = banded_nw(q, t, q_lens, t_lens, offsets, band,
                             score_dtype, packed)
        return traceback(bp, dist, offsets, q_lens, t_lens, band)
    args = (q, t, q_lens, t_lens, offsets)
    op = torch.uint8 if packed else torch.int8
    for name, x, dt in zip(_NAMES, args, (op, op) + (torch.int32,) * 3):
        if x.device != q.device or x.dtype != dt or not x.is_contiguous():
            raise DeviceError("wavefront_align",
                              f"{name}: want a contiguous {dt} tensor on "
                              f"{q.device}, got {x.dtype} on {x.device}")
    B, width = q.shape
    edge = 4 * width if packed else width
    n_waves = offsets.shape[1]
    if (t.shape != (B, width) or q_lens.shape != (B,)
            or t_lens.shape != (B,) or offsets.shape[0] != B):
        raise DeviceError("wavefront_align", "inconsistent pair shapes")
    if not 0 < band <= MAX_BAND:
        raise DeviceError("wavefront_align",
                          f"band {band} outside (0, {MAX_BAND}]")
    if score_dtype not in ("int32", "int16") or (
            score_dtype == "int16" and not aligner_int16_ok(edge)):
        raise DeviceError("wavefront_align",
                          f"score dtype {score_dtype} at edge {edge}: not "
                          f"int32, nor int16 under the overflow proof")
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
            meta.data_ptr(), B, edge, band, n_waves,
            2 if score_dtype == "int16" else 4, int(packed), stream)
    _build.check(lib, rc, "wavefront_align")
    counter.count((edge, band, score_dtype, bool(packed)))
    return ops, meta
