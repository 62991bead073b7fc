"""The least time the card could take for a K1 or K2 launch: the peaks of
one H100 and the operation and byte counts of each kernel, frozen here
from chip_smoke.py (PEAK_BYTES, PEAK_OPS, bound, window_sweep_bound,
wavefront_bound), so a later change to the program cannot move the
yardstick. `window_sweep_terms` and `wavefront_terms` give the same counts
as device tensors, without waiting for the card, so the traced run can
count every launch of its window and read them all once it has closed.

A kernel's roofline share is the summed least time of its launches over
their summed device time from the profiler.
"""

from __future__ import annotations

#: peak rates of one H100 SXM: HBM bytes/s (NVIDIA data sheet), and the
#: 32-bit integer rate the kernels' DP runs at (adds, compares, mins and
#: selects; no FMAs): 132 SMs x 64 INT32 lanes x 1.98 GHz (NVIDIA Hopper
#: architecture white paper); both at the 700 W power limit
PEAK_BYTES = 3.35e12
PEAK_OPS = 132 * 64 * 1.98e9


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def window_sweep_bound(args, L) -> tuple[float, str]:
    """Least time for one window_sweep batch: its inputs read once (in
    the form given: packed operands are a quarter of the int8 bytes) and
    its int32 ranks [B, L] written once, or the DP this data needs. A
    real node row needs only its in-band columns (all lens + 1 when the
    band is 0); each such cell takes, per in-edge, 2 adds (diagonal,
    vertical), 2 maxes and the 2 equality tests of the backpointer, and
    per cell the substitution compare and the running max (subtract,
    max, add): 6 x in-degree + 4 operations, at either score width."""
    nbytes, ops = window_sweep_terms(args, L)
    return bound(nbytes, float(ops))


def window_sweep_terms(args, L):
    """window_sweep_bound's (bytes, operations), the operations a 0-dim
    tensor on the batch's device."""
    import torch

    codes, preds, centers, sinks, seq, lens, band, nnodes = args
    nbytes = (sum(t.numel() * t.element_size() for t in args)
              + preds.shape[0] * L * 4)
    deg = (preds >= 0).sum(dim=2)                                 # [B, N]
    N = deg.shape[1]
    rows = torch.arange(N, device=deg.device)[None, :] < nnodes[:, None]
    c = centers.long()
    ln = lens.long()[:, None]
    half = (band.long() // 2)[:, None]
    cols = (torch.minimum(ln, c + half) - torch.clamp(c - half, min=1) + 1)
    cols = torch.where(band[:, None] > 0, cols.clamp(min=0), ln + 1)
    return float(nbytes), ((6 * deg + 4) * cols * rows).sum()


def wavefront_bound(q_lens, t_lens, offsets, band, count,
                    packed=False) -> tuple[float, str]:
    """Least time for one wavefront_align batch: each pair's bases (a
    quarter byte each when packed), lengths and band offsets up to
    wavefront m + n read once, its ops and meta written once; or the DP
    cells inside both the band and the matrix, at 8 operations each (the
    substitution compare, 3 adds, 2 mins and the 2 compares that pick
    the backpointer), at either score width."""
    nbytes, ops = wavefront_terms(q_lens, t_lens, offsets, band, count,
                                  packed)
    return bound(float(nbytes), float(ops))


def wavefront_terms(q_lens, t_lens, offsets, band, count, packed=False):
    """wavefront_bound's (bytes, operations) as 0-dim tensors on the
    batch's device."""
    import torch

    m = q_lens.long()[:, None]
    n = t_lens.long()[:, None]
    mn = (m + n)[:, 0]
    d = torch.arange(offsets.shape[1], device=offsets.device)[None, :]
    off = offsets.long()
    lo = torch.maximum(off, (d - n).clamp(min=0))
    hi = torch.minimum(off + band - 1, torch.minimum(d, m))
    cells = ((hi - lo + 1).clamp(min=0) * (d <= m + n)).sum()
    base_bytes = mn.sum() / 4 if packed else mn.sum()
    nbytes = (base_bytes + 4 * (mn + 1).sum() + 4 * count.long().sum()
              + 20 * len(mn))
    return nbytes, 8.0 * cells
