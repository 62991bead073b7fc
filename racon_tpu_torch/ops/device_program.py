"""Pieces the device engines' chunk loops share.

The port's counterpart of the JAX package's racon_tpu/ops/device_program.py,
trimmed to `shard_useful_split`. Its `ChunkBreaker` is not carried: it
routes a failed chunk's items to the engine's declared fallback, and in
the port a failed launch raises instead.
"""

from __future__ import annotations


def shard_useful_split(row_cells, lanes: int, n_devices: int) -> list:
    """Per-lane useful-cell sums for a contiguously split batch of `lanes`
    rows (rows s*per .. (s+1)*per land on lane s) — the occupancy lane
    view every engine records. `row_cells` is the per-row useful-cell
    list for the REAL rows only; the padding rows at the batch tail
    contribute zero wherever they land."""
    per = lanes // max(1, n_devices)
    return [sum(row_cells[s * per:(s + 1) * per])
            for s in range(n_devices)]
