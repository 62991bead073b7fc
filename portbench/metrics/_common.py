"""Helpers the metric readers share (not a reader: its name starts with
an underscore)."""

from __future__ import annotations

import math


def stats(view) -> list:
    """The counters of every finished job's polisher run."""
    return [j["run"]["stats"] for j in view["jobs"]
            if j["ok"] and j.get("run") and j["run"].get("stats")]


def wall(view) -> float:
    return view["t_end"] - view["t0"]


def nearest_rank(sorted_vals, q: float):
    """Nearest-rank percentile: the value at rank ceil(q * n), 1-based, of
    an ascending list (the arithmetic of racon_tpu_torch.serve.queue's)."""
    n = len(sorted_vals)
    return sorted_vals[max(0, min(n - 1, math.ceil(q * n) - 1))]


def roofline(view, kernel: str):
    """Summed least time of the window's launches of `kernel` over their
    summed device time, in %; None where the trace holds no launch of it
    or counts other launches than the benchmark counted."""
    trace, bounds = view["trace"], view["bounds"]
    if not trace or not bounds:
        return None
    dev_s, n_trace = trace["kernels"].get(kernel, (0.0, 0))
    bound_ms, n_counted = bounds.get(kernel, (0.0, 0))
    if n_trace == 0 or dev_s <= 0 or n_trace != n_counted:
        return None
    return 100.0 * bound_ms / (dev_s * 1e3)
