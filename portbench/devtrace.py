"""The traced run's reading of the card: a torch.profiler capture (CPU and
CUDA activities) over the whole measured window, reduced to

  - `busy_s`: the union of the intervals in which any device operation
    (kernel, copy, set) ran, and `window_s`, the traced window's wall;
  - each kernel's summed device time and launch count, by name;
  - the breakdown: the device operations that took the most time, and the
    idle gaps between device intervals, summed by the innermost host range
    (a `record_function` name) open where each gap begins.
"""

from __future__ import annotations

import bisect
import time

#: kernel names as the profiler reports them
KERNELS = {"k1": "window_sweep_kernel", "k2": "align_wavefront_kernel"}
#: host ranges that name nothing useful about what the host was doing
_NOT_RANGES = ("aten::", "cuda", "cudnn", "Memcpy", "Memset", "void ",
               "[memory]", "ProfilerStep", "Activity Buffer",
               "Buffer Flush")
#: gaps shorter than this are summed under one name, not looked up
SHORT_GAP_US = 1000.0
#: host ranges looked at, back from a gap, for the one open across it
SCAN = 20000


def short(name: str) -> str:
    """A kernel's name without its argument list ("void f<T>(args)" ->
    "void f<T>"); other names whole."""
    if not name.startswith("void "):
        return name
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif (ch == "(" and depth == 0
              and not name.startswith("(anonymous", i)):
            return name[:i]
    return name


class DeviceTrace:
    def __init__(self, device: str = "cuda"):
        self.cuda = device == "cuda"
        self.prof = None
        self.t0 = self.t1 = 0.0

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(*exc)
        return False

    def reduce(self) -> dict:
        return reduce_events(self.prof.events(), self.t1 - self.t0)


def reduce_events(events, window_s: float) -> dict:
    """busy_s, window_s, kernels and breakdown from the profiler's events
    (FunctionEvent: name, device_type, time_range in microseconds)."""
    from torch.autograd import DeviceType

    # a record_function range also shows on the device's timeline
    # under its own name: that is no device operation
    host = {e.name for e in events if e.device_type == DeviceType.CPU}
    dev = sorted((e.time_range.start, e.time_range.end, short(e.name))
                 for e in events if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and e.name not in host)
    merged: list = []
    for a, b, _ in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_us = sum(b - a for a, b in merged)
    by_name: dict = {}
    for a, b, name in dev:
        s, n = by_name.get(name, (0.0, 0))
        by_name[name] = (s + (b - a), n + 1)
    kernels = {}
    for kernel, pattern in KERNELS.items():
        hits = [(s, n) for name, (s, n) in by_name.items()
                if pattern in name]
        kernels[kernel] = (sum(s for s, _ in hits) / 1e6,
                          sum(n for _, n in hits))
    device_ops = sorted(((name, s / 1e6) for name, (s, _) in
                         by_name.items()), key=lambda x: -x[1])[:10]
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in events
                    if e.device_type == DeviceType.CPU
                    and not e.name.startswith(_NOT_RANGES))
    gaps = [(merged[i][1], merged[i + 1][0])
            for i in range(len(merged) - 1)]
    idle: dict = {}
    starts = [r[0] for r in ranges]
    for a, b in gaps:
        if b - a < SHORT_GAP_US:
            name = "(gaps under 1 ms)"
        else:
            name = "(no host range)"
            k = bisect.bisect_right(starts, a) - 1
            stop = max(-1, k - SCAN)
            while k > stop:
                if ranges[k][1] >= a:
                    name = ranges[k][2]
                    break
                k -= 1
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    idle_gaps = sorted(idle.items(), key=lambda x: -x[1])[:10]
    return {"busy_s": busy_us / 1e6, "window_s": window_s,
            "kernels": kernels,
            "breakdown": {"device_ops": [list(x) for x in device_ops],
                          "idle_gaps": [list(x) for x in idle_gaps]}}
