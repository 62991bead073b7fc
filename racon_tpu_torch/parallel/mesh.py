"""Batch sharding over device lanes.

The reference scales across GPUs by instantiating batch objects per
device and pulling work from a shared index, with no inter-GPU
communication at all (src/cuda/cudapolisher.cpp:165-199,228-345). The
JAX package shards the leading batch axis over a device mesh
(racon_tpu/parallel/mesh.py); this is its counterpart for CUDA:
`BatchRunner` cuts a batch into equal per-lane shards and launches the
kernel once per shard, each on its lane's device and CUDA stream. Every
window and overlap is independent, so no collective exists: a shard is
an independent launch, and the JAX runner's shard_map path has no
counterpart here.

A lane is a device, and a device list may repeat one device: that is how
N lanes share one card (each lane still gets its own stream, so the
lanes' launches may overlap) and how the CPU tests get N lanes
(`[torch.device("cpu")] * 8`).
"""

from __future__ import annotations

import torch

from ..errors import DeviceError


def _tensors(out):
    """The tensors of one shard's output (a tensor, or a tuple or list
    of them)."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for t in out if isinstance(t, torch.Tensor)]


def mesh_info(worker_lanes: int = 1, devices=None) -> dict:
    """The lane posture a measurement was taken under, with the JAX
    package's keys (racon_tpu/parallel/mesh.py): `n_devices` is the
    number of lanes a BatchRunner over `devices` uses (None: every
    visible CUDA device, and DeviceError without one), `worker_lanes`
    the serve layer's lane count. `max_devices_env` is always None: the
    port reads no environment variable to cap its devices."""
    return {"n_devices": BatchRunner(devices).n_devices,
            "worker_lanes": int(worker_lanes),
            "max_devices_env": None}


def partition_devices(devices=None, k: int = 1) -> list[list]:
    """Split a device list into `k` contiguous, near-equal lanes (the
    serve layer's worker lanes, each with its own BatchRunner): `k`
    clamps to the device count and the first len(devices) % k lanes
    carry the extra device. `devices=None` takes every visible CUDA
    device (none on a host without a card: pass the list there)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    k = max(1, min(int(k), len(devices)))
    base, extra = divmod(len(devices), k)
    out, start = [], 0
    for i in range(k):
        n = base + (1 if i < extra else 0)
        out.append(devices[start:start + n])
        start += n
    return out


class BatchRunner:
    """Runs batched kernels with the leading axis split over its lanes.

    `devices=None` takes every visible CUDA device
    (`torch.cuda.device_count()`; CUDA_VISIBLE_DEVICES narrows it, as
    for any CUDA program) and raises when there is none; give an explicit
    list for anything else. With one lane a launch is a plain call on
    the caller's current stream.
    """

    def __init__(self, devices=None):
        if devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n == 0:
                raise DeviceError("BatchRunner", "no CUDA device is visible; "
                                                 "pass an explicit device "
                                                 "list")
            devices = [torch.device("cuda", i) for i in range(n)]
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise DeviceError("BatchRunner", "empty device list")
        for d in self.devices:
            if d.type == "cuda" and d.index is None:
                raise DeviceError("BatchRunner", f"device {d} has no index")
        self._streams: list | None = None
        self._subs: dict[int, "BatchRunner"] = {}
        #: calls of a run_split `fn` per lane since construction (or the
        #: last reset), sub-runners' calls included: with one kernel
        #: launch per call, the launches per lane
        self.lane_calls = [0] * len(self.devices)
        #: the runner whose first lanes these are (for_batch), whose
        #: streams and lane counts this one shares
        self._root = self

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def round_batch(self, batch: int) -> int:
        """Smallest multiple of n_devices >= batch (so shards are equal)."""
        n = self.n_devices
        return ((batch + n - 1) // n) * n

    def for_batch(self, batch: int) -> "BatchRunner":
        """The runner a batch of `batch` rows should dispatch through:
        this runner when the batch fills its lanes, else a cached
        SUB-RUNNER over the first `batch` lanes — so a tail batch smaller
        than the lane count ships with ZERO padding lanes instead of
        rounding up to the full count. Per-row results are independent
        of batch composition, so the output is byte-identical either
        way."""
        n = self.n_devices
        if batch >= n or batch < 1 or n == 1:
            return self
        sub = self._subs.get(batch)
        if sub is None:
            sub = self._subs[batch] = BatchRunner(self.devices[:batch])
            sub._root = self._root
        return sub

    def reset_lane_calls(self) -> None:
        self._root.lane_calls = [0] * self._root.n_devices

    def streams(self) -> list:
        """One CUDA stream per lane, made at the first use and kept for
        the runner's life (None for a CPU lane); a sub-runner uses its
        root's first streams."""
        root = self._root
        if root._streams is None:
            root._streams = [torch.cuda.Stream(d) if d.type == "cuda"
                             else None for d in root.devices]
        return root._streams[:self.n_devices]

    @staticmethod
    def place(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
        """`t` on `dev`, copied asynchronously on the current stream (a
        host tensor from pinned memory); the tensor itself when it is
        there already."""
        if t.device == dev:
            return t
        if dev.type == "cuda" and t.device.type == "cpu" \
                and not t.is_pinned():
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    def run_split(self, fn, *tensors):
        """Per-lane batch split: lane i gets rows [i*per, (i+1)*per) of
        every operand (the leading dim must be a multiple of n_devices,
        see round_batch) and one call of `fn` on them, on its device and
        stream — the multi-GPU batch-per-device loop of
        cudapolisher.cpp:228-345. With one lane, `fn` is called directly
        on the operands placed on that lane's device, on the current
        stream, and its output is returned as it is; otherwise the
        per-lane outputs come back as a list in lane order (the caller
        concatenates).

        ALL shards are placed before the first launch (asynchronous
        copies from pinned host memory, or between devices, each on its
        lane's stream), so lane k+1's copy overlaps lane k's kernel. Each
        lane stream first waits for the work already queued on its
        device's current stream (the operands may be produced there),
        and after the launches each device's current stream waits for
        its lanes' streams, so whatever the caller queues next on its
        current streams (copies back, concatenation) sees the results.
        Tensors used across streams are recorded on them, so the caching
        allocator does not hand out their memory early."""
        calls = self._root.lane_calls
        if self.n_devices == 1:
            dev = self.devices[0]
            calls[0] += 1
            return fn(*(self.place(t, dev) for t in tensors))
        n = self.n_devices
        rows = tensors[0].shape[0]
        if rows % n or any(t.shape[0] != rows for t in tensors):
            raise DeviceError("BatchRunner.run_split",
                              f"leading dims {[t.shape[0] for t in tensors]}"
                              f" do not split into {n} equal shards")
        per = rows // n
        if any(d.type == "cuda" for d in self.devices):
            tensors = [t.pin_memory() if t.device.type == "cpu"
                       and not t.is_pinned() else t for t in tensors]
        streams = self.streams()
        placed = []
        for i, (dev, st) in enumerate(zip(self.devices, streams)):
            shard = [t[i * per:(i + 1) * per] for t in tensors]
            if st is None:
                placed.append([self.place(t, dev) for t in shard])
                continue
            for t in shard:
                if t.device.type == "cuda":
                    st.wait_stream(torch.cuda.current_stream(t.device))
            st.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(st):
                ops = [self.place(t, dev) for t in shard]
            for t in ops:
                if t.device.type == "cuda":
                    t.record_stream(st)
            placed.append(ops)
        outs = []
        for i, (dev, st, ops) in enumerate(zip(self.devices, streams,
                                                placed)):
            calls[i] += 1
            if st is None:
                outs.append(fn(*ops))
                continue
            with torch.cuda.stream(st):
                out = fn(*ops)
            cur = torch.cuda.current_stream(dev)
            cur.wait_stream(st)
            for t in _tensors(out):
                t.record_stream(cur)
            outs.append(out)
        return outs


def concat(outs, dev: torch.device):
    """The per-lane outputs of BatchRunner.run_split concatenated in lane
    order on `dev`, on its current stream (a one-lane result passes
    through). Each lane's output is a tensor or a tuple of tensors."""
    if not isinstance(outs, list):
        return outs
    if isinstance(outs[0], torch.Tensor):
        return torch.cat([o.to(dev, non_blocking=True) for o in outs])
    return tuple(torch.cat([o[k].to(dev, non_blocking=True) for o in outs])
                 for k in range(len(outs[0])))
