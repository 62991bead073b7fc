"""Error types.

The reference hard-exits with a diagnostic prefix `[racon::Class::method]
error: ...`. The port raises RaconError with the same message shape; the
CLI turns it into stderr + exit status 1.

Device failures (a kernel that does not build, a launch the CUDA runtime
refuses) raise DeviceError and propagate: the port never swaps a failed
device pass for a host re-run. ChunkCorrupt is the DeviceError a fault
plan's `corrupt` action raises (resilience/faults.py).
"""

from __future__ import annotations


class RaconError(RuntimeError):
    """User-facing error carrying a `[racon_tpu_torch::Scope] error: ...`
    message."""

    def __init__(self, scope: str, message: str):
        self.scope = scope
        super().__init__(f"[racon_tpu_torch::{scope}] error: {message}")


class DeviceError(RaconError):
    """A kernel build, launch or device query failed."""


class ChunkCorrupt(DeviceError):
    """A chunk's results failed validation or could not be unpacked."""
