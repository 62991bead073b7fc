"""Fault injection for the dispatch pipeline (faults.FaultPlan).

The JAX package's resilience layer also has a watchdog with retries, a
strict mode and per-window quarantine: its ladder from a failed device
call to a host re-run. The port has no such ladder (a device failure
raises), so of that layer it keeps the fault plan alone: a per-polisher
object whose faults fire at the pipeline's stages and fail the run with
the error taxonomy's types (errors.py). The serve layer's batcher runs a
job that carries a plan on its own, so its faults touch no other job.
"""

from .faults import FaultPlan

__all__ = ["FaultPlan"]
