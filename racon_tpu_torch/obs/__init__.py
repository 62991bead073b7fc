"""One-shot observability: span tracing, metrics, histograms, log levels.

All off, or invisible, by default, so a plain run's stdout and stderr
stay as they were:

  1. span tracing (`obs.trace`): a thread-safe `TraceRecorder` armed by
     the CLI's `--cuda-trace <out.json>`, writing Chrome trace-event
     JSON for Perfetto: per-chunk pipeline stage spans, the session
     engine's dispatch and commit, the polisher's phases;
  2. the metrics registry (`obs.metrics.MetricsRegistry`): the pipeline
     stage counters, the latency histograms and the aligner's accounting
     in one namespaced snapshot, dumped by `--cuda-metrics <out.json>`
     and rendered as an end-of-run stderr table;
  3. latency histograms (`obs.hist`): per-chunk pipeline stage seconds
     and per-phase seconds as p50/p95/p99/max;
  4. leveled logging (`utils/logger.py`, re-exported here):
     `--cuda-log-level quiet|info|debug`.

For a long-lived process: `obs.flight` (an always-on bounded ring of
recent spans, dumped per job), `obs.journal` (a size-bounded JSONL
lifecycle log) and `obs.prom` (Prometheus text exposition and its strict
parser); the histograms carry exemplars and export for it.

`torch_profile(directory, phase)` is the deep-dive hook, the counterpart
of the JAX package's `jax_profile`: a context manager that brackets one
device phase with a `torch.profiler` capture written as Chrome trace
JSON to `<directory>/<phase>.json` (`--cuda-profile <dir>`), and a no-op
when no directory is named or the profiler cannot start.
"""

from __future__ import annotations

import contextlib
import os

from . import trace
from .hist import Histogram, HistogramSet
from .metrics import MetricsRegistry
from ..utils.logger import (flush_dedup, log_debug, log_info, log_level,
                            warn_dedup)

__all__ = ["trace", "MetricsRegistry", "Histogram", "HistogramSet",
           "torch_profile", "log_debug", "log_info", "log_level",
           "warn_dedup", "flush_dedup"]


class _SafeTorchProfile:
    """`torch.profiler.profile` bracket that degrades to a no-op: a
    profiler that cannot start or stop must not take a run down."""

    def __init__(self, path: str):
        self._path = path
        self._prof = None

    def __enter__(self) -> "_SafeTorchProfile":
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
            self._prof = prof
        except Exception as exc:
            log_debug(f"[racon_tpu_torch::obs] torch profiler unavailable "
                      f"({type(exc).__name__}: {exc}); phase runs "
                      "unprofiled")
            self._prof = None
        return self

    def __exit__(self, *exc_info) -> bool:
        if self._prof is not None:
            try:
                self._prof.__exit__(*exc_info)
                os.makedirs(os.path.dirname(self._path) or ".",
                            exist_ok=True)
                self._prof.export_chrome_trace(self._path)
            except Exception as exc:
                log_debug(f"[racon_tpu_torch::obs] torch profiler stop "
                          f"failed ({type(exc).__name__}: {exc})")
        return False


def torch_profile(directory: str | None, phase: str = "profile"):
    """Context manager capturing one phase into `<directory>/<phase>.json`
    (each phase its own file, so align and consensus don't clobber each
    other); a no-op context when `directory` is None or empty."""
    if not directory:
        return contextlib.nullcontext()
    return _SafeTorchProfile(os.path.join(directory, f"{phase}.json"))
