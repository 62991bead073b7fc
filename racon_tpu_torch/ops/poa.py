"""Batched POA consensus over windows.

The consensus role spoa (CPU) and GenomeWorks cudapoa (GPU) play in the
reference. Two engines:

  - host: the native C++ POA graph engine (racon_tpu_torch/native),
    threaded over windows — the spoa-equivalent path;
  - device (`device_batches > 0`): the evolving-graph session engine
    (ops/poa_graph.DeviceGraphPOA): the graph DP of every layer runs on
    the device while the graph bookkeeping stays in the C++ session; the
    consensus is byte-identical to the host engine's. Windows outside the
    kernel's shape envelope are built by the host engine inside the
    session and counted. The device engine runs each bucket at the score
    dtype `score_dtype` resolves to under its overflow proof, and ships
    all-ACGT batches 2-bit packed unless `pack_bases` is False.

The host engine runs its chunks through the dispatch pipeline
(pipeline/): a pack worker builds chunk k+1's window lists while the
native POA call (GIL released) computes chunk k and the unpack worker
trims chunk k-1. The session engine keeps its own in-flight deque.

Windows with fewer than 3 sequences keep their backbone (reference
window.cpp:68-71); TGS windows are coverage-trimmed (window.cpp:118-139).
A device failure raises; nothing re-runs the windows on the host.
"""

from __future__ import annotations

import torch

from ..device import resolve
from ..native import poa_batch
from ..pipeline import DispatchPipeline
from ..utils.logger import Logger


class BatchPOA:
    #: windows per host batch call (bounds peak packed-buffer memory)
    HOST_CHUNK = 4096

    def __init__(self, match: int, mismatch: int, gap: int,
                 window_length: int, num_threads: int = 1,
                 device_batches: int = 0, banded: bool = False,
                 logger: Logger | None = None,
                 device: str | torch.device = "cuda",
                 score_dtype: str = "auto", pack_bases: bool = True,
                 pipeline=None):
        self.match = match
        self.mismatch = mismatch
        self.gap = gap
        self.window_length = window_length
        self.num_threads = num_threads
        self.device_batches = device_batches
        # the reference's -b / cuda-banded-alignment flag: the device
        # session trusts banded DP results (skips the clipped -> full-DP
        # retry), trading byte-identity with the host engine for speed
        self.banded_only = banded
        self.logger = logger
        self.device = resolve(device) if device_batches > 0 else None
        self.score_dtype = score_dtype
        self.pack_bases = pack_bases
        #: the host chunk loop's DispatchPipeline (None: synchronous)
        self.pipeline = pipeline
        #: per-window outcome counts of the last pass
        self.n_device = 0
        self.n_host = 0
        self.n_backbone = 0
        self.engine = None

    def generate_consensus(self, windows, trim: bool) -> None:
        """Fill `window.consensus` / `window.polished` for every window."""
        todo = []
        for w in windows:
            if len(w.sequences) < 3:
                w.backbone_fallback()
            else:
                todo.append(w)
        self.n_backbone = len(windows) - len(todo)
        if not todo:
            return
        if self.device_batches > 0:
            self._device_consensus(todo, trim)
            return
        bar = self.logger.bar if self.logger is not None else None
        if self.logger is not None:
            self.logger.bar_total(len(todo))
        pl = (self.pipeline if self.pipeline is not None
              else DispatchPipeline(depth=0))
        chunks = [todo[s:s + self.HOST_CHUNK]
                  for s in range(0, len(todo), self.HOST_CHUNK)]

        def pack(chunk):
            return [_pack(w) for w in chunk]

        def dispatch(chunk, packed):
            results = poa_batch(packed, self.match, self.mismatch, self.gap,
                                n_threads=self.num_threads)
            pl.stats.bump("launches")
            return results

        def wait(results):
            return results

        def unpack(chunk, results):
            for w, (cons, cov) in zip(chunk, results):
                w.apply_trim(cons, cov, trim)
                if bar is not None:
                    bar("[racon_tpu_torch::Polisher.polish] generating "
                        "consensus")

        pl.run(chunks, pack, dispatch, wait, unpack, label="host_poa",
               describe=lambda c: {"engine": "host", "jobs": len(c)})
        self.n_host = len(todo)

    def _device_consensus(self, todo, trim) -> None:
        from .poa_graph import DeviceGraphPOA, log_session_stats

        self.engine = DeviceGraphPOA(
            self.match, self.mismatch, self.gap, device=self.device,
            num_threads=self.num_threads, logger=self.logger,
            banded_only=self.banded_only, score_dtype=self.score_dtype,
            pack_bases=self.pack_bases)
        results, statuses = self.engine.consensus([_pack(w) for w in todo])
        for w, (cons, cov) in zip(todo, results):
            w.apply_trim(cons, cov, trim)
        self.n_device = int((statuses == 0).sum())
        self.n_host = int((statuses == 1).sum())
        log_session_stats(self.engine.last_stats, statuses,
                          self.engine.batches_by_plan)


def _pack(w):
    return [(w.sequences[i], w.qualities[i], w.positions[i][0],
             w.positions[i][1]) for i in range(len(w.sequences))]
