"""The warm polishing service.

    queue.py      the bounded job queue: admission with retry-after,
                  FIFO within a priority, weighted fair order across
                  tenants, quotas, deadlines, cancel and drain
    batcher.py    WindowBatcher: concurrent jobs' windows merged into
                  shared device iterations by one feeder thread per
                  worker lane, with lane quarantine and re-probes and
                  the identity audit's hooks
    server.py     ServeConfig, PolishServer (warm-up, transport, workers,
                  rounds, range and fragment jobs, admit-time ingest,
                  preemption, cancel, drain; the scrape and metrics
                  port, the journal, the flight ring with `debug` and
                  `trace_pull`, per-job traces, the SLO burn rate),
                  make_synth_dataset, make_fragment_dataset and `serve`
    client.py     PolishClient, its typed errors, `clock_sync`,
                  `submit_traced` and `merge_trace`, `submit` and
                  `cancel`
    router.py     PolishRouter, RouterConfig and `router`: one service
                  over N warm replicas (contig, window-range and
                  fragment read-range shards, the contig-order merge,
                  journal-backed requeue on a replica's loss, rolling
                  restarts, the federated scrape, add_replica /
                  remove_replica and the dispatch hold)
    autoscale.py  AutoscaleConfig and Autoscaler: the elastic fleet's
                  loop, spawning and stopping replica processes
    protocol.py   length-prefixed JSON frames, the typed frame errors and
                  `error_response`
    wincache.py   the content-addressed window consensus cache, keyed on
                  sched/autotune.posture_key
    ingest.py     admit-time validation, pair normalization and
                  subsampling over the port's rampler and preprocess
"""

from .batcher import WindowBatcher
from .client import (DeadlineDoomed, JobCancelled, JobFailed, PolishClient,
                     PolishResult, QueueFull, ServeError, ServerDraining,
                     TenantQuota)
from .ingest import IngestError, IngestSpec
from .protocol import (FrameGarbage, FrameTooLarge, FrameTruncated,
                       ProtocolError, error_response, recv_frame,
                       send_frame)
from .queue import JobQueue
from .router import PolishRouter, RouterConfig
from .server import (PolishServer, ServeConfig, make_fragment_dataset,
                     make_synth_dataset)
from .wincache import WindowCache, window_content_digest

__all__ = ["DeadlineDoomed", "FrameGarbage", "FrameTooLarge",
           "FrameTruncated", "IngestError", "IngestSpec", "JobCancelled",
           "JobFailed", "JobQueue", "PolishClient", "PolishResult",
           "PolishRouter", "PolishServer", "ProtocolError", "QueueFull",
           "RouterConfig", "ServeConfig",
           "ServeError", "ServerDraining", "TenantQuota", "WindowBatcher",
           "WindowCache", "error_response", "make_fragment_dataset",
           "make_synth_dataset",
           "recv_frame", "send_frame", "window_content_digest"]
