"""The warm polishing service's leaf modules.

    protocol.py   length-prefixed JSON frames, the typed frame errors and
                  `error_response`
    wincache.py   the content-addressed window consensus cache, keyed on
                  sched/autotune.posture_key
    ingest.py     admit-time validation, pair normalization and
                  subsampling over the port's rampler and preprocess

The queue, the batcher, the server and the client build on these.
"""

from .ingest import IngestError, IngestSpec
from .protocol import (FrameGarbage, FrameTooLarge, FrameTruncated,
                       ProtocolError, error_response, recv_frame,
                       send_frame)
from .wincache import WindowCache, window_content_digest

__all__ = ["FrameGarbage", "FrameTooLarge", "FrameTruncated",
           "IngestError", "IngestSpec", "ProtocolError", "WindowCache",
           "error_response", "recv_frame", "send_frame",
           "window_content_digest"]
