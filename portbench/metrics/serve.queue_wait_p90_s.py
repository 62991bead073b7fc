"""Nearest-rank 90th percentile of the responses' queue_wait_s, the time a
job waited in the server's queue (serve/queue.py)."""

from portbench.metrics import _common as _c

UNIT = "s"
SUFFIXES = ("serve",)


def read(view):
    waits = sorted(j["queue_wait_s"] for j in view["jobs"]
                   if j["ok"] and "queue_wait_s" in j)
    if not waits:
        return None
    return _c.nearest_rank(waits, 0.90)
