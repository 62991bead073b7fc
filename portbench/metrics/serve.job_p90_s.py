"""Nearest-rank 90th percentile of every job's latency in the window, on
the client's clock (submit to result): serve/server.py, serve/queue.py.
The job count is printed beside it on standard error."""

import sys

from portbench.metrics import _common as _c

UNIT = "s"
SUFFIXES = ("serve",)


def read(view):
    lat = sorted(j["t1"] - j["t0"] for j in view["jobs"] if j["ok"])
    if not lat:
        return None
    print(f"[portbench] serve.job_p90_s over {len(lat)} jobs",
          file=sys.stderr)
    return _c.nearest_rank(lat, 0.90)
