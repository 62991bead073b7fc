"""Share of the windows polished by the host POA engine, of all windows
of the finished jobs (BatchPOA.n_host; ops/poa.py, ops/poa_graph.py)."""

from portbench.metrics import _common as _c

UNIT = "%"
SUFFIXES = ("polish",)


def read(view):
    st = _c.stats(view)
    windows = sum(s["windows"] for s in st)
    if not windows:
        return None
    return 100.0 * sum(s["poa_host"] for s in st) / windows
