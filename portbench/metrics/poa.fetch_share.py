"""Share of the window's wall that the finished jobs' session engines spent
fetching a finished consensus batch to the host (span poa.fetch in
Polisher.span_s; ops/poa_graph.py), in %."""

from portbench.metrics import _spans

UNIT = "%"
SUFFIXES = ("polish",)


def read(view):
    return _spans.share(view, ("poa.fetch",))
