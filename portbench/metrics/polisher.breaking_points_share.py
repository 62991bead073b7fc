"""Share of the window's wall that the finished jobs spent handing the
device pairs' run arrays to their overlaps and walking every alignment
into per-window breaking points (spans align.runs and
polisher.breaking_points in Polisher.span_s; core/polisher.py,
core/overlap.py), in %."""

from portbench.metrics import _spans

UNIT = "%"
SUFFIXES = ("polish",)


def read(view):
    return _spans.share(view, ("align.runs", "polisher.breaking_points"))
