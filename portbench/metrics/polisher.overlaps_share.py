"""Share of the window's wall that the finished jobs spent loading their
overlaps: the PAF parse, each row's name resolution and racon's filter
(span polisher.load_overlaps in Polisher.span_s; io/parsers.py,
core/polisher.py), in %."""

from portbench.metrics import _spans

UNIT = "%"
SUFFIXES = ("polish",)


def read(view):
    return _spans.share(view, ("polisher.load_overlaps",))
