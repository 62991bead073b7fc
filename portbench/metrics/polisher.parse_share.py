"""Share of the window's wall that the finished jobs spent parsing their
targets and reads (spans polisher.load_targets and polisher.load_sequences
in Polisher.span_s; io/parsers.py and the native loader), in %."""

from portbench.metrics import _spans

UNIT = "%"
SUFFIXES = ("polish",)


def read(view):
    return _spans.share(view, ("polisher.load_targets",
                               "polisher.load_sequences"))
