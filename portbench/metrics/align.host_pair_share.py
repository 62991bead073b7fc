"""Share of the overlap pairs that the host aligner took, of all pairs
the finished jobs aligned (the polisher's aligner counts; ops/align.py)."""

from portbench.metrics import _common as _c

UNIT = "%"
SUFFIXES = ("polish",)


def read(view):
    st = _c.stats(view)
    pairs = sum(s["pairs"] for s in st)
    if not pairs:
        return None
    return 100.0 * sum(s["host_pairs"] for s in st) / pairs
