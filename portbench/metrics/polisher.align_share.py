"""Share of the window's wall that the finished jobs' align phases took
(Polisher.phase_s["align"], summed): the polisher layer, core/polisher.py."""

from portbench.metrics import _common as _c

UNIT = "%"
SUFFIXES = ("polish",)


def read(view):
    st = _c.stats(view)
    if not st:
        return None
    return 100.0 * sum(s["phase_s"].get("align", 0.0) for s in st) / _c.wall(view)
