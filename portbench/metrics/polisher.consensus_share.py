"""Share of the window's wall that the finished jobs' consensus phases
took (Polisher.phase_s["consensus"], summed): core/polisher.py."""

from portbench.metrics import _common as _c

UNIT = "%"
SUFFIXES = ("polish",)


def read(view):
    st = _c.stats(view)
    if not st:
        return None
    return (100.0 * sum(s["phase_s"].get("consensus", 0.0) for s in st)
            / _c.wall(view))
