"""Host seconds of the dispatch pipeline's pack and unpack stages per
1,000 windows polished (Polisher.stage_stats; pipeline/). Its device stage
is a host-side wait and is not read."""

from portbench.metrics import _common as _c

UNIT = "s"
SUFFIXES = ("polish",)


def read(view):
    st = _c.stats(view)
    windows = sum(s["windows"] for s in st)
    if not windows:
        return None
    host = sum(s["stages"].get("pack_s", 0.0) + s["stages"].get("unpack_s", 0.0)
               for s in st)
    return 1000.0 * host / windows
