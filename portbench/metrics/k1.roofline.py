"""K1 (csrc/poa_window_sweep.cu): the window's launches' least time
(roofline.window_sweep_bound on each launch's own inputs) over their
device time in the profiler's trace, in %."""

from portbench.metrics import _common as _c

UNIT = "%"
SUFFIXES = ("polish", "serve")


def read(view):
    return _c.roofline(view, "k1")
