"""K2 (csrc/align_wavefront.cu): the window's launches' least time
(roofline.wavefront_bound on each launch's own inputs and traceback
lengths) over their device time in the profiler's trace, in %."""

from portbench.metrics import _common as _c

UNIT = "%"
SUFFIXES = ("polish", "serve")


def read(view):
    return _c.roofline(view, "k2")
