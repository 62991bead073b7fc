"""The span readers' arithmetic (not a reader: its name starts with an
underscore): what share of the window's wall the finished jobs spent in
some of the polisher's spans (Polisher.span_s, obs/trace.py's totals)."""

from __future__ import annotations

from portbench.metrics import _common as _c


def share(view, names: tuple):
    """100 x the finished jobs' summed seconds in `names` over the window's
    wall; None where no job recorded any of them."""
    spans = [s["span_s"] for s in _c.stats(view) if s.get("span_s")]
    if not any(n in s for s in spans for n in names):
        return None
    return 100.0 * sum(s.get(n, 0.0) for s in spans for n in names) \
        / _c.wall(view)
