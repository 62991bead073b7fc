"""Share of the traced window in which no operation ran on the card (the
profiler's device intervals, merged)."""

UNIT = "%"
SUFFIXES = ("polish", "serve")


def read(view):
    t = view["trace"]
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
