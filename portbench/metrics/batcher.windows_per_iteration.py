"""Windows per device iteration of the server's window batcher over the
window (its counters' windows / iterations; serve/batcher.py)."""

UNIT = "windows"
SUFFIXES = ("serve",)


def read(view):
    b, a = view["batcher"]["before"], view["batcher"]["after"]
    if not a:
        return None
    iters = a["iterations"] - b.get("iterations", 0)
    if iters <= 0:
        return None
    return (a["windows"] - b.get("windows", 0)) / iters
