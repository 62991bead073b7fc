"""The card's peak allocated memory over the window
(torch.cuda.max_memory_allocated after a reset at the window's start)."""

UNIT = "GiB"
SUFFIXES = ("polish", "serve")


def read(view):
    if not view["peak_bytes"]:
        return None
    return view["peak_bytes"] / 2**30
