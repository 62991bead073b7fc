"""Phase timing + progress logging to stderr.

`Logger` mirrors the reference Logger (src/logger.cpp:20-54): `log()`
opens a timing section, `log(msg)` closes it printing elapsed seconds,
`bar(msg)` renders a fixed 20-bin progress bar (interactive redraws only
when stderr is a tty; piped runs get one completion line per phase),
`total(msg)` prints cumulative elapsed time.

Leveled logging (`quiet`, `info`, `debug`; default info, set by the
CLI's `--cuda-log-level` through `set_log_level`): `log_info(msg)` and
`log_debug(msg)` print one stderr line at their level;
`warn_dedup(key, msg)` prints the first occurrence of a repeated warning
and counts the rest (at debug it prints every occurrence), and
`flush_dedup()` reports the counts at the end of a run. Quiet silences
the Logger's progress and timing lines; timing still accumulates.
"""

from __future__ import annotations

import sys
import threading
import time


QUIET, INFO, DEBUG = 0, 1, 2
_LEVELS = {"quiet": QUIET, "info": INFO, "debug": DEBUG}
#: the valid level names, in severity order (the CLI validates against it)
LEVEL_NAMES = tuple(_LEVELS)

_level = INFO


def log_level() -> int:
    return _level


def set_log_level(name: str | None) -> None:
    """Pin the level (`quiet`/`info`/`debug`); None restores info."""
    global _level
    if name is None:
        _level = INFO
        return
    if name not in _LEVELS:
        raise ValueError(f"set_log_level: unknown level {name!r} "
                         f"(expected one of {', '.join(_LEVELS)})")
    _level = _LEVELS[name]


def log_info(msg: str) -> None:
    if _level >= INFO:
        print(msg, file=sys.stderr)


def log_debug(msg: str) -> None:
    if _level >= DEBUG:
        print(msg, file=sys.stderr)


_dedup_lock = threading.Lock()
#: key -> count of suppressed repeats since the first occurrence
_dedup: dict[str, int] = {}


def warn_dedup(key: str, msg: str) -> None:
    """Once-per-run warning keyed on the call site: the first occurrence
    prints at info, repeats are counted for `flush_dedup()`; at debug
    every occurrence prints."""
    with _dedup_lock:
        first = key not in _dedup
        _dedup[key] = 0 if first else _dedup[key] + 1
    if _level >= DEBUG or (first and _level >= INFO):
        print(msg, file=sys.stderr)


def flush_dedup() -> None:
    """End-of-run hook: report (and clear) the suppressed-repeat counts;
    silent at quiet, and at debug, where every occurrence printed."""
    with _dedup_lock:
        repeated = [(k, c) for k, c in _dedup.items() if c]
        _dedup.clear()
    if _level != INFO:
        return
    for key, count in repeated:
        print(f"[racon_tpu_torch::log] warning '{key}' repeated {count} "
              f"more time{'s' if count != 1 else ''} (suppressed)",
              file=sys.stderr)


def reset_dedup() -> None:
    with _dedup_lock:
        _dedup.clear()


def _stderr_is_tty() -> bool:
    try:
        return sys.stderr.isatty()
    except Exception:
        return False


class Logger:
    def __init__(self):
        self._time = 0.0
        self._bar = 0
        self._bar_count = 0
        self._bar_total = 0
        self._total = 0.0
        self._open = False
        self._bar_lock = threading.Lock()

    def log(self, msg: str | None = None) -> None:
        now = time.perf_counter()
        if msg is None:
            self._time = now
            self._open = True
            return
        elapsed = now - self._time
        self._total += elapsed
        log_info(f"{msg} {elapsed:.5f} s")
        self._time = now
        self._open = False

    def bar_total(self, total: int) -> None:
        """Arm the 20-bin progress bar for `total` upcoming bar() calls."""
        with self._bar_lock:
            self._bar_total = max(total, 1)
            self._bar_count = 0
            self._bar = 0

    def bar(self, msg: str) -> None:
        with self._bar_lock:
            self._bar_count += 1
            bins = min(20 * self._bar_count // self._bar_total, 20)
            if bins == self._bar and bins < 20:
                return
            self._bar = bins
            quiet = _level < INFO
            tty = not quiet and _stderr_is_tty()
            done = bins == 20 and self._bar_count >= self._bar_total
            if tty:
                filled = "=" * bins + (">" if bins < 20 else "")
                sys.stderr.write(f"{msg} [{filled:<20}] {bins * 5}%")
            if done:
                elapsed = time.perf_counter() - self._time
                self._total += elapsed
                if tty:
                    sys.stderr.write(f" {elapsed:.5f} s\n")
                elif not quiet:
                    sys.stderr.write(f"{msg} [{'=' * 20}] 100% "
                                     f"{elapsed:.5f} s\n")
                self._bar = 0
                self._bar_count = 0
                self._time = time.perf_counter()
            elif tty:
                sys.stderr.write("\r")
            if not quiet:
                sys.stderr.flush()

    def total(self, msg: str) -> None:
        elapsed = self._total
        if self._open or self._bar:
            elapsed += time.perf_counter() - self._time
        log_info(f"{msg} {elapsed:.5f} s")
