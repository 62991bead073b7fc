"""SLO burn-rate alerting for the warm server.

`BurnRateTracker` is a fast/slow dual-window burn-rate monitor over the
cumulative `deadline_hit` / `deadline_miss` counters (the SRE
multiwindow shape: it fires only when both the fast and the slow window
burn the error budget faster than `threshold` times, so a single
straggler cannot page and a sustained breach cannot hide). The server
samples it on every deadline-carrying job (the queue's `on_slo` hook);
a change of state journals a typed `alert` line, and the scrape carries
`racon_tpu_slo_burn_rate`, `..._burn_rate_slow` and `..._burn_alert`.

The budget, the two windows and the threshold are parameters (the
server's `slo_*` keywords and `serve` flags); no environment variable
sets them. The rest of the JAX package's fleet plane (`Endpoint`,
`FleetAggregator`, `fleet_main`: scrape federation over several
replicas) belongs to the fleet, with the router, and is not here.
"""

from __future__ import annotations

import threading
import time
from collections import deque

#: the defaults: allowed deadline-miss rate, the two window lengths in
#: seconds and the burn multiple that fires
DEFAULT_BUDGET = 0.01
DEFAULT_FAST_S = 60.0
DEFAULT_SLOW_S = 600.0
DEFAULT_THRESHOLD = 2.0


class BurnRateTracker:
    """Fast/slow dual-window SLO burn-rate monitor (module docstring).

    Feed it cumulative deadline_hit / deadline_miss samples through
    `sample()`; it returns the windowed burn rates (the window's miss
    rate over the error budget), the firing state, and whether the state
    just changed (the journal's alert edge). `seed_zero` plants a (0, 0)
    baseline at the first sample: right for a tracker born with its
    counters (the server); one attaching to counters mid-life leaves it
    False, so the existing totals are the baseline."""

    def __init__(self, budget: float = DEFAULT_BUDGET,
                 fast_s: float = DEFAULT_FAST_S,
                 slow_s: float = DEFAULT_SLOW_S,
                 threshold: float = DEFAULT_THRESHOLD,
                 seed_zero: bool = False):
        self.budget = max(1e-9, float(budget))
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self.threshold = float(threshold)
        self._samples: deque = deque()
        self._lock = threading.Lock()
        self.firing = False
        self.fast = 0.0
        self.slow = 0.0
        #: planted lazily at the first sample's own clock, so callers
        #: that drive `t` (tests, replayed journals) keep one timeline
        self._seed_zero = seed_zero

    def _burn_locked(self, now: float, window: float) -> float:
        """Miss rate over `window`, as a multiple of the budget. The
        baseline is the newest sample at or before the window start (else
        the oldest), so a short history reads as its full length rather
        than as zero."""
        if len(self._samples) < 2:
            return 0.0
        cutoff = now - window
        base = self._samples[0]
        for s in self._samples:
            if s[0] > cutoff:
                break
            base = s
        latest = self._samples[-1]
        dh = latest[1] - base[1]
        dm = latest[2] - base[2]
        total = dh + dm
        if total <= 0 or dm <= 0:
            return 0.0
        return (dm / total) / self.budget

    def sample(self, hit: int, miss: int, t: float | None = None) -> dict:
        """Record one cumulative sample and re-evaluate. Returns {fast,
        slow, firing, changed, threshold}."""
        now = time.monotonic() if t is None else t
        with self._lock:
            if self._seed_zero:
                self._seed_zero = False
                self._samples.append((now - 1e-9, 0, 0))
            # a counter that went down was reset (a restart): the older
            # samples no longer compare, so rebase on the new totals
            # rather than let negative deltas hide an ongoing breach
            if self._samples and (hit < self._samples[-1][1]
                                  or miss < self._samples[-1][2]):
                self._samples.clear()
            self._samples.append((now, int(hit), int(miss)))
            # keep one sample at or before the slow window's start as
            # its baseline; anything older no window reaches
            while (len(self._samples) > 2
                   and self._samples[1][0] <= now - self.slow_s):
                self._samples.popleft()
            self.fast = self._burn_locked(now, self.fast_s)
            self.slow = self._burn_locked(now, self.slow_s)
            firing = (self.fast >= self.threshold
                      and self.slow >= self.threshold)
            changed = firing != self.firing
            self.firing = firing
            return {"fast": round(self.fast, 4),
                    "slow": round(self.slow, 4),
                    "firing": firing, "changed": changed,
                    "threshold": self.threshold}

    def state(self) -> dict:
        with self._lock:
            return {"fast": round(self.fast, 4),
                    "slow": round(self.slow, 4),
                    "firing": self.firing,
                    "threshold": self.threshold,
                    "budget": self.budget}
