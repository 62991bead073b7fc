"""One-shot polisher jobs, one after another, as the shards and fragments
drivers run them: each job is what the port's router sends a replica,
here run in the process as racon's library is called: `create_polisher`
on the input triple, the job's range set on the polisher, `initialize()`,
`polish()`. Jobs go round-robin over the driver's parts from the first,
and start until the window's seconds have passed; the job in flight then
finishes and counts. The rate is every finished job's windows over the
time from the window's start to the end of the last job.

A driver sets `kind` (the PolisherType's name) and `range_attr` (the
polisher attribute a job's range sets), and in prepare() `paths` (the
sequences, overlaps and targets files), `parts` (one `(dataset, range)` a
job, in the window's order) and `warm` (the warm-up job's).
"""

from __future__ import annotations

import time


class OneShot:
    kind: str
    range_attr: str

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.traffic = ctx.traffic
        self.paths = None
        self.parts: list = []
        self.warm = None

    def job(self, key, rng: tuple[int, int]) -> dict:
        from racon_tpu_torch.core.polisher import PolisherType, create_polisher
        from torch.profiler import record_function

        rc, dv = self.cfg["racon"], self.cfg["device"]
        # a window-range job returns segments (check.stitch_errors)
        rec = {"dataset": key,
               "range": rng if self.range_attr == "window_range" else None,
               "t0": time.perf_counter()}
        try:
            with record_function("portbench.create_polisher"):
                pol = create_polisher(
                    *self.paths, PolisherType[self.kind], rc["window_length"],
                    rc["quality_threshold"], rc["error_threshold"],
                    rc["trim"], rc["match"], rc["mismatch"], rc["gap"],
                    rc["threads"], device=self.ctx.device,
                    autotune_table=self.ctx.autotune_table,
                    log_level="quiet", **dv)
            setattr(pol, self.range_attr, rng)
            with record_function("portbench.initialize"):
                pol.initialize()
            with record_function("portbench.polish"):
                out = pol.polish()
            rec["output"] = [(s.name, s.data) for s in out]
            rec["run"] = self.ctx.capture.runs.pop(self.ctx.capture.key(pol))
            rec["windows"] = len(rec["run"]["windows"])
            rec["ok"] = True
        except Exception as exc:  # a failed job counts; the window goes on
            rec["ok"] = False
            rec["error"] = f"{type(exc).__name__}: {exc}"
        rec["t1"] = time.perf_counter()
        return rec

    def warmup(self) -> None:
        rec = self.job(*self.warm)
        if not rec["ok"]:
            raise RuntimeError(f"warm-up job failed: {rec['error']}")

    def window(self, seconds: float) -> tuple[list, float]:
        jobs = []
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            jobs.append(self.job(*self.parts[i % len(self.parts)]))
            i += 1
        return jobs, t0

    def rate(self, jobs: list, t0: float) -> float:
        end = max(j["t1"] for j in jobs)
        return sum(j["windows"] for j in jobs if j["ok"]) / (end - t0)

    def close(self) -> None:
        pass
