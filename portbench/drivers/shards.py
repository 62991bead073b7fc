"""One-shot range-shard jobs, one after another: each job is what the
port's router sends a replica for one range of a contig, here run in the
process as racon's library is called: `create_polisher` on the whole
input triple, `window_range` set to the shard, `initialize()`, `polish()`.
Jobs go round-robin over the contig's shards from the first, and start
until the window's seconds have passed; the job in flight then finishes
and counts. The rate is every finished job's windows over the time from
the window's start to the end of the last job.

Traffic keys: `shard_windows` (windows a shard), `warmup_windows` (the
warm-up job's range, at the contig's end), `metric` and `unit` (the
end-to-end rate's name and unit).
"""

from __future__ import annotations

import time

from portbench import gen


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.traffic = ctx.traffic
        self.paths = None
        self.length = 0

    def prepare(self) -> dict:
        ds = gen.from_config(self.cfg, self.ctx.seed)
        self.paths = gen.write(ds, self.ctx.workdir, self.cfg["name"],
                               self.cfg["contig_name"])
        self.length = len(ds.draft)
        wl = self.cfg["racon"]["window_length"]
        span = self.traffic["shard_windows"] * wl
        self.shards = [(lo, min(lo + span, self.length))
                       for lo in range(0, self.length, span)]
        return {0: ds}

    def job(self, rng: tuple[int, int]) -> dict:
        from racon_tpu_torch.core.polisher import PolisherType, create_polisher
        from torch.profiler import record_function

        rc, dv = self.cfg["racon"], self.cfg["device"]
        rec = {"dataset": 0, "range": rng, "t0": time.perf_counter()}
        try:
            with record_function("portbench.create_polisher"):
                pol = create_polisher(
                    *self.paths, PolisherType.kC, rc["window_length"],
                    rc["quality_threshold"], rc["error_threshold"],
                    rc["trim"], rc["match"], rc["mismatch"], rc["gap"],
                    rc["threads"], device=self.ctx.device,
                    autotune_table=self.ctx.autotune_table,
                    log_level="quiet", **dv)
            pol.window_range = rng
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
        wl = self.cfg["racon"]["window_length"]
        lo = max(0, self.length - self.traffic["warmup_windows"] * wl)
        rec = self.job((lo, self.length))
        if not rec["ok"]:
            raise RuntimeError(f"warm-up job failed: {rec['error']}")

    def window(self, seconds: float) -> tuple[list, float]:
        jobs = []
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            jobs.append(self.job(self.shards[i % len(self.shards)]))
            i += 1
        return jobs, t0

    def rate(self, jobs: list, t0: float) -> float:
        end = max(j["t1"] for j in jobs)
        return sum(j["windows"] for j in jobs if j["ok"]) / (end - t0)

    def close(self) -> None:
        pass
