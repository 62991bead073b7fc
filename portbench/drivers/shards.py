"""One-shot range-shard jobs, one after another (drivers/_oneshot.py): each
job is what the port's router sends a replica for one range of a contig:
`create_polisher` on the whole input triple (PolisherType.kC) with
`window_range` set to the shard. Jobs go round-robin over the contig's
shards from the first.

Traffic keys: `shard_windows` (windows a shard), `warmup_windows` (the
warm-up job's range, at the contig's end), `metric` and `unit` (the
end-to-end rate's name and unit).
"""

from __future__ import annotations

from portbench import check, gen
from portbench.drivers._oneshot import OneShot


class Driver(OneShot):
    kind = "kC"
    range_attr = "window_range"

    def prepare(self) -> None:
        self.ds = gen.from_config(self.cfg, self.ctx.seed)
        self.paths = gen.write(self.ds, self.ctx.workdir, self.cfg["name"],
                               self.cfg["contig_name"])
        length = len(self.ds.draft)
        wl = self.cfg["racon"]["window_length"]
        span = self.traffic["shard_windows"] * wl
        self.parts = [(0, (lo, min(lo + span, length)))
                      for lo in range(0, length, span)]
        self.warm = (0, (max(0, length - self.traffic["warmup_windows"] * wl),
                         length))

    def inputs(self, jobs: list) -> dict:
        """check.Inputs of the one contig the jobs polished."""
        return {0: check.contig_inputs(
            self.ds, self.cfg["contig_name"],
            self.cfg["racon"]["error_threshold"])}
