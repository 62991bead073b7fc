"""One-shot read-correction jobs, one after another (drivers/_oneshot.py),
as `racon_wrapper -f --split <bytes>` runs them: the targets cut into
consecutive chunks of at most `split_bytes` bases (a read longer than that
alone), each chunk one racon -f job against every read and the dual
all-vs-all PAF. A job is `create_polisher(reads, paf, reads,
PolisherType.kF)` with `target_range` set to the chunk's reads, the slice
that the port's router hands a replica; every job parses all the reads
and every PAF row. Jobs go round-robin over the chunks from the first.

Traffic keys: `split_bytes` (the wrapper's --split), `warmup_targets`
(reads in the warm-up job's slice, at the file's end), `min_shared_bp`
(the least truth two reads share to get their rows; gen_ava.py), `metric`
and `unit` (the end-to-end rate's name and unit).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench import check, gen, gen_ava
from portbench.drivers._oneshot import OneShot


def split(lengths, chunk_bytes: int) -> list:
    """[lo, hi) read slices: the wrapper's byte-bounded chunks (its
    rampler split), each closed before the read that would take it past
    `chunk_bytes`."""
    out, lo, size = [], 0, 0
    for i, n in enumerate(lengths):
        if i > lo and size + n > chunk_bytes:
            out.append((lo, i))
            lo, size = i, 0
        size += n
    if lo < len(lengths):
        out.append((lo, len(lengths)))
    return out


class Driver(OneShot):
    kind = "kF"
    range_attr = "target_range"

    def prepare(self) -> None:
        self.ds = gen.from_config(self.cfg, self.ctx.seed)
        self.rows = gen_ava.rows(self.ds, int(self.traffic["min_shared_bp"]))
        self.paths = gen_ava.write(self.ds, self.rows, self.ctx.workdir,
                                   self.cfg["name"])
        self.slices = split(np.diff(self.ds.read_offsets),
                            int(self.traffic["split_bytes"]))
        self.parts = list(enumerate(self.slices))
        n = self.ds.n_reads
        self.warm = ("warmup",
                     (max(0, n - int(self.traffic["warmup_targets"])), n))

    def inputs(self, jobs: list) -> dict:
        """check.Inputs of each slice the jobs corrected: the slice's reads
        as targets, every read, and the PAF rows onto the slice."""
        names = [f"r{i}" for i in range(self.ds.n_reads)]
        out = {}
        for k in sorted({j["dataset"] for j in jobs}):
            lo, hi = self.slices[k]
            part = self.rows.take(np.nonzero((self.rows.t >= lo)
                                             & (self.rows.t < hi))[0])
            part = dataclasses.replace(part, t=part.t - lo)
            out[k] = check.Inputs(
                "kF", [(names[i], self.ds.read(i)) for i in range(lo, hi)],
                names, self.ds.read, part,
                self.cfg["racon"]["error_threshold"])
        return out
