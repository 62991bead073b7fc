"""The check as it stood before it held read-correction jobs (one draft a
dataset, a PAF row matched by strand, query length and draft span), kept
for one test: on contig jobs the check of today has to read the same four
numbers. Only what differs is here; the sampling and the reference's
tasks are today's, unchanged."""

from __future__ import annotations

import random
import sys

import numpy as np

from portbench import reference
from portbench.check import NUMBERS, _map, _overlap_task, _window_task, draw


class Inputs:
    """What the benchmark gave one job: its dataset and the PAF rows that
    racon's filter keeps (the reference's own reading of them)."""

    def __init__(self, ds, contig: str, error_threshold: float):
        self.ds = ds
        self.contig = contig
        self.draft = ds.draft_bytes()
        q_span = np.diff(ds.read_offsets)
        t_span = ds.t_ends - ds.t_begins
        err = 1 - np.minimum(q_span, t_span) / np.maximum(q_span, t_span)
        self.kept = np.nonzero(err <= error_threshold)[0]
        self._oriented: dict = {}
        #: the PAF row an aligned overlap came from, by what the program
        #: keeps of it: (strand, query length, target begin, target end)
        self.row_of = {(bool(s), int(q), int(b), int(e)): i for i, (s, q, b, e)
                       in enumerate(zip(ds.strands, q_span, ds.t_begins,
                                        ds.t_ends))}

    def oriented(self, i: int) -> bytes:
        """Read i on the draft's strand."""
        got = self._oriented.get(i)
        if got is None:
            r = self.ds.read(i)
            got = reference.revcomp(r) if self.ds.strands[i] else r
            self._oriented[i] = got
        return got


def _bps_by_read(inp: Inputs, run) -> dict:
    return {inp.row_of.get((row[2], row[5], row[6], row[7]), -1): row
            for row in run["bps"]}


def layers_of(inp: Inputs, bps: dict, ws: int, wl: int):
    """The reference's layers of the window starting at ws: (bases, None,
    begin, end) in PAF order, and the overlaps that touch it but that the
    program left unaligned."""
    touch = inp.kept[(inp.ds.t_begins[inp.kept] < ws + wl)
                     & (inp.ds.t_ends[inp.kept] > ws)]
    layers, missing = [], 0
    for i in touch:
        row = bps.get(int(i))
        if row is None:
            missing += 1
            continue
        for t_first, q_first, t_last1, q_last1 in row[8]:
            if (t_first // wl) * wl != ws:
                continue
            if q_last1 - q_first < 0.02 * wl:
                continue
            layers.append((inp.oriented(int(i))[q_first:q_last1], None,
                           int(t_first - ws), int(t_last1 - ws - 1)))
    return layers, missing


def check(jobs: list, inputs: dict, cfg: dict, spec: dict, seed: int,
          control: str | None = None) -> tuple[bool, list]:
    """Returns (correct, [(name, value, limit)]). `jobs` are the finished
    jobs: {"dataset", "output": [(name, bytes)], "run": capture record,
    "range"}; `inputs` maps a dataset index to its Inputs. `spec` gives
    the windows and overlaps to draw, the limits, and the processes the
    reference runs in (`workers`, 0: this one)."""
    rc = cfg["racon"]
    wl, m, x, g = rc["window_length"], rc["match"], rc["mismatch"], rc["gap"]
    narrow = 8 if control == "int8" else None
    rng = random.Random(seed)
    limits = spec["limits"]
    workers = int(spec.get("workers", 0))
    done = [j for j in jobs if j.get("run") and j["run"]["windows"]]
    # a finished job whose windows the benchmark did not see cannot be
    # held to anything: it fails the stitch
    stitch = len(jobs) - len(done)

    # what every finished job returns, against its windows
    for job in done:
        inp = inputs[job["dataset"]]
        wins = job["run"]["windows"]
        data = b"".join(w.consensus for w in wins)
        out = job["output"]
        if len(out) != 1 or out[0][1] != data:
            stitch += 1
            continue
        if job.get("range") is not None:
            stitch += out[0][0] != inp.contig
            continue
        bps = _bps_by_read(inp, job["run"])
        polished = sum(len(layers_of(inp, bps, w.rank * wl, wl)[0]) >= 2
                       for w in wins)
        want = (f"{inp.contig} LN:i:{len(data)} RC:i:{len(inp.kept)} "
                f"XC:f:{polished / len(wins):.6f}")
        stitch += out[0][0] != want

    # windows: the deepest, one of each path (the host engine, each K1
    # instantiation), and a sample drawn from the seed
    pool = [(k, w, p) for k, job in enumerate(done)
            for w, p in zip(job["run"]["windows"],
                            job["run"].get("window_paths")
                            or [()] * len(job["run"]["windows"]))]
    picked = []
    if pool:
        deepest = max(range(len(pool)), key=lambda i: len(pool[i][1].sequences))
        picked = draw(rng, [p for _, _, p in pool], spec["windows"], deepest)
    layer_bad = 0
    tasks = []
    for i in picked:
        k, w, _ = pool[i]
        inp = inputs[done[k]["dataset"]]
        ws = w.rank * wl
        layers, missing = layers_of(inp, _bps_by_read(inp, done[k]["run"]),
                                    ws, wl)
        backbone = inp.draft[ws:ws + wl]
        mine = [(s, None, p[0], p[1]) for s, p in
                zip(w.sequences[1:], w.positions[1:])]
        if missing or w.sequences[0] != backbone or mine != layers:
            layer_bad += 1
        tasks.append((backbone, layers, m, x, g, w.consensus, narrow))
    window_bad = sum(_map(_window_task, tasks, workers))
    drawn = sorted(set().union(*(pool[i][2] for i in picked)))

    # alignment: the longest overlap, one of each path (each K2 batch
    # class, the host aligner), and a sample drawn from the seed
    ovl = [(k, row, p) for k, job in enumerate(done)
           for row, p in zip(job["run"]["bps"],
                             job["run"].get("bp_paths")
                             or [""] * len(job["run"]["bps"]))]
    excess = 0
    tasks = []
    o_picked = []
    if ovl:
        longest = max(range(len(ovl)), key=lambda i: ovl[i][1][4]
                      - ovl[i][1][3])
        o_picked = draw(rng, [(p,) if p else () for _, _, p in ovl],
                        spec["overlaps"], longest)
        for i in o_picked:
            k, row, _ = ovl[i]
            inp = inputs[done[k]["dataset"]]
            _, _, strand, q_begin, q_end, q_length, t_begin, t_end, bp = row
            q0 = (q_length - q_end) if strand else q_begin
            i_read = inp.row_of.get((strand, q_length, t_begin, t_end))
            if i_read is None:
                excess += q_end - q_begin
                continue
            q = inp.oriented(i_read)[q0:q0 + q_end - q_begin]
            t = inp.draft[t_begin:t_end]
            points = []
            for t_first, q_first, t_last1, q_last1 in bp:
                points.append((t_first - t_begin, q_first - q0))
                points.append((t_last1 - t_begin, q_last1 - q0))
            tasks.append((q, t, points, len(q) + len(t)))
    excess += sum(_map(_overlap_task, tasks, workers))
    print(f"[portbench] check drew {len(picked)} of {len(pool)} windows "
          f"(paths {drawn}) and {len(o_picked)} of {len(ovl)} overlaps "
          f"(paths {sorted({ovl[i][2] for i in o_picked})}) from "
          f"{len(done)} jobs", file=sys.stderr)

    values = {"bp_excess": excess, "layer_mismatch": layer_bad,
              "window_mismatch": window_bad, "stitch_mismatch": stitch}
    numbers = [(n, values[n], limits[n]) for n in NUMBERS]
    empty = not done
    return (not empty and all(v <= lim for _, v, lim in numbers)), numbers
