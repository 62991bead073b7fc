"""The comparison that decides `correct`, once the window has closed.

Each finished job is held to the plain reference (reference.py) at three
stages, on the benchmark's own inputs:

  - `bp_excess` (alignment): a sample of the overlaps the jobs aligned:
    the longest, one of each path the aligner has (each K2 batch class of
    bucket edge, band and score dtype; the host aligner), and the rest
    drawn from the seed. For each, the edits
    that the path through the program's breaking points costs beyond the
    optimal alignment of the read to its draft span, summed. Any optimal
    alignment reads 0, whichever of the tied ones the program chose.
  - `layer_mismatch` and `window_mismatch` (windows and consensus): a
    sample of windows: the deepest, one of each path the consensus engine
    has (the host engine; each K1 instantiation of score dtype and operand
    form), and the rest drawn from the seed. The reference builds
    each window from the draft, the reads and the PAF rows that pass
    racon's filter, cut at the program's breaking points (the stage the
    first number checks), and counts the windows whose backbone or layers
    differ from the program's, and those whose consensus, worked out by
    the reference's own POA, differs from the program's.
  - `stitch_mismatch` (what the job returns): every finished job's
    output sequence against its windows' consensus joined in order, and for a whole
    contig its name and tags (LN, RC from the filtered PAF rows, XC from
    the windows with two layers or more).

The reference follows the program from its breaking points on: racon's
alignment is any one of the optimal ones, and which one the program picks
decides the window's layers to the base. So the alignment stage is held
by itself (the excess), and the rest from there.

`control="int8"` puts the reference computed in 8-bit cells in the
program's place: what a precision one step below the port's int16 cells
gives, which the limits must refuse.
"""

from __future__ import annotations

import random
import sys

import numpy as np

from . import reference

NUMBERS = ("bp_excess", "layer_mismatch", "window_mismatch",
           "stitch_mismatch")


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


def draw(rng: random.Random, labels: list, n: int, first: int) -> list:
    """Indices of a sample of n items: `first`, then one item of each path
    label that the sample does not hold yet (labels in sorted order, the
    item drawn from the seed), then items drawn from the seed."""
    picked = [first]
    have = set(labels[first])
    by_label: dict = {}
    for i, ls in enumerate(labels):
        for lab in ls:
            by_label.setdefault(lab, []).append(i)
    for lab in sorted(by_label):
        if lab not in have:
            i = rng.choice(by_label[lab])
            picked.append(i)
            have.update(labels[i])
    taken = set(picked)
    rest = [i for i in range(len(labels)) if i not in taken]
    picked += rng.sample(rest, max(0, min(len(rest), n - len(picked))))
    return picked


def _window_task(task) -> tuple[int, int]:
    """(want, got) of one window: the reference's consensus, and the
    program's, or with the control the reference's in 8-bit cells."""
    backbone, layers, m, x, g, got, narrow = task
    want = reference.polish_window(backbone, b"!" * len(backbone), layers,
                                   m, x, g)
    if narrow is not None:
        got = reference.polish_window(backbone, b"!" * len(backbone),
                                      layers, m, x, g, narrow=narrow)
    return got != want


def _overlap_task(task) -> int:
    q, t, points, fallback = task
    try:
        return reference.breaking_point_excess(q, t, points)
    except ValueError:
        return fallback


def _map(fn, tasks: list, workers: int) -> list:
    """fn over tasks, in `workers` spawned processes (0: in this one).
    The pool is shut down, and its processes ended, before it returns."""
    if workers <= 0 or len(tasks) < 2:
        return [fn(t) for t in tasks]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(min(workers, len(tasks)), mp_context=ctx) as ex:
        return list(ex.map(fn, tasks))


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
