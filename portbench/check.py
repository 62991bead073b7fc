"""The comparison that decides `correct`, once the window has closed.

Each finished job is held to the plain reference (reference.py) at three
stages, on the benchmark's own inputs: its targets (one draft for contig
polishing, a slice of the reads for read correction), its reads and the
PAF rows onto its targets.

  - `bp_excess` (alignment): a sample of the overlaps the jobs aligned:
    the longest, one of each path the aligner has (each K2 batch class of
    bucket edge, band and score dtype; the host aligner), and the rest
    drawn from the seed. For each, the edits
    that the path through the program's breaking points costs beyond the
    optimal alignment of the read to its target span, summed. Any optimal
    alignment reads 0, whichever of the tied ones the program chose.
  - `layer_mismatch` and `window_mismatch` (windows and consensus): a
    sample of windows: the deepest, one of each path the consensus engine
    has (the host engine; each K1 instantiation of score dtype and operand
    form), and the rest drawn from the seed. The reference builds
    each window from its target, the reads and the PAF rows that pass
    racon's filter (the longest row a query for contigs, every valid row
    for reads), cut at the program's breaking points (the stage the
    first number checks), and counts the windows whose backbone or layers
    differ from the program's, and those whose consensus, worked out by
    the reference's own POA, differs from the program's.
  - `stitch_mismatch` (what the job returns): every sequence a finished
    job returns against its target's windows' consensus joined in order,
    and for a whole target its name (with `r` for reads) and tags (LN, RC
    from the filtered PAF rows, XC from the windows with two layers or
    more); a target with no such window must be absent.

The reference follows the program from its breaking points on: racon's
alignment is any one of the optimal ones, and which one the program picks
decides the window's layers to the base. So the alignment stage is held
by itself (the excess), and the rest from there.

`control="int8"` puts the reference computed in 8-bit cells in the
program's place: what a precision one step below the port's int16 cells
gives, which the limits must refuse.
"""

from __future__ import annotations

import itertools
import random
import sys

import numpy as np

from . import gen_ava, reference

NUMBERS = ("bp_excess", "layer_mismatch", "window_mismatch",
           "stitch_mismatch")


class Inputs:
    """What the benchmark gave one job: its targets, its reads, the PAF rows
    onto those targets in file order, and the rows racon's filter keeps
    (the reference's own reading of them).

    `kind` is "kC" (contig polishing: the longest row per query) or "kF"
    (read correction: every row); `targets` the (name, bases) of each
    target in file order; `read_names` and `read` the reads' names and
    bases as stored, by index; `rows` a gen_ava.Rows of query read, target
    (an index into `targets`), strand and coordinates."""

    def __init__(self, kind: str, targets: list, read_names, read, rows,
                 error_threshold: float):
        self.kind = kind
        self.targets = targets
        self.read = read
        self.rows = rows
        q_names = [read_names[q] for q in rows.q.tolist()]
        t_names = [targets[t][0] for t in rows.t.tolist()]
        # a read against itself: racon matches the two by name
        self_rows = np.array([a == b for a, b in zip(q_names, t_names)],
                             dtype=bool)
        self.kept = racon_filter(kind, rows, self_rows, error_threshold)
        #: RC: the kept rows onto each target
        self.rc = np.bincount(rows.t[self.kept], minlength=len(targets))
        #: each target's kept rows, in file order
        order = self.kept[np.argsort(rows.t[self.kept], kind="stable")]
        cuts = np.searchsorted(rows.t[order], np.arange(len(targets) + 1))
        self.by_target = [order[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
        self._oriented: dict = {}
        #: the PAF row an aligned overlap came from, by what the program
        #: keeps of it: (query name, target name, strand, query begin,
        #: query end, target begin, target end)
        self.row_of = {k: i for i, k in enumerate(zip(
            q_names, t_names, rows.strand.tolist(), rows.q_begin.tolist(),
            rows.q_end.tolist(), rows.t_begin.tolist(),
            rows.t_end.tolist()))}

    def oriented(self, i: int) -> bytes:
        """Row i's read on its target's strand."""
        q, rev = int(self.rows.q[i]), bool(self.rows.strand[i])
        got = self._oriented.get((q, rev))
        if got is None:
            r = self.read(q)
            got = reference.revcomp(r) if rev else r
            self._oriented[(q, rev)] = got
        return got


def contig_inputs(ds, contig: str, error_threshold: float) -> Inputs:
    """A gen.Dataset's job: one draft, one PAF row a read over the whole
    read (gen.write's)."""
    n = ds.n_reads
    q_len = np.diff(ds.read_offsets)
    rows = gen_ava.Rows(q=np.arange(n), t=np.zeros(n, dtype=np.int64),
                        strand=ds.strands, q_begin=np.zeros(n, dtype=np.int64),
                        q_end=q_len, q_length=q_len, t_begin=ds.t_begins,
                        t_end=ds.t_ends)
    return Inputs("kC", [(contig, ds.draft_bytes())],
                  [f"r{i}" for i in range(n)], ds.read, rows,
                  error_threshold)


def racon_filter(kind: str, rows, self_rows: np.ndarray,
                 error_threshold: float) -> np.ndarray:
    """Indices of the rows racon keeps (src/polisher.cpp:284-308): those
    with error (1 - shorter span / longer) at most the threshold and not a
    read against itself; for contigs the longest of each run of one
    query's rows, with racon's pass structure: a row is dropped for its
    error only when the scan reaches it, so it can still knock out a
    longer-or-equal earlier row first, and a tie keeps the later row."""
    q_span = rows.q_end - rows.q_begin
    t_span = rows.t_end - rows.t_begin
    length = np.maximum(q_span, t_span)
    err = np.where(length > 0, 1 - np.minimum(q_span, t_span)
                   / np.maximum(length, 1), 0.0)
    bad = (err > error_threshold) | self_rows
    if kind == "kF":
        return np.nonzero(~bad)[0]
    starts = np.flatnonzero(np.r_[True, rows.q[1:] != rows.q[:-1]])
    kept = []
    for a, b in zip(starts.tolist(), [*starts[1:].tolist(), len(rows.q)]):
        if b - a == 1:
            if not bad[a]:
                kept.append(a)
            continue
        alive = [True] * (b - a)
        for i in range(b - a):
            if not alive[i]:
                continue
            if bad[a + i]:
                alive[i] = False
                continue
            for j in range(i + 1, b - a):
                if not alive[j]:
                    continue
                if length[a + i] > length[a + j]:
                    alive[j] = False
                else:
                    alive[i] = False
                    break
        kept += [a + i for i in range(b - a) if alive[i]]
    return np.array(kept, dtype=np.int64)


def _bps_by_read(inp: Inputs, run) -> dict:
    return {inp.row_of.get((row[0], row[1], row[2], row[3], row[4], row[6],
                            row[7]), -1): row
            for row in run["bps"]}


def layers_of(inp: Inputs, bps: dict, target: int, ws: int, wl: int):
    """The reference's layers of the window of `target` starting at ws:
    (bases, None, begin, end) in PAF order, and the overlaps that touch it
    but that the program left unaligned."""
    rows = inp.by_target[target]
    touch = rows[(inp.rows.t_begin[rows] < ws + wl)
                 & (inp.rows.t_end[rows] > ws)]
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


def stitch_errors(inp: Inputs, job: dict, wl: int) -> int:
    """How many of a job's returned sequences differ from what its windows
    stitch to: each target's windows' consensus joined in rank order. A
    window-range job returns each target's segment under its bare name; a
    whole job names each target (with `r` for kF) and its LN, RC and XC
    tags (XC: the windows with two layers or more, of all the target's
    windows), and leaves out a target with no such window."""
    groups: dict = {}
    for w in job["run"]["windows"]:
        groups.setdefault(w.id, []).append(w)
    want: list = []
    if job.get("range") is not None:
        for t in sorted(groups):
            data = b"".join(w.consensus for w in
                            sorted(groups[t], key=lambda w: w.rank))
            want.append((inp.targets[t][0], data))
    else:
        bps = _bps_by_read(inp, job["run"])
        for t, (name, bases) in enumerate(inp.targets):
            wins = sorted(groups.get(t, ()), key=lambda w: w.rank)
            n = -(-len(bases) // wl)
            if [w.rank for w in wins] != list(range(n)):
                want.append(None)  # windows lost: no output can match
                continue
            polished = sum(len(layers_of(inp, bps, t, w.rank * wl, wl)[0])
                           >= 2 for w in wins)
            if not polished:
                continue
            data = b"".join(w.consensus for w in wins)
            suffix = "r" if inp.kind == "kF" else ""
            want.append((f"{name}{suffix} LN:i:{len(data)} RC:i:"
                         f"{inp.rc[t]} XC:f:{polished / n:.6f}", data))
    return sum(got != w for got, w in
               itertools.zip_longest(job["output"], want))


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
        stitch += stitch_errors(inputs[job["dataset"]], job, wl)

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
                                    w.id, ws, wl)
        backbone = inp.targets[w.id][1][ws:ws + wl]
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
            q_name, t_name, strand, q_begin, q_end, q_length, t_begin, \
                t_end, bp = row
            q0 = (q_length - q_end) if strand else q_begin
            i_row = inp.row_of.get((q_name, t_name, strand, q_begin, q_end,
                                    t_begin, t_end))
            if i_row is None:
                excess += q_end - q_begin
                continue
            q = inp.oriented(i_row)[q0:q0 + q_end - q_begin]
            t = inp.targets[int(inp.rows.t[i_row])][1][t_begin:t_end]
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
