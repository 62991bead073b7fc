"""The check on read-correction (kF) jobs at a tiny size on the CPU: each
job's output names as racon writes them (`<read>r LN:i: RC:i: XC:f:`),
targets with no polished window absent, racon's overlap filter for both
polisher types, and the stitch's rules on windows made by hand."""

import re
import types

import numpy as np
import pytest

from portbench import check, gen_ava
from portbench.tests import tiny

NAME = re.compile(r"^(r\d+)r LN:i:(\d+) RC:i:(\d+) XC:f:(\d\.\d{6})$")


def spied_run(base, cell, monkeypatch, **kw):
    """tiny.run, returning also the jobs and inputs the check was given."""
    seen = {}
    real = check.check

    def spy(jobs, inputs, *a, **k):
        seen.setdefault("jobs", jobs)
        seen.setdefault("inputs", inputs)
        return real(jobs, inputs, *a, **k)

    monkeypatch.setattr(check, "check", spy)
    result, _ = tiny.run(base, cell, **kw)
    return result, seen["jobs"], seen["inputs"]


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    base = tiny.copy(tmp_path_factory.mktemp("pb"))
    # reads must share 1,400 bp to get rows: the short ones get none, and
    # come back unpolished
    tiny.write(base, "traffic", "tinyr_sparse", {
        "driver": "fragments", "split_bytes": 12000, "warmup_targets": 3,
        "min_shared_bp": 1400, "metric": "polish_windows_per_s",
        "unit": "windows/s", "suffix": "polish"})
    tiny.write(base, "cells", "tiny.reads_sparse", {
        "config": "tiny", "traffic": "tinyr_sparse", "chips": 1,
        "check": {"windows": 4, "overlaps": 6, "limits": tiny.LIMITS}})
    return base


def test_output_names(base, monkeypatch):
    result, jobs, inputs = spied_run(base, "tiny.reads", monkeypatch,
                                     seconds=0.5)
    assert result["correct"], result["checks"]
    for job in jobs:
        inp = inputs[job["dataset"]]
        assert inp.kind == "kF"
        names = [t[0] for t in inp.targets]
        for name, data in job["output"]:
            m = NAME.match(name)
            assert m, name
            t = names.index(m.group(1))
            assert int(m.group(2)) == len(data)
            assert int(m.group(3)) == inp.rc[t] > 0


def test_unpolished_targets_absent(base, monkeypatch):
    result, jobs, inputs = spied_run(base, "tiny.reads_sparse", monkeypatch,
                                     seconds=1.0)
    assert result["correct"], result["checks"]
    absent = 0
    for job in jobs:
        inp = inputs[job["dataset"]]
        got = {NAME.match(n).group(1) for n, _ in job["output"]}
        for t, (name, _) in enumerate(inp.targets):
            if inp.rc[t] == 0:
                assert name not in got
                absent += 1
    assert absent > 0


def rows_of(lengths, q, bad_err=()):
    """Rows onto target 0, query i's spans both `lengths[i]` long (or, in
    `bad_err`, the target's half as long)."""
    n = len(lengths)
    t_len = np.array([x // 2 if i in bad_err else x
                      for i, x in enumerate(lengths)])
    z = np.zeros(n, dtype=np.int64)
    return gen_ava.Rows(q=np.array(q), t=z, strand=np.zeros(n, dtype=bool),
                        q_begin=z, q_end=np.array(lengths), q_length=np.array(
                            lengths), t_begin=z, t_end=t_len)


@pytest.mark.parametrize("lengths,bad,kept", [
    ([5, 7, 7, 3], (), [2]),        # a tie keeps the later row
    ([9, 5, 3], (), [0]),           # the longest, first
    ([5, 9], (1,), []),             # a bad row knocks out a shorter one first
    ([9, 5], (1,), [0]),
    ([5, 9, 6], (1,), [2]),
])
def test_contig_filter_keeps_racons_row(lengths, bad, kept):
    rows = rows_of(lengths, [0] * len(lengths), bad)
    got = check.racon_filter("kC", rows, np.zeros(len(lengths), dtype=bool),
                             0.3)
    assert got.tolist() == kept


def test_reads_filter_keeps_every_sound_row():
    rows = rows_of([5, 7, 7, 3], [0, 0, 1, 1], (1,))
    self_rows = np.array([False, False, True, False])
    assert check.racon_filter("kF", rows, self_rows, 0.3).tolist() == [0, 3]
    # a contig keeps one row a query: the bad row knocks out the first
    assert check.racon_filter("kC", rows, self_rows, 0.3).tolist() == [3]


def test_stitch_rules():
    """Two targets of 3 and 2 windows; the second has no layers at all."""
    wl = 4
    targets = [("r7", b"ACGTACGTAC"), ("r9", b"GGGGCC")]
    rows = gen_ava.Rows(q=np.array([0, 1]), t=np.array([0, 0]),
                        strand=np.zeros(2, dtype=bool),
                        q_begin=np.zeros(2, dtype=np.int64),
                        q_end=np.array([10, 10]), q_length=np.array([10, 10]),
                        t_begin=np.array([0, 0]), t_end=np.array([10, 10]))
    inp = check.Inputs("kF", targets, ["r0", "r1"], lambda i: b"ACGTACGTAC",
                       rows, 0.3)
    # both reads laid along the whole of target 0, one piece a window
    bp = np.array([[0, 0, 4, 4], [4, 4, 8, 8], [8, 8, 10, 10]])
    run = {"bps": [(f"r{i}", "r7", False, 0, 10, 10, 0, 10, bp)
                   for i in range(2)]}
    win = types.SimpleNamespace
    run["windows"] = ([win(id=0, rank=k, consensus=b"AC") for k in range(3)]
                      + [win(id=1, rank=k, consensus=b"GG") for k in range(2)])
    job = {"run": run, "range": None,
           "output": [("r7r LN:i:6 RC:i:2 XC:f:1.000000", b"ACACAC")]}
    assert check.stitch_errors(inp, job, wl) == 0
    # the unpolished target returned, a wrong tag, a target missing
    extra = dict(job, output=job["output"] + [("r9r LN:i:4 RC:i:0 "
                                               "XC:f:0.000000", b"GGGG")])
    assert check.stitch_errors(inp, extra, wl) == 1
    wrong = dict(job, output=[("r7r LN:i:6 RC:i:2 XC:f:0.666667", b"ACACAC")])
    assert check.stitch_errors(inp, wrong, wl) == 1
    assert check.stitch_errors(inp, dict(job, output=[]), wl) == 1
    # a window-range job: each target's bare name, none dropped
    ranged = dict(job, range=(0, 12), output=[("r7", b"ACACAC"),
                                             ("r9", b"GGGG")])
    assert check.stitch_errors(inp, ranged, wl) == 0
