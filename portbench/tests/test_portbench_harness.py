"""The harness end to end on the CPU at a tiny size: the last line's
schema, a configuration, a traffic mix, a cell and a per-layer metric
found as new files, and the window's arithmetic."""

import json
import os
import time

import pytest

from portbench.tests import tiny

DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tiny.copy(tmp_path_factory.mktemp("pb"))


@pytest.mark.parametrize("cell,metric", [("tiny.contig", "polish_windows_per_s"),
                                         ("tiny.reads", "polish_windows_per_s"),
                                         ("tiny.serve", "served_jobs_per_s")])
def test_result_line(base, cell, metric):
    result, numbers = tiny.run(base, cell)
    line = json.loads(json.dumps(result))
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {metric, "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert DEVICE_KEYS <= set(line["device"])
    assert [n for n, _, _ in numbers] == list(line["checks"])
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_traced_line(base):
    result, _ = tiny.run(base, "tiny.serve", trace=1)
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    names = set(result["metrics"])
    assert "serve.job_p90_s.serve" in names
    assert "batcher.windows_per_iteration.serve" in names
    # no device number from a CPU run
    assert not any(n.startswith(("device.", "k1.", "k2.")) for n in names)
    assert all(n.endswith(".serve") for n in names)


@pytest.mark.parametrize("cell", ["tiny.contig", "tiny.reads"])
def test_span_share_readers(base, cell):
    """The polisher's span shares, from the span totals each run copies;
    the session engine's fetch is left out where no job ran that engine
    (the host engines here)."""
    result, _ = tiny.run(base, cell, trace=1)
    m = result["metrics"]
    for name in ("polisher.parse_share", "polisher.overlaps_share",
                 "polisher.breaking_points_share"):
        assert 0 < m[f"{name}.polish"]["value"] < 100, name
        assert m[f"{name}.polish"]["unit"] == "%"
    assert "poa.fetch_share.polish" not in m


def test_new_files_are_found(base):
    """A configuration, a traffic mix, a cell and a metric reader added as
    files, and nothing edited."""
    tiny.write(base, "configs", "tiny2", dict(
        json.load(open(os.path.join(base, "configs", "tiny.json"))),
        name="tiny2", genome_length=4000))
    tiny.write(base, "traffic", "tinyc2", {
        "driver": "shards", "shard_windows": 3, "warmup_windows": 1,
        "metric": "polish_windows_per_s", "unit": "windows/s",
        "suffix": "polish"})
    tiny.write(base, "cells", "tiny2.c2", {
        "config": "tiny2", "traffic": "tinyc2", "chips": 1,
        "check": {"windows": 2, "overlaps": 3, "limits": tiny.LIMITS}})
    with open(os.path.join(base, "metrics", "jobs.count.py"), "w") as fh:
        fh.write('UNIT = "jobs"\nSUFFIXES = ("polish",)\n\n\n'
                 'def read(view):\n    return len(view["jobs"])\n')
    result, _ = tiny.run(base, "tiny2.c2", trace=1)
    assert result["correct"]
    assert result["metrics"]["jobs.count.polish"]["value"] == \
        result["attempted"]
    assert "polisher.align_share.polish" in result["metrics"]


class FakeCtx:
    config = {"racon": {"window_length": 500}}
    traffic = {"shard_windows": 10, "clients": 3}


def test_window_counts_the_job_in_flight():
    from portbench.drivers import shards

    drv = shards.Driver(FakeCtx())
    drv.parts = [(0, (0, 1)), (0, (1, 2))]

    def job(key, rng):
        t0 = time.perf_counter()
        time.sleep(0.12)
        return {"ok": True, "windows": 10, "t0": t0,
                "t1": time.perf_counter()}

    drv.job = job
    jobs, t0 = drv.window(0.3)
    # started at 0, 0.12, 0.24 (< 0.3); the third runs past the window and
    # counts, and no job starts after it
    assert len(jobs) == 3
    assert jobs[-1]["t0"] - t0 < 0.3 < jobs[-1]["t1"] - t0
    rate = drv.rate(jobs, t0)
    assert rate == pytest.approx(30 / (jobs[-1]["t1"] - t0))


def test_served_window_counts_every_client():
    from portbench.drivers import served

    class Ctx(FakeCtx):
        class capture:
            runs = {}

    drv = served.Driver(Ctx())
    drv.paths = [None] * 4

    class Batcher:
        counters = {"iterations": 0, "windows": 0}

    class Server:
        batcher = Batcher()

    drv.server = Server()

    def submit(k, trace_id):
        t0 = time.perf_counter()
        time.sleep(0.1)
        return {"ok": True, "dataset": k, "trace_id": trace_id, "t0": t0,
                "t1": time.perf_counter()}

    drv._submit = submit
    jobs, t0 = drv.window(0.25)
    # each of 3 clients starts at 0, 0.1, 0.2: 9 jobs, all counted
    assert len(jobs) == 9
    assert sorted({j["dataset"] for j in jobs}) == [0, 1, 2, 3]
    end = max(j["t1"] for j in jobs)
    assert drv.rate(jobs, t0) == pytest.approx(9 / (end - t0))


def test_nearest_rank():
    from portbench.metrics import _common as c

    vals = list(range(1, 101))
    assert c.nearest_rank(vals, 0.90) == 90
    assert c.nearest_rank(vals, 0.99) == 99
    assert c.nearest_rank([5.0], 0.90) == 5.0
    assert c.nearest_rank(list(range(1, 11)), 0.90) == 9
    assert c.nearest_rank(list(range(1, 12)), 0.90) == 10
