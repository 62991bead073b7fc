"""The serve benchmark's modes in the port
(racon_tpu_torch/tools/servebench.py) on the CPU, each at its smallest
size: `--router 2`, `--ramp 2`, `--rounds 2`, `--fragment 2`, `--flood 2`,
and a two-point `--qps-curve` with a `--baseline` the test writes.

Inputs: `build_dataset` (seed 42) at 4 kb over 2 contigs at 5x with
1.5 kb reads, or, where a gate needs jobs long enough to queue, preempt
or be doomed (fragment, flood, ramp), 12 kb over 2 contigs at 10x with
2 kb reads; the fleet modes' replicas are `serve --device cpu`
processes. Tolerance: none on bytes and counts; the speed gates are the
tool's own (a fragment wave faster than the contig wave, a ramp that
scales up and back down).

What is held: each mode exits 0 and its artifact carries the JAX tool's
block for it (`router` with `trace`, `autoscale`, `rounds` and `cache`,
`fragment`, `qos`, `openloop` with `baseline`), with the mode's identity
gates true and, for `--baseline`, the block equal to `_baseline_view`
of the file.
"""

import contextlib
import io
import json

import pytest
import torch

from racon_tpu_torch.sched.autotune import reset_autotuner_cache
from racon_tpu_torch.tools import servebench

SMALL = ["--device", "cpu", "--genome-kb", "4", "--contigs", "2",
         "--coverage", "5", "--read-len", "1500"]
MEDIUM = ["--device", "cpu", "--genome-kb", "12", "--contigs", "2",
          "--coverage", "10", "--read-len", "2000"]


@pytest.fixture(scope="module", autouse=True)
def _env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    reset_autotuner_cache()
    yield
    reset_autotuner_cache()
    torch.set_num_threads(threads)


def bench(tmp_path, argv) -> tuple[dict, str]:
    out = str(tmp_path / "a.json")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = servebench.main(argv + ["--json", out])
    assert rc == 0, err.getvalue()[-4000:]
    with open(out) as fh:
        doc = json.load(fh)
    assert doc["pass"] is True
    return doc, err.getvalue()


def test_router_mode(tmp_path):
    doc, _ = bench(tmp_path, SMALL + ["--router", "2", "--jobs", "2"])
    r = doc["router"]
    assert doc["mode"] == "router" and r["identical"] is True
    assert [pt["replicas"] for pt in r["curve"]] == [1, 2]
    assert r["requeues"] == 0 and r["scaling_x"] > 0
    assert set(doc["trace"]) == {"untraced_wall_s", "traced_wall_s",
                                 "overhead_pct"}


def test_ramp_mode(tmp_path):
    doc, _ = bench(tmp_path, MEDIUM + ["--ramp", "2", "--ramp-jobs", "12"])
    a = doc["autoscale"]
    assert a["jobs_lost"] == 0 and a["completed"] == 12
    assert a["scale_ups"] >= 1 and a["scale_downs"] >= 1
    assert a["drained_to_min"] is True
    assert len(a["ramp_jobs"]) == 12 and a["replicas_over_time"]


def test_rounds_mode(tmp_path):
    doc, _ = bench(tmp_path, SMALL + ["--rounds", "2"])
    assert doc["cache"]["identical"] is True
    assert doc["cache"]["resubmit"]["hit_rate"] > 0
    assert doc["rounds"]["completed"] == 2
    assert len(doc["rounds"]["per_round"]) == 2


def test_fragment_mode(tmp_path):
    doc, _ = bench(tmp_path, MEDIUM + ["--fragment", "2", "--jobs", "2"])
    f = doc["fragment"]
    assert f["identical"] is True and f["reads"] == 17
    assert f["vs_contig_x"] > 1 and f["wave"]["completed"] == 2
    assert f["parts_per_job"] > 1


def test_flood_mode(tmp_path):
    doc, _ = bench(tmp_path, MEDIUM + ["--flood", "2", "--jobs", "2",
                                       "--workers", "1"])
    q = doc["qos"]
    assert q["preemptions"] >= 1
    assert q["doomed_aborted"] == q["doomed_submitted"] == 2


def test_qps_curve_with_baseline(tmp_path):
    base = {"design": "round-barrier",
            "curve": [{"qps": 0.5, "p99_s": 30.0, "ttfb_p50_s": 10.0},
                      {"qps": 1.0, "p99_s": 40.0, "ttfb_p50_s": 12.0}]}
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(base))
    doc, err = bench(tmp_path, SMALL + [
        "--jobs", "2", "--cold-runs", "1", "--qps-curve", "0.5,1",
        "--qps-jobs", "2", "--baseline", str(path)])
    curve = doc["openloop"]["curve"]
    assert [pt["qps"] for pt in curve] == [0.5, 1.0]
    assert all(pt["completed"] == 2 for pt in curve)
    assert doc["openloop"]["knee_qps"] == servebench.saturation_knee(curve)
    assert doc["baseline"] == servebench._baseline_view(base)
    assert "vs baseline (round-barrier): p99" in err
