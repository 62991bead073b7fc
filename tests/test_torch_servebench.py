"""The serve benchmark in the port (racon_tpu_torch/tools/servebench.py)
against the JAX package's `tools/servebench.py`, on the CPU.

Inputs: `build_dataset` at small sizes (seed 42; 4 kb over 2 contigs at
5x with 1.5 kb reads for the runs), hand-built stats snapshots and
open-loop curves, torch at one thread, every winner table a fresh path.
Tolerance: none; bytes, keys and numbers are compared exactly.

What is held:

  - `build_dataset` writes the JAX tool's files (their gzip payloads: a
    gzip header stamps the time of writing), one contig and several;
  - `merge_fleet_snaps`, `saturation_knee` and `_baseline_view` return
    the JAX tool's values on the same inputs;
  - `mesh_info` has the JAX keys and values over the same device count
    (`max_devices_env` is always None in the port, as it is in JAX with
    RACON_TPU_MAX_DEVICES unset);
  - the default mode at its smallest size (one cold run, two wave jobs)
    exits 0, and its artifact has the JAX tool's keys, top level and in
    every block both write the same way (`warm`, `slo`, `journal`,
    `cold`, `iterations`, `mesh`); the port's cold CLI FASTA equals the
    JAX package's one-shot FASTA on the same files;
  - `--check-slo` at its smallest size exits 0 with its three cells
    green; with an impossible p99 bound it exits 1.
"""

import contextlib
import copy
import gzip
import importlib
import io
import json
import os
import sys

import pytest
import torch

from racon_tpu_torch.sched.autotune import reset_autotuner_cache
from racon_tpu_torch.tools import servebench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--genome-kb", "4", "--contigs", "2",
         "--coverage", "5", "--read-len", "1500"]


def jax_tool(name: str):
    """A script of the JAX package's tools/ directory, as a module."""
    pytest.importorskip("jax")
    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module(name)


@pytest.fixture(scope="module", autouse=True)
def _env(tmp_path_factory):
    table = str(tmp_path_factory.mktemp("autotune") / "jax.json")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RACON_TPU_AUTOTUNE_CACHE", table)
        mp.delenv("RACON_TPU_MAX_DEVICES", raising=False)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        reset_autotuner_cache()
        yield
        reset_autotuner_cache()
        torch.set_num_threads(threads)


def run_main(argv) -> tuple[int, str]:
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = servebench.main(argv)
    return rc, err.getvalue()


# ---------------------------------------------------------------- dataset
@pytest.mark.parametrize("contigs", [1, 3])
def test_build_dataset_matches_jax(tmp_path, contigs):
    jsb = jax_tool("servebench")
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ours = servebench.build_dataset(str(tmp_path / "a"), 3, 4, 1000, 42,
                                    contigs=contigs)
    theirs = jsb.build_dataset(str(tmp_path / "b"), 3, 4, 1000, 42,
                               contigs=contigs)
    for a, b in zip(ours, theirs):
        assert os.path.basename(a) == os.path.basename(b)
        with gzip.open(a) as fa, gzip.open(b) as fb:
            assert fa.read() == fb.read()


# ---------------------------------------------------------------- helpers
def snap(k: int) -> dict:
    """A server's stats snapshot, its numbers shifted by `k`."""
    return {
        "queue": {"submitted": 3 + k, "admitted": 3 + k, "completed": 2 + k,
                  "failed": k, "rejected_full": 0, "expired": 1,
                  "deadline_hit": 2, "deadline_miss": k, "depth": k},
        "slo": {"deadline_hit": 2, "deadline_miss": k, "expired": 1,
                "miss_rate": 0.0},
        "batcher": {"iterations": 5 + k, "shared_iterations": 2,
                    "solo_iterations": k, "jobs": 3, "windows": 40 + k,
                    "host_s": 0.5 * k, "compiles": k, "compile_s": 0.1,
                    "max_jobs_in_iteration": 2 + k,
                    "max_windows_in_iteration": 30 - k,
                    "max_concurrent_iterations": 1,
                    "lanes": [{"lane": 0, "iterations": 5 + k}],
                    "occupancy": {"poa": {"occupancy_pct": 50.0 + k}}},
        "inflight": k, "tenants": {"t": k}}


@pytest.mark.parametrize("n", [1, 2, 3])
def test_merge_fleet_snaps_matches_jax(n):
    jsb = jax_tool("servebench")
    snaps = [snap(k) for k in range(n)]
    assert servebench.merge_fleet_snaps(copy.deepcopy(snaps)) == \
        jsb.merge_fleet_snaps(copy.deepcopy(snaps))


CURVES = [
    [],
    [{"qps": 1.0, "achieved_qps": 0.95}, {"qps": 2.0, "achieved_qps": 1.9}],
    [{"qps": 4.0, "achieved_qps": 4.0}, {"qps": 1.0, "achieved_qps": 0.5},
     {"qps": 2.0, "achieved_qps": 2.0}],
    [{"qps": 0.5, "achieved_qps": 0.5}, {"qps": 1.0, "achieved_qps": 0.8},
     {"qps": 2.0, "achieved_qps": 2.0}],
]


@pytest.mark.parametrize("curve", CURVES)
def test_saturation_knee_matches_jax(curve):
    jsb = jax_tool("servebench")
    assert servebench.saturation_knee(curve) == jsb.saturation_knee(curve)


BASELINES = [
    {},
    {"mode": "serve", "warm": {"p99_s": 2.5, "ttfb_p50_s": 0.4}},
    {"design": "round-barrier",
     "curve": [{"qps": 1.0, "p99_s": 3.0, "ttfb_p50_s": 1.0},
               {"qps": 2.0, "p99_s": 5.0}]},
    {"mode": "serve", "openloop": {"curve": [
        {"qps": 0.5, "p99_s": 1.0, "ttfb_p50_s": 0.2},
        {"qps": 1.0}]}, "warm": {"p99_s": 9.0}},
]


@pytest.mark.parametrize("doc", BASELINES)
def test_baseline_view_matches_jax(doc):
    jsb = jax_tool("servebench")
    assert servebench._baseline_view(copy.deepcopy(doc)) == \
        jsb._baseline_view(copy.deepcopy(doc))


@pytest.mark.parametrize("lanes", [1, 2])
def test_mesh_info_matches_jax(lanes):
    pytest.importorskip("jax")
    import jax

    from racon_tpu.parallel.mesh import mesh_info as jax_mesh_info
    from racon_tpu_torch.parallel.mesh import mesh_info

    want = jax_mesh_info(lanes)
    n = len(jax.devices())
    got = mesh_info(lanes, devices=[torch.device("cpu")] * n)
    assert got == want
    assert got["max_devices_env"] is None


# --------------------------------------------------------- default mode
#: the blocks whose keys the port writes as the JAX tool does; `metrics`,
#: `occupancy` and `lanes` carry each package's own batcher snapshot
BLOCKS = ("warm", "slo", "journal", "cold", "iterations", "mesh")


@pytest.fixture(scope="module")
def default_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sb") / "serve.json")
    rc, err = run_main(SMALL + ["--jobs", "2", "--cold-runs", "1",
                                "--json", out])
    with open(out) as fh:
        return rc, err, json.load(fh)


def test_default_mode_passes(default_run):
    rc, err, doc = default_run
    assert rc == 0, err[-3000:]
    assert "[servebench] PASS" in err
    assert doc["pass"] is True and doc["mode"] == "serve"
    assert doc["warm"]["compiles_per_job"] == [0, 0, 0]
    assert doc["journal"]["consistent"] is True
    assert doc["mesh"] == {"n_devices": 1, "worker_lanes": 1,
                           "max_devices_env": None}
    assert "device" not in doc  # the card's info only on cuda


def test_default_mode_artifact_keys_match_jax(default_run, tmp_path):
    jsb = jax_tool("servebench")
    out = str(tmp_path / "jax.json")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = jsb.main(["--genome-kb", "4", "--contigs", "2", "--coverage",
                       "5", "--read-len", "1500", "--jobs", "2",
                       "--cold-runs", "1", "--json", out])
    assert rc == 0, err.getvalue()[-3000:]
    with open(out) as fh:
        want = json.load(fh)
    got = default_run[2]
    assert set(got) == set(want)
    for block in BLOCKS:
        assert set(got[block]) == set(want[block]), block


def test_cold_cli_matches_jax_one_shot(tmp_path):
    pytest.importorskip("jax")
    from racon_tpu.core.polisher import PolisherType, create_polisher

    args = servebench.parse_args(SMALL)
    paths = servebench.build_dataset(str(tmp_path), 4, 5, 1500, 42,
                                     contigs=2)
    _, cold = servebench.cold_cli_run(paths, args)
    p = create_polisher(*paths, PolisherType.kC, 500, 10.0, 0.3,
                        num_threads=2)
    p.initialize()
    assert cold == b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                            for s in p.polish())


# -------------------------------------------------------------- --check-slo
def test_check_slo_passes_and_fails():
    rc, err = run_main(SMALL + ["--jobs", "2", "--check-slo"])
    assert rc == 0, err[-3000:]
    assert "SLO gate PASS: 3/3 cells green" in err
    rc, err = run_main(SMALL + ["--jobs", "2", "--check-slo",
                                "--slo-p99", "0"])
    assert rc == 1
    assert "p99 FAIL" in err
