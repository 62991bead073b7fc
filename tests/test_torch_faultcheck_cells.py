"""The fault grid's `depth2+sched` and `depth2+trace` columns and its hang
rows in the port (racon_tpu_torch/tools/faultcheck.py) on the CPU; the
`depth2+fused` column is in tests/test_torch_faultcheck_fused_*.py.

Inputs: faultcheck's seeded dataset (rng 11), torch at one thread, a
cold winner table. Tolerance: none; each cell's verdict is the tool's
own (the typed error, the fault fired, no orphan thread, a clean run
after it; a hang row waited out with the clean bytes).

What is held:

  - the clean gate: the scheduler-on run equals the static run, with the
    aligner off and on;
  - each quick row is green in both columns; a `depth2+trace` cell
    also validates the failed run's Chrome trace (its `resilience.faults`
    instants equal the failed polisher's counter), and its verdict says
    `traced`;
  - `validate_trace` refuses a trace whose instants disagree with the
    counter, and `orphans` sees a live `racon-torch-*` thread but not a
    `racon-torch-serve-*` one;
  - the hang rows (`slow`, as the JAX package's own hang test): in every
    one-shot column the stage stalls 5 s and the run goes on with the
    clean bytes, no typed timeout, within the stall plus WALL_CAP.
"""

import json
import random
import threading

import pytest
import torch

from racon_tpu_torch.sched.autotune import reset_autotuner_cache
from racon_tpu_torch.tools import faultcheck

QUICK = [m for m in faultcheck.MATRIX if not m[3]]
HANG = [m for m in faultcheck.MATRIX if m[3]]


@pytest.fixture(scope="module", autouse=True)
def _env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    reset_autotuner_cache()
    yield
    reset_autotuner_cache()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fc")
    g = faultcheck.Grid(faultcheck.make_dataset(str(tmp),
                                                random.Random(11)),
                        "cpu", str(tmp / "cold.json"))
    assert g.clean_gates(depths=(2,),
                         columns=("depth2+sched", "depth2+trace")) == []
    return g


@pytest.mark.parametrize("column", ["depth2+sched", "depth2+trace"])
@pytest.mark.parametrize("name,aligner,spec", [m[:3] for m in QUICK],
                         ids=[m[0] for m in QUICK])
def test_one_shot_cell(grid, column, name, aligner, spec):
    cell = faultcheck.run_cell(grid, column, aligner, spec)
    assert cell.startswith("pass"), cell
    want, _ = faultcheck.expected_error(spec)
    assert want.__name__ in cell
    assert ("traced" in cell) == (column == "depth2+trace")


def test_validate_trace_refuses_a_miscount(tmp_path):
    doc = {"traceEvents": [
        {"name": "resilience.faults", "ph": "i", "pid": 1, "tid": 1,
         "ts": 1.0, "args": {"n": 1}},
        {"name": "pipeline.pack", "ph": "X", "pid": 1, "tid": 1,
         "ts": 0.0, "dur": 2.0}]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(doc))
    stats = {"faults": 1, "quarantined": 0}
    assert faultcheck.validate_trace(str(path), stats) is None
    stats["faults"] = 2
    assert faultcheck.validate_trace(str(path), stats).startswith(
        "FAIL trace faults events 1 != counter 2")
    doc["traceEvents"][1]["dur"] = -1.0
    path.write_text(json.dumps(doc))
    assert "negative" in faultcheck.validate_trace(str(path), stats)


def test_orphans_sees_workers_not_servers():
    stop = threading.Event()
    threads = [threading.Thread(target=stop.wait, name=name, daemon=True)
               for name in ("racon-torch-serve-worker-9",
                            "racon-torch-pack")]
    for t in threads:
        t.start()
    try:
        assert faultcheck.orphans(grace=0.1) == ["racon-torch-pack"]
    finally:
        stop.set()
        for t in threads:
            t.join(5)
    assert faultcheck.orphans(grace=1.0) == []


@pytest.mark.slow
@pytest.mark.parametrize("column", list(faultcheck.ONE_SHOT))
@pytest.mark.parametrize("name,aligner,spec", [m[:3] for m in HANG],
                         ids=[m[0] for m in HANG])
def test_hang_cell_waited_out(tmp_path, column, name, aligner, spec):
    g = faultcheck.Grid(faultcheck.make_dataset(str(tmp_path),
                                                random.Random(11)),
                        "cpu", str(tmp_path / "cold.json"))
    assert g.clean_gates(aligners=(aligner,), depths=(0, 2),
                         columns=(column,)) == []
    cell = faultcheck.run_cell(g, column, aligner, spec)
    assert cell.startswith("pass  stalled 5s (no deadline)"), cell
