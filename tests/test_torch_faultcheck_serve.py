"""The fault grid's `serve` and `serve-lanes2` columns and its audit
section in the port (racon_tpu_torch/tools/faultcheck.py), against the
JAX package's strict server, on the CPU.

Inputs: faultcheck's seeded dataset (rng 11); the grid's two CPU
servers (one lane, and two lanes over the CPU twice); a JAX
`PolishServer` at `RACON_TPU_ALIGNER_MAXLEN=1024` and
`RACON_TPU_DEVICE_RETRIES=0`, each row's plan submitted `strict`, as JAX
faultcheck submits it; torch at one thread, every winner table a fresh
path. Tolerance: none; every value held is a byte, a type name or a
cell verdict.

What is held:

  - each quick row in the `serve` column: the poisoned job fails typed
    with the type JAX's strict server answers for the same plan, the
    server survives, and its next clean job gives the clean bytes (the
    port submits without `strict`: nothing degrades a job there);
  - each quick row in `serve-lanes2`: the same type, while a concurrent
    clean job on the other lane answers the clean bytes;
  - the audit section: at rate 1.0 an `sdc` flip is caught (journaled,
    counted, the planted winner table demoted on disk) and the FASTA
    repaired; at rate 0 the flip ships and no audit event fires.
"""

import os
import random

import pytest
import torch

from racon_tpu_torch.sched.autotune import reset_autotuner_cache
from racon_tpu_torch.tools import faultcheck

QUICK = [m for m in faultcheck.MATRIX if not m[3]]


@pytest.fixture(scope="module", autouse=True)
def _env(tmp_path_factory):
    table = str(tmp_path_factory.mktemp("autotune") / "jax.json")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RACON_TPU_MAX_DEVICES", "1")
        mp.setenv("RACON_TPU_AUTOTUNE_CACHE", table)
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
    assert g.clean_gates(depths=(2,), columns=faultcheck.SERVE_COLUMNS) \
        == []
    return g


@pytest.fixture(scope="module")
def servers(grid, tmp_path_factory):
    out = faultcheck.grid_servers(grid, str(tmp_path_factory.mktemp("s")),
                                  faultcheck.SERVE_COLUMNS)
    yield {col: client for col, (_, client) in out.items()}
    for srv, _ in out.values():
        assert srv.drain(timeout=60)


@pytest.fixture(scope="module")
def jax_types(grid, tmp_path_factory):
    """The error type JAX's strict server answers for each quick row."""
    pytest.importorskip("jax")
    from racon_tpu.serve import JobFailed, PolishClient, PolishServer

    sock = str(tmp_path_factory.mktemp("jax") / "jax.sock")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RACON_TPU_ALIGNER_MAXLEN", "1024")
        mp.setenv("RACON_TPU_DEVICE_RETRIES", "0")
        srv = PolishServer(socket_path=sock, workers=2,
                           quality_threshold=-1.0, warmup=False).start()
        try:
            cl = PolishClient(socket_path=sock)
            types = {}
            for name, aligner, spec, _ in QUICK:
                try:
                    cl.submit(*grid.paths, fault_plan=spec, strict=True,
                              options={"tpu_aligner_batches": aligner})
                    types[name] = None
                except JobFailed as exc:
                    types[name] = exc.error_type
        finally:
            srv.drain(timeout=60)
    return types


@pytest.mark.parametrize("column", faultcheck.SERVE_COLUMNS)
@pytest.mark.parametrize("name,aligner,spec", [m[:3] for m in QUICK],
                         ids=[m[0] for m in QUICK])
def test_serve_cell_typed_as_jax(grid, servers, jax_types, column, name,
                                 aligner, spec):
    run = (faultcheck.run_serve_cell if column == "serve"
           else faultcheck.run_serve_lanes_cell)
    cell = run(grid, servers[column], aligner, spec)
    assert cell.startswith("pass"), cell
    assert jax_types[name] is not None
    assert cell.split()[1].rstrip(",") == jax_types[name]


def test_audit_cells(grid, tmp_path):
    cells = faultcheck.run_audit_cells(str(tmp_path), grid.paths, "cpu")
    assert [n for n, _ in cells] == ["audit sdc sampled",
                                     "audit sdc unsampled"]
    for name, cell in cells:
        assert cell.startswith("pass"), (name, cell)
    assert os.path.exists(tmp_path / "audit_journal.jsonl")
