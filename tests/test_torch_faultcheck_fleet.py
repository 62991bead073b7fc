"""The fault grid's fleet sections in the port
(racon_tpu_torch/tools/faultcheck.py) on the CPU: router, range and
preempt here, fragment and trace in tests/test_torch_faultcheck_fleet2.py;
over real `python -m racon_tpu_torch serve --device cpu` replica
processes, one killed with `kill -9` mid-job.

Inputs: the serve stack's seeded datasets (`make_synth_dataset` with 1,
3 or 4 contigs, `make_fragment_dataset`); a `device:chunk=0:hang=8` plan
keeping the routed shards busy while the kill lands (no deadline: the
stall is waited out). Tolerance: none; each cell's verdict is the
tool's own: the bytes of a solo run at the serve defaults, the journal
lines, obsreport's and tracereport's checks.

What is held:

  - router: the requeued job and a concurrent one both give the solo
    bytes, `requeued` and `replica-down` journaled;
  - range: one contig range-sharded, requeued, segments tiling the
    window axis once, the journal consistent;
  - fragment: a poisoned fragment ingest refused typed `bad-request`
    beside a contig job that keeps its bytes; a fragment job
    read-range-sharded through a kill, read groups tiling the axis;
  - trace: a traced routed job through a kill with the `router.requeue`
    instant in its merged trace and tracereport's checks clean;
  - preempt: a gold job preempting a free one (both identical); a cancel
    during a device hang acked, the job failing typed `JobCancelled`
    once the stall returns, the next clean job identical;
  - every replica process is gone after its section.
"""

import os

import pytest
import torch

from racon_tpu_torch.sched.autotune import reset_autotuner_cache
from racon_tpu_torch.tools import faultcheck


@pytest.fixture(scope="module", autouse=True)
def _env():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    reset_autotuner_cache()
    yield
    reset_autotuner_cache()
    torch.set_num_threads(threads)


SECTIONS = [
    (faultcheck.run_router_cells, ["router kill -9 mid-job",
                                   "router survivor concurrent job"]),
    (faultcheck.run_range_cells, ["range-shard kill -9 mid-job"]),
    (faultcheck.run_preempt_cells, ["preempt gold over free",
                                    "cancel during device hang"]),
]


@pytest.mark.parametrize("fn,names", SECTIONS,
                         ids=[fn.__name__[4:-6] for fn, _ in SECTIONS])
def test_section_green(fn, names, tmp_path):
    check_section(fn, names, tmp_path)


def check_section(fn, names, tmp_path):
    cells = fn(str(tmp_path), "cpu")
    assert [n for n, _ in cells] == names
    for name, cell in cells:
        assert cell.startswith("pass"), (name, cell)
    # the replica processes' logs are left, their sockets are gone
    logs = [f for f in os.listdir(tmp_path) if f.endswith(".log")]
    if fn is not faultcheck.run_preempt_cells:
        assert len(logs) == 2
        for log in logs:
            sock = str(tmp_path / log[:-len(".log")]) + ".sock"
            assert not os.path.exists(sock) or _dead(sock)


def _dead(sock: str) -> bool:
    """No server answers on `sock` any more."""
    from racon_tpu_torch.serve import PolishClient

    try:
        PolishClient(socket_path=sock, timeout=2).request({"type": "ping"})
    except Exception:  # noqa: BLE001 — refused or reset: nobody there
        return True
    return False
