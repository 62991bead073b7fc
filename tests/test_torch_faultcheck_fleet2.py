"""The fault grid's fragment and trace sections in the port
(racon_tpu_torch/tools/faultcheck.py) on the CPU, over real `python -m
racon_tpu_torch serve --device cpu` replica processes, one killed with
`kill -9` mid-job; held as tests/test_torch_faultcheck_fleet.py holds
the router, range and preempt sections.

What is held:

  - fragment: a poisoned fragment ingest refused typed `bad-request`
    beside a contig job that keeps its bytes, then a clean fragment job
    with the solo kF bytes; a fragment job read-range-sharded through a
    kill with the solo kF bytes, `frag-plan` and `requeued` journaled,
    read groups tiling the read axis;
  - trace: a traced routed job through a kill with a solo run's bytes,
    the `router.requeue` instant in its merged trace and tracereport's
    checks clean;
  - every replica process is gone after its section.
"""

import pytest

from racon_tpu_torch.tools import faultcheck
from test_torch_faultcheck_fleet import _env, check_section  # noqa: F401

SECTIONS = [
    (faultcheck.run_fragment_cells,
     ["fragment poisoned ingest, contig alongside",
      "fragment kill -9 mid-job"]),
    (faultcheck.run_trace_cells, ["traced requeue kill -9 mid-job"]),
]


@pytest.mark.parametrize("fn,names", SECTIONS,
                         ids=[fn.__name__[4:-6] for fn, _ in SECTIONS])
def test_section_green(fn, names, tmp_path):
    check_section(fn, names, tmp_path)
