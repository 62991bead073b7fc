"""Nothing the harness runs loads JAX or the JAX package (compared by the
whole top-level name: racon_tpu_torch begins with racon_tpu), and the
reference loads nothing of the program."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

HARNESS = """
import glob, importlib.util, json, os, sys
import portbench.run, portbench.check, portbench.reference, portbench.gen
import portbench.capture, portbench.devtrace, portbench.roofline
import portbench.drivers.shards, portbench.drivers.served
import portbench.drivers.fragments, portbench.gen_ava
for p in sorted(glob.glob(os.path.join("portbench", "metrics", "*.py"))):
    spec = importlib.util.spec_from_file_location("m_" + os.path.basename(p)[:-3], p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
import racon_tpu_torch.core.polisher, racon_tpu_torch.serve.server
import racon_tpu_torch.serve.client, racon_tpu_torch.ops.poa_kernels
import racon_tpu_torch.ops.align_kernels, racon_tpu_torch._build
import racon_tpu_torch.native
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
import portbench.reference, portbench.check, portbench.gen
import portbench.gen_ava
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def top_levels(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    loaded = top_levels(HARNESS)
    assert "racon_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "racon_tpu"}


def test_reference_loads_nothing_of_the_program():
    loaded = top_levels(REFERENCE)
    assert "racon_tpu_torch" not in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "racon_tpu", "torch"}


def test_forbidden_check_is_by_whole_name():
    from portbench import run

    saved = dict(sys.modules)
    try:
        sys.modules.pop("racon_tpu", None)
        assert "racon_tpu" not in run.forbidden_modules()
        sys.modules["racon_tpu.fake"] = object()
        assert run.forbidden_modules() == ["racon_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
