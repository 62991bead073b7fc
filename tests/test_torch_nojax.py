"""The port never loads JAX or the JAX package: in a fresh interpreter
where importing jax fails, racon_tpu_torch polishes a tiny dataset on the
CPU through both device paths, and afterwards no `jax` or `racon_tpu`
module is loaded."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import io, random, sys, tempfile
sys.modules["jax"] = None
import torch
torch.set_num_threads(1)
from racon_tpu_torch import cli
from racon_tpu_torch.synth import simulate, write_dataset
_, draft, reads, paf = simulate(random.Random(3), 2500, 6, 1500, 0.12, 0.10)
paths = write_dataset(tempfile.mkdtemp(), draft, reads, paf)
buf = io.BytesIO()
out, wrapper = sys.stdout, io.TextIOWrapper(buf)
sys.stdout = wrapper
rc = cli.main(["--device", "cpu", "-c", "1", "--cudaaligner-batches", "1",
               *paths])
wrapper.flush()
fasta = buf.getvalue()
sys.stdout = out
assert rc == 0 and fasta.startswith(b">draft LN:i:"), rc
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "racon_tpu")
             and sys.modules[m] is not None)
print("LOADED", bad)
"""


def test_port_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout
