"""The port never loads JAX or the JAX package: in a fresh interpreter
where importing jax fails, racon_tpu_torch polishes a tiny dataset on the
CPU through both device paths (at the default score-dtype posture, through
the dispatch pipeline at depth 2 with a span trace and a metrics dump,
at int16, and with the fused consensus engine at both chunk postures,
its kernel wrapper and host finalizer loaded; with
--cuda-adaptive-buckets, through a 2-lane batch runner with the
scheduler on for both engines, and with --cuda-autotune-table naming a
winner table that forces int32, the same FASTA; the autotuner, oracle
and auditor modules loaded), packs and unpacks bases and resolves a score dtype with its own
copies of the JAX package's encode and dtypes modules, corrects a tiny
read set with -f (both device paths) and through the wrapper (split into
chunks, sharded), runs rampler and preprocess, and afterwards no `jax`
or `racon_tpu` module is loaded. A second interpreter does the same over
this slice's modules: a polisher rebound, run on a window range with a
progress hook, and re-drafted (core/remap.py), the native build entry,
and the serve stack's leaves (sched.pack_iteration, partition_devices,
posture_key, the histogram export, the tracer's scopes, the flight
recorder, the journal, the Prometheus round trip, frames, the window
cache and ingest)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import io, random, sys, tempfile
sys.modules["jax"] = None
import torch
torch.set_num_threads(1)
from racon_tpu_torch import cli, preprocess, rampler, wrapper
from racon_tpu_torch.synth import (ava_overlaps, simulate, simulate_truth,
                                   write_dataset, write_fragment_dataset)

def run(main, argv):
    buf = io.BytesIO()
    out, text = sys.stdout, io.TextIOWrapper(buf)
    sys.stdout = text
    try:
        rc = main(argv)
        text.flush()
    finally:
        sys.stdout = out
    assert rc == 0, (main, rc)
    return buf.getvalue()

_, draft, reads, paf = simulate(random.Random(3), 2500, 6, 1500, 0.12, 0.10)
paths = write_dataset(tempfile.mkdtemp(), draft, reads, paf)
import json, os
obs = tempfile.mkdtemp()
fasta = run(cli.main, ["--device", "cpu", "-c", "1", "--cudaaligner-batches",
                       "1", "--cuda-pipeline-depth", "2", "--cuda-trace",
                       os.path.join(obs, "t.json"), "--cuda-metrics",
                       os.path.join(obs, "m.json"), *paths])
assert fasta.startswith(b">draft LN:i:")
names = {e["name"] for e in json.load(open(os.path.join(obs, "t.json")))
         ["traceEvents"]}
assert {"pipeline.pack", "pipeline.device", "pipeline.unpack",
        "session.commit"} <= names, names
assert json.load(open(os.path.join(obs, "m.json")))["pipeline"]["chunks"] >= 1
assert run(cli.main, ["--device", "cpu", "-c", "1", "--cudaaligner-batches",
                      "1", "--cuda-dtype", "int16", *paths]) == fasta
fused = [run(cli.main, ["--device", "cpu", "-c", "1", "--cuda-engine",
                         "fused", "--cuda-fused", f, *paths]) for f in "01"]
assert fused[0] == fused[1] and fused[0].startswith(b">draft LN:i:")
assert {"racon_tpu_torch.ops.poa_fused",
        "racon_tpu_torch.ops.poa_fused_kernels"} <= set(sys.modules)
adaptive = run(cli.main, ["--device", "cpu", "-c", "1",
                          "--cudaaligner-batches", "1",
                          "--cuda-adaptive-buckets", *paths])
assert adaptive == fasta
from racon_tpu_torch.obs import audit
from racon_tpu_torch.ops import oracle
from racon_tpu_torch.sched import autotune
table = autotune.Autotuner(os.path.join(obs, "autotune.json"))
for nb, lb in ((320, 256), (768, 640), (1280, 640), (2048, 640)):
    table.record("session", (nb, lb), (3, -5, -4, 8),
                 {"kernel": "plain", "dtype": "int32", "ms": {},
                  "identical": True}, backend="cpu")
table.save()
assert run(cli.main, ["--device", "cpu", "-c", "1", "--cudaaligner-batches",
                      "1", "--cuda-autotune-table", table.path,
                      *paths]) == fasta
assert audit.WindowAuditor(0.1, device="cpu").oracle.device == "cpu"
assert oracle.engine_params_key
from racon_tpu_torch.core.polisher import PolisherType, create_polisher
# the fused runs above align on the host
for engine, want, aligner in (("session", adaptive, 1), ("fused", fused[1], 0)):
    pol = create_polisher(*paths, PolisherType.kC, 500, 10.0, 0.3, True,
                          3, -5, -4, cuda_poa_batches=1,
                          cuda_aligner_batches=aligner, device="cpu",
                          cuda_engine=engine, cuda_fused="1",
                          adaptive_buckets=True,
                          devices=[torch.device("cpu")] * 2)
    pol.initialize()
    lanes = b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                     for s in pol.polish())
    assert lanes == want, engine
    assert pol.device_runner.lane_calls[1] > 0
    assert engine in pol.occupancy_stats
assert {"racon_tpu_torch.sched", "racon_tpu_torch.parallel.mesh",
        "racon_tpu_torch.ops.device_program"} <= set(sys.modules)
from racon_tpu_torch.ops import dtypes, encode
assert dtypes.resolve_dtype(dtypes.poa_int16_ok(768, 640, 5, -4, -8)) \
    == "int16"
codes, lens = encode.encode_padded([b"ACGTTGCA", b"GAT"], 8)
assert encode.packable(codes, lens)
packed = torch.from_numpy(encode.pack_2bit(codes))
assert torch.equal(encode.unpack_2bit(packed, 8, torch.from_numpy(lens)),
                   torch.from_numpy(codes))
_, _, reads, _ = simulate_truth(random.Random(3), 2500, 4, 1500, 0.12, 0.10)
frag = write_fragment_dataset(tempfile.mkdtemp(), reads, ava_overlaps(reads))
# the wrapper's scores (5, -4, -8) are not the CLI's defaults
fasta = run(cli.main, ["--device", "cpu", "-f", "-c", "1",
                       "--cudaaligner-batches", "1", "-m", "5", "-x", "-4",
                       "-g", "-8", *frag])
assert fasta.startswith(b">read") and b"r LN:i:" in fasta, fasta[:100]
shard = run(wrapper.main, ["--device", "cpu", "-f", "--split", "3000",
                           "--num-shards", "2", "--shard-id", "1", *frag])
assert shard.startswith(b">read") and shard in fasta
assert len(rampler.split(frag[0], 3000, tempfile.mkdtemp())) > 1
assert run(preprocess.main, [frag[0]]).startswith(b"@read01")
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


LEAVES = r"""
import io, itertools, json, os, random, socket, sys, tempfile
sys.modules["jax"] = None
import torch
torch.set_num_threads(1)
from racon_tpu_torch.core.polisher import (ContigStreamer, PolisherType,
                                           create_polisher)
from racon_tpu_torch.core import remap
from racon_tpu_torch.native import __main__ as native_main
from racon_tpu_torch.obs import flight, hist, journal, prom, trace
from racon_tpu_torch.parallel.mesh import partition_devices
from racon_tpu_torch.sched import pack_iteration
from racon_tpu_torch.sched.autotune import Autotuner, posture_key
from racon_tpu_torch.serve import (IngestSpec, WindowCache, error_response,
                                   recv_frame, send_frame)
from racon_tpu_torch.serve.ingest import prepare
from racon_tpu_torch.synth import simulate, write_dataset

d = tempfile.mkdtemp()
_, draft, reads, paf = simulate(random.Random(3), 2500, 6, 1500, 0.12, 0.10)
paths = write_dataset(d, draft, reads, paf)
pol = create_polisher(*paths, PolisherType.kC, 500, 10.0, 0.3, True, 5, -4,
                      -8, device="cpu")
events = []
pol.progress_hook = events.append
pol.initialize()
whole = pol.polish()
assert events[-1]["phase"] == "stitch", events[-1]
pol.rebind(*paths)
pol.window_range = (0, 1200)
pol.initialize()
seg = pol.polish()
assert whole[0].data.startswith(seg[0].data) and pol.segment_meta
pol.window_range = None
pol.redraft(whole, d, "r1")
pol.initialize()
pol._consensus_pass()
st = ContigStreamer(pol, True)
st.on_windows(list(reversed(pol.windows)))
assert st.finish()[0].name.startswith("draft LN:i:")
assert remap.remap_overlaps(whole, whole)
assert native_main.main([]) == 0
assert pack_iteration([3, 1, 2], 2, int, int) == ([1, 2], [3])
assert partition_devices(list(range(5)), 2) == [[0, 1, 2], [3, 4]]
assert posture_key("cpu")[0] == "plain"
assert Autotuner(os.path.join(d, "t.json")).consult_counts() == []
h = hist.HistogramSet()
h.observe("a", 0.5, exemplar={"trace_id": "x", "t": 1.0})
text = prom.render({"jobs": 1}, None, h)
assert prom.parse(text).histogram("racon_tpu_a_seconds").count == 1
ring = trace.install(flight.FlightRecorder(8))
with trace.scoped() as rec:
    trace.instant("mark", trace_id="x")
assert flight.trace_events(ring, "x") and rec.events()
trace.reset()
jr = journal.Journal(os.path.join(d, "j.jsonl"))
jr.record("received", job="j")
jr.close()
assert journal.read_journal(os.path.join(d, "j.jsonl"))[0]["job"] == "j"
a, b = socket.socketpair()
send_frame(a, error_response("bad-frame", "x"))
assert recv_frame(b)["code"] == "bad-frame"
assert WindowCache().snapshot()["entries"] == 0
assert prepare(*paths, IngestSpec.from_request({"ingest": True}), d,
               "j1") == paths
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "racon_tpu")
             and sys.modules[m] is not None)
print("LOADED", bad)
"""


def test_slice_modules_run_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", LEAVES], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout
