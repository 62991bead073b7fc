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
cache and ingest). A third does it over the warm server: the fault plan
(resilience/), the job queue, the window batcher, the server and the
client, with a job served on the CPU (buffered and streamed) equal to a
one-shot polish, and a fault-plan job failing typed. A fourth serves
what a job can ask for: rounds with the window cache armed and a
resubmit answered from it, range shards, a fragment job and a fragment
slice, admit-time ingest with subsample and normalize (the lazily
imported rampler and preprocess), under preemption and the abort margin
armed. A fifth serves on two worker lanes with the identity audit and
the window cache armed: clean jobs, an `sdc` fault-plan job repaired to
the clean bytes with the winner table demoted and the lane quarantined
and rejoined, and the audit's journal lines. A sixth serves with the
server's observability armed (the journal, the metrics port, the flight
ring and its dumps, a traced job merged with the client's spans, a trace
pull, obs/fleet.py's burn-rate tracker) and leaves no tracer armed. A
seventh routes jobs over two servers (a contig job, a streamed job and a
fragment job through serve/router.py, with its journal and metrics port)
and polls them with obs/fleet.py's aggregator and `fleet --json`. An
eighth, with `racon_tpu` blocked too, takes an autoscaler's scale-up
decision over a fake router and runs the three tools' `main`
(obsreport on a journal, tracereport on a trace, servetop on a live
server).
Besides, no module of the port, nor `chip_smoke.py`, names `jax`,
`jaxlib` or `racon_tpu` in an import statement."""

import ast
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


SERVE = r"""
import os, random, sys, tempfile
sys.modules["jax"] = None
import torch
torch.set_num_threads(1)
from racon_tpu_torch.core.polisher import PolisherType, create_polisher
from racon_tpu_torch.resilience import FaultPlan
from racon_tpu_torch.serve import queue, batcher, server, client
from racon_tpu_torch.synth import simulate, write_dataset

d = tempfile.mkdtemp()
_, draft, reads, paf = simulate(random.Random(3), 2500, 6, 1500, 0.12, 0.10)
paths = write_dataset(d, draft, reads, paf)
pol = create_polisher(*paths, PolisherType.kC, 500, 10.0, 0.3, True, 5, -4,
                      -8, num_threads=2, device="cpu")
pol.initialize()
want = b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                for s in pol.polish())
assert FaultPlan.parse("device:chunk=0:raise").unfired
srv = server.PolishServer(socket_path=os.path.join(d, "s.sock"),
                          device="cpu", match=5, mismatch=-4,
                          gap=-8).start()
try:
    cl = client.PolishClient(socket_path=srv.config.socket_path,
                             timeout=120)
    assert cl.submit(*paths).fasta == want
    assert cl.submit(*paths, stream=True).fasta == want
    try:
        cl.submit(*paths, fault_plan="pack:chunk=0:raise")
        raise AssertionError("the fault-plan job did not fail")
    except client.JobFailed as exc:
        assert exc.error_type == "DeviceError"
    assert isinstance(srv.batcher, batcher.WindowBatcher)
    assert isinstance(srv.queue, queue.JobQueue)
finally:
    assert srv.drain(timeout=60)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "racon_tpu")
             and sys.modules[m] is not None)
print("LOADED", bad)
"""


def test_serve_modules_run_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", SERVE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


SERVE_KINDS = r"""
import gzip, os, sys, tempfile
sys.modules["jax"] = None
import torch
torch.set_num_threads(1)
from racon_tpu_torch.core.polisher import PolisherType, create_polisher
from racon_tpu_torch.serve import (PolishClient, PolishServer, ServeError,
                                   make_fragment_dataset, make_synth_dataset)

def fa(polished):
    return b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                    for s in polished)

d = tempfile.mkdtemp()
paths = make_synth_dataset(d, contigs=2)
frags = make_fragment_dataset(d)
pol = create_polisher(*paths, PolisherType.kC, 500, 10.0, 0.3, device="cpu")
pol.initialize()
r1 = pol.polish()
pol.redraft(r1, d, "r1")
pol.initialize()
want = fa(pol.polish())
fpol = create_polisher(*frags, PolisherType.kF, 500, 10.0, 0.3, device="cpu")
fpol.initialize()
fwant = fa(fpol.polish())
srv = PolishServer(socket_path=os.path.join(d, "s.sock"), device="cpu",
                   warmup=False, wincache=True, preempt=True,
                   abort_margin=30.0, frag_group=4).start()
try:
    cl = PolishClient(socket_path=srv.config.socket_path, timeout=120)
    assert cl.submit(*paths, rounds=2).fasta == want
    again = cl.submit(*paths, rounds=2)
    assert again.fasta == want and again.rounds["cache"]["misses"] == 0
    segs = []
    for lo, hi in ((0, 1000), (1000, 10**9)):
        parts = []
        cl.request({"type": "submit", "sequences": paths[0],
                    "overlaps": paths[1], "target": paths[2],
                    "range_lo": lo, "range_hi": hi, "stream": True},
                   on_part=parts.append)
        assert all(p["seg"] for p in parts)
        segs.append(parts)
    assert cl.submit(*frags, fragment=True).fasta == fwant
    assert cl.submit(*frags, fragment=True, frag_lo=0,
                     frag_hi=4).fasta.count(b">") <= 4
    sub = {"reference_length": 2000, "coverage": 2, "seed": 7}
    assert cl.submit(*paths, ingest=True, subsample=sub).fasta
    norm = os.path.join(d, "ovl_norm.paf.gz")
    with gzip.open(paths[1], "rt") as fh, gzip.open(norm, "wt") as out:
        for line in fh:
            cols = line.split("\t")
            cols[0] += "1"
            out.write("\t".join(cols))
    assert cl.submit(paths[0], norm, paths[2], normalize=True).fasta
    bad = os.path.join(d, "bad.fasta")
    with open(bad, "w") as fh:
        fh.write("not fasta\n")
    try:
        cl.submit(bad, paths[1], paths[2], ingest=True)
        raise AssertionError("the poisoned input was admitted")
    except ServeError as exc:
        assert exc.response["terminal"] == "rejected-ingest"
    assert srv.stats_snapshot()["qos"]["preemptions"] == 0
finally:
    assert srv.drain(timeout=60)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "racon_tpu")
             and sys.modules[m] is not None)
print("LOADED", bad)
"""


def test_serve_kinds_run_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", SERVE_KINDS], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


SERVE_LANES = r"""
import json, os, sys, tempfile
sys.modules["jax"] = None
import torch
torch.set_num_threads(1)
from racon_tpu_torch.core.polisher import PolisherType, create_polisher
from racon_tpu_torch.obs.journal import Journal, read_journal
from racon_tpu_torch.ops.poa_graph import BUCKETS
from racon_tpu_torch.sched.autotune import Autotuner
from racon_tpu_torch.serve import (PolishClient, PolishServer,
                                   make_synth_dataset)

d = tempfile.mkdtemp()
paths = make_synth_dataset(d)
pol = create_polisher(*paths, PolisherType.kC, 100, 10.0, 0.3, device="cpu",
                      cuda_poa_batches=1)
pol.initialize()
want = b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                for s in pol.polish())
table = os.path.join(d, "t.json")
at = Autotuner(table)
for nb, lb in BUCKETS:
    at.record("session", (nb, lb), (3, -5, -4, 8),
              {"kernel": "plain", "dtype": "int16", "ms": {},
               "identical": True}, backend="cpu")
at.save()
cpu = torch.device("cpu")
srv = PolishServer(socket_path=os.path.join(d, "s.sock"), device="cpu",
                   workers=2, worker_lanes=2, devices=[cpu, cpu],
                   audit_rate=1.0, wincache=True, cuda_poa_batches=1,
                   window_length=100, autotune_table=table, warmup=False,
                   flight_dir=os.path.join(d, "flight")).start()
srv.auditor.journal = Journal(os.path.join(d, "j.jsonl"))
try:
    cl = PolishClient(socket_path=srv.config.socket_path, timeout=120)
    assert cl.submit(*paths).fasta == want
    assert cl.submit(*paths, stream=True).fasta == want
    assert cl.submit(*paths, fault_plan="device:chunk=1:sdc").fasta == want
    a = srv.stats_snapshot()["audit"]
    assert (a["mismatches"], a["repaired"]) == (1, 1) and a["demotions"]
    assert Autotuner(table).table  # demoted on disk
    import time
    deadline = time.monotonic() + 120
    while srv.batcher.snapshot()["lane_rejoins"] < 1:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert cl.submit(*paths).fasta == want
    events = {e["event"] for e in read_journal(os.path.join(d, "j.jsonl"))}
    assert events == {"audit-mismatch", "audit-lane"}
finally:
    assert srv.drain(timeout=60)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "racon_tpu")
             and sys.modules[m] is not None)
print("LOADED", bad)
"""


def test_serve_lanes_and_audit_run_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", SERVE_LANES], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


SERVE_OBS = r"""
import json, os, sys, tempfile, urllib.request
sys.modules["jax"] = None
import torch
torch.set_num_threads(1)
from racon_tpu_torch.obs import prom, trace
from racon_tpu_torch.obs.fleet import BurnRateTracker
from racon_tpu_torch.obs.journal import check_consistency, read_journal
from racon_tpu_torch.serve import (JobFailed, PolishClient, PolishServer,
                                   make_synth_dataset)

d = tempfile.mkdtemp()
paths = make_synth_dataset(d)
tr = BurnRateTracker(seed_zero=True)
assert tr.sample(0, 1, t=1.0)["firing"]
jp = os.path.join(d, "j.jsonl")
srv = PolishServer(socket_path=os.path.join(d, "s.sock"), device="cpu",
                   warmup=False, metrics_port=0, journal=jp,
                   flight_dir=os.path.join(d, "flight")).start()
try:
    assert trace.get_tracer() is srv._flight
    cl = PolishClient(socket_path=srv.config.socket_path, timeout=120)
    result, doc = cl.submit_traced(*paths, trace_out=os.path.join(d, "t.json"))
    assert result.fasta and json.load(open(os.path.join(d, "t.json")))
    assert cl.submit(*paths, trace_id="pulled").fasta == result.fasta
    assert cl.trace_pull("pulled")["events"]
    try:
        cl.submit(*paths, fault_plan="device:chunk=0:raise")
        raise AssertionError("the fault-plan job did not fail")
    except JobFailed:
        pass
    assert len(cl.debug()["dumps"]) == 1
    url = f"http://127.0.0.1:{srv.config.metrics_port}/metrics"
    body = urllib.request.urlopen(url, timeout=30).read().decode()
    assert prom.parse(body).counters["racon_tpu_serve_jobs_failed_total"] == 1
finally:
    assert srv.drain(timeout=60)
assert trace.get_tracer() is None
assert check_consistency(read_journal(jp)) == []
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "racon_tpu")
             and sys.modules[m] is not None)
print("LOADED", bad)
"""


def test_serve_observability_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", SERVE_OBS], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


ROUTER_FLEET = r"""
import io, json, os, sys, tempfile, urllib.request
sys.modules["jax"] = None
import torch
torch.set_num_threads(1)
from racon_tpu_torch import cli
from racon_tpu_torch.obs import prom
from racon_tpu_torch.obs.fleet import FleetAggregator
from racon_tpu_torch.obs.journal import check_consistency, read_journal
from racon_tpu_torch.serve import (PolishClient, PolishRouter, PolishServer,
                                   make_fragment_dataset, make_synth_dataset)

d = tempfile.mkdtemp()
os.makedirs(os.path.join(d, "c"))
os.makedirs(os.path.join(d, "f"))
paths = make_synth_dataset(os.path.join(d, "c"), contigs=2)
frag = make_fragment_dataset(os.path.join(d, "f"))
servers = [PolishServer(socket_path=os.path.join(d, f"s{i}.sock"),
                        device="cpu", warmup=False,
                        autotune_table=os.path.join(d, "at.json")).start()
           for i in range(2)]
socks = [s.config.socket_path for s in servers]
jp = os.path.join(d, "router.jsonl")
router = PolishRouter(replicas=socks, socket_path=os.path.join(d, "r.sock"),
                      journal=jp, metrics_port=0).start()
try:
    direct = PolishClient(socket_path=socks[0], timeout=120)
    cl = PolishClient(socket_path=router.config.socket_path, timeout=120)
    want = direct.submit(*paths).fasta
    res = cl.submit(*paths)
    assert res.fasta == want and res.router["shards"] == 2
    assert cl.submit(*paths, stream=True).fasta == want
    reads = cl.submit(*frag, fragment=True)
    assert reads.fasta == direct.submit(*frag, fragment=True).fasta
    assert reads.router["frag_shards"] == 2
    url = f"http://127.0.0.1:{router.config.metrics_port}/metrics"
    body = urllib.request.urlopen(url, timeout=30).read().decode()
    assert prom.parse(body).counters[
        "racon_tpu_router_jobs_completed_total"] == 3
    agg = FleetAggregator(socks)
    assert agg.poll().healthy
    agg.close()
    out, buf = sys.stdout, io.StringIO()
    sys.stdout = buf
    try:
        rc = cli.main(["fleet", "--endpoints", ",".join(socks), "--json"])
    finally:
        sys.stdout = out
    assert rc == 0 and json.loads(buf.getvalue())["healthy"]
finally:
    assert router.drain()
    for s in servers:
        assert s.drain(timeout=60)
assert check_consistency(read_journal(jp)) == []
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "racon_tpu")
             and sys.modules[m] is not None)
print("LOADED", bad)
"""


def test_router_and_fleet_run_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", ROUTER_FLEET], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


ELASTIC_TOOLS = r"""
import io, json, os, sys, tempfile, threading, types
sys.modules["jax"] = None
sys.modules["racon_tpu"] = None
import torch
torch.set_num_threads(1)
from racon_tpu_torch.serve import PolishServer
from racon_tpu_torch.serve.autoscale import AutoscaleConfig, Autoscaler
from racon_tpu_torch.tools import obsreport, servetop, tracereport

class Router:
    def __init__(self):
        rep = types.SimpleNamespace(routable=True)
        self.fleet = types.SimpleNamespace(last=lambda: types.SimpleNamespace(
            replicas=[types.SimpleNamespace(ok=True, health={
                "queue_depth": 5, "inflight": 1})], burn=None))
        self._state_lock = threading.Lock()
        self.replicas = [rep]
        self._inflight_jobs = self._requeued_outstanding = 0
        self._dispatch_waiting = 0
        self.journal = None
        self.added = []
    def add_replica(self, spec):
        self.added.append(spec)
        self.replicas.append(types.SimpleNamespace(routable=True))
    def remove_replica(self, spec):
        self.replicas.pop()

d = tempfile.mkdtemp()
router = Router()
sc = Autoscaler(router, AutoscaleConfig(up_sustain_s=1.0, socket_dir=d),
                spawn=lambda spec: spec, stop=lambda h: None)
sc._wait_ready = lambda spec: True
assert sc.step(now=0.0) is None and sc.step(now=1.5) == "up"
assert router.added == [os.path.join(d, "autoscale_1.sock")]

def run(main, argv):
    out, buf = sys.stdout, io.StringIO()
    sys.stdout = buf
    try:
        return main(argv), buf.getvalue()
    finally:
        sys.stdout = out

jp = os.path.join(d, "j.jsonl")
with open(jp, "w") as fh:
    for i, e in enumerate(["received", "started", "finished"]):
        fh.write(json.dumps({"t": float(i), "event": e, "job": "j1"}) + "\n")
    fh.write(json.dumps({"t": 3.0, "event": "autoscale-down",
                         "replica": "x"}) + "\n")
rc, out = run(obsreport.main, ["--journal", jp, "--flight-dir", d, "--check"])
assert rc == 1 and "autoscale-down for 'x'" in out, out
tp = os.path.join(d, "t.json")
with open(tp, "w") as fh:
    json.dump({"traceEvents": [{"name": "serve.job", "ph": "X", "ts": 0,
                                "dur": 100, "args": {}}],
               "trace_context": {}}, fh)
rc, out = run(tracereport.main, [tp, "--check"])
assert rc == 0 and "direct" in out, out
srv = PolishServer(socket_path=os.path.join(d, "s.sock"), device="cpu",
                   warmup=False,
                   autotune_table=os.path.join(d, "at.json")).start()
try:
    rc, out = run(servetop.main, ["--once", "--endpoints",
                                  srv.config.socket_path])
    assert rc == 0 and "fleet  queue" in out, out
finally:
    assert srv.drain(timeout=60)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "racon_tpu", "obsreport",
                                    "tracereport", "servetop")
             and sys.modules[m] is not None)
print("LOADED", bad)
"""


def test_autoscaler_and_tools_run_without_jax():
    """An autoscaler step over a fake router, and the three tools' `main`
    on small inputs, with `jax` and `racon_tpu` blocked."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", ELASTIC_TOOLS], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


def _sources():
    root = os.path.join(REPO, "racon_tpu_torch")
    for dirpath, _, names in os.walk(root):
        for name in sorted(names):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_source_imports_jax_or_the_jax_package():
    bad = []
    for path in _sources():
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(os.path.relpath(path, REPO), n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "racon_tpu")]
    assert bad == []
