"""The identity audit's serve hooks and the fault plan's `sdc` action in
the port, against the JAX package, on the CPU.

Inputs: windows made from seeds (a 60 bp backbone and four mutated
layers), the port's `make_synth_dataset` triple (one 2 kb contig, 400 bp
reads, seed 11) and the JAX package's one-shot FASTA on it; scores
3/-5/-4; torch at one thread, `RACON_TPU_MAX_DEVICES=1`. Tolerance: none;
every value held is a byte, an integer, a flag or a key.

What is held:

  - `FaultPlan.parse("device:chunk=1:sdc").corrupt_consensus` flips the
    JAX plan's base on the same windows, is no stage hook and fires once;
    `sdc=<arg>` is refused as JAX refuses it; `BatchPOA` consumes an
    `sdc` plan after the host engine and after the device session and
    fused engines (their plain versions), counted as a fault;
  - the auditor's serve hooks: the `audit-mismatch` and `audit-lane`
    journal lines carry the JAX auditor's fields for the same mismatch,
    one `audit.shadow` observation a pass with the dump as exemplar, a
    lane mismatch quarantines the lane and flushes every lane, a
    cache-hit mismatch quarantines the entry and blames no lane;
  - the end-to-end pin: a two-lane server at `audit_rate=1.0` with a
    hand-recorded winner table answers a `device:chunk=1:sdc` job with
    the JAX one-shot bytes after one mismatch, one repair and a demotion
    on disk; the lane is quarantined, re-probed and back at health 1.0;
    one dual-stream dump; the window cache invalidated;
  - the poisoned cache: every cached consensus flipped, a resubmit gives
    the clean bytes, the mismatches are the entries', no demotion, no
    lane quarantined, and a third submit re-dispatches;
  - an audited server's production counters and launches equal an
    unaudited one's; an audit-off one-lane server answers `audit: None`
    with one healthy lane and the JAX bytes.

Every wait is bounded. The JAX package is imported inside the fixtures
and tests that use it.
"""

import json
import os
import random
import time
import types

import pytest
import torch

from racon_tpu_torch.core.window import WindowType, create_window
from racon_tpu_torch.errors import RaconError
from racon_tpu_torch.obs.audit import WindowAuditor
from racon_tpu_torch.obs.hist import HistogramSet
from racon_tpu_torch.obs.journal import Journal, read_journal
from racon_tpu_torch.ops.poa import BatchPOA
from racon_tpu_torch.pipeline import DispatchPipeline
from racon_tpu_torch.resilience import FaultPlan
from racon_tpu_torch.sched.autotune import Autotuner, reset_autotuner_cache
from racon_tpu_torch.serve import (PolishClient, PolishServer, WindowCache,
                                   make_synth_dataset)

WAIT = 120
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RACON_TPU_MAX_DEVICES", "1")
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        reset_autotuner_cache()
        yield
        reset_autotuner_cache()
        torch.set_num_threads(threads)


def wait_for(cond, what: str, timeout: float = WAIT) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def make_windows(mod=None, n=3, seed=3, length=60, depth=4):
    """Small consensus-ready windows of the port, or of the JAX package
    with `mod` its window module."""
    rng = random.Random(seed)
    cw = create_window if mod is None else mod.create_window
    wt = WindowType.kNGS if mod is None else mod.WindowType.kNGS
    windows = []
    for k in range(n):
        bb = "".join(rng.choice("ACGT") for _ in range(length))
        w = cw(0, k, wt, bb.encode(), b"!" * length)
        for _ in range(depth):
            layer = "".join(c if rng.random() > 0.05 else rng.choice("ACGT")
                            for c in bb)
            w.add_layer(layer.encode(), None, 0, length - 1)
        windows.append(w)
    return windows


def params(tmp_path, engine=None):
    """A polisher's parameters for the port: the host engine, or a
    device engine on the CPU."""
    return types.SimpleNamespace(
        match=3, mismatch=-5, gap=-4, window_length=500, trim=True,
        num_threads=1, cuda_poa_batches=0 if engine is None else 1,
        cuda_banded_alignment=False, cuda_aligner_band_width=0,
        cuda_engine=engine or "session", cuda_fused="auto",
        fused_fallback="session", score_dtype="auto", pack_bases=True,
        pipeline_depth=0, device=CPU,
        autotuner=Autotuner(str(tmp_path / "t.json")))


def jax_params():
    return types.SimpleNamespace(
        match=3, mismatch=-5, gap=-4, window_length=500, trim=True,
        num_threads=1, tpu_poa_batches=0, tpu_banded_alignment=False,
        tpu_aligner_band_width=0, tpu_engine=None, tpu_pipeline_depth=0,
        tpu_device_timeout=0.0)


def host_consensus(windows, engine_mod=None):
    poa = BatchPOA if engine_mod is None else engine_mod.BatchPOA
    poa(3, -5, -4, 500, num_threads=1).generate_consensus(windows, True)
    return windows


class _Lanes:
    """The batcher's audit callbacks, recorded."""

    def __init__(self):
        self.calls: list = []

    def flush_lane_engines(self):
        self.calls.append("flush")

    def quarantine_lane(self, index):
        self.calls.append(("quarantine", index))


# -------------------------------------------------------------------- sdc
def test_sdc_flip_equals_jax():
    jwin = pytest.importorskip("racon_tpu.core.window")
    jpoa = pytest.importorskip("racon_tpu.ops.poa")
    jfaults = pytest.importorskip("racon_tpu.resilience.faults")
    port = host_consensus(make_windows())
    ref = host_consensus(make_windows(jwin), jpoa)
    assert [w.consensus for w in port] == [w.consensus for w in ref]
    before = [w.consensus for w in port]
    plans = (FaultPlan.parse("device:chunk=1:sdc"),
             jfaults.FaultPlan.parse("device:chunk=1:sdc"))
    for plan, windows in zip(plans, (port, ref)):
        plan.fire("device", 1)  # not a stage hook: stays armed
        assert plan.unfired
        assert plan.corrupt_consensus(windows) == 1
        assert plan.corrupt_consensus(windows) == 0  # one-shot
    assert [w.consensus for w in port] == [w.consensus for w in ref]
    after = [w.consensus for w in port]
    assert after[0] == before[0] and after[2] == before[2]
    assert after[1] != before[1] and len(after[1]) == len(before[1])
    assert all(w.polished for w in port)
    # a chunk beyond the pass stays armed for a larger one
    far = FaultPlan.parse("device:chunk=9:sdc")
    assert far.corrupt_consensus(port) == 0 and far.unfired


def test_sdc_with_argument_refused_as_jax():
    jfaults = pytest.importorskip("racon_tpu.resilience.faults")
    with pytest.raises(RaconError) as port_exc:
        FaultPlan.parse("device:chunk=1:sdc=1")
    with pytest.raises(Exception) as jax_exc:
        jfaults.FaultPlan.parse("device:chunk=1:sdc=1")
    assert "takes no argument" in str(port_exc.value)
    assert "takes no argument" in str(jax_exc.value)


@pytest.mark.parametrize("engine", [None, "session", "fused"])
def test_batchpoa_consumes_sdc_plan(engine):
    plan = FaultPlan.parse("device:chunk=0:sdc")
    pl = DispatchPipeline(depth=0, faults=plan)
    kw = ({} if engine is None else
          {"device_batches": 1, "device": "cpu", "engine": engine,
           "fused": "1"})
    windows = make_windows()
    BatchPOA(3, -5, -4, 500, num_threads=1, pipeline=pl,
             **kw).generate_consensus(windows, True)
    clean = host_consensus(make_windows())
    assert windows[0].consensus != clean[0].consensus
    assert [w.consensus for w in windows[1:]] == \
        [w.consensus for w in clean[1:]]
    assert pl.stats.snapshot()["faults"] == 1 and not plan.unfired


# ----------------------------------------------------- the auditor's hooks
def corrupt(windows, i=1):
    bad = bytearray(windows[i].consensus)
    bad[0] = ord("A") if bad[0] != ord("A") else ord("C")
    windows[i].consensus = bytes(bad)
    return bytes(bad)


def test_journal_lines_carry_jax_fields(tmp_path):
    """The same corrupted window through the port's and the JAX
    auditor, each with a journal: the `audit-mismatch` lines have the
    same keys and the same engine, bucket, lane, iteration and window;
    the `audit-lane` lines are equal but for the time."""
    jwin = pytest.importorskip("racon_tpu.core.window")
    jpoa = pytest.importorskip("racon_tpu.ops.poa")
    jaudit = pytest.importorskip("racon_tpu.obs.audit")
    jjournal = pytest.importorskip("racon_tpu.obs.journal")
    lines = []
    for side in ("port", "jax"):
        d = tmp_path / side
        d.mkdir()
        jpath = str(d / "j.jsonl")
        if side == "port":
            windows = host_consensus(make_windows())
            p, journal = params(d), Journal(jpath)
            auditor = WindowAuditor(1.0, device="cpu", flight_dir=str(d),
                                    journal=journal)
        else:
            windows = host_consensus(make_windows(jwin), jpoa)
            p, journal = jax_params(), jjournal.Journal(jpath)
            auditor = jaudit.WindowAuditor(1.0, flight_dir=str(d),
                                           journal=journal)
        truth = windows[1].consensus
        corrupt(windows)
        n = auditor.audit_windows([(w, p) for w in windows],
                                  lane_index=1, iteration=4)
        assert n == 1 and windows[1].consensus == truth
        auditor.lane_event(1, "rejoined", reprobes=2)
        auditor.close()
        journal.close()
        lines.append(read_journal(jpath))
    port, ref = lines
    assert [e["event"] for e in port] == [e["event"] for e in ref] == \
        ["audit-mismatch", "audit-lane"]
    assert set(port[0]) == set(ref[0])
    for key in ("event", "engine", "bucket", "lane", "iteration", "window"):
        assert port[0][key] == ref[0][key], key
    assert port[0]["lane"] == "1" and port[0]["kernel"] == "plain"
    assert os.path.basename(port[0]["flight"]) == \
        os.path.basename(ref[0]["flight"])
    assert {k: v for k, v in port[1].items() if k != "t"} == \
        {k: v for k, v in ref[1].items() if k != "t"}


def test_lane_mismatch_quarantines_and_observes_once(tmp_path):
    windows = host_consensus(make_windows())
    corrupt(windows, 0)
    hists = HistogramSet()
    lanes = _Lanes()
    auditor = WindowAuditor(1.0, device="cpu", flight_dir=str(tmp_path),
                            hists=hists)
    p = params(tmp_path, "session")
    assert auditor.audit_windows([(w, p) for w in windows], lane_index=1,
                                 iteration=3, batcher=lanes) == 1
    # the session engine's table holds nothing to demote: no flush
    assert lanes.calls == [("quarantine", 1)]
    (labels, count), = auditor.mismatch_samples()
    assert labels["lane"] == "1" and count == 1
    h = hists.get("audit.shadow")
    assert h.count == 1 and h.min > 0.0
    (ex,) = h.bucket_exemplars().values()
    assert "audit-mismatch" in ex["flight"] and ex["value"] == h.max
    rec = auditor.snapshot()["recent"][-1]
    assert (rec["lane"], rec["iteration"]) == (1, 3)
    # with both switches off nothing but the repair happens
    corrupt(windows, 2)
    quiet = WindowAuditor(1.0, device="cpu", demote=False,
                          quarantine=False)
    lanes.calls.clear()
    assert quiet.audit_windows([(w, p) for w in windows], lane_index=0,
                               iteration=5, batcher=lanes) == 1
    assert lanes.calls == [] and quiet.snapshot()["demotions"] == 0
    auditor.close()
    quiet.close()


def test_demotion_flushes_lanes(tmp_path):
    from racon_tpu_torch.ops.poa_graph import BUCKETS

    p = params(tmp_path, "session")
    for nb, lb in BUCKETS:
        p.autotuner.record("session", (nb, lb), (3, -5, -4, 8),
                           {"kernel": "plain", "dtype": "int16", "ms": {},
                            "identical": True}, backend="cpu")
    windows = host_consensus(make_windows())
    corrupt(windows)
    lanes = _Lanes()
    auditor = WindowAuditor(1.0, device="cpu")
    auditor.audit_windows([(w, p) for w in windows], lane_index=0,
                          iteration=1, batcher=lanes)
    assert auditor.snapshot()["demotions"] == len(BUCKETS)
    assert lanes.calls == ["flush", ("quarantine", 0)]
    auditor.close()


def test_cache_hit_mismatch_blames_the_entry(tmp_path):
    windows = host_consensus(make_windows())
    cache = WindowCache()
    keys = {id(w): ("k", w.rank) for w in windows}
    for w in windows:
        cache.store(keys[id(w)], w.consensus, w.polished)
    truth = windows[1].consensus
    corrupt(windows)
    lanes = _Lanes()
    auditor = WindowAuditor(1.0, device="cpu")
    p = params(tmp_path, "session")
    assert auditor.audit_windows([(w, p) for w in windows], lane_index=-1,
                                 iteration=-1, batcher=lanes,
                                 wincache=cache, cache_keys=keys) == 1
    assert windows[1].consensus == truth and lanes.calls == []
    assert cache.quarantined(keys[id(windows[1])])
    assert cache.lookup(keys[id(windows[1])]) is None
    assert cache.lookup(keys[id(windows[0])]) is not None
    (labels, _), = auditor.mismatch_samples()
    assert labels["lane"] == "cache"
    assert auditor.snapshot()["demotions"] == 0
    auditor.close()


# ------------------------------------------------------------- the server
@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_synth_dataset(str(tmp_path_factory.mktemp("audit")))


@pytest.fixture(scope="module")
def jax_oneshot(dataset):
    """The JAX package's one-shot FASTA (host POA) at window length w."""
    jpol = pytest.importorskip("racon_tpu.core.polisher")
    cache: dict = {}

    def run(w=500):
        if w not in cache:
            p = jpol.create_polisher(*dataset, jpol.PolisherType.kC, w,
                                     10.0, 0.3, num_threads=2)
            p.initialize()
            cache[w] = b"".join(b">" + s.name.encode() + b"\n" + s.data
                                + b"\n" for s in p.polish())
        return cache[w]

    return run


def start(tmp_path, name="s", **kw):
    kw.setdefault("warmup", False)
    srv = PolishServer(socket_path=str(tmp_path / f"{name}.sock"),
                       device="cpu", **kw).start()
    return srv, PolishClient(socket_path=srv.config.socket_path,
                             timeout=WAIT)


def test_sdc_job_caught_repaired_demoted_and_lane_rejoins(
        dataset, jax_oneshot, tmp_path):
    from racon_tpu_torch.ops.poa_graph import BUCKETS

    table = str(tmp_path / "t.json")
    at = Autotuner(table)
    for nb, lb in BUCKETS:
        at.record("session", (nb, lb), (3, -5, -4, 8),
                  {"kernel": "plain", "dtype": "int16", "ms": {},
                   "identical": True}, backend="cpu")
    at.save()
    reset_autotuner_cache()
    flight = tmp_path / "flight"
    srv, cl = start(tmp_path, workers=2, worker_lanes=2,
                    devices=[CPU] * 2, audit_rate=1.0, wincache=True,
                    autotune_table=table, flight_dir=str(flight))
    jpath = str(tmp_path / "j.jsonl")
    srv.auditor.journal = Journal(jpath)
    opts = {"cuda_poa_batches": 1, "window_length": 100}
    want = jax_oneshot(100)
    try:
        clean = cl.submit(*dataset, options=opts)
        assert clean.fasta == want
        a = srv.auditor.snapshot()
        assert a["mismatches"] == 0 and a["audited"] == a["sampled"] > 0
        bad = cl.submit(*dataset, options=opts, trace_id="sdc-job",
                        fault_plan="device:chunk=1:sdc")
        assert bad.fasta == want
        a = srv.auditor.snapshot()
        assert (a["mismatches"], a["repaired"]) == (1, 1)
        assert a["demotions"] >= 1
        reset_autotuner_cache()
        disk = Autotuner(table).table
        assert all(ent.get("demoted") and ent["dtype"] == "int32"
                   for key, ent in disk.items()
                   if key.startswith("cpu|session|"))
        wait_for(lambda: srv.batcher.snapshot()["lane_rejoins"] == 1,
                 "the lane never rejoined")
        snap = srv.batcher.snapshot()
        assert snap["lane_quarantines"] == 1 and snap["lane_reprobes"] >= 1
        assert all(ln["health"] == 1.0 and not ln["quarantined"]
                   for ln in snap["lanes"])
        assert snap["wincache"]["invalidations"] >= 1
        dumps = os.listdir(flight)
        assert len(dumps) == 1 and "audit-mismatch" in dumps[0]
        doc = json.load(open(flight / dumps[0]))["flight"]
        assert doc["produced"] != doc["oracle"]
        events = read_journal(jpath)
        mism = [e for e in events if e["event"] == "audit-mismatch"]
        lane_ev = [(e["lane"], e["state"]) for e in events
                   if e["event"] == "audit-lane"]
        assert len(mism) == 1 and mism[0]["engine"] == "session"
        assert mism[0]["trace"] == "sdc-job" and mism[0]["demoted"]
        lane = int(mism[0]["lane"])
        assert lane_ev == [(lane, "quarantined"), (lane, "rejoined")]
        # the demoted table serves the next job with the same bytes
        assert cl.submit(*dataset, options=opts).fasta == want
        assert srv.auditor.snapshot()["mismatches"] == 1
    finally:
        assert srv.drain(timeout=60)
        reset_autotuner_cache()


def test_poisoned_cache_entry_caught_without_blaming_a_lane(
        dataset, jax_oneshot, tmp_path):
    srv, cl = start(tmp_path, wincache=True, audit_rate=1.0)
    try:
        want = jax_oneshot()
        assert cl.submit(*dataset).fasta == want
        assert srv.auditor.snapshot()["mismatches"] == 0
        wc = srv.batcher.wincache
        with wc._lock:
            assert wc._entries
            for key, (cons, pol) in list(wc._entries.items()):
                flip = b"T" if cons[:1] != b"T" else b"A"
                wc._entries[key] = (flip + cons[1:], pol)
        assert cl.submit(*dataset).fasta == want
        audit = srv.auditor.snapshot()
        assert audit["mismatches"] > 0
        assert audit["repaired"] == audit["mismatches"]
        assert audit["demotions"] == 0
        snap = srv.batcher.snapshot()
        assert snap["lane_quarantines"] == 0
        assert all(ln["health"] == 1.0 and not ln["quarantined"]
                   for ln in snap["lanes"])
        assert wc.snapshot()["quarantined"] >= audit["mismatches"]
        assert {labels["lane"] for labels, _ in
                srv.auditor.mismatch_samples()} == {"cache"}
        # a condemned key stays refused: the content re-dispatches
        assert cl.submit(*dataset).fasta == want
        assert srv.auditor.snapshot()["mismatches"] == audit["mismatches"]
    finally:
        assert srv.drain(timeout=60)


def test_audit_leaves_production_counters_alone(dataset, jax_oneshot,
                                                tmp_path):
    on, cl_on = start(tmp_path, "on", audit_rate=1.0)
    off, cl_off = start(tmp_path, "off")
    opts = {"cuda_poa_batches": 1, "window_length": 100}
    try:
        r_on = cl_on.submit(*dataset, options=opts)
        r_off = cl_off.submit(*dataset, options=opts)
        assert r_on.fasta == r_off.fasta
        pipe_on = on.batcher._merged_pipeline()
        pipe_off = off.batcher._merged_pipeline()
        for key in ("launches", "chunks", "errors", "faults",
                    "quarantined"):
            assert pipe_on[key] == pipe_off[key], key
        for key in ("iterations", "k1_launches", "k2_launches",
                    "k3_launches", "windows"):
            assert r_on.serve["batch"][key] == r_off.serve["batch"][key]
        for key in ("launches", "chunks", "errors"):
            assert r_on.metrics["pipeline"][key] == \
                r_off.metrics["pipeline"][key], key
        a = on.auditor.snapshot()
        assert a["audited"] == a["sampled"] > 0 and a["shadow_s"] > 0.0
        assert on.batcher.snapshot()["audit_s"] > 0.0
        assert off.batcher.snapshot()["audit_s"] == 0.0
    finally:
        assert on.drain(timeout=60)
        assert off.drain(timeout=60)


def test_audit_off_one_lane_server(dataset, jax_oneshot, tmp_path):
    srv, cl = start(tmp_path)
    try:
        r = cl.submit(*dataset)
        assert r.fasta == jax_oneshot()
        stats = cl.stats()
        assert srv.auditor is None and stats["audit"] is None
        b = stats["batcher"]
        assert b["worker_lanes"] == 1 and len(b["lanes"]) == 1
        lane = b["lanes"][0]
        assert (lane["health"], lane["quarantined"], lane["reprobes"]) == \
            (1.0, False, 0)
        assert lane["iterations"] == b["iterations"] >= 1
        assert b["audit_s"] == 0.0 and b["lane_quarantines"] == 0
    finally:
        assert srv.drain(timeout=60)
