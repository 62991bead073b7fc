"""The serve stack's leaf modules of the port against the JAX package's.

For the same inputs, each leaf gives the JAX function's output:

  - sched.pack_iteration, parallel/mesh.partition_devices, and
    Autotuner.consult_counts; sched/autotune.posture_key folds the
    constructor postures and reads no environment;
  - obs/hist.py's exemplars, export / from_export / cumulative and
    HistogramSet.get; obs/trace.py's rebase, install, scoped (with its
    tee), rebase_events and trace_matches;
  - obs/flight.py's ring, trace_events, window_events and dump;
    obs/journal.py's lines (time fields pinned), staging, rotation,
    read_journal and check_consistency;
  - obs/prom.py's render and parse, as a round trip;
  - serve/protocol.py's frames, limits and typed errors;
    serve/wincache.py's digests, keys, LRU and quarantine;
    serve/ingest.py's spec checks and prepared files.

Trace events differ from the JAX package's only in their `cat` field
(the package name), which the comparisons drop. Tolerance: none; every
value is an integer, a string or a byte.
"""

import gzip
import itertools
import json
import os
import random
import socket
import struct
import threading
import time

import pytest
import torch

jax = pytest.importorskip("jax")

from racon_tpu.core import window as jax_window  # noqa: E402
from racon_tpu.obs import flight as jax_flight  # noqa: E402
from racon_tpu.obs import hist as jax_hist  # noqa: E402
from racon_tpu.obs import journal as jax_journal  # noqa: E402
from racon_tpu.obs import prom as jax_prom  # noqa: E402
from racon_tpu.obs import trace as jax_trace  # noqa: E402
from racon_tpu.parallel import mesh as jax_mesh  # noqa: E402
from racon_tpu import sched as jax_sched  # noqa: E402
from racon_tpu.sched import autotune as jax_autotune  # noqa: E402
from racon_tpu.serve import ingest as jax_ingest  # noqa: E402
from racon_tpu.serve import protocol as jax_protocol  # noqa: E402
from racon_tpu.serve import wincache as jax_wincache  # noqa: E402

from racon_tpu_torch import sched  # noqa: E402
from racon_tpu_torch.core import window  # noqa: E402
from racon_tpu_torch.obs import flight, hist, journal, prom, trace  # noqa: E402
from racon_tpu_torch.parallel import mesh  # noqa: E402
from racon_tpu_torch.sched import autotune  # noqa: E402
from racon_tpu_torch.serve import ingest, protocol, wincache  # noqa: E402


def no_cat(events):
    return [{k: v for k, v in e.items() if k != "cat"} for e in events]


# ------------------------------------------------------------- scheduling
@pytest.mark.parametrize("cap,lanes", [(1, 1), (5, 1), (8, 3), (64, 4),
                                       (7, 8)])
def test_pack_iteration_matches_jax(cap, lanes):
    rng = random.Random(cap * 31 + lanes)
    for n in (0, 1, 3, 9, 40):
        pool = [(rng.randrange(4), rng.randrange(50), rng.random(), i)
                for i in range(n)]
        args = (cap, lambda it: (it[0], it[1]), lambda it: it[2], lanes)
        assert (sched.pack_iteration(list(pool), *args)
                == jax_sched.pack_iteration(list(pool), *args))
        batch, rest = sched.pack_iteration(list(pool), *args)
        assert sorted(batch + rest) == sorted(pool)
        if pool:
            assert min(pool, key=lambda it: it[2]) in batch


def test_partition_devices_matches_jax():
    for n in range(10):
        devices = [torch.device("cpu")] * n if n % 2 else list(range(n))
        for k in range(1, 6):
            assert (mesh.partition_devices(devices, k)
                    == jax_mesh.partition_devices(devices, k))
    want = (torch.cuda.device_count() if torch.cuda.is_available() else 0)
    assert sum(map(len, mesh.partition_devices(None, 2))) == want


def test_posture_key_folds_the_postures(monkeypatch):
    base = autotune.posture_key("cpu")
    assert base == ("plain", "auto", True, "session", "auto", "cpu")
    variants = [autotune.posture_key("cpu", score_dtype="int32"),
                autotune.posture_key("cpu", pack_bases=False),
                autotune.posture_key("cpu", cuda_engine="fused"),
                autotune.posture_key("cpu", cuda_fused="1")]
    assert len({base, *variants}) == 5
    # the JAX package's posture knobs move nothing here
    for var in ("RACON_TPU_PALLAS", "RACON_TPU_DTYPES", "RACON_TPU_FUSED",
                "RACON_TPU_PACK_BASES"):
        monkeypatch.setenv(var, "1")
    assert autotune.posture_key("cpu") == base
    # the window cache keys on the polisher's own posture
    from racon_tpu_torch.core.polisher import Polisher, PolisherType

    pol = Polisher(None, None, None, PolisherType.kC, 500, 10.0, 0.3, True,
                   5, -4, -8, device="cpu", score_dtype="int16",
                   cuda_engine="fused", cuda_fused="0")
    assert pol.posture_key == ("plain", "int16", True, "fused", "0", "cpu")


def test_consult_counts_matches_jax(tmp_path):
    mine = autotune.Autotuner(str(tmp_path / "port.json"))
    theirs = jax_autotune.Autotuner(str(tmp_path / "jax.json"))
    entries = [("session", (768, 640), (5, -4, -8, 8),
                {"kernel": "plain", "dtype": "int16"}),
               ("aligner", (8192, 896), (), {"kernel": "plain",
                                             "dtype": "int32"})]
    for eng, bucket, params, ent in entries:
        mine.record(eng, bucket, params, ent, backend="cpu")
        theirs.table[theirs.key(eng, bucket, params, backend="cpu")] = ent
    calls = [entries[0][:3], entries[1][:3], entries[0][:3],
             ("fused", (2048, 640, 32), (5, -4, -8))]
    for eng, bucket, params in calls:
        mine.winner(eng, bucket, params, backend="cpu")
        theirs.winner(eng, bucket, params)
    assert mine.consult_counts() == theirs.consult_counts()
    assert mine.consult_counts()[-1] == (
        {"engine": "session", "decision": "plain", "dtype": "int16"}, 2)


# ---------------------------------------------------------- histograms
def observations(seed):
    rng = random.Random(seed)
    return [(rng.lognormvariate(-3, 2),
             {"trace_id": f"t{i}", "t": 1000.0 + i} if i % 3 == 0 else None)
            for i in range(200)]


def test_histogram_exemplars_and_export_match_jax():
    mine, theirs = hist.Histogram(), jax_hist.Histogram()
    for v, ex in observations(5):
        mine.observe(v, exemplar=ex)
        theirs.observe(v, exemplar=ex)
    assert mine.export() == theirs.export()
    assert mine.cumulative() == theirs.cumulative()
    assert mine.bucket_exemplars() == theirs.bucket_exemplars()
    assert mine.bucket_exemplars(), "no exemplar kept"
    args = (*mine.export(), mine.min, mine.max, mine.bucket_exemplars())
    back = hist.Histogram.from_export(*args)
    assert back.snapshot() == mine.snapshot()
    assert back.bucket_exemplars() == mine.bucket_exemplars()
    assert (back.snapshot()
            == jax_hist.Histogram.from_export(*args).snapshot())
    # without the min / max sidecars: the bounds the buckets give
    assert (hist.Histogram.from_export(*mine.export()).snapshot()
            == jax_hist.Histogram.from_export(*theirs.export()).snapshot())
    # merges keep the newer exemplar of a bucket
    other, jother = hist.Histogram(), jax_hist.Histogram()
    for v, ex in observations(6):
        if ex:
            ex = {**ex, "t": ex["t"] + 0.5}
        other.observe(v, exemplar=ex)
        jother.observe(v, exemplar=ex)
    mine.merge(other)
    theirs.merge(jother)
    assert mine.bucket_exemplars() == theirs.bucket_exemplars()
    assert mine.snapshot() == theirs.snapshot()
    mset, jset = hist.HistogramSet(), jax_hist.HistogramSet()
    for s in (mset, jset):
        s.observe("a.b", 0.25, exemplar={"trace_id": "x", "t": 1.0})
        s.observe("c", 3.0)
    assert mset.get("a.b").export() == jset.get("a.b").export()
    assert mset.get("missing") is None
    assert mset.snapshot() == jset.snapshot()


# -------------------------------------------------------------- tracing
def test_trace_rebase_and_event_helpers_match_jax():
    t0 = time.perf_counter()
    recs = []
    for mod in (trace, jax_trace):
        rec = mod.TraceRecorder(None)
        rec._base = t0 + 1.0
        rec.rebase(t0 + 2.0)  # later: ignored
        rec.rebase(t0)
        rec.complete("job.queue", t0 + 0.25, t0 + 0.75, {"trace_id": "a"})
        recs.append(rec.events())
    assert no_cat(recs[0]) == no_cat(recs[1])
    assert recs[0][-1]["ts"] == 250000.0
    events = recs[0] + [{"name": "x", "ph": "i", "ts": 5.0, "pid": 1,
                         "tid": 2}]
    for shift, name in ((0.0, None), (-300000.0, "replica r1"),
                        (12.5, "router")):
        assert (trace.rebase_events(events, 77, shift, name)
                == jax_trace.rebase_events(events, 77, shift, name))
    assert events[-1]["pid"] == 1  # the input is not mutated
    cases = [None, {}, {"trace_id": "abc"}, {"trace_id": "abc.s1"},
             {"trace_id": "abcd"}, {"trace_ids": ["x", "abc.s2"]},
             {"trace_ids": ("x",)}, {"trace_ids": "abc"},
             {"trace_id": 5}]
    for args, tid in itertools.product(cases, ("abc", "x", "abc.s1")):
        assert (trace.trace_matches(args, tid)
                == jax_trace.trace_matches(args, tid))


def test_install_and_scoped_tee_match_jax():
    names = []
    for mod, fl in ((trace, flight), (jax_trace, jax_flight)):
        mod.reset()
        ring = mod.install(fl.FlightRecorder(16))
        assert mod.get_tracer() is ring
        with mod.span("outer"):
            pass
        with mod.scoped() as job:
            with mod.span("inner", trace_id="j"):
                pass
            mod.instant("mark")
        assert mod.get_tracer() is ring
        mod.instant("after")
        names.append(([e["name"] for e in job.events() if e["ph"] != "M"],
                      [e["name"] for e in ring.events() if e["ph"] != "M"]))
        mod.reset()
        with mod.scoped() as job:
            mod.instant("alone")
        assert mod.get_tracer() is None
    assert names[0] == names[1]
    assert names[0] == (["inner", "mark"],
                        ["outer", "inner", "mark", "after"])


def record_flight(mod, fl, t0):
    rec = fl.FlightRecorder(6)
    rec._base = t0
    done = threading.Event()

    def worker():
        for i in range(4):
            rec.complete("pipeline.pack", t0 + i, t0 + i + 0.5,
                         {"trace_id": f"job{i % 2}.s{i}"})
        done.set()

    th = threading.Thread(target=worker, name="racon-pack")
    th.start()
    th.join()
    for i in range(5):
        rec.complete("lane.iter", t0 + 10 + i, t0 + 10.25 + i,
                     {"trace_ids": ["job1", f"other{i}"]})
    return rec


def test_flight_ring_and_dump_match_jax(tmp_path):
    t0 = time.perf_counter()
    mine = record_flight(trace, flight, t0)
    theirs = record_flight(jax_trace, jax_flight, t0)
    assert len([e for e in mine.events() if e["ph"] != "M"]) == 6
    assert no_cat(mine.events()) == no_cat(theirs.events())
    for tid, cap in (("job1", None), ("job0", 2), (["job0", "other3"], 0),
                     ("nothing", None)):
        assert (no_cat(flight.trace_events(mine, tid, cap))
                == no_cat(jax_flight.trace_events(theirs, tid, cap)))
    for since in (None, t0 + 12.0):
        assert (no_cat(flight.window_events(mine, since))
                == no_cat(jax_flight.window_events(theirs, since)))
    docs = []
    for mod, rec in ((flight, mine), (jax_flight, theirs)):
        path = str(tmp_path / f"{mod.__name__}.json")
        mod.dump(rec, path, since=t0 + 11.0,
                 flight={"job": "j1", "reason": "failed"})
        doc = json.load(open(path))
        doc["traceEvents"] = no_cat(doc["traceEvents"])
        docs.append(doc)
    assert docs[0] == docs[1]
    assert flight.FlightRecorder().capacity == flight.DEFAULT_CAPACITY


# -------------------------------------------------------------- journal
def drive_journal(mod, path, monkeypatch):
    clock = itertools.count(1_700_000_000.0, 0.125)
    monkeypatch.setattr(time, "time", lambda: next(clock))
    jr = mod.Journal(path, max_bytes=400)
    jr.record("received", job="j1", trace="t1", tenant="gold",
              options={"w": 500}, skip=None)
    jr.stage("admitted", job="j1", position=0)
    jr.stage("admitted", job="j2")
    jr.record("started", job="j1")
    for c in range(4):
        jr.record("part-streamed", job="j1", contig=f"ctg{c}", bytes=c * 17)
    jr.record("finished", job="j1", wall_s=1.5)
    jr.stage("expired", job="j2")
    jr.flush_staged()
    jr.record("alert", job="j3", burn=2.0)
    jr.close()
    jr.record("late", job="j4")
    counts = (jr.events, jr.dropped)
    files = [open(p, "rb").read() for p in (path + ".1", path)]
    return counts, files, mod.read_journal(path)


def test_journal_matches_jax(tmp_path, monkeypatch):
    mine = drive_journal(journal, str(tmp_path / "port.jsonl"), monkeypatch)
    theirs = drive_journal(jax_journal, str(tmp_path / "jax.jsonl"),
                           monkeypatch)
    assert mine == theirs
    assert mine[0] == (11, 1) and mine[1][0], "no rotation"
    entries = mine[2] + [{"job": "j5", "event": "finished"},
                         {"job": "j6", "event": "started"},
                         {"job": "j6", "event": "expired"},
                         {"job": "j7", "event": "received"},
                         {"job": "j7", "event": "finished"}]
    problems = journal.check_consistency(entries)
    assert problems == jax_journal.check_consistency(entries)
    assert len(problems) == 2
    with pytest.raises(OSError):
        journal.Journal(str(tmp_path / "no" / "such" / "dir.jsonl"))
    assert journal.Journal(str(tmp_path / "d.jsonl")).fsync is False


# ----------------------------------------------------------------- prom
def scrape_inputs(mod_hist, mod_prom):
    hs = mod_hist.HistogramSet()
    for v, ex in observations(9):
        hs.observe("job.latency", v, exemplar=ex)
    hs.observe("pipeline.pack", 0.003)
    hs._hists["empty"] = mod_hist.Histogram()
    counters = {"serve.jobs_completed": 42,
                "serve.tenant_device_s": mod_prom.Labeled(
                    [({"tenant": "gold"}, 1.5),
                     ({"tenant": 'we"ird\\n'}, 2.25)], "per tenant"),
                "autotune.consults": (7, "winner-table consults")}
    gauges = {"serve.queue_depth": 3, "serve.up": True,
              "serve.ratio": float("nan"), "serve.cap": float("inf"),
              "racon_tpu_already.prefixed": 1.0}
    return counters, gauges, hs


def test_prom_round_trip_matches_jax():
    text = prom.render(*scrape_inputs(hist, prom))
    assert text == jax_prom.render(*scrape_inputs(jax_hist, jax_prom))
    assert ' # {trace_id="t' in text
    mine, theirs = prom.parse(text), jax_prom.parse(text)
    for attr in ("counters", "counter_series", "gauge_series"):
        assert getattr(mine, attr) == getattr(theirs, attr)
    assert {k for k in mine.gauges} == {k for k in theirs.gauges}
    assert sorted(mine.hists) == sorted(theirs.hists)
    _, _, hs = scrape_inputs(hist, prom)
    for name in mine.hists:
        got = mine.histogram(name)
        assert got.snapshot() == theirs.histogram(name).snapshot()
        assert got.bucket_exemplars() == theirs.histogram(
            name).bucket_exemplars()
    assert (mine.histogram("racon_tpu_job_latency_seconds").snapshot()
            == hs.get("job.latency").snapshot())
    assert (mine.series_sum("racon_tpu_serve_tenant_device_s_total")
            == 3.75)
    assert prom.render(hists=mine.histogram_set()) == jax_prom.render(
        hists=theirs.histogram_set())
    for bad in ("no_type 1\n", "# TYPE x counter\nx{a=1} 2\n",
                "# TYPE x bogus\n", "# junk\n",
                "# TYPE h histogram\nh_bucket{le=\"1\"} 5\n"
                "h_bucket{le=\"2\"} 3\n"):
        with pytest.raises(prom.PromParseError) as mine_exc:
            prom.parse(bad)
        with pytest.raises(jax_prom.PromParseError) as jax_exc:
            jax_prom.parse(bad)
        assert str(mine_exc.value) == str(jax_exc.value)


# ------------------------------------------------------------- protocol
def frame_outcome(mod, payload: bytes, max_frame, close=True):
    a, b = socket.socketpair()
    try:
        a.sendall(payload)
        if close:
            a.shutdown(socket.SHUT_WR)
        try:
            got = mod.recv_frame(b, max_frame)
            rest = mod.recv_frame(b, max_frame)
            return ("ok", got, rest)
        except mod.ProtocolError as exc:
            return (type(exc).__name__, exc.code, exc.resync, str(exc))
    finally:
        a.close()
        b.close()


def test_frames_match_jax():
    obj = {"type": "submit", "fasta": bytes(range(256)).decode("latin-1"),
           "n": [1, 2.5, None, True]}
    raws = []
    for mod in (protocol, jax_protocol):
        a, b = socket.socketpair()
        mod.send_frame(a, obj)
        a.close()
        raws.append(b.recv(1 << 20))
        b.close()
    assert raws[0] == raws[1]
    header = struct.Struct(">4sI")
    cases = [
        (raws[0], None),
        (raws[0], 16),  # too large: drained, then the stream goes on
        (raws[0] + raws[0], 16),
        (header.pack(b"RTPU", 5) + b"[1,2]", None),
        (header.pack(b"RTPU", 4) + b"\xff\xfe{}", None),
        (header.pack(b"RTPX", 2) + b"{}", None),
        (header.pack(b"RTPU", 10) + b"{}", None),
        (header.pack(b"RTPU", 100) + b"{}", 50),
        (b"RT", None),
        (b"", None),
    ]
    for payload, cap in cases:
        limit = protocol.DEFAULT_MAX_FRAME if cap is None else cap
        mine = frame_outcome(protocol, payload, limit)
        theirs = frame_outcome(jax_protocol, payload, cap)
        assert mine[:3] == theirs[:3], (payload[:12], cap)
        if mine[0] != "ok":
            assert mine[3] == theirs[3]
    assert (protocol.error_response("queue-full", "busy", retry_after=2.5)
            == jax_protocol.error_response("queue-full", "busy",
                                           retry_after=2.5))
    for cls in ("ProtocolError", "FrameTooLarge", "FrameGarbage",
                "FrameTruncated"):
        mine, theirs = getattr(protocol, cls), getattr(jax_protocol, cls)
        assert (mine.code, mine.resync) == (theirs.code, theirs.resync)


# ------------------------------------------------------------- wincache
def windows_of(mod, seed, n):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        bb = bytes(rng.choice(b"ACGT") for _ in range(60 + i))
        qual = bytes(rng.randrange(33, 70) for _ in bb) if i % 2 else b""
        w = mod.create_window(i, i, list(mod.WindowType)[i % 2], bb,
                              qual or b"!" * len(bb))
        for _ in range(3):
            lay = bytes(rng.choice(b"ACGT") for _ in range(40))
            q = bytes(rng.randrange(33, 70) for _ in lay) if i % 2 else None
            b = rng.randrange(10)
            w.add_layer(lay, q, b, b + 39)
        out.append(w)
    return out


def drive_cache(mod, wins, posture):
    cache = mod.WindowCache(max_bytes=800)
    engine_key = (5, -4, -8, 500, True)
    keys = [mod.WindowCache.key(w, engine_key, posture) for w in wins]
    trail = []
    for i, k in enumerate(keys):
        trail.append(cache.lookup(k))
        cache.store(k, b"C" * (50 + 10 * i), i % 3 != 0)
        trail.append(cache.lookup(keys[0]))
    cache.quarantine(keys[1])
    cache.store(keys[1], b"again", True)
    trail += [cache.lookup(keys[1]), cache.quarantined(keys[1])]
    trail.append(cache.invalidate_all("demotion"))
    trail.append(cache.lookup(keys[-1]))
    return keys, trail, cache.snapshot()


def test_wincache_matches_jax():
    mine_w, jax_w = windows_of(window, 3, 8), windows_of(jax_window, 3, 8)
    for a, b in zip(mine_w, jax_w):
        assert (wincache.window_content_digest(a)
                == jax_wincache.window_content_digest(b))
    posture = autotune.posture_key("cpu")
    mine = drive_cache(wincache, mine_w, posture)
    theirs = drive_cache(jax_wincache, jax_w, posture)
    assert mine == theirs
    assert mine[2]["evictions"] > 0 and mine[2]["quarantined"] == 1
    other = wincache.WindowCache.key(mine_w[0], (5, -4, -8, 500, True),
                                     autotune.posture_key(
                                         "cpu", score_dtype="int32"))
    assert other != mine[0][0]


# --------------------------------------------------------------- ingest
@pytest.mark.parametrize("req", [
    {}, {"ingest": True}, {"ingest": 1}, {"normalize": "yes"},
    {"subsample": 5}, {"subsample": {"reference_length": 10}},
    {"subsample": {"reference_length": 10, "coverage": 2, "x": 1}},
    {"subsample": {"reference_length": True, "coverage": 2}},
    {"subsample": {"reference_length": 10, "coverage": 2, "seed": "s"}},
    {"subsample": {"reference_length": 10, "coverage": 2, "seed": 3},
     "normalize": True}])
def test_ingest_spec_matches_jax(req):
    def outcome(mod):
        try:
            spec = mod.IngestSpec.from_request(req)
        except mod.IngestError as exc:
            return ("error", exc.stage, str(exc).split("error: ", 1)[1])
        return ("ok", spec.subsample, spec.normalize)

    assert outcome(ingest) == outcome(jax_ingest)


def write_pair_set(d):
    rng = random.Random(4)
    genome = bytes(rng.choice(b"ACGT") for _ in range(3000))
    paths = {k: os.path.join(d, f"{k}") for k in ("r1.fastq.gz", "ovl.paf",
                                                 "draft.fasta")}
    with gzip.open(paths["r1.fastq.gz"], "wb") as fh:
        for i in range(30):
            s = rng.randrange(0, 2000)
            seq = genome[s:s + 900]
            name = f"pair{i // 2}/{i % 2 + 1}"
            fh.write(b"@%s\n%s\n+\n%s\n" % (name.encode(), seq,
                                            b"I" * len(seq)))
    with open(paths["ovl.paf"], "w") as fh:
        fh.write("pair0/1\t900\t0\t900\t+\tdraft\t3000\t0\t900\t850\t900"
                 "\t60\n")
    with open(paths["draft.fasta"], "wb") as fh:
        fh.write(b">draft\n" + genome + b"\n")
    return paths["r1.fastq.gz"], paths["ovl.paf"], paths["draft.fasta"]


def test_ingest_prepare_matches_jax(tmp_path, monkeypatch):
    spec = {"subsample": {"reference_length": 3000, "coverage": 4,
                          "seed": 11}, "normalize": True}
    results = []
    for mod, jmod in ((ingest, journal), (jax_ingest, jax_journal)):
        clock = itertools.count(1_700_000_000.0, 1.0)
        monkeypatch.setattr(time, "time", lambda: next(clock))
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        inputs = write_pair_set(str(d))
        work = d / "work"
        work.mkdir()
        jr = jmod.Journal(str(d / "j.jsonl"))
        out = mod.prepare(*inputs, mod.IngestSpec.from_request(spec),
                          str(work), "job7", trace_id="t7", journal=jr)
        jr.close()
        results.append((os.path.relpath(out[0], d),
                        open(out[0], "rb").read(),
                        os.path.basename(out[1]),
                        open(d / "j.jsonl", "rb").read()))
        with pytest.raises(mod.IngestError) as exc:
            empty = d / "empty.fasta"
            empty.write_bytes(b"")
            mod.prepare(str(empty), *inputs[1:], mod.IngestSpec(),
                        str(work), "job8")
        results.append((exc.value.stage,
                        str(exc.value).split("error: ", 1)[1]
                        .replace(str(d), "")))
    assert results[0] == results[2]
    assert results[1] == results[3]
    assert results[0][1].count(b"\n+\n") < 30
