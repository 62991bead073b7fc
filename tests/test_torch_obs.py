"""The port's one-shot observability (racon_tpu_torch/obs, utils/logger)
against the JAX package's (racon_tpu/obs, racon_tpu/utils/logger).

  - histograms: for the same observations, the port's quantiles and
    snapshots (and merges) equal the JAX package's;
  - the metrics registry renders the same snapshot, flat view, table and
    dump as the JAX one for the same providers;
  - the tracer: thread-safe, well-formed Chrome trace-event JSON, span
    sums equal to the pipeline's stage counters;
  - log levels: quiet / info / debug, warning deduplication, a quiet
    Logger that still accumulates its timing;
  - `torch_profile` is a no-op without a directory and writes a capture
    with one;
  - the CLI: `--cuda-trace` writes loadable Chrome JSON whose pipeline
    stage spans carry the JAX tracer's names and `args` keys,
    `--cuda-metrics` dumps the `pipeline` / `latency` / `aligner`
    namespaces with the JAX `pipeline` and `aligner` keys, and
    `--cuda-log-level quiet` leaves stderr without progress or timing
    lines and stdout unchanged.

Tolerance: none; every compared value is computed from the same inputs
by the same arithmetic.
"""

import io
import json
import os
import random
import sys
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from racon_tpu import cli as jax_cli  # noqa: E402
from racon_tpu.obs import hist as jax_hist  # noqa: E402
from racon_tpu.obs import trace as jax_trace  # noqa: E402
from racon_tpu.obs.metrics import MetricsRegistry as JaxRegistry  # noqa: E402
from racon_tpu.utils import logger as jax_logger  # noqa: E402
from racon_tpu_torch import cli  # noqa: E402
from racon_tpu_torch.obs import hist, torch_profile, trace  # noqa: E402
from racon_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402
from racon_tpu_torch.pipeline import DispatchPipeline  # noqa: E402
from racon_tpu_torch.synth import simulate, write_dataset  # noqa: E402
from racon_tpu_torch.utils import logger  # noqa: E402

SCORES = ["-m", "5", "-x", "-4", "-g", "-8"]
STAGES = ("pipeline.pack", "pipeline.device", "pipeline.unpack",
          "pipeline.fallback")
#: the port's spans that the JAX package has not got: initialize()'s
#: steps, the pipeline caller's waits, and the aligner's and the
#: consensus engines' host steps (obs/trace.py, README's observability
#: section)
PORT_ONLY_SPANS = (
    "polisher.load_targets", "polisher.load_sequences",
    "polisher.load_overlaps", "polisher.transmute", "align.pairs",
    "pipeline.drain_fallback", "align.runs", "polisher.breaking_points",
    "polisher.windows", "polisher.layers", "pipeline.wait_pack",
    "pipeline.wait_unpack", "pipeline.join", "align.operands",
    "align.kernel", "align.launch", "align.account", "align.readback",
    "align.decode", "poa.prepare", "poa.dispatch", "poa.wait", "poa.sync",
    "poa.fetch", "poa.commit", "poa.finish", "fused.pack", "fused.kernel",
    "fused.finish")


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    for env in ("RACON_TPU_TRACE", "RACON_TPU_METRICS",
                "RACON_TPU_LOG_LEVEL", "RACON_TPU_PROFILE"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv("RACON_TPU_MAX_DEVICES", "1")
    monkeypatch.setenv("RACON_TPU_STRICT", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.reset()
    logger.set_log_level(None)
    logger.reset_dedup()
    yield
    trace.reset()
    logger.set_log_level(None)
    logger.reset_dedup()
    jax_trace.reset()
    jax_logger.set_log_level(None)
    torch.set_num_threads(threads)


# ------------------------------------------------------------ histograms

def _values(kind):
    rng = np.random.default_rng(11)
    if kind == "lognormal":
        return list(rng.lognormal(-3.0, 2.0, 2000))
    if kind == "uniform":
        return list(rng.uniform(0.0, 5.0, 777))
    if kind == "edges":
        # zero and negative (clamped), exact bucket edges, past `hi`
        return [0.0, -1.0, 1e-4, 1e-5, 1.0, 2 ** 0.25, 12345.0, 1e4, 3.0]
    return [0.125]


@pytest.mark.parametrize("kind", ["lognormal", "uniform", "edges", "one"])
def test_histogram_matches_jax(kind):
    vals = _values(kind)
    mine, theirs = hist.Histogram(), jax_hist.Histogram()
    for v in vals:
        mine.observe(float(v))
        theirs.observe(float(v))
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert mine.quantile(q) == theirs.quantile(q), q
    assert mine.snapshot() == theirs.snapshot()
    assert mine.counts == theirs.counts and mine.edges == theirs.edges

    other, other_j = hist.Histogram(), jax_hist.Histogram()
    for v in vals[: len(vals) // 2]:
        other.observe(float(v) * 3)
        other_j.observe(float(v) * 3)
    mine.merge(other)
    theirs.merge(other_j)
    assert mine.snapshot() == theirs.snapshot()


def test_histogram_set_and_empty_match_jax():
    mine, theirs = hist.HistogramSet(), jax_hist.HistogramSet()
    for i, v in enumerate(_values("lognormal")[:300]):
        name = ("pipeline.pack", "pipeline.device", "phase.align")[i % 3]
        mine.observe(name, float(v))
        theirs.observe(name, float(v))
    assert mine.snapshot() == theirs.snapshot()
    mine.merge(mine)
    theirs.merge(theirs)
    assert mine.snapshot() == theirs.snapshot()
    assert hist.Histogram().snapshot() == jax_hist.Histogram().snapshot()
    assert hist.Histogram().quantile(0.5) == 0.0
    with pytest.raises(ValueError):
        hist.Histogram(lo=1.0, hi=0.5)
    with pytest.raises(ValueError):
        hist.Histogram().merge(hist.Histogram(lo=1e-3))


# --------------------------------------------------------------- metrics

def test_metrics_registry_matches_jax(tmp_path):
    providers = {"pipeline": lambda: {"pack_s": 1.23456, "chunks": 3},
                 "latency": lambda: {"phase.align": {"count": 1,
                                                     "p50": 0.5}},
                 "aligner": lambda: {"pairs": 7}}
    mine, theirs = MetricsRegistry(), JaxRegistry()
    for ns, fn in providers.items():
        mine.register(ns, fn)
        theirs.register(ns, fn)
    assert mine.snapshot() == theirs.snapshot()
    assert mine.flat() == theirs.flat()
    assert mine.table() == theirs.table()
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    mine.dump(str(a))
    theirs.dump(str(b))
    assert a.read_text() == b.read_text()
    assert MetricsRegistry().table() == JaxRegistry().table()
    for bad in ("", "a.b"):
        with pytest.raises(ValueError):
            mine.register(bad, dict)


# ----------------------------------------------------------------- trace

def test_tracing_off_by_default():
    assert trace.get_tracer() is None
    with trace.span("x", a=1):
        pass
    trace.instant("y")
    assert trace.save() is None


def test_trace_thread_safe_and_well_formed(tmp_path):
    rec = trace.configure(str(tmp_path / "t.json"))
    barrier = threading.Barrier(6)

    def work(k):
        barrier.wait(10)
        for i in range(200):
            with trace.span("work", thread=k, i=i):
                pass
        trace.instant("done", thread=k)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    path = trace.save()
    doc = json.load(open(path))
    evs = doc["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    spans = [e for e in evs if e["ph"] == "X"]
    assert len(meta) == 6 and len(spans) == 1200
    assert sum(e["ph"] == "i" for e in evs) == 6
    ts = [e["ts"] for e in evs if e["ph"] != "M"]
    assert ts == sorted(ts)
    for e in spans:
        assert e["dur"] >= 0 and e["pid"] == os.getpid() and e["tid"] >= 1
        assert set(e["args"]) == {"thread", "i"}
    assert len({e["tid"] for e in spans}) == 6
    assert rec.events()[len(meta):] == evs[len(meta):]


@pytest.mark.parametrize("depth", [0, 2])
def test_span_sums_match_stage_stats(depth):
    """Each stage's span durations sum to its stage counter (they share
    perf_counter endpoints)."""
    rec = trace.configure(None)
    with DispatchPipeline(depth=depth) as pl:
        pl.run(range(6), lambda i: sum(range(2000)),
               lambda i, ops: ops, lambda h: h, lambda i, r: None,
               label="aligner", describe=lambda i: {"jobs": i})
        pl.submit_fallback(lambda: sum(range(2000)))
        pl.drain_fallback()
    stats = pl.stats.snapshot()
    sums = {}
    for e in rec.events():
        if e["ph"] == "X":
            sums[e["name"]] = sums.get(e["name"], 0.0) + e["dur"] / 1e6
    for stage, key in zip(STAGES, ("pack_s", "device_s", "unpack_s",
                                   "fallback_s")):
        assert abs(sums[stage] - stats[key]) < 1e-4 + 1e-6 * 20, stage


# ------------------------------------------------------------ log levels

def test_log_levels(capsys):
    assert logger.LEVEL_NAMES == jax_logger.LEVEL_NAMES
    for level, info, debug in (("quiet", False, False),
                               ("info", True, False),
                               ("debug", True, True)):
        logger.set_log_level(level)
        logger.log_info("i-line")
        logger.log_debug("d-line")
        err = capsys.readouterr().err
        assert ("i-line" in err) == info and ("d-line" in err) == debug
    with pytest.raises(ValueError):
        logger.set_log_level("loud")
    logger.set_log_level(None)
    assert logger.log_level() == logger.INFO


def test_warn_dedup_by_level(capsys):
    for _ in range(3):
        logger.warn_dedup("k", "warned")
    logger.flush_dedup()
    err = capsys.readouterr().err
    assert err.count("warned") == 1 and "repeated 2 more times" in err
    logger.set_log_level("debug")
    for _ in range(3):
        logger.warn_dedup("k", "warned")
    logger.flush_dedup()
    err = capsys.readouterr().err
    assert err.count("warned") == 3 and "repeated" not in err


def test_quiet_logger_keeps_timing(capsys):
    logger.set_log_level("quiet")
    log = logger.Logger()
    log.log()
    log.log("phase")
    log.bar_total(3)
    for _ in range(3):
        log.bar("bar")
    log.total("total")
    assert capsys.readouterr().err == ""
    assert log._total > 0.0


# --------------------------------------------------------------- profile

def test_torch_profile(tmp_path):
    with torch_profile(None, "align"):
        torch.ones(4).sum()
    assert not list(tmp_path.iterdir())
    with torch_profile(str(tmp_path / "prof"), "align"):
        torch.ones(4).sum()
    doc = json.load(open(tmp_path / "prof" / "align.json"))
    assert "traceEvents" in doc


# ------------------------------------------------------------------- CLI

def _run(main, argv):
    """Call a CLI's main; returns (stdout bytes, stderr text)."""
    buf = io.BytesIO()
    text, err = io.TextIOWrapper(buf), io.StringIO()
    saved = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = text, err
    try:
        rc = main(argv)
        text.flush()
    finally:
        sys.stdout, sys.stderr = saved
    assert rc == 0, err.getvalue()[-2000:]
    return buf.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One traced depth-2 run of each CLI on the same tiny dataset, plus
    a read that is unrelated to the span its overlap names: the aligner
    rejects it over the cost limit, and the fallback pool aligns it."""
    d = tmp_path_factory.mktemp("obs")
    rng = random.Random(3)
    _, draft, reads, paf = simulate(rng, 2500, 6, 1500, 0.12, 0.10)
    junk = bytes(rng.choice(b"ACGT") for _ in range(1200))
    reads = reads + [("junk", junk)]
    paf = paf + [f"junk\t1200\t0\t1200\t+\tdraft\t{len(draft)}\t500\t"
                 "1700\t1200\t1200\t60"]
    paths = write_dataset(str(d), draft, reads, paf)
    flags = ["-c", "1", "--cudaaligner-batches", "1", *SCORES]
    torch.set_num_threads(1)
    try:
        port = _run(cli.main, ["--device", "cpu", *flags,
                               "--cuda-trace", str(d / "port.json"),
                               "--cuda-metrics", str(d / "port_m.json"),
                               *paths])
        quiet = _run(cli.main, ["--device", "cpu", *flags,
                                "--cuda-log-level", "quiet", *paths])
        jflags = [f.replace("--cuda", "--tpu") for f in flags]
        jax_out = _run(jax_cli.main, [*jflags,
                                      "--tpu-trace", str(d / "jax.json"),
                                      "--tpu-metrics",
                                      str(d / "jax_m.json"), *paths])
    finally:
        trace.reset()
        jax_trace.reset()
    return {"port": port, "quiet": quiet, "jax": jax_out,
            "trace": json.load(open(d / "port.json")),
            "jax_trace": json.load(open(d / "jax.json")),
            "metrics": json.load(open(d / "port_m.json")),
            "jax_metrics": json.load(open(d / "jax_m.json"))}


def _arg_keys(doc):
    keys: dict = {}
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            keys.setdefault(e["name"], set()).update(e.get("args", {}))
    return keys


def test_cli_trace_spans_match_jax(traced):
    assert traced["port"][0] == traced["jax"][0]
    assert traced["port"][0].startswith(b">")
    mine, theirs = _arg_keys(traced["trace"]), _arg_keys(traced["jax_trace"])
    assert set(STAGES) <= set(mine)
    for name in (*STAGES, "session.dispatch", "session.commit",
                 "polisher.initialize", "polisher.align_overlaps",
                 "polisher.consensus", "polisher.stitch"):
        assert mine[name] == theirs[name], name
    # the port's first dispatch of a launch shape is its span
    # sched.first_dispatch, the JAX package's first compile xla.compile
    # (each only when the shape is new to the process), with the same
    # arguments
    first = mine.pop("sched.first_dispatch", None)
    assert first in (None, {"engine", "shape"})
    assert set(mine) <= set(theirs) | set(PORT_ONLY_SPANS)
    loops = {e["args"]["loop"] for e in traced["trace"]["traceEvents"]
             if e["name"] == "pipeline.device"}
    assert loops == {"aligner"}
    assert "trace written to" in traced["port"][1]


def test_cli_metrics_match_jax(traced):
    mine, theirs = traced["metrics"], traced["jax_metrics"]
    assert set(mine) == {"pipeline", "sched", "latency", "aligner"}
    assert set(mine["pipeline"]) == set(theirs["pipeline"])
    # occupancy: the same engines, and per bucket the same jobs and
    # useful cells (lanes and padding follow each package's batch
    # widths)
    assert set(mine["sched"]) == set(theirs["sched"]) == {"aligner",
                                                          "session"}
    for engine in ("aligner", "session"):
        assert ({b: (v["jobs"], v["useful_cells"])
                 for b, v in mine["sched"][engine]["buckets"].items()}
                == {b: (v["jobs"], v["useful_cells"])
                    for b, v in theirs["sched"][engine]["buckets"].items()})
    assert set(mine["aligner"]) == set(theirs["aligner"])
    assert mine["aligner"] == theirs["aligner"]
    assert mine["aligner"]["host_fallbacks"] > 0
    assert mine["pipeline"]["chunks"] == mine["pipeline"]["launches"] >= 1
    assert mine["pipeline"]["fallback_s"] > 0.0
    # compile.<engine>: first dispatches / first compiles, each only for
    # a shape new to its process
    assert ({k for k in mine["latency"] if not k.startswith("compile.")}
            <= set(theirs["latency"]))
    assert {"pipeline.pack", "pipeline.device", "pipeline.unpack",
            "pipeline.fallback", "phase.initialize", "phase.consensus",
            "phase.stitch"} <= set(mine["latency"])
    assert "end-of-run metrics" in traced["port"][1]


def test_cli_quiet_level(traced):
    out, err = traced["quiet"]
    assert out == traced["port"][0]
    assert "[racon_tpu_torch::Polisher" not in err
    assert "=]" not in err and " s\n" not in err
    assert "pipeline stages" in traced["port"][1]


def test_cli_flags_parse_and_help(capsys):
    opts = cli.parse_args(["--cuda-pipeline-depth", "0", "--cuda-trace",
                           "t.json", "--cuda-metrics=m.json",
                           "--cuda-log-level", "debug", "--cuda-profile",
                           "prof", "a", "b", "c"])
    assert (opts["pipeline_depth"], opts["trace_path"], opts["metrics_path"],
            opts["log_level"], opts["profile_dir"]) == (
        0, "t.json", "m.json", "debug", "prof")
    assert cli.parse_args(["a", "b", "c"])["pipeline_depth"] == 2
    cli.parse_args(["--help"])
    help_text = capsys.readouterr().out
    for flag in ("--cuda-pipeline-depth", "--cuda-trace", "--cuda-metrics",
                 "--cuda-log-level", "--cuda-profile"):
        assert flag in help_text
    with pytest.raises(SystemExit):
        cli.parse_args(["--cuda-log-level", "loud", "a", "b", "c"])
