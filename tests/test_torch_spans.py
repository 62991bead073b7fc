"""The port's one span API (racon_tpu_torch/obs/trace.py) on the CPU:

  - its three sinks: `into` totals with tracing off, the Chrome event
    only while a recorder is armed, a `torch.profiler` range on the
    profiler's clock (laid over the recorder's events through the saved
    `baseTimeNanoseconds`), and nothing at all when no sink is on;
  - a worker thread's span in `obs.torch_profile`'s capture, where the
    installed torch accepts `profile_all_threads`;
  - a tiny `--device cpu` polisher run: `Polisher.span_s` holds every
    initialize() step and the session engine's poa.sync / poa.fetch,
    each within its phase, equal to its Chrome events' summed durations,
    and reset by a warm reuse;
  - every sink of one span under each way of arming a recorder, on a
    normal and on an exceptional exit.

Imports no JAX.
"""

import json
import os
import random
import subprocess
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from racon_tpu_torch import obs
from racon_tpu_torch.core.polisher import PolisherType, create_polisher
from racon_tpu_torch.obs import trace
from racon_tpu_torch.synth import simulate, write_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: initialize()'s steps, by the phase_s entry that holds each
INIT_STEPS = ("polisher.load_targets", "polisher.load_sequences",
              "polisher.load_overlaps", "polisher.transmute",
              "polisher.windows", "polisher.layers")
ALIGN_STEPS = ("align.pairs", "pipeline.drain_fallback", "align.runs",
               "polisher.breaking_points")
CONSENSUS_STEPS = ("poa.sync", "poa.fetch")


@pytest.fixture(autouse=True)
def _disarmed():
    trace.reset()
    yield
    trace.reset()


def _sleep_span(name, **kw):
    with trace.span(name, **kw):
        time.sleep(0.002)


# ------------------------------------------------------------ the sinks

def test_into_is_filled_with_tracing_off():
    totals = {}
    _sleep_span("spans.a", into=totals)
    _sleep_span("spans.a", into=totals)
    _sleep_span("spans.b", into=totals)
    assert set(totals) == {"spans.a", "spans.b"}
    assert totals["spans.a"] >= 0.004 and totals["spans.b"] >= 0.002
    assert trace.get_tracer() is None
    into = {"spans.a": 1.0}
    trace.add_totals(into, totals)
    assert into == {"spans.a": 1.0 + totals["spans.a"],
                    "spans.b": totals["spans.b"]}


def test_span_api_loads_no_torch():
    """The serve client's commands import the tracer; a span looks torch's
    profiler up only once torch is loaded."""
    code = ("import sys; from racon_tpu_torch.obs import trace; "
            "from racon_tpu_torch.serve import client; "
            "d = {}\n"
            "with trace.span('x', into=d): pass\n"
            "assert 'x' in d and 'torch' not in sys.modules")
    got = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert got.returncode == 0, got.stderr


def test_nothing_recorded_when_no_sink_is_on():
    a, b = trace.span("spans.a"), trace.span("spans.b", k=1)
    # one shared no-op: no recorder, no `into`, no profiler
    assert a is b
    with a as sp:
        sp.set(done=True)
    assert trace.get_tracer() is None


def test_chrome_event_only_when_armed():
    rec = trace.configure(None)
    totals = {}
    with trace.span("spans.armed", into=totals, k=1) as sp:
        sp.set(late=2)
    trace.reset()
    _sleep_span("spans.disarmed", into=totals)
    xs = [e for e in rec.events() if e["ph"] == "X"]
    assert [e["name"] for e in xs] == ["spans.armed"]
    assert xs[0]["args"] == {"k": 1, "late": 2}
    assert abs(xs[0]["dur"] / 1e6 - totals["spans.armed"]) < 1e-6
    assert set(totals) == {"spans.armed", "spans.disarmed"}


def test_span_is_a_profiler_range_on_the_wall_clock(tmp_path):
    rec = trace.configure(str(tmp_path / "t.json"))
    # a rebase keeps the epoch base on the same instant
    before = rec.base_ns
    rec.rebase(rec._base - 0.5)
    assert rec.base_ns == before - 500_000_000
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # a process's first range resolves its profiler op (about 2 ms,
        # between the range's start and the span's own clock reading)
        _sleep_span("spans.warm")
        _sleep_span("spans.main", k=1)
    mine = json.load(open(trace.save()))
    kineto_path = str(tmp_path / "k.json")
    prof.export_chrome_trace(kineto_path)
    theirs = json.load(open(kineto_path))

    def wall_us(doc, name):
        ev = next(e for e in doc["traceEvents"]
                  if e.get("name") == name and e.get("ph") == "X")
        start = doc["baseTimeNanoseconds"] / 1e3 + ev["ts"]
        return start, start + ev["dur"]

    assert any(e.name == "spans.main" for e in prof.events())
    for a, b in zip(wall_us(mine, "spans.main"),
                    wall_us(theirs, "spans.main")):
        assert abs(a - b) < 1000.0


def test_worker_thread_span_in_torch_profile(tmp_path):
    if not obs._all_threads():
        pytest.skip("this torch has no profile_all_threads")
    done = []

    def work():
        _sleep_span("spans.worker")
        done.append(True)

    with obs.torch_profile(str(tmp_path), "phase"):
        t = threading.Thread(target=work, name="spans-worker")
        t.start()
        t.join(30)
        assert not t.is_alive() and done
        _sleep_span("spans.main")
    doc = json.load(open(tmp_path / "phase.json"))
    tids = {e["name"]: e["tid"] for e in doc["traceEvents"]
            if e.get("ph") == "X" and e.get("name", "").startswith("spans.")}
    assert set(tids) == {"spans.worker", "spans.main"}
    assert tids["spans.worker"] != tids["spans.main"]


@pytest.mark.parametrize("arming", ["off", "configured", "scoped",
                                    "scoped_in_configured"])
def test_every_sink_under_each_arming(arming):
    """`into`, each armed recorder (a scope over an armed recorder tees to
    both) and the profiler range all see a span, also one whose body
    raises."""
    outer = trace.configure(None) if arming in (
        "configured", "scoped_in_configured") else None
    scope = trace.scoped() if arming.startswith("scoped") else None
    inner = scope.__enter__() if scope is not None else None
    totals = {}
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _sleep_span("spans.ok", into=totals, k=1)
            with pytest.raises(ValueError):
                with trace.span("spans.raised", into=totals):
                    raise ValueError("body")
    finally:
        if scope is not None:
            scope.__exit__(None, None, None)
    assert trace.get_tracer() is outer
    assert set(totals) == {"spans.ok", "spans.raised"}
    assert totals["spans.ok"] >= 0.002
    ranges = {e.name for e in prof.events()}
    assert {"spans.ok", "spans.raised"} <= ranges
    for rec in (outer, inner):
        if rec is None:
            continue
        xs = {e["name"]: e for e in rec.events() if e["ph"] == "X"}
        assert set(xs) == {"spans.ok", "spans.raised"}
        assert xs["spans.ok"]["args"] == {"k": 1}
        assert abs(xs["spans.ok"]["dur"] / 1e6 - totals["spans.ok"]) < 1e-6


# -------------------------------------------------- the polisher's totals

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    _, draft, reads, paf = simulate(random.Random(5), 2000, 5, 700, 0.12,
                                    0.10)
    return write_dataset(str(d), draft, reads, paf)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_polisher_span_s(dataset, one_thread):
    pol = create_polisher(*dataset, PolisherType.kC, 500, 10.0, 0.3, True,
                          3, -5, -4, 1, device="cpu", cuda_poa_batches=1,
                          cuda_aligner_batches=1)
    rec = trace.configure(None)
    pol.initialize()
    pol.polish()
    trace.reset()
    span_s, phase_s = dict(pol.span_s), pol.phase_s
    assert set(span_s) == set(INIT_STEPS + ALIGN_STEPS + CONSENSUS_STEPS)
    assert all(v >= 0.0 for v in span_s.values())
    for steps, phase in ((INIT_STEPS, "initialize"), (ALIGN_STEPS, "align"),
                         (CONSENSUS_STEPS, "consensus")):
        for k in steps:
            assert span_s[k] <= phase_s[phase], k
        assert sum(span_s[k] for k in steps) <= phase_s[phase], phase
    assert (sum(span_s[k] for k in INIT_STEPS) + phase_s["align"]
            <= phase_s["initialize"])
    # the same endpoints as the Chrome events
    sums = {}
    for e in rec.events():
        if e["ph"] == "X":
            sums[e["name"]] = sums.get(e["name"], 0.0) + e["dur"] / 1e6
    for k, v in span_s.items():
        assert abs(sums[k] - v) <= 0.01 * v + 1e-6, k
    assert {"poa.wait", "align.kernel", "align.launch", "align.account",
            "pipeline.wait_pack", "pipeline.join", "polisher.initialize",
            "polisher.consensus"} <= set(sums)
    # a warm reuse reports its own run only
    pol.span_s["sentinel"] = 1.0
    pol.initialize()
    pol.polish()
    assert set(pol.span_s) == set(span_s)
