"""Warm reuse and progress of the port's Polisher against the JAX package.

On a 3 kb draft at 8x with 2 kb reads (seed 7), and its two-contig twin
(seeds 7 and 8):

  - a polisher rebound to the same triple writes the FASTA of its first,
    fresh run, which equals the JAX package's (`-c 1
    --cudaaligner-batches 1`: the kernels' plain versions against the
    XLA programs, RACON_TPU_STRICT=1); rebound across triples (twin,
    tiny, twin) each run equals a fresh JAX run of its triple;
  - the counters of a run describe that run alone: aligner pairs, the
    pipeline's chunks and launches, the scheduler's occupancy, the phase
    walls and the logger's total;
  - rebind raises while windows are pending;
  - progress events: per phase, `done` and `total` never decrease and
    end at done == total; the sequence equals the JAX polisher's; a hook
    that raises changes no byte.

Tolerance: zero, every value is an integer or a byte.
"""

import gzip
import os
import random

import pytest
import torch

jax = pytest.importorskip("jax")

from racon_tpu.core import polisher as jax_polisher  # noqa: E402
from racon_tpu_torch.core.polisher import (PolisherType,  # noqa: E402
                                           create_polisher)
from racon_tpu_torch.errors import RaconError  # noqa: E402
from racon_tpu_torch.synth import simulate, write_dataset  # noqa: E402

SCORES = (5, -4, -8)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("RACON_TPU_MAX_DEVICES", "1")
    monkeypatch.setenv("RACON_TPU_STRICT", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_twin(directory, seeds=(7, 8)):
    """Two contigs (`ctg<seed>`), each simulated as the tiny set is, with
    their reads and overlaps in one triple."""
    drafts, reads, paf = [], [], []
    for seed in seeds:
        _, draft, rs, rows = simulate(random.Random(seed), 3000, 8, 2000,
                                      0.12, 0.10)
        drafts.append((f"ctg{seed}", draft))
        reads += [(f"s{seed}_{name}", seq) for name, seq in rs]
        for row in rows:
            f = row.split("\t")
            f[0], f[5] = f"s{seed}_{f[0]}", f"ctg{seed}"
            paf.append("\t".join(f))
    paths = (os.path.join(directory, "reads.fasta.gz"),
             os.path.join(directory, "ovl.paf.gz"),
             os.path.join(directory, "draft.fasta.gz"))
    with gzip.open(paths[0], "wb") as fh:
        for name, seq in reads:
            fh.write(b">%s\n%s\n" % (name.encode(), seq))
    with gzip.open(paths[1], "wt") as fh:
        fh.write("\n".join(paf) + "\n")
    with gzip.open(paths[2], "wb") as fh:
        for name, seq in drafts:
            fh.write(b">%s\n%s\n" % (name.encode(), seq))
    return paths


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny")
    _, draft, reads, paf = simulate(random.Random(7), 3000, 8, 2000, 0.12,
                                    0.10)
    return write_dataset(str(d), draft, reads, paf)


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    return write_twin(str(tmp_path_factory.mktemp("twin")))


def port(paths, poa=0, aligner=0, **kw):
    return create_polisher(*paths, PolisherType.kC, 500, 10.0, 0.3, True,
                           *SCORES, cuda_poa_batches=poa,
                           cuda_aligner_batches=aligner, device="cpu", **kw)


def run(pol):
    pol.initialize()
    return [(s.name, s.data) for s in pol.polish()]


def jax_run(paths, poa=0, aligner=0, hook=None):
    pol = jax_polisher.create_polisher(
        *paths, jax_polisher.PolisherType.kC, 500, 10.0, 0.3, True,
        *SCORES, tpu_poa_batches=poa, tpu_aligner_batches=aligner)
    pol.progress_hook = hook
    return run(pol)


def counters(pol) -> dict:
    st = pol.stage_stats
    return {"pairs": pol.n_aligner_pairs, "device": pol.n_aligner_device,
            "host": pol.n_aligner_host_fallback, "chunks": st["chunks"],
            "launches": st["launches"], "windows": pol.poa.n_device,
            "occupancy": {e: (v["useful_cells"], v["total_cells"])
                          for e, v in pol.occupancy_stats.items()},
            "phases": sorted(pol.phase_s), "targets": pol.n_targets,
            # first dispatches of a shape ("compile.*") happen once a
            # process, so a warm run has none
            "latency": {k: v["count"]
                        for k, v in pol.hists.snapshot().items()
                        if not k.startswith("compile.")}}


@pytest.fixture(scope="module")
def device_runs(tiny):
    """A fresh polisher's run at the device posture, the same polisher
    rebound to the same triple and run again, and the JAX run."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RACON_TPU_MAX_DEVICES", "1")
        mp.setenv("RACON_TPU_STRICT", "1")
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            pol = port(tiny, 1, 1)
            first = run(pol)
            c1 = counters(pol)
            logger1 = pol.logger
            pol.rebind(*tiny)
            assert pol.n_aligner_pairs == 0 and pol.phase_s == {}
            second = run(pol)
            c2 = counters(pol)
            loggers = (logger1, pol.logger)
            want = jax_run(tiny, 1, 1)
        finally:
            torch.set_num_threads(threads)
    return first, second, want, (c1, c2), loggers


def test_rebind_equals_fresh_and_jax(device_runs):
    first, second, want, _, _ = device_runs
    assert first[0][0].startswith("draft LN:i:")
    assert second == first == want


def test_per_run_counters_are_not_cumulative(device_runs):
    _, _, _, (c1, c2), (logger1, logger2) = device_runs
    assert c1["pairs"] == c1["device"] > 0 and c1["chunks"] > 0
    assert c1["windows"] > 0
    assert c2 == c1
    # each run has a logger of its own, whose total times that run alone
    assert logger2 is not logger1
    assert logger1._total > 0 and logger2._total > 0


def test_rebind_across_triples_equals_fresh_jax(tiny, twin):
    pol = port(twin)
    for paths in (twin, tiny, twin):
        got = run(pol)
        assert got == jax_run(paths)
        assert pol.n_targets == (2 if paths is twin else 1)
        pol.rebind(*(tiny if paths is twin else twin))
    assert [name.split()[0] for name, _ in jax_run(twin)] == ["ctg7",
                                                              "ctg8"]


def test_rebind_raises_mid_run(tiny):
    pol = port(tiny)
    pol.initialize()
    assert pol.windows
    with pytest.raises(RaconError, match="cannot rebind mid-run"):
        pol.rebind(*tiny)
    out = pol.polish()
    assert pol.rebind(*tiny) is pol
    assert [(s.name, s.data) for s in out] == run(pol)


def check_monotone(events):
    last = {}
    for ev in events:
        d, t = ev["done"], ev["total"]
        assert 0 <= d <= t
        pd, pt = last.get(ev["phase"], (0, 0))
        assert d >= pd and t >= pt, (ev, last)
        last[ev["phase"]] = (d, t)
    return last


def test_progress_events_match_jax(tiny):
    events, jax_events = [], []
    pol = port(tiny, aligner=1)
    pol.progress_hook = events.append
    got = run(pol)
    assert got == jax_run(tiny, aligner=1, hook=jax_events.append)
    last = check_monotone(events)
    assert set(last) == {"align", "consensus", "stitch"}
    assert all(d == t > 0 for d, t in last.values())
    assert events[-1] == {"phase": "stitch", "done": 6, "total": 6,
                          "sequences": 1}

    def bare(evs):
        return [{k: v for k, v in e.items() if k != "occupancy"}
                for e in evs]

    assert bare(events) == bare(jax_events)
    assert [e for e in events if "occupancy" in e]
    # a second run of the same polisher starts its phases from zero
    pol.rebind(*tiny)
    events.clear()
    assert run(pol) == got
    assert bare(events) == bare(jax_events)


def test_raising_progress_hook_changes_nothing(tiny, twin):
    calls = []

    def hook(ev):
        calls.append(ev)
        raise RuntimeError("hook failed")

    for paths in (tiny, twin):
        calls.clear()
        pol = port(paths, aligner=1)
        pol.progress_hook = hook
        assert run(pol) == jax_run(paths, aligner=1)
        assert len(calls) > 10
        assert all(d == t for d, t in check_monotone(calls).values())
