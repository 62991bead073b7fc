"""The port's async dispatch pipeline (racon_tpu_torch/pipeline) against
the JAX package's (racon_tpu/pipeline).

  - the mechanics of racon_tpu's tests/test_pipeline.py: stage order and
    stats at every depth, errors with and without a handler, a stage
    error in either worker aborting the run instead of hanging, a
    BaseException mid-run, the fallback pool, stats shared across
    pipelines, and overlap (shown with events, not a wall-clock margin);
  - the PipelineStats snapshot has the JAX keys;
  - BatchAligner.align at depth 0 and 2, with unbucketable and
    band-clipped pairs fed through `on_reject` into the fallback pool,
    gives the JAX BatchAligner's runs and reject set;
  - BatchPOA's host chunk loop at depth 0 and 2 gives the JAX host
    engine's consensus;
  - the CLI at `--cuda-pipeline-depth 0` and `2` writes the JAX CLI's
    FASTA at `--tpu-pipeline-depth 0` and `2`, for contig polishing
    (`-c 1 --cudaaligner-batches 1`) and fragment correction (`-f`).

Tolerance: none; every value compared is an integer or a byte.
"""

import io
import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from racon_tpu import cli as jax_cli  # noqa: E402
from racon_tpu.native import nw_cigar_batch as jax_nw_cigar_batch  # noqa: E402
from racon_tpu.pipeline import DispatchPipeline as JaxPipeline  # noqa: E402
from racon_tpu.pipeline import PipelineStats as JaxStats  # noqa: E402
from racon_tpu_torch import cli  # noqa: E402
from racon_tpu_torch.native import nw_cigar_batch  # noqa: E402
from racon_tpu_torch.pipeline import (DispatchPipeline,  # noqa: E402
                                      PipelineStats)
from racon_tpu_torch.synth import (align_pairs, ava_overlaps,  # noqa: E402
                                   simulate, simulate_truth, write_dataset,
                                   write_fragment_dataset)
from test_torch_align import run_lists  # noqa: E402

ACGT = b"ACGT"
SCORES = ["-m", "5", "-x", "-4", "-g", "-8"]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("RACON_TPU_MAX_DEVICES", "1")
    monkeypatch.setenv("RACON_TPU_STRICT", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- mechanics

@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_stage_order_and_stats(depth):
    """Items traverse pack -> dispatch -> wait -> unpack in order at every
    depth; unpack order equals dispatch order."""
    pl = DispatchPipeline(depth=depth)
    seen = []
    pl.run(range(9),
           pack=lambda i: i * 10,
           dispatch=lambda i, ops: ops + 1,
           wait=lambda h: h + 1,
           unpack=lambda i, r: seen.append((i, r)))
    pl.close()
    assert seen == [(i, i * 10 + 2) for i in range(9)]
    s = pl.stats.snapshot()
    assert s["chunks"] == 9 and s["errors"] == 0
    for k in ("pack_s", "device_s", "unpack_s", "fallback_s"):
        assert s[k] >= 0.0


def test_stats_keys_equal_jax():
    assert PipelineStats.KEYS == JaxStats.KEYS
    assert list(PipelineStats().snapshot()) == list(JaxStats().snapshot())


@pytest.mark.parametrize("depth", [0, 2])
def test_error_without_handler_propagates(depth):
    pl = DispatchPipeline(depth=depth)

    def bad_dispatch(i, ops):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        pl.run([1, 2], lambda i: i, bad_dispatch, lambda h: h,
               lambda i, r: None)
    pl.close()
    assert pl.stats.snapshot()["errors"] >= 1


@pytest.mark.parametrize("stage", ["pack", "dispatch", "wait", "unpack"])
@pytest.mark.parametrize("depth", [0, 1, 2])
def test_stage_error_aborts_run_without_hang(stage, depth):
    """A launch failure in dispatch or a decode error in the unpack
    worker (or a failure in pack or wait) reaches the caller and stops
    the run, also with many items behind it on full bounded queues."""
    pl = DispatchPipeline(depth=depth)
    done = []

    def maybe(name, i, value):
        if name == stage and i == 3:
            raise ValueError(f"{name} failed")
        return value

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match=f"{stage} failed"):
        pl.run(range(200),
               pack=lambda i: maybe("pack", i, i),
               dispatch=lambda i, ops: maybe("dispatch", i, ops),
               wait=lambda h: maybe("wait", h, h),
               unpack=lambda i, r: done.append(maybe("unpack", i, r)))
    assert time.perf_counter() - t0 < 30
    pl.close()
    assert 3 not in done and len(done) < 200
    assert pl.stats.snapshot()["errors"] >= 1


@pytest.mark.parametrize("depth", [0, 2])
def test_error_handler_skips_chunk_and_continues(depth):
    pl = DispatchPipeline(depth=depth)
    failed, done = [], []

    def dispatch(i, ops):
        if i == 3:
            raise RuntimeError("chunk 3 died")
        return ops

    pl.run(range(6), lambda i: i, dispatch, lambda h: h,
           lambda i, r: done.append(i),
           on_error=lambda i, exc: failed.append(i))
    pl.close()
    assert failed == [3]
    assert sorted(done) == [0, 1, 2, 4, 5]
    assert pl.stats.snapshot()["errors"] == 1


@pytest.mark.parametrize("depth", [0, 2])
def test_fallback_pool(depth):
    """submit_fallback runs host work concurrently (inline at depth 0);
    drain re-raises the first failure; map_fallback chunks; cancel
    abandons what has not started."""
    pl = DispatchPipeline(depth=depth)
    futs = [pl.submit_fallback(lambda k=k: k * k) for k in range(4)]
    pl.drain_fallback()
    assert [f.result() for f in futs] == [0, 1, 4, 9]

    bad = pl.submit_fallback(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        pl.drain_fallback()
    assert bad.exception() is not None
    pl.drain_fallback(ignore_errors=True)  # nothing pending: no-op
    assert pl.stats.snapshot()["fallback_s"] >= 0.0

    fb = pl.map_fallback(list(range(10)), lambda sub: [i * 2 for i in sub],
                         chunk=4)
    pl.drain_fallback()
    assert [len(sub) for sub, _ in fb] == [4, 4, 2]
    got = [x for sub, fut in fb for x in fut.result()]
    assert got == [i * 2 for i in range(10)]
    pl.close()


def test_cancel_fallback_abandons_queued_jobs():
    """cancel_fallback cancels the jobs not yet started and waits for
    the running one; the count lands in the stats."""
    pl = DispatchPipeline(depth=2, fallback_workers=1)
    release = threading.Event()
    running = pl.submit_fallback(lambda: release.wait(10))
    queued = [pl.submit_fallback(lambda: None) for _ in range(8)]
    threading.Timer(0.2, release.set).start()
    assert pl.cancel_fallback() == (8, 1)
    assert running.result() is True
    assert all(f.cancelled() for f in queued)
    assert pl.stats.snapshot()["cancelled"] == 8
    pl.close()


def test_base_exception_mid_run_does_not_hang():
    """A BaseException escaping the dispatch loop (the Ctrl-C shape) with
    both bounded queues full cleans up and re-raises promptly."""
    pl = DispatchPipeline(depth=1)

    def dispatch(i, ops):
        if i == 2:
            raise KeyboardInterrupt
        return ops

    t0 = time.perf_counter()
    with pytest.raises(KeyboardInterrupt):
        pl.run(range(50), lambda i: i, dispatch,
               lambda h: time.sleep(0.02), lambda i, r: None)
    assert time.perf_counter() - t0 < 10
    pl.close()


def test_stats_shared_across_pipelines():
    stats = PipelineStats()
    for depth in (0, 2):
        pl = DispatchPipeline(depth=depth, stats=stats)
        pl.run(range(3), lambda i: i, lambda i, o: o, lambda h: h,
               lambda i, r: None)
        pl.close()
    assert stats.snapshot()["chunks"] == 6


@pytest.mark.parametrize("depth", [1, 2])
def test_overlap_actually_happens(depth):
    """While chunk 0's wait blocks, the pack worker packs chunk 1 and
    the caller dispatches it: chunk 0's wait returns only once chunk 1
    was dispatched, which a synchronous pipeline could never do (its
    wait times out instead)."""
    dispatched = {i: threading.Event() for i in range(4)}
    seen = []

    def dispatch(i, ops):
        dispatched[i].set()
        return i

    def wait(h):
        if h + 1 in dispatched:
            seen.append(dispatched[h + 1].wait(10))
        return h

    pl = DispatchPipeline(depth=depth)
    pl.run(range(4), lambda i: i, dispatch, wait, lambda i, r: None)
    pl.close()
    assert seen == [True, True, True]


def test_synchronous_path_does_not_overlap():
    dispatched = {i: threading.Event() for i in range(2)}
    seen = []
    pl = DispatchPipeline(depth=0)
    pl.run(range(2), lambda i: i,
           lambda i, ops: dispatched[i].set() or i,
           lambda h: seen.append(h + 1 in dispatched
                                 and dispatched[h + 1].wait(0.05)) or h,
           lambda i, r: None)
    assert seen == [False, False]


# ------------------------------------------------------------- aligner

def _pairs():
    """16 mutated pairs in the 512 bucket, synth.align_pairs' band-edge
    pairs (band-clipped at band 64), one pair with an empty query and one
    beyond the largest bucket (both unbucketable)."""
    rng = np.random.default_rng(7)
    bases = np.frombuffer(ACGT, np.uint8)

    def rand(n):
        return bytes(rng.choice(bases, n))

    def mut(seq):
        out = bytearray()
        for ch in seq:
            r = rng.random()
            if r < 0.03:
                continue
            out.append(int(bases[rng.integers(4)]) if r < 0.08 else ch)
            if rng.random() < 0.03:
                out.append(int(bases[rng.integers(4)]))
        return bytes(out)

    pairs = []
    for _ in range(16):
        t = rand(int(rng.integers(200, 480)))
        pairs.append((mut(t), t))
    pairs += align_pairs(5, 512, 64, ("band_edge",))
    pairs.append((b"", rand(300)))
    pairs.append((rand(70000), rand(69000)))
    return pairs


def _align(aligner, pairs, pl, cigars):
    fb = []

    def on_reject(idxs):
        fb.extend(pl.map_fallback(idxs, lambda sub: cigars(
            [pairs[i] for i in sub], n_threads=2)))

    runs = aligner.align(list(pairs), pipeline=pl, on_reject=on_reject)
    pl.drain_fallback()
    pl.close()
    rejected = sorted(i for sub, _ in fb for i in sub)
    fallback = {i: c for sub, fut in fb for i, c in zip(sub, fut.result())}
    return runs, rejected, fallback


def test_aligner_depths_match_jax_with_reject_fallback():
    """The port's BatchAligner through the pipeline at depth 0 and 2:
    the same runs, the same rejects (fed by on_reject into the fallback
    pool, which host-aligns them) as the JAX BatchAligner at depth 0."""
    from racon_tpu.ops.align import BatchAligner as JaxAligner

    from racon_tpu_torch.ops.align import BatchAligner

    pairs = _pairs()
    want = _align(JaxAligner(band_width=64), pairs, JaxPipeline(depth=0),
                  jax_nw_cigar_batch)
    n = len(pairs)
    assert {n - 2, n - 1} <= set(want[1])  # unbucketable
    assert set(want[1]) & set(range(16, n - 2))  # band-clipped
    for depth in (0, 2):
        al = BatchAligner(band_width=64, device="cpu")
        stats = PipelineStats()
        got = _align(al, pairs, DispatchPipeline(depth=depth, stats=stats),
                     nw_cigar_batch)
        assert (run_lists(got[0]), *got[1:]) == want, depth
        assert al.n_unbucketed == 2 and al.n_band_rejects >= 1
        snap = stats.snapshot()
        assert snap["launches"] == snap["chunks"] >= 1
        # every pair has device runs xor a fallback CIGAR
        for i in range(n):
            assert (got[0][i] is not None) != (i in got[2])


# ------------------------------------------------------------- host POA

def _mutate(rng, s, rate):
    out = bytearray()
    for c in s:
        r = rng.random()
        if r < rate / 3:
            continue
        if r < 2 * rate / 3:
            out.append(rng.choice(ACGT))
            out.append(c)
            continue
        out.append(rng.choice(ACGT) if r < rate else c)
    return bytes(out)


def _windows(window_cls, type_cls, seed):
    rng = random.Random(seed)
    windows = []
    for _ in range(12):
        truth = bytes(rng.choice(ACGT) for _ in range(220))
        bb = _mutate(rng, truth, 0.1)
        w = window_cls(0, 0, type_cls.kTGS, bb, b"!" * len(bb))
        for _ in range(6):
            w.add_layer(_mutate(rng, truth, 0.1) or b"A", None, 0,
                        len(bb) - 1)
        windows.append(w)
    return windows


def test_host_poa_depths_byte_identical_to_jax():
    """BatchPOA's host chunk loop (4 windows a chunk, so 3 chunks) at
    depth 0 and 2: the JAX host engine's consensus and polished flags."""
    from racon_tpu.core.window import Window as JaxWindow
    from racon_tpu.core.window import WindowType as JaxType
    from racon_tpu.ops.poa import BatchPOA as JaxPOA

    from racon_tpu_torch.core.window import Window, WindowType
    from racon_tpu_torch.ops.poa import BatchPOA

    jw = _windows(JaxWindow, JaxType, 17)
    JaxPOA(3, -5, -4, 220, num_threads=2).generate_consensus(jw, trim=True)
    want = [(w.consensus, w.polished) for w in jw]
    for depth in (0, 2):
        pw = _windows(Window, WindowType, 17)
        with DispatchPipeline(depth=depth) as pl:
            eng = BatchPOA(3, -5, -4, 220, num_threads=2, device="cpu",
                           pipeline=pl, host_chunk=4)
            eng.generate_consensus(pw, trim=True)
            stats = pl.stats.snapshot()
        assert stats["chunks"] == stats["launches"] == 3
        assert [(w.consensus, w.polished) for w in pw] == want, depth


# ------------------------------------------------------------- whole run

def run(main, argv):
    """Call a CLI's main; returns its stdout bytes."""
    buf = io.BytesIO()
    text = io.TextIOWrapper(buf)
    out, err = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = text, io.StringIO()
    try:
        rc = main(argv)
        text.flush()
    finally:
        sys.stdout, sys.stderr = out, err
    assert rc == 0, main
    return buf.getvalue()


@pytest.fixture(scope="module")
def contig(tmp_path_factory):
    _, draft, reads, paf = simulate(random.Random(3), 2500, 6, 1500, 0.12,
                                    0.10)
    return write_dataset(str(tmp_path_factory.mktemp("contig")), draft,
                         reads, paf)


@pytest.fixture(scope="module")
def fragment(tmp_path_factory):
    _, _, reads, _ = simulate_truth(random.Random(3), 2500, 4, 1500, 0.12,
                                    0.10)
    return write_fragment_dataset(str(tmp_path_factory.mktemp("frag")),
                                  reads, ava_overlaps(reads))


@pytest.mark.parametrize("kind,flags", [
    ("contig", ["-c", "1", "--cudaaligner-batches", "1"]),
    ("fragment", ["-f", "-c", "0", "--cudaaligner-batches", "1"]),
])
@pytest.mark.parametrize("depth", ["0", "2"])
def test_cli_depths_byte_identical_to_jax(request, kind, flags, depth):
    paths = request.getfixturevalue(kind)
    jax_flags = [f.replace("--cuda", "--tpu") for f in flags]
    want = run(jax_cli.main, [*jax_flags, "--tpu-pipeline-depth", depth,
                              *SCORES, *paths])
    got = run(cli.main, ["--device", "cpu", *flags, "--cuda-pipeline-depth",
                         depth, *SCORES, *paths])
    assert got.startswith(b">")
    assert got == want
