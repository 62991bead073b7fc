"""The port's batch runner (racon_tpu_torch/parallel/mesh.BatchRunner)
and the lane paths of its engines, against the JAX package's mesh
(racon_tpu/parallel/mesh.py, at its 8 virtual CPU devices from
tests/conftest.py).

On the CPU a runner's lanes are `[torch.device("cpu")] * N`: every lane
path runs for real, the kernels' plain versions in place of the kernels.
Covered: round_batch and the cached sub-runner of for_batch;
run_split's lane-order concatenation equal to the one-lane result; the
row interleave and the per-lane useful split against the JAX functions;
OccupancyStats.merge_from against the JAX one; the aligner's sub-runner
tail and its lane view (each bucket's per-lane useful cells sum to its
useful cells); and the polished FASTA of both device consensus engines
byte-identical at 1, 2 and 8 lanes and equal to the JAX package's at its
8 virtual devices. Inputs are made from seeds. Tolerance: none.

The `gpu`-marked test runs two lanes on one card; it skips without one.
"""

import ast
import random

import numpy as np
import pytest
import torch

from racon_tpu_torch.errors import DeviceError
from racon_tpu_torch.ops.device_program import shard_useful_split
from racon_tpu_torch.parallel.mesh import BatchRunner, concat
from racon_tpu_torch.sched import (BatchScheduler, OccupancyStats,
                                   shard_interleave)

CPU = torch.device("cpu")


def lanes(n):
    return BatchRunner([CPU] * n)


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -------------------------------------------------------------- the runner

def test_round_batch_and_cached_sub_runners():
    r = lanes(8)
    assert r.n_devices == 8
    assert [r.round_batch(b) for b in (1, 8, 9, 16, 17)] == [8, 8, 16, 16,
                                                             24]
    assert r.for_batch(8) is r and r.for_batch(20) is r
    sub = r.for_batch(3)
    assert sub.n_devices == 3 and sub.devices == [CPU] * 3
    assert r.for_batch(3) is sub  # cached
    assert lanes(1).for_batch(1).n_devices == 1
    with pytest.raises(DeviceError):
        BatchRunner([])


def test_runner_without_devices_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the runner takes it")
    with pytest.raises(DeviceError):
        BatchRunner()


@pytest.mark.parametrize("device, lanes", [
    ("cuda", ["cuda:0", "cuda:1"]), ("cuda:1", ["cuda:1"]),
    ("cpu", ["cpu"])])
def test_polisher_lanes_follow_the_named_device(monkeypatch, device, lanes):
    """With no device list, a bare 'cuda' takes every visible card, a
    named card runs alone on one lane, and the CPU is one lane. Two
    cards are stubbed: nothing here launches."""
    from racon_tpu_torch.core.polisher import Polisher, PolisherType

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    pol = Polisher(None, None, None, PolisherType.kC, 500, 10.0, 0.3, True,
                   3, -5, -4, 1, 0, True, 0, 0, device)
    assert pol.device_runner.devices == [torch.device(d) for d in lanes]


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_run_split_concatenation_equals_one_lane(n):
    """K1's plain version on a batch of jobs (synth.poa_jobs) split over
    n lanes: the lanes' outputs concatenated in lane order are the
    one-lane output; one call per lane is counted."""
    from racon_tpu_torch.ops.poa_kernels import window_sweep
    from racon_tpu_torch.synth import poa_jobs

    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            poa_jobs(3, 24, 96, 64, 4, (0, 32), far=20, pad_rows=2)]

    def fn(*a):
        return window_sweep(*a, 3, -5, -4)

    want = fn(*args)
    r = lanes(n)
    got = concat(r.run_split(fn, *args), CPU)
    assert torch.equal(got, want)
    assert r.lane_calls == [1] * n
    pair = concat(r.run_split(lambda x, y: (x + 1, y * 2), args[5],
                              args[6]), CPU)
    assert torch.equal(pair[0], args[5] + 1)
    assert torch.equal(pair[1], args[6] * 2)
    if n > 1:
        with pytest.raises(DeviceError):
            r.run_split(fn, *(a[:n + 1] for a in args))
    sub = r.for_batch(1)
    sub.run_split(lambda x: x, args[5][:1])
    assert r.lane_calls[0] == 3  # a sub-runner counts on its root's lanes
    r.reset_lane_calls()
    assert r.lane_calls == [0] * n


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_shard_interleave_and_useful_split_match_jax(n):
    pytest.importorskip("jax")
    from racon_tpu.ops.device_program import \
        shard_useful_split as jax_split
    from racon_tpu.sched import shard_interleave as jax_interleave

    rng = random.Random(n)
    for size in (0, 1, n, 2 * n, 5 * n + 3, 64):
        items = list(range(size))
        assert shard_interleave(items, n) == jax_interleave(items, n)
        cells = [rng.randrange(1000) for _ in items]
        rows = -(-size // n) * n
        assert (shard_useful_split(cells, rows, n)
                == jax_split(cells, rows, n))
        assert sum(shard_useful_split(cells, rows, n)) == sum(cells)


def test_occupancy_merge_from_matches_jax():
    """Counters add, per-lane lists add element-wise, descriptors take
    the last write, first-dispatch totals add — as the JAX merge does."""
    pytest.importorskip("jax")
    from racon_tpu.sched import OccupancyStats as JaxStats

    def fill(cls):
        a, b, merged = cls(), cls(), cls()
        a.record("eng", (64,), jobs=2, lanes=2, useful_cells=30,
                 total_cells=40, n_devices=2, shard_useful=[10, 20],
                 full_mesh_cells=40, dtype="int16")
        b.record("eng", (64,), jobs=3, lanes=4, useful_cells=50,
                 total_cells=80, n_devices=4, shard_useful=[5, 5, 20, 20],
                 full_mesh_cells=80, dtype="int32")
        b.record("other", (8, 8), jobs=1, lanes=1, useful_cells=3,
                 total_cells=9)
        a.record_compile("eng", 0.5)
        b.record_compile("eng", 0.25, count=2)
        merged.merge_from(a)
        merged.merge_from(b)
        return merged.snapshot()

    snap = fill(OccupancyStats)
    assert snap == fill(JaxStats)
    b = snap["eng"]["buckets"]["(64,)"]
    assert b["shard_useful"] == [15, 25, 20, 20]
    assert (b["jobs"], b["lanes"], b["n_devices"], b["dtype"]) == (5, 6, 4,
                                                                  "int32")
    assert snap["eng"]["compiles"] == 3


def test_aligner_sub_runner_tail_and_lane_view():
    """At 4 lanes, each (edge, band) group's body batches are multiples
    of 4 with their rows interleaved, its remainder one batch on a
    sub-runner with no padding lane; the runs are the one-lane runs;
    per bucket the lanes' useful cells sum to its useful cells, and the
    full-runner baseline counts the tail rounded up to 4 lanes."""
    from racon_tpu_torch.ops.align import BatchAligner
    from test_torch_align import run_lists
    from test_torch_sched import skewed_pairs

    pairs = skewed_pairs()
    want = run_lists(BatchAligner(band_width=64,
                                  device="cpu").align(list(pairs)))
    sched = BatchScheduler()
    al = BatchAligner(band_width=64, device="cpu", scheduler=sched,
                      runner=lanes(4))
    chunks = al.chunks(pairs)
    sizes = {}
    for edge, band, idx in chunks:
        sizes.setdefault((edge, band), []).append(len(idx))
    for group in sizes.values():
        assert all(s % 4 == 0 for s in group[:-1])
        assert sum(group) % 4 == 0 or group[-1] < 4
    assert any(s < 4 for group in sizes.values() for s in group)
    assert run_lists(al.align(list(pairs))) == want
    snap = sched.stats.snapshot()["aligner"]
    assert sum(snap["shard_useful"]) == snap["useful_cells"]
    for key, b in snap["buckets"].items():
        edge, band = ast.literal_eval(key)
        assert sum(b["shard_useful"]) == b["useful_cells"]
        n = sum(sizes[(edge, band)])
        assert b["lanes"] == n and b["jobs"] == n
        assert b["full_mesh_cells"] == -(-n // 4) * 4 * (2 * edge + 1) * band


# ---------------------------------------------- polished FASTA over lanes

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from test_pipeline import _synth_dataset

    return [str(p) for p in _synth_dataset(tmp_path_factory.mktemp("mesh"),
                                           random.Random(23))]


def polish(paths, engine, devices, adaptive=False):
    from racon_tpu_torch.core.polisher import PolisherType, create_polisher

    pol = create_polisher(*paths, PolisherType.kC, 500, 10.0, 0.3, True,
                          3, -5, -4, cuda_poa_batches=1,
                          cuda_aligner_batches=1, device="cpu",
                          cuda_engine=engine, cuda_fused="1",
                          devices=devices, adaptive_buckets=adaptive)
    pol.initialize()
    fasta = b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                     for s in pol.polish())
    return fasta, pol


@pytest.mark.parametrize("engine", ["session", "fused"])
def test_polished_fasta_identical_across_lanes_and_to_jax(synth, engine,
                                                          monkeypatch):
    """1, 2 and 8 CPU lanes (the scheduler on at 8) give the same FASTA,
    equal to the JAX CLI's at its 8 virtual devices; at 8 lanes every
    lane launched, and each bucket's per-lane useful cells sum to its
    useful cells."""
    pytest.importorskip("jax")
    from racon_tpu import cli as jax_cli
    from test_torch_fused_cli import run

    monkeypatch.delenv("RACON_TPU_MAX_DEVICES", raising=False)
    monkeypatch.setenv("RACON_TPU_STRICT", "1")
    monkeypatch.setenv("RACON_TPU_FUSED", "auto")
    import jax

    assert len(jax.devices()) == 8
    want, _ = run(jax_cli.main, ["-c", "1", "--tpualigner-batches", "1",
                                 "--tpu-engine", engine, "--tpu-fused", "1",
                                 *synth])
    one, _ = polish(synth, engine, [CPU])
    two, _ = polish(synth, engine, [CPU] * 2)
    eight, pol = polish(synth, engine, [CPU] * 8, adaptive=True)
    assert one.startswith(b">") and one == two == eight == want
    assert pol.device_runner.n_devices == 8
    assert min(pol.device_runner.lane_calls) > 0
    occ = pol.occupancy_stats
    assert {"aligner", engine} <= set(occ)
    for e in occ.values():
        for b in e["buckets"].values():
            assert sum(b["shard_useful"]) == b["useful_cells"]
            assert len(b["shard_useful"]) <= 8


# --------------------------------------------------------------- the card

@pytest.mark.gpu
def test_two_lanes_on_one_card_match_one_lane():
    """Two lanes on one card (each its own stream): K1 and K2 through
    run_split equal one launch on the whole batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from racon_tpu_torch.ops.align import BatchAligner
    from racon_tpu_torch.ops.align_kernels import wavefront_align
    from racon_tpu_torch.ops.poa_kernels import window_sweep
    from racon_tpu_torch.synth import poa_jobs
    from test_torch_sched import skewed_pairs

    dev = torch.device("cuda", 0)
    r = BatchRunner([dev, dev])
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            poa_jobs(4, 32, 768, 640, 8, (0, 256), far=150, pad_rows=1)]

    def k1(*a):
        return window_sweep(*a, 3, -5, -4)

    want = k1(*(a.to(dev) for a in args))
    assert torch.equal(concat(r.run_split(k1, *args), dev), want)
    assert r.lane_calls == [1, 1]
    pairs = skewed_pairs()[:8]
    al = BatchAligner(band_width=64, device=dev)
    host = al.host_operands(pairs, 4096, 64, list(range(8)))
    ops1, meta1 = wavefront_align(*(x.to(dev) for x in host), 64,
                                  packed=host[0].dtype == torch.uint8)
    ops2, meta2 = concat(r.run_split(
        lambda *a: wavefront_align(*a, 64,
                                   packed=host[0].dtype == torch.uint8),
        *host), dev)
    torch.cuda.synchronize()
    assert torch.equal(meta1, meta2)
    for k in range(8):
        n = int(meta1[k, 0])
        assert torch.equal(ops1[k, :n], ops2[k, :n])
