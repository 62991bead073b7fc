"""The fault grid's knobs and its one-shot cells in the port
(racon_tpu_torch/tools/faultcheck.py), against the JAX package, on the
CPU.

Inputs: faultcheck's seeded dataset (`make_dataset`, rng 11: a 2 kb
draft, 400 bp reads and two 1,300 bp reads), torch at one thread, every
winner table a fresh path. Tolerance: none; every value held is a byte,
an integer, a type or a cell verdict. The `device_s` floor is a lower
bound: sleeping at least the floor per chunk.

What is held:

  - `make_dataset` writes JAX `tools/faultcheck.py`'s files byte for byte
    (their gzip payloads: a gzip header stamps the time of writing);
  - the aligner's `max_length`: at 1024 the port writes the JAX
    package's bytes at `RACON_TPU_ALIGNER_MAXLEN=1024` and counts the
    same device and host-fallback pairs (the two 1,300 bp reads leave
    the device), and the device aligner's buckets stop at the envelope;
  - the simulated device latency and the host POA chunk: with
    `device_latency_s`, `device_latency_x` and `host_poa_chunk` on, the
    port writes the JAX package's bytes at the same environment knobs,
    runs the same number of host POA chunks, and `device_s` grows by at
    least the floor a chunk; a bad value raises RaconError as JAX's
    does;
  - the clean bytes at pipeline depths 0 and 2 with the aligner off and
    on equal JAX faultcheck's `polish` at the same settings;
  - each quick row in the `depth0` and `depth2` columns is green under
    the port's contract (the typed error, the fault fired, no orphan
    thread, a clean run after it). The other columns are held in
    tests/test_torch_faultcheck_cells.py, ..._fused_*.py and
    ..._serve.py.
"""

import gzip
import importlib
import os
import random
import sys

import pytest
import torch

from racon_tpu_torch.core.polisher import PolisherType, create_polisher
from racon_tpu_torch.errors import RaconError
from racon_tpu_torch.ops.align import BatchAligner
from racon_tpu_torch.ops.poa import BatchPOA
from racon_tpu_torch.pipeline import DispatchPipeline
from racon_tpu_torch.sched.autotune import reset_autotuner_cache
from racon_tpu_torch.tools import faultcheck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICK = [m for m in faultcheck.MATRIX if not m[3]]


def jax_tool(name: str):
    """A script of the JAX package's tools/ directory, as a module."""
    pytest.importorskip("jax")
    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module(name)


@pytest.fixture(scope="module", autouse=True)
def _env(tmp_path_factory):
    table = str(tmp_path_factory.mktemp("autotune") / "jax.json")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RACON_TPU_MAX_DEVICES", "1")
        mp.setenv("RACON_TPU_AUTOTUNE_CACHE", table)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        reset_autotuner_cache()
        yield
        reset_autotuner_cache()
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return faultcheck.make_dataset(str(tmp_path_factory.mktemp("fc")),
                                   random.Random(11))


@pytest.fixture(scope="module")
def grid(paths, tmp_path_factory):
    g = faultcheck.Grid(paths, "cpu",
                        str(tmp_path_factory.mktemp("tbl") / "cold.json"))
    assert g.clean_gates(columns=("depth0", "depth2")) == []
    return g


def port_polisher(paths, **kw):
    kw.setdefault("num_threads", 2)
    return create_polisher(*paths, PolisherType.kC, 500, -1.0, 0.3,
                           device="cpu", **kw)


def jax_polisher(paths, **kw):
    from racon_tpu.core.polisher import PolisherType as JType
    from racon_tpu.core.polisher import create_polisher as jcreate

    kw.setdefault("num_threads", 2)
    return jcreate(*paths, JType.kC, 500, -1.0, 0.3, **kw)


def run(p) -> bytes:
    p.initialize()
    return faultcheck.fasta(p.polish())


# ---------------------------------------------------------------- dataset
def test_make_dataset_matches_jax(paths, tmp_path):
    jfc = jax_tool("faultcheck")
    theirs = jfc.make_dataset(str(tmp_path), random.Random(11))
    for ours, want in zip(paths, theirs):
        assert os.path.basename(ours) == os.path.basename(want)
        with gzip.open(ours) as a, gzip.open(want) as b:
            assert a.read() == b.read()


# ------------------------------------------------------------ max_length
def test_aligner_max_length_matches_jax(paths, monkeypatch):
    pytest.importorskip("jax")
    ours = port_polisher(paths, cuda_aligner_batches=1,
                         aligner_max_length=1024)
    got = run(ours)
    monkeypatch.setenv("RACON_TPU_ALIGNER_MAXLEN", "1024")
    theirs = jax_polisher(paths, tpu_aligner_batches=1)
    want = run(theirs)
    assert got == want
    assert (ours.n_aligner_device, ours.n_aligner_host_fallback) == \
        (theirs.n_aligner_device, theirs.n_aligner_host_fallback)
    # the two 1,300 bp reads (and nothing else) left the device
    assert ours.n_aligner_host_fallback == 2
    assert ours.aligner.n_unbucketed == 2


def test_aligner_max_length_bounds_the_buckets():
    al = BatchAligner(device="cpu", max_length=1024)
    assert [al._bucket_of(n) for n in (400, 512, 513, 1024, 1025)] == \
        [512, 512, 1024, 1024, None]
    assert BatchAligner(device="cpu")._bucket_of(65536) == 65536
    # an envelope below the smallest edge leaves every pair to the host
    assert BatchAligner(device="cpu", max_length=500)._bucket_of(10) is None


@pytest.mark.parametrize("passed", [None, 1024])
def test_knob_defaults_are_the_engines_own(paths, passed):
    """The layers that only pass the envelope and the host chunk on keep
    None, so each default is the engine's: BatchAligner.BUCKETS[-1] and
    BatchPOA.HOST_CHUNK."""
    from racon_tpu_torch.serve.server import ServeConfig

    p = port_polisher(paths, cuda_aligner_batches=1,
                      aligner_max_length=passed, host_poa_chunk=passed)
    run(p)
    want = BatchAligner.BUCKETS[-1] if passed is None else passed
    assert p.aligner.max_length == want
    poa = BatchPOA(5, -4, -8, 500, device="cpu", host_chunk=passed)
    assert poa.host_chunk == (BatchPOA.HOST_CHUNK if passed is None
                              else passed)
    cfg = ServeConfig(aligner_max_length=passed, host_poa_chunk=passed)
    assert (cfg.aligner_max_length, cfg.host_poa_chunk) == (passed, passed)


# ----------------------------------------------- simulated device latency
KNOBS = {"device_latency_s": 0.05, "device_latency_x": 0.5,
         "host_poa_chunk": 2}


def test_latency_knobs_keep_bytes_and_pace_chunks(paths, monkeypatch):
    pytest.importorskip("jax")
    base = port_polisher(paths)
    clean = run(base)
    ours = port_polisher(paths, **KNOBS)
    assert run(ours) == clean
    monkeypatch.setenv("RACON_TPU_DEVICE_LATENCY_S", "0.05")
    monkeypatch.setenv("RACON_TPU_DEVICE_LATENCY_X", "0.5")
    monkeypatch.setenv("RACON_TPU_HOST_POA_CHUNK", "2")
    theirs = jax_polisher(paths)
    assert run(theirs) == clean
    mine, jax_stats = ours.stage_stats, theirs.stage_stats
    # 4 windows in host POA chunks of 2: the same chunks as JAX's
    assert mine["chunks"] == jax_stats["chunks"] == 2
    assert base.stage_stats["chunks"] == 1
    assert mine["device_s"] >= mine["chunks"] * KNOBS["device_latency_s"]
    assert mine["device_s"] > base.stage_stats["device_s"]


def test_latency_floor_charged_per_chunk_at_both_depths():
    items = list(range(5))
    for depth in (0, 2):
        with DispatchPipeline(depth=depth, device_latency_s=0.02) as pl:
            out = []
            pl.run(items, lambda x: x, lambda x, o: o, lambda h: h,
                   lambda x, r: out.append(r))
            snap = pl.stats.snapshot()
        assert out == items
        assert snap["chunks"] == 5 and snap["device_s"] >= 5 * 0.02


@pytest.mark.parametrize("value", [-1, -0.5, "x"])
def test_bad_latency_raises_as_jax(value, monkeypatch):
    jpipe = pytest.importorskip("racon_tpu.pipeline")
    for key, env in (("device_latency_s", "RACON_TPU_DEVICE_LATENCY_S"),
                     ("device_latency_x", "RACON_TPU_DEVICE_LATENCY_X")):
        with pytest.raises(RaconError):
            DispatchPipeline(**{key: value})
        monkeypatch.setenv(env, str(value))
        with pytest.raises(jpipe.RaconError):
            jpipe.DispatchPipeline()
        monkeypatch.delenv(env)


@pytest.mark.parametrize("value", [0, -3, "many"])
def test_bad_host_chunk_raises_as_jax(value, monkeypatch):
    jpoa = pytest.importorskip("racon_tpu.ops.poa")
    from racon_tpu.errors import RaconError as JaxRaconError

    with pytest.raises(RaconError):
        BatchPOA(3, -5, -4, 500, device="cpu", host_chunk=value)
    monkeypatch.setenv("RACON_TPU_HOST_POA_CHUNK", str(value))
    with pytest.raises(JaxRaconError):
        jpoa.BatchPOA(3, -5, -4, 500)._host_chunk()


# ------------------------------------------------------------ clean bytes
@pytest.mark.parametrize("depth,aligner", [(0, 0), (0, 1), (2, 0), (2, 1)])
def test_clean_bytes_match_jax(grid, paths, depth, aligner, monkeypatch):
    jfc = jax_tool("faultcheck")
    monkeypatch.setenv("RACON_TPU_ALIGNER_MAXLEN", "1024")
    assert grid.clean[depth, aligner] == jfc.polish(paths, depth, aligner,
                                                    0.0)[0]


# ------------------------------------------------------- one-shot cells
@pytest.mark.parametrize("column", ["depth0", "depth2"])
@pytest.mark.parametrize("name,aligner,spec", [m[:3] for m in QUICK],
                         ids=[m[0] for m in QUICK])
def test_one_shot_cell(grid, column, name, aligner, spec):
    cell = faultcheck.run_cell(grid, column, aligner, spec)
    assert cell.startswith("pass"), cell
    want, _ = faultcheck.expected_error(spec)
    assert want.__name__ in cell
