"""The port's persisted autotuner (racon_tpu_torch/sched/autotune.py) and
the engines' use of its winner table, on the CPU.

The table round trip, its key scoping by backend (`cuda` and `cpu`
entries never cross), corrupt and stale tables read as absent; `_pick`
and `demote` against the JAX package's on the same tables (kernel names
mapped: the port's plane for the JAX `xla`); the three profilers at tiny
buckets (fresh, then warm on a second instance, identical); the "weld":
the keys `profile_all` writes are the keys the engines consult, and the
derived shapes of `--cuda-adaptive-buckets` consulting cold; each
engine's plan following a recorded entry and unchanged when the table
is cold; and the polished FASTA with a table forcing int32 and one launch
a chunk everywhere, equal to the FASTA without a table and to the JAX
CLI's at `--tpu-dtype int32` and `--tpu-fused 1` / `0`, for both
engines. Inputs are made from seeds. Tolerance: none — decisions, keys
and bytes must be equal.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from racon_tpu_torch.sched import autotune
from racon_tpu_torch.sched.autotune import (Autotuner, default_table_path,
                                            get_autotuner,
                                            reset_autotuner_cache)

@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """No test sees another's table through the process cache; one torch
    thread, as the other port tests run."""
    reset_autotuner_cache()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    reset_autotuner_cache()


def entry(kernel, dtype):
    return {"kernel": kernel, "dtype": dtype, "ms": {}, "identical": True}


# ------------------------------------------------------------- the table
def test_table_roundtrip_persists_across_instances(tmp_path):
    path = str(tmp_path / "t.json")
    at = Autotuner(path)
    ent = {"kernel": "cuda", "dtype": "int16",
           "ms": {"cuda:int32": 1.5, "cuda:int16": 0.5}, "identical": True}
    at.record("session", (192, 128), (3, -5, -4, 8), ent, backend="cuda")
    assert at.save() == path
    again = Autotuner(path)
    assert again.winner("session", (192, 128), (3, -5, -4, 8),
                        backend="cuda") == ent
    assert again.winner("session", (192, 128), (5, -4, -8, 8),
                        backend="cuda") is None
    assert again.winner("aligner", (192, 128), backend="cuda") is None
    assert again.consults == {("session", "cuda", "int16"): 1,
                              ("session", "none", ""): 1,
                              ("aligner", "none", ""): 1}
    doc = json.load(open(path))
    assert doc["version"] == autotune.VERSION
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_key_is_backend_scoped(tmp_path):
    k_cpu = Autotuner.key("session", (96, 96), (3, -5, -4), backend="cpu")
    k_gpu = Autotuner.key("session", (96, 96), (3, -5, -4), backend="cuda")
    assert k_cpu == "cpu|session|96x96|3,-5,-4"
    assert k_gpu == "cuda|session|96x96|3,-5,-4"
    assert Autotuner.key("aligner", 512, backend="cpu") \
        == Autotuner.key("aligner", (512,), backend="cpu")
    at = Autotuner(str(tmp_path / "t.json"))
    at.record("aligner", (512, 128), (), entry("cuda", "int32"),
              backend="cuda")
    at.record("session", (96, 96), (), entry("plain", "int32"),
              backend="cpu")
    # a table profiled on the card never feeds a CPU run, nor the reverse
    assert at.winner("aligner", (512, 128), backend="cpu") is None
    assert at.winner("session", (96, 96), backend="cuda") is None
    assert at.winner("aligner", (512, 128), backend="cuda")["kernel"] \
        == "cuda"


@pytest.mark.parametrize("content", [
    "{not json", json.dumps({"version": 99, "winners": {
        "cpu|session|96x96|": entry("plain", "int16")}}),
    json.dumps({"version": 1, "winners": []})])
def test_corrupt_or_stale_table_read_as_absent(tmp_path, content):
    path = tmp_path / "t.json"
    path.write_text(content)
    at = Autotuner(str(path))
    assert at.table == {}
    assert at.winner("session", (96, 96), backend="cpu") is None


def test_default_path_and_process_cache(tmp_path):
    assert default_table_path() == os.path.join(
        os.path.expanduser("~"), ".cache", "racon_tpu_torch",
        "racon_tpu_torch_autotune.json")
    assert Autotuner().path == default_table_path()
    path = str(tmp_path / "t.json")
    assert get_autotuner(path) is get_autotuner(path)
    assert get_autotuner(path) is not get_autotuner(str(tmp_path / "u"))
    first = get_autotuner(path)
    reset_autotuner_cache()
    assert get_autotuner(path) is not first


# -------------------------------------------------- against the JAX one
@pytest.mark.parametrize("case", range(4))
def test_pick_matches_jax(case):
    from racon_tpu.sched.autotune import Autotuner as JaxAutotuner

    rng = np.random.default_rng(case)
    names = ["cuda:int32", "cuda:int16"] if case < 2 else \
        ["split:int16", "fused:int16"]
    oracle = names[0]
    ms = {n: float(rng.uniform(0.1, 5.0)) for n in names}
    outs = {n: np.arange(6) for n in names}
    if case % 2:
        # the faster candidate differs from the oracle: vetoed
        fast = min(ms, key=ms.get)
        other = names[1] if fast == oracle else fast
        outs[other] = np.arange(6) + 1
    want = JaxAutotuner._pick(ms, outs, oracle)
    got = Autotuner._pick(ms, outs, oracle)
    assert got == want
    assert got["identical"] is (case % 2 == 0)
    # tuple outputs (the aligner's and the fused profiles') compare too
    touts = {n: ([1, 2], ["inf"]) for n in names}
    touts[names[1]] = ([1, 2], [3])
    assert Autotuner._pick(ms, touts, oracle) == JaxAutotuner._pick(
        ms, touts, oracle)
    assert Autotuner._pick(ms, touts, oracle)["kernel"] == \
        oracle.split(":")[0]


@pytest.mark.parametrize("case", ["inside", "beyond", "cold_wins",
                                  "vetoed"])
def test_settle_keeps_the_cold_decision_inside_the_spread(case):
    """The noise gate over `_pick`: a winner other than the cold
    decision stands only when its slowest timed call beat the cold one's
    fastest; inside that spread the entry keeps the cold decision and
    says `noise`; a vetoed candidate never comes back."""
    cold, other = "cuda:int16", "cuda:int32"
    times = {"inside": {cold: [1.0, 1.3, 1.2], other: [0.9, 1.05, 1.0]},
             "beyond": {cold: [1.0, 1.3, 1.2], other: [0.9, 0.95, 0.8]},
             "cold_wins": {cold: [0.8, 0.9, 0.85], other: [1.0, 0.7, 1.1]},
             "vetoed": {cold: [1.0, 1.3, 1.2], other: [0.9, 0.95, 0.8]}
             }[case]
    outs = {other: np.arange(4), cold: np.arange(4)}
    if case == "vetoed":
        outs[cold] = np.arange(4) + 1
    got = Autotuner._settle(times, outs, other, cold)
    means = {k: sum(v) / len(v) for k, v in times.items()}
    picked = Autotuner._pick(means, outs, other)
    assert got["ms"] == picked["ms"]
    assert got["spread"] == {k: [round(min(v), 3), round(max(v), 3)]
                             for k, v in times.items()}
    winner = {"inside": cold, "beyond": other, "cold_wins": cold,
              "vetoed": other}[case]
    assert f"{got['kernel']}:{got['dtype']}" == winner
    assert got.get("noise", False) is (case == "inside")
    assert got["identical"] is (case != "vetoed")


def test_profiles_default_to_the_widths_the_engines_launch(monkeypatch):
    """With no `rows`, K1 is profiled at the session engine's pinned
    width for the bucket, K2 at a full batch (the byte cap, at most
    ALIGNER_PROFILE_ROWS pairs) and K3 at the fused engine's chunk width
    B."""
    from racon_tpu_torch.ops.align import BatchAligner
    from racon_tpu_torch.ops.poa_fused import FusedPOA
    from racon_tpu_torch.ops.poa_graph import pinned_rows

    seen = {}

    def spy(name, real, at):
        def wrapped(*args):
            seen[name] = args[at]
            args = args[:at] + (2,) + args[at + 1:]
            return real(*args)
        return wrapped

    monkeypatch.setattr(autotune, "_session_jobs",
                        spy("session", autotune._session_jobs, 3))
    monkeypatch.setattr(autotune, "_aligner_pairs",
                        spy("aligner", autotune._aligner_pairs, 1))
    monkeypatch.setattr(autotune, "_fused_windows",
                        spy("fused", autotune._fused_windows, 3))
    # the fused profile's chunk is B windows: keep B small on the CPU
    monkeypatch.setattr("racon_tpu_torch.ops.poa_fused._pinned_rows",
                        lambda *a: 2)
    at = Autotuner(os.devnull)
    at.profile_session_bucket(96, 96, 4, 3, -5, -4, reps=1, device="cpu")
    at.profile_aligner_bucket(512, 128, reps=1, device="cpu")
    at.profile_aligner_bucket(8192, 896, reps=1, device="cpu")
    assert seen["aligner"] == BatchAligner.batch_cap(8192, 896) == 146
    at.profile_fused_bucket(192, 96, 8, 4, 3, -5, -4, reps=1, device="cpu")
    assert seen["session"] == pinned_rows(torch.device("cpu"), 96, 96)
    assert seen["fused"] == FusedPOA(3, -5, -4, device="cpu",
                                     max_nodes=192, max_len=96,
                                     max_pred=4).B == 2
    at2 = Autotuner(os.devnull)
    at2.profile_aligner_bucket(512, 128, reps=1, device="cpu")
    assert seen["aligner"] == min(autotune.ALIGNER_PROFILE_ROWS,
                                  BatchAligner.batch_cap(512, 128)) == 256


#: JAX kernel names -> the port's on each backend: `xla` is the plane
#: (`plain` on the CPU, `cuda` on the card; the JAX table marks its
#: non-oracle session / aligner / fused entries by dtype, as the port
#: must), the fused loop's names are shared
_TO_PORT = {"cpu": {"xla": "plain"}, "cuda": {"xla": "cuda"}}


def _tables(tmp_path):
    """The same table for both packages: entries on two backends (the JAX
    `tpu` is the port's `cuda`), oracle and non-oracle."""
    from racon_tpu.sched.autotune import Autotuner as JaxAutotuner

    rows = [("session", (64, 128), (3, -5, -4, 8), "xla", "int16"),
            ("session", (128, 256), (3, -5, -4, 8), "xla", "int32"),
            ("aligner", (512, 128), (), "xla", "int16"),
            ("aligner", (1024, 128), (), "xla", "int32"),
            ("fused", (2048, 640), (3, -5, -4, 8), "xla", "int16"),
            ("fused_loop", (2048, 640, 8), (3, -5, -4, 8), "fused",
             "int32"),
            ("fused_loop", (2048, 640, 16), (3, -5, -4, 8), "split",
             "int32")]
    jax_at = JaxAutotuner(str(tmp_path / "jax.json"))
    port_at = Autotuner(str(tmp_path / "port.json"))
    for jb, pb in (("cpu", "cpu"), ("tpu", "cuda")):
        for eng, bucket, params, kern, dt in rows:
            jax_at.table[JaxAutotuner.key(eng, bucket, params,
                                          backend=jb)] = entry(kern, dt)
            port_at.record(eng, bucket, params,
                           entry(_TO_PORT[pb].get(kern, kern), dt),
                           backend=pb)
    return jax_at, port_at


def _port_key(jax_key: str) -> str:
    return jax_key.replace("tpu|", "cuda|", 1)


@pytest.mark.parametrize("sweep", [
    dict(engine="session"), dict(engine="fused_loop"), dict(engine=None),
    dict(engine="aligner", bucket=(512, 128), params=())])
@pytest.mark.parametrize("backend", ["cpu", "tpu"])
def test_demote_matches_jax(tmp_path, sweep, backend):
    jax_at, port_at = _tables(tmp_path)
    want = jax_at.demote(backend=backend, **sweep)
    got = port_at.demote(backend="cuda" if backend == "tpu" else "cpu",
                         **sweep)
    assert got == [_port_key(k) for k in want] and got
    # the other backend's entries are untouched, the oracle ones too
    plane = "cuda" if backend == "tpu" else "plain"
    on_disk = Autotuner(port_at.path).table
    for key, ent in on_disk.items():
        eng = key.split("|")[1]
        if key in got:
            oracle = "split" if eng == "fused_loop" else plane
            assert ent["kernel"] == oracle and ent["dtype"] == "int32"
            assert ent["demoted"] is True and ent["identical"] is False
        else:
            assert "demoted" not in ent
    assert port_at.demote(backend="cuda" if backend == "tpu" else "cpu",
                          **sweep) == []


# ------------------------------------------------------------ profilers
def test_profilers_fresh_then_warm(tmp_path):
    path = str(tmp_path / "t.json")
    at = Autotuner(path)
    s, fresh_s = at.profile_session_bucket(96, 96, 4, 3, -5, -4, rows=4,
                                           reps=1, device="cpu")
    a, fresh_a = at.profile_aligner_bucket(512, 128, rows=3, reps=1,
                                           device="cpu")
    f, fresh_f = at.profile_fused_bucket(192, 96, 8, 4, 3, -5, -4, rows=2,
                                         reps=1, device="cpu")
    assert fresh_s and fresh_a and fresh_f
    assert set(s["ms"]) == {"plain:int32", "plain:int16"}
    assert set(a["ms"]) == {"plain:int32", "plain:int16"}
    assert set(f["ms"]) == {"split:int16", "fused:int16"}
    assert s["identical"] and a["identical"] and f["identical"]
    assert s["kernel"] == a["kernel"] == "plain"
    assert f["kernel"] in ("split", "fused")
    at.save()
    warm = Autotuner(path)
    assert warm.profile_session_bucket(96, 96, 4, 3, -5, -4,
                                       device="cpu") == (s, False)
    assert warm.profile_aligner_bucket(512, 128, device="cpu") == (a, False)
    assert warm.profile_fused_bucket(192, 96, 8, 4, 3, -5, -4,
                                     device="cpu") == (f, False)
    assert set(warm.table) == {
        "cpu|session|96x96|3,-5,-4,4", "cpu|aligner|512x128|",
        "cpu|fused_loop|192x96x8|3,-5,-4,4"}


def test_profile_inputs_match_jax():
    """The synthetic profiling jobs, pairs and windows are the JAX
    package's, seed for seed."""
    from racon_tpu.sched import autotune as jax_autotune

    for a, b in zip(autotune._session_jobs(96, 96, 4, 5, 7),
                    jax_autotune._session_jobs(96, 96, 4, 5, 7)):
        assert np.array_equal(a, b)
    assert autotune._aligner_pairs(512, 4, 11) == \
        jax_autotune._aligner_pairs(512, 4, 11)
    assert autotune._fused_windows(192, 96, 12, 2, 13) == \
        jax_autotune._fused_windows(192, 96, 12, 2, 13)


def test_profile_all_writes_the_keys_the_engines_consult(tmp_path,
                                                         monkeypatch):
    """The weld: every key `profile_all` writes is one an engine built
    with its defaults consults, and every consult of those engines at
    the profiled scorings finds an entry — the session grid, the
    aligner's auto band at any mean length of a bucket up to 8192, and
    the fused engine's leading chain bucket at any chunk depth."""
    from racon_tpu_torch.ops.align import BatchAligner
    from racon_tpu_torch.ops.poa_fused import FUSED_LOOP_MAX_DEPTH, FusedPOA
    from racon_tpu_torch.ops.poa_graph import DeviceGraphPOA

    def fake(engine, n_bucket):
        def profile(self, *args, device="cuda", **kw):
            bucket = args[:n_bucket]
            params = tuple(args[n_bucket + 1:n_bucket + 4]) + (
                args[n_bucket],) if engine != "aligner" else ()
            self.record(engine, bucket, params, entry("plain", "int32"),
                        backend=torch.device(device).type)
            return self.table[self.key(engine, bucket, params,
                                       torch.device(device).type)], True
        return profile

    monkeypatch.setattr(Autotuner, "profile_session_bucket",
                        fake("session", 2))
    monkeypatch.setattr(Autotuner, "profile_aligner_bucket",
                        fake("aligner", 2))
    monkeypatch.setattr(Autotuner, "profile_fused_bucket",
                        fake("fused_loop", 3))
    at = Autotuner(str(tmp_path / "t.json"))
    scores = ((3, -5, -4), (5, -4, -8))
    done = autotune.profile_all(at, scores=scores, device="cpu")
    assert len(done) == len(at.table) == 8 + 11 + 8

    for m, x, g in scores:
        eng = DeviceGraphPOA(m, x, g, device="cpu", autotuner=at)
        for nb, lb in eng.buckets:
            eng.plan_for(nb, lb)
        fused = FusedPOA(m, x, g, device="cpu", autotuner=at)
        for depth in range(1, FUSED_LOOP_MAX_DEPTH + 1):
            fused._fused_plan(fused._chain_plan(depth))
    al = BatchAligner(device="cpu", autotuner=at)
    edges = [e for e in BatchAligner.BUCKETS if e <= 8192]
    for edge, prev in zip(edges, [0] + edges):
        for length in (prev + 1, (prev + edge) // 2 + 1, edge):
            band = al._band_for([(b"A" * length, b"A" * length)], [0])
            al.plan_for(edge, band)
    cold = {k: n for k, n in at.consults.items() if k[1] == "none"}
    # the only cold consult: the fused engine's dtype, which no profile
    # writes (as in the JAX package), one per scoring
    assert cold == {("fused", "none", ""): 2}
    consulted = {k for k, n in at.consults.items() if k[1] != "none"}
    assert consulted == {("session", "plain", "int32"),
                         ("aligner", "plain", "int32"),
                         ("fused_loop", "plain", "int32")}


# ------------------------------------------------- engines follow table
def test_derived_shapes_consult_cold(tmp_path):
    """With the scheduler on, the engines look up their derived shapes,
    which a static profile does not cover: those buckets consult cold and
    resolve as without a table (the proof; split), while the static
    shapes they keep still take the table's entry."""
    from racon_tpu_torch.ops.align import BatchAligner
    from racon_tpu_torch.ops.dtypes import poa_int16_ok
    from racon_tpu_torch.ops.poa_fused import DEPTH_BUCKETS, FusedPOA
    from racon_tpu_torch.ops.poa_graph import (BUCKETS, MAX_LEN, MAX_NODES,
                                               MAX_PRED, DeviceGraphPOA)
    from racon_tpu_torch.sched import BatchScheduler

    rng = random.Random(3)
    at = Autotuner(str(tmp_path / "t.json"))
    params = (3, -5, -4, MAX_PRED)
    for nb, lb in BUCKETS:
        at.record("session", (nb, lb), params, entry("plain", "int32"),
                  backend="cpu")
    for edge in BatchAligner.BUCKETS:
        for band in BatchAligner.auto_bands(edge):
            at.record("aligner", (edge, band), (), entry("plain", "int32"),
                      backend="cpu")
    for d in DEPTH_BUCKETS:
        at.record("fused_loop", (MAX_NODES, MAX_LEN, d), params,
                  entry("fused", "int32"), backend="cpu")

    def seq(n):
        return bytes(rng.choice(b"ACGT") for _ in range(n))

    windows = []
    for _ in range(24):
        n = rng.randint(150, 450)
        windows.append([(seq(n), None, 0, 0)] + [
            (seq(rng.randint(n - 40, n)), None, 0, n - 1)
            for _ in range(rng.randint(3, 21))])

    eng = DeviceGraphPOA(3, -5, -4, device="cpu", autotuner=at,
                         scheduler=BatchScheduler(adaptive=True))
    eng.adapt(windows)
    derived = [b for b in eng.buckets if b not in BUCKETS]
    assert derived and (MAX_NODES, MAX_LEN) in eng.buckets
    for nb, lb in eng.buckets:
        want = ("int32" if (nb, lb) in BUCKETS else
                "int16" if poa_int16_ok(nb, lb, 3, -5, -4) else "int32")
        assert eng.plan_for(nb, lb) == want, (nb, lb)
    assert at.consults[("session", "none", "")] == len(derived)

    pairs = [(seq(n), seq(n)) for n in
             (rng.randint(2100, 4000) for _ in range(40))]
    al = BatchAligner(device="cpu", autotuner=at,
                      scheduler=BatchScheduler(adaptive=True))
    keys = {(edge, band) for edge, band, _ in al.chunks(pairs)}
    cold = {k for k in keys if k[0] not in BatchAligner.BUCKETS}
    assert cold and all(al.plan_for(*k) == "int16" for k in cold)
    assert all(al.plan_for(*k) == "int32" for k in keys - cold)

    fused = FusedPOA(3, -5, -4, device="cpu", batch_rows=4, autotuner=at,
                     scheduler=BatchScheduler(adaptive=True))
    fused.adapt(windows)
    assert set(fused.depth_buckets) - set(DEPTH_BUCKETS)
    for d in fused.depth_buckets:
        static = d in DEPTH_BUCKETS
        assert fused._fused_plan([d]) is static, d


def test_session_engine_plan_follows_table(tmp_path):
    from racon_tpu_torch.ops.poa_graph import DeviceGraphPOA

    at = Autotuner(str(tmp_path / "t.json"))

    def plan(posture="auto", table=at):
        return DeviceGraphPOA(3, -5, -4, device="cpu", max_nodes=96,
                              max_len=96, buckets=((96, 96),),
                              batch_rows=4, score_dtype=posture,
                              autotuner=table).plan_for(96, 96)

    assert plan() == plan(table=None) == "int16"   # cold: the proof
    at.record("session", (96, 96), (3, -5, -4, 8), entry("plain", "int32"),
              backend="cpu")
    assert plan() == "int32"
    assert plan("int16") == "int16" and plan("int32") == "int32"
    # an entry on the card's backend does not feed a CPU engine
    at.table.clear()
    at.record("session", (96, 96), (3, -5, -4, 8), entry("cuda", "int32"),
              backend="cuda")
    assert plan() == "int16"
    # one consult a bucket: the plan is cached
    eng = DeviceGraphPOA(3, -5, -4, device="cpu", max_nodes=96,
                         max_len=96, buckets=((96, 96),), batch_rows=4,
                         autotuner=at)
    before = sum(at.consults.values())
    for _ in range(3):
        eng.plan_for(96, 96)
    assert sum(at.consults.values()) == before + 1


def test_aligner_plan_follows_table(tmp_path):
    from racon_tpu_torch.ops.align import BatchAligner

    at = Autotuner(str(tmp_path / "t.json"))
    assert BatchAligner(device="cpu", autotuner=at).plan_for(
        512, 128) == "int16"
    at.record("aligner", (512, 128), (), entry("plain", "int32"),
              backend="cpu")
    al = BatchAligner(device="cpu", autotuner=at)
    assert al.plan_for(512, 128) == "int32"
    assert al.plan_for(512, 256) == "int16"   # another band: cold
    assert al.plan_for(8192, 896) == "int32"  # the proof fails
    assert BatchAligner(device="cpu", score_dtype="int16",
                        autotuner=at).plan_for(512, 128) == "int16"


def test_fused_engine_plans_follow_table(tmp_path):
    from racon_tpu_torch.ops.poa_fused import FUSED_LOOP_MAX_DEPTH, FusedPOA

    at = Autotuner(str(tmp_path / "t.json"))
    kw = dict(device="cpu", max_nodes=256, max_len=128, batch_rows=4,
              depth_buckets=(4, 8))

    def eng(fused="auto", table=at, **more):
        return FusedPOA(3, -5, -4, fused=fused, autotuner=table, **kw,
                        **more)

    cold = eng()
    assert cold.score_dtype == "int16"
    assert not cold._fused_plan([8, 4]) and not cold._fused_plan([4])
    at.record("fused", (256, 128), (3, -5, -4, 8), entry("plain", "int32"),
              backend="cpu")
    at.record("fused_loop", (256, 128, 8), (3, -5, -4, 8),
              entry("fused", "int16"), backend="cpu")
    warm = eng()
    assert warm.score_dtype == "int32"
    assert eng(score_dtype="int16").score_dtype == "int16"
    assert warm._fused_plan([8, 4]) and warm._fused_plan([8])
    assert not warm._fused_plan([4])          # another leading bucket
    assert not warm._fused_plan([8] * (FUSED_LOOP_MAX_DEPTH // 8 + 1))
    assert not eng("0")._fused_plan([8, 4])   # forced postures win
    assert eng("1", table=None)._fused_plan([4])


# ----------------------------------------------------------- the bytes
@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from test_pipeline import _synth_dataset

    return [str(p) for p in _synth_dataset(
        tmp_path_factory.mktemp("autotune"), random.Random(23))]


def forcing_table(path: str) -> None:
    """A table on the CPU backend whose every entry the default-built
    engines consult at 3/-5/-4 is int32, and one launch a chunk for the
    fused loop: every decision `auto` makes goes against the cold default
    (int16 where the proof holds, split)."""
    from racon_tpu_torch.ops.align import BatchAligner
    from racon_tpu_torch.ops.poa_fused import DEPTH_BUCKETS
    from racon_tpu_torch.ops.poa_graph import (BUCKETS, MAX_LEN, MAX_NODES,
                                               MAX_PRED)

    at = Autotuner(path)
    params = (3, -5, -4, MAX_PRED)
    for nb, lb in BUCKETS:
        at.record("session", (nb, lb), params, entry("plain", "int32"),
                  backend="cpu")
    for edge in BatchAligner.BUCKETS:
        for band in BatchAligner.auto_bands(edge):
            at.record("aligner", (edge, band), (), entry("plain", "int32"),
                      backend="cpu")
    at.record("fused", (MAX_NODES, MAX_LEN), params,
              entry("plain", "int32"), backend="cpu")
    for d in DEPTH_BUCKETS:
        at.record("fused_loop", (MAX_NODES, MAX_LEN, d), params,
                  entry("fused", "int32"), backend="cpu")
    at.save()


@pytest.mark.parametrize("engine", ["session", "fused"])
def test_fasta_with_forcing_table_matches_cold_and_jax(synth, engine,
                                                       tmp_path,
                                                       monkeypatch):
    from test_torch_fused_cli import run

    from racon_tpu import cli as jax_cli
    from racon_tpu_torch import cli

    monkeypatch.setenv("RACON_TPU_MAX_DEVICES", "1")
    monkeypatch.setenv("RACON_TPU_STRICT", "1")
    monkeypatch.setenv("RACON_TPU_FUSED", "auto")
    monkeypatch.setenv("RACON_TPU_DTYPE", "auto")
    device = ["-c", "1", "--cudaaligner-batches", "1"] if engine == \
        "session" else ["-c", "1"]
    flags = device + ["--cuda-engine", engine, "--cuda-pipeline-depth",
                      "0"]
    path = str(tmp_path / "forcing.json")
    forcing_table(path)
    cold, _ = run(cli.main, ["--device", "cpu", *flags,
                             "--cuda-autotune-table",
                             str(tmp_path / "none.json"), *synth])
    warm, log = run(cli.main, ["--device", "cpu", *flags,
                               "--cuda-autotune-table", path, *synth])
    decisions = log.split("autotuner ")[1].splitlines()[0]
    assert " 0 cold " in decisions, decisions
    if engine == "fused":
        assert "at int32" in log and "1 of them one launch" in log
    else:
        assert "int32 packed" in log and "int16" not in \
            log.split("device layer alignments")[1].splitlines()[0]
    jax_flags = [f.replace("--cuda-", "--tpu-").replace(
        "--cudaaligner", "--tpualigner") for f in flags]
    want, _ = run(jax_cli.main, [*jax_flags, "--tpu-dtype", "int32",
                                 "--tpu-fused", "1", *synth])
    assert warm.startswith(b">") and warm == cold == want
    if engine == "fused":
        split, _ = run(jax_cli.main, [*jax_flags, "--tpu-fused", "0",
                                      *synth])
        assert split == want
