"""The port's identity audit (racon_tpu_torch/obs/audit.py) and its oracle
(racon_tpu_torch/ops/oracle.py), on the CPU.

`window_sample_fraction` equals the JAX package's bit for bit, and so do
the sampled sets at rates 0, 0.1, 0.5 and 1.0; `OracleExecutor.consensus`
equals the JAX `OracleExecutor`'s for host, session and fused parameters;
the oracle keeps its posture (int32, unpacked, split, no table) whatever
the production posture, with both running at once on two threads; its
counters never reach the polisher's `pipeline` and `sched` namespaces; a
clean audit counts as the JAX auditor counts; and a corrupted window is
caught, repaired, dumped with both streams, alerts until acknowledged,
leaves its probe, and demotes the polisher's winner table on disk, so
the next polisher dispatches the oracle candidate. Windows are made from
seeds. Tolerance: none — bytes and counts must be equal. The card test
(`gpu`) audits a small card run and skips without a card.
"""

import json
import os
import random
import threading
import types

import pytest
import torch

from racon_tpu_torch.core.window import WindowType, create_window
from racon_tpu_torch.obs.audit import WindowAuditor, window_sample_fraction
from racon_tpu_torch.ops.oracle import (OracleExecutor, engine_params_key,
                                        rebuild_window, snapshot_window)
from racon_tpu_torch.ops.poa import BatchPOA
from racon_tpu_torch.sched.autotune import Autotuner, reset_autotuner_cache


@pytest.fixture(autouse=True)
def _one_thread():
    reset_autotuner_cache()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    reset_autotuner_cache()


def make_windows(mod=None, n=6, seed=3, length=60, depth=4, quals=False):
    """Small consensus-ready windows (a backbone and mutated layers) of
    the port, or of the JAX package with `mod` its window module; the
    JAX auditor tests' windows, with layer qualities when `quals`."""
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
            q = (bytes(rng.randint(40, 70) for _ in layer) if quals
                 else None)
            w.add_layer(layer.encode(), q, rng.randint(0, 2),
                        length - 1 - rng.randint(0, 2))
        windows.append(w)
    return windows


def params(engine=None, **kw):
    """Polisher parameters for the port: the host engine, or a device
    engine on the CPU."""
    base = dict(match=3, mismatch=-5, gap=-4, window_length=500, trim=True,
                num_threads=1, cuda_poa_batches=0 if engine is None else 1,
                cuda_banded_alignment=False, cuda_aligner_band_width=0,
                cuda_engine=engine or "session", fused_fallback="session",
                pipeline_depth=0, score_dtype="auto",
                device=torch.device("cpu"), autotuner=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def jax_params(engine=None):
    return types.SimpleNamespace(
        match=3, mismatch=-5, gap=-4, window_length=500, trim=True,
        num_threads=1, tpu_poa_batches=0 if engine is None else 1,
        tpu_banded_alignment=False, tpu_aligner_band_width=0,
        tpu_engine=engine, tpu_pipeline_depth=0, tpu_device_timeout=0.0)


# ------------------------------------------------------------- sampling
def test_sample_fraction_and_sets_match_jax():
    from racon_tpu.core import window as jax_window
    from racon_tpu.obs.audit import WindowAuditor as JaxAuditor
    from racon_tpu.obs.audit import \
        window_sample_fraction as jax_fraction

    ours = make_windows(n=40, quals=True) + make_windows(n=8, seed=9)
    theirs = (make_windows(jax_window, n=40, quals=True)
              + make_windows(jax_window, n=8, seed=9))
    fracs = [window_sample_fraction(w) for w in ours]
    assert fracs == [jax_fraction(w) for w in theirs]
    assert len(set(fracs)) == len(fracs)
    assert all(0.0 <= f < 1.0 for f in fracs)
    sets = {}
    for rate in (0.0, 0.1, 0.5, 1.0):
        ours_a, theirs_a = WindowAuditor(rate, device="cpu"), JaxAuditor(rate)
        got = {i for i, w in enumerate(ours) if ours_a.sampled(w)}
        assert got == {i for i, w in enumerate(theirs) if theirs_a.sampled(w)}
        sets[rate] = got
    assert sets[0.0] == set() and sets[1.0] == set(range(len(ours)))
    assert sets[0.1] <= sets[0.5] <= sets[1.0]
    assert 0 < len(sets[0.1]) < len(sets[0.5]) < len(ours)
    # one flipped base moves the fraction
    w = ours[0]
    moved = create_window(0, 0, WindowType.kNGS, b"A" + w.sequences[0][1:],
                          w.qualities[0])
    assert window_sample_fraction(moved) != fracs[0]


def test_rate_bounds_and_rebuild():
    auditor = WindowAuditor(rate=0.0, device="cpu")
    assert not auditor.armed
    auditor.set_rate(2.0)
    assert auditor.rate == 1.0 and auditor.armed
    auditor.set_rate(-1.0)
    assert auditor.rate == 0.0
    w = make_windows(n=1, quals=True)[0]
    clone = rebuild_window(snapshot_window(w))
    assert (clone.id, clone.rank, clone.type) == (w.id, w.rank, w.type)
    assert clone.sequences == w.sequences
    assert clone.qualities == w.qualities
    assert clone.positions == w.positions
    assert clone.consensus == b"" and not clone.polished


# --------------------------------------------------------------- oracle
@pytest.mark.parametrize("engine", [None, "session", "fused"])
def test_oracle_consensus_matches_jax(engine, monkeypatch):
    from racon_tpu.core import window as jax_window
    from racon_tpu.ops.oracle import OracleExecutor as JaxOracle
    from racon_tpu.ops.oracle import snapshot_window as jax_snapshot

    monkeypatch.setenv("RACON_TPU_MAX_DEVICES", "1")
    monkeypatch.setenv("RACON_TPU_STRICT", "1")
    ours = make_windows(n=4, quals=True)
    theirs = make_windows(jax_window, n=4, quals=True)
    # a window below three sequences keeps its backbone
    ours.append(create_window(0, 9, WindowType.kNGS, b"ACGTACGT", b"!" * 8))
    theirs.append(jax_window.create_window(0, 9, jax_window.WindowType.kNGS,
                                           b"ACGTACGT", b"!" * 8))
    ex, jex = OracleExecutor("cpu"), JaxOracle()
    try:
        got = ex.consensus(params(engine),
                           [snapshot_window(w) for w in ours])
        want = jex.consensus(jax_params(engine),
                             [jax_snapshot(w) for w in theirs])
    finally:
        ex.close()
        jex.close()
    assert [(c.consensus, c.polished) for c in got] == \
        [(c.consensus, c.polished) for c in want]
    assert all(c.polished for c in got[:4]) and not got[4].polished
    # the rebuilt clones carry the production windows' content, and the
    # production windows are not touched
    assert all(w.consensus == b"" for w in ours)


@pytest.mark.parametrize("engine", ["session", "fused"])
def test_oracle_keeps_its_posture_beside_production(engine, tmp_path):
    """A production engine at int16, packed, one launch a chunk and a
    table that says so, and the oracle, running at once on two threads:
    the oracle runs int32, unpacked, split and consults no table."""
    from racon_tpu_torch.ops.poa_graph import BUCKETS, MAX_LEN, MAX_NODES

    at = Autotuner(str(tmp_path / "t.json"))
    for nb, lb in BUCKETS:
        at.record("session", (nb, lb), (3, -5, -4, 8),
                  {"kernel": "plain", "dtype": "int16", "ms": {},
                   "identical": True}, backend="cpu")
    at.record("fused", (MAX_NODES, MAX_LEN), (3, -5, -4, 8),
              {"kernel": "plain", "dtype": "int16", "ms": {},
               "identical": True}, backend="cpu")
    prod_windows = make_windows(n=4)
    oracle_windows = make_windows(n=4)
    prod = BatchPOA(3, -5, -4, 500, device_batches=1, device="cpu",
                    score_dtype="auto", pack_bases=True, engine=engine,
                    fused="1", autotuner=at)
    ex = OracleExecutor("cpu")
    p = params(engine)
    out: dict = {}
    errors: list = []

    def go(name, fn):
        try:
            out[name] = fn()
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)

    threads = [
        threading.Thread(target=go, args=("prod", lambda: prod.
                                          generate_consensus(prod_windows,
                                                             True))),
        threading.Thread(target=go, args=("oracle", lambda: ex.consensus(
            p, [snapshot_window(w) for w in oracle_windows])))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    oracle = ex._engines[engine_params_key(p)]
    assert (oracle.score_dtype, oracle.pack_bases, oracle.fused,
            oracle.autotuner) == ("int32", False, "0", None)
    if engine == "session":
        assert set(prod.engine.batches_by_plan) == {("int16", True)}
        assert set(oracle.engine.batches_by_plan) == {("int32", False)}
    else:
        assert prod.engine.score_dtype == "int16"
        assert prod.engine.last_stats["fused_chunks"] >= 1
        assert oracle.engine.score_dtype == "int32"
        assert oracle.engine.last_stats["fused_chunks"] == 0
        assert oracle.engine.autotuner is None
    assert [c.consensus for c in out["oracle"]] == \
        [w.consensus for w in prod_windows]
    ex.close()


# -------------------------------------------------------------- auditor
def _dataset(tmp_path):
    from racon_tpu_torch.synth import simulate, write_dataset

    _, draft, reads, paf = simulate(random.Random(3), 2500, 6, 1500, 0.12,
                                    0.10)
    return write_dataset(str(tmp_path), draft, reads, paf)


def _polish(paths, table):
    """One CPU polish with the session engine; returns the polisher, its
    windows (kept before polish() drops them) and the FASTA."""
    from racon_tpu_torch.core.polisher import PolisherType, create_polisher

    pol = create_polisher(*paths, PolisherType.kC, 500, 10.0, 0.3, True,
                          3, -5, -4, cuda_poa_batches=1, device="cpu",
                          autotune_table=table)
    pol.initialize()
    windows = list(pol.windows)
    fasta = [(s.name, s.data) for s in pol.polish()]
    return pol, windows, fasta


def test_audit_leaves_production_counters_alone(tmp_path):
    paths = _dataset(tmp_path)
    pol, windows, _ = _polish(paths, str(tmp_path / "none.json"))
    before = json.dumps(pol.metrics.snapshot(), sort_keys=True)
    auditor = WindowAuditor(1.0, device="cpu")
    assert auditor.audit_windows([(w, pol) for w in windows]) == 0
    assert json.dumps(pol.metrics.snapshot(), sort_keys=True) == before
    snap = auditor.snapshot()
    assert snap["audited"] == snap["clean"] == len(windows)
    assert snap["shadow"]["compiles"] >= 1 and snap["shadow_s"] > 0
    auditor.close()


@pytest.mark.parametrize("rate", [0.5, 1.0])
def test_clean_audit_counts_match_jax(rate):
    from racon_tpu.core import window as jax_window
    from racon_tpu.obs.audit import WindowAuditor as JaxAuditor
    from racon_tpu.ops.poa import BatchPOA as JaxBatchPOA

    ours = make_windows(n=8, quals=True)
    theirs = make_windows(jax_window, n=8, quals=True)
    BatchPOA(3, -5, -4, 500).generate_consensus(ours, True)
    JaxBatchPOA(3, -5, -4, 500).generate_consensus(theirs, True)
    a, b = WindowAuditor(rate, device="cpu"), JaxAuditor(rate)
    assert a.audit_windows([(w, params()) for w in ours]) == \
        b.audit_windows([(w, jax_params()) for w in theirs], 0, 0) == 0
    keys = ("windows", "sampled", "audited", "clean", "mismatches",
            "repaired", "demotions")
    sa, sb = a.snapshot(), b.snapshot()
    assert {k: sa[k] for k in keys} == {k: sb[k] for k in keys}
    assert 0 < sa["sampled"] <= 8 and not sa["alert_firing"]
    a.close()
    b.close()


def test_corrupted_window_caught_repaired_and_demoted(tmp_path):
    """The whole chain on a session-engine run whose table dispatches
    int16: the planted window is caught, repaired to the oracle bytes,
    dumped with both streams; the alert fires until acknowledged; the
    probe holds the oracle bytes; the polisher's table is demoted on disk;
    and the next polisher dispatches int32 with the same FASTA."""
    from racon_tpu_torch.ops.poa_graph import BUCKETS

    paths = _dataset(tmp_path)
    table = str(tmp_path / "t.json")
    at = Autotuner(table)
    for nb, lb in BUCKETS:
        at.record("session", (nb, lb), (3, -5, -4, 8),
                  {"kernel": "plain", "dtype": "int16", "ms": {"x": 1.0},
                   "identical": True}, backend="cpu")
    at.record("aligner", (1024, 128), (),
              {"kernel": "plain", "dtype": "int16", "ms": {},
               "identical": True}, backend="cpu")
    at.record("session", (768, 640), (3, -5, -4, 8),
              {"kernel": "cuda", "dtype": "int16", "ms": {},
               "identical": True}, backend="cuda")
    at.save()
    pol, windows, fasta = _polish(paths, table)
    assert set(pol.poa.engine.batches_by_plan) == {("int16", True)}
    assert pol.autotune_decisions.get(("session", "plain", "int16"))
    truth = windows[1].consensus
    bad = bytearray(truth)
    bad[3] = ord("A") if bad[3] != ord("A") else ord("C")
    windows[1].consensus = bytes(bad)
    alerts: list = []
    flight = tmp_path / "flight"
    auditor = WindowAuditor(1.0, device="cpu", flight_dir=str(flight),
                            on_alert=lambda s, d: alerts.append(s))
    n = auditor.audit_windows([(w, pol) for w in windows])
    assert n == 1 and windows[1].consensus == truth
    snap = auditor.snapshot()
    assert (snap["mismatches"], snap["repaired"], snap["demotions"]) == \
        (1, 1, len(BUCKETS))
    assert snap["alert_firing"] and alerts == ["firing"]
    (labels, count), = auditor.mismatch_samples()
    assert count == 1 and labels == {
        "engine": "session", "kernel": "plain", "dtype": "auto",
        "bucket": f"{len(windows[1].sequences)}x"
                  f"{len(windows[1].sequences[0])}"}
    dumps = os.listdir(flight)
    assert len(dumps) == 1 and "audit-mismatch" in dumps[0]
    doc = json.load(open(flight / dumps[0]))["flight"]
    assert doc["oracle"].encode("latin-1") == truth
    assert doc["produced"].encode("latin-1") == bytes(bad)
    assert auditor.probe()[2] == truth
    assert auditor.probe()[1][1] == windows[1].rank
    assert auditor.ack() == {"acked": 1, "firing": False}
    assert not auditor.alert_firing and alerts == ["firing", "clear"]
    auditor.close()

    # demoted on disk: the session entries of the CPU backend only
    disk = Autotuner(table).table
    for key, ent in disk.items():
        if key.startswith("cpu|session|"):
            assert ent == {"kernel": "plain", "dtype": "int32",
                           "ms": ent["ms"], "identical": False,
                           "demoted": True}
        else:
            assert "demoted" not in ent, key
    # the next polisher (a fresh process's table, and this process's)
    for fresh in (True, False):
        if fresh:
            reset_autotuner_cache()
        again, _, fasta2 = _polish(paths, table)
        assert set(again.poa.engine.batches_by_plan) == {("int32", True)}
        assert fasta2 == fasta


@pytest.mark.gpu
def test_audit_of_a_card_run_is_clean(tmp_path):
    """The session and fused engines on the card at the production
    posture (int16 where provable, packed, depth 2), every window
    audited against the oracle on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from racon_tpu_torch.core.polisher import PolisherType, create_polisher

    paths = _dataset(tmp_path)
    for engine in ("session", "fused"):
        pol = create_polisher(*paths, PolisherType.kC, 500, 10.0, 0.3, True,
                              3, -5, -4, cuda_poa_batches=1,
                              cuda_aligner_batches=1, device="cuda",
                              cuda_engine=engine,
                              autotune_table=str(tmp_path / "t.json"))
        pol.initialize()
        windows = list(pol.windows)
        pol.polish()
        auditor = WindowAuditor(1.0, device="cuda")
        assert auditor.audit_windows([(w, pol) for w in windows]) == 0
        assert auditor.snapshot()["clean"] == len(windows)
        auditor.close()
