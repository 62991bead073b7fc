"""What a served job can ask for, in the port's server against the JAX
package's, on the CPU.

Inputs: `make_synth_dataset` (two 2 kb contigs, or one, 400 bp reads,
seed 11) and `make_fragment_dataset` (17 reads of 400 bp off a 2 kb
genome, their all-vs-all PAF, seed 13), written by the port and held
equal to the JAX package's files; both servers at their defaults (host
POA and host alignment, scores 3/-5/-4, w 500) unless a test says
otherwise; torch at one thread, `RACON_TPU_MAX_DEVICES=1`. Tolerance:
none; every value held is a byte, an integer or an error text.

What is held:

  - `rounds=N`: the FASTA equals N chained JAX one-shot rounds
    (`Polisher.redraft`) with the window cache off and on, a resubmit
    is answered from the cache with the same bytes, the `rounds` block
    has one entry a round, a plain submit has none;
  - range shards (`range_lo` / `range_hi`): the raw segments
    concatenate to the whole contig and their `seg` accounting equals
    the JAX server's frame by frame;
  - fragment jobs (`mode: "fragment"`): equal to the JAX one-shot kF
    polisher; the groups of `frag_group` reads tile [0, 17) and equal the
    JAX server's frames; `frag_lo` / `frag_hi` slices concatenate to the
    whole;
  - every refused combination of rounds, mode, range and frag bounds
    gets the JAX server's code and text, and the valid neighbours pass;
  - admit-time ingest: validate-only, a poisoned input refused typed
    (`rejected-ingest`) with the server going on, bad specs refused as
    the JAX server refuses them, subsample deterministic and equal to the
    JAX server's bytes, normalize on admit.

The JAX package is imported inside the fixtures that use it.
"""

import gzip
import os
import time

import pytest
import torch

from racon_tpu_torch.errors import RaconError
from racon_tpu_torch.serve import (PolishClient, PolishServer, ServeConfig,
                                   ServeError, make_fragment_dataset,
                                   make_synth_dataset)

WAIT = 120
N_ROUNDS = 3
N_READS = 17  # make_fragment_dataset: (2000 - 400) // 100 + 1
FRAG_GROUP = 8


@pytest.fixture(scope="module", autouse=True)
def _env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RACON_TPU_MAX_DEVICES", "1")
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


def fasta(polished) -> bytes:
    return b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                    for s in polished)


@pytest.fixture(scope="module")
def contigs2(tmp_path_factory):
    return make_synth_dataset(str(tmp_path_factory.mktemp("c2")), contigs=2)


@pytest.fixture(scope="module")
def contig1(tmp_path_factory):
    return make_synth_dataset(str(tmp_path_factory.mktemp("c1")))


@pytest.fixture(scope="module")
def frags(tmp_path_factory):
    return make_fragment_dataset(str(tmp_path_factory.mktemp("frag")))


@pytest.fixture(scope="module")
def jax_chained():
    """The JAX package's N chained one-shot rounds: polish, redraft,
    polish again (what its own rounds tests hold the server to)."""
    jpol = pytest.importorskip("racon_tpu.core.polisher")
    cache: dict = {}

    def run(paths, n, tmp):
        if (tuple(paths), n) not in cache:
            p = jpol.create_polisher(*paths, jpol.PolisherType.kC, 500,
                                     10.0, 0.3, num_threads=2)
            p.initialize()
            for rnd in range(1, n + 1):
                polished = p.polish(True)
                if rnd < n:
                    p.redraft(polished, str(tmp), tag=f"r{rnd}")
                    p.initialize()
            cache[(tuple(paths), n)] = fasta(polished)
        return cache[(tuple(paths), n)]

    return run


@pytest.fixture(scope="module")
def jax_fragment():
    """The JAX package's one-shot kF polisher, optionally on a target
    slice."""
    jpol = pytest.importorskip("racon_tpu.core.polisher")

    def run(paths):
        p = jpol.create_polisher(*paths, jpol.PolisherType.kF, 500, 10.0,
                                 0.3, num_threads=2)
        p.initialize()
        return fasta(p.polish(True))

    return run


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """The port's server of this file: cache off, small fragment
    groups, two workers."""
    sock = str(tmp_path_factory.mktemp("sock") / "s.sock")
    srv = PolishServer(socket_path=sock, device="cpu", workers=2,
                       warmup=False, frag_group=FRAG_GROUP).start()
    yield srv
    assert srv.drain(timeout=30)


@pytest.fixture(scope="module")
def client(server):
    return PolishClient(socket_path=server.config.socket_path, timeout=WAIT)


@pytest.fixture(scope="module")
def jax_client(tmp_path_factory):
    """The JAX package's server at the same knobs."""
    jserve = pytest.importorskip("racon_tpu.serve")
    sock = str(tmp_path_factory.mktemp("jsock") / "s.sock")
    srv = jserve.PolishServer(socket_path=sock, workers=2, warmup=False,
                              wincache=False, frag_group=FRAG_GROUP,
                              flight_dir="").start()
    yield jserve.PolishClient(socket_path=sock, timeout=WAIT)
    srv.drain(timeout=30)


def raw(paths, **kw) -> dict:
    return dict({"type": "submit", "sequences": os.path.abspath(paths[0]),
                 "overlaps": os.path.abspath(paths[1]),
                 "target": os.path.abspath(paths[2])}, **kw)


def refusal(cl, req) -> tuple[str, str]:
    """(code, message) of a request both servers must refuse; the
    packages' error prefixes differ by name only."""
    with pytest.raises(Exception) as exc_info:
        cl.request(req)
    exc = exc_info.value
    return exc.code, exc.response.get("message").replace(
        "racon_tpu_torch::", "racon_tpu::")


# ------------------------------------------------------------- datasets
def test_make_fragment_dataset_files_equal_jax(tmp_path, monkeypatch):
    jax_server = pytest.importorskip("racon_tpu.serve.server")
    # gzip stamps the write time into each file's header
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    mine = make_fragment_dataset(str(tmp_path / "port"))
    theirs = jax_server.make_fragment_dataset(str(tmp_path / "jax"))
    assert mine[0] == mine[2] and os.path.basename(mine[1]) == \
        os.path.basename(theirs[1])
    for a, b in zip(mine, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a


def test_config_knobs_validated():
    cfg = ServeConfig()
    assert (cfg.wincache, cfg.frag_group, cfg.preempt,
            cfg.abort_margin) == (False, 64, False, None)
    assert ServeConfig(abort_margin=-2).abort_margin == 0.0
    for bad in ({"frag_group": 0}, {"wincache_max_bytes": 0},
                {"wincache_max_bytes": -5}):
        with pytest.raises(RaconError):
            ServeConfig(**bad)


# --------------------------------------------------------------- rounds
def test_rounds_equal_jax_cache_off(client, contigs2, jax_chained, tmp_path):
    want = jax_chained(contigs2, N_ROUNDS, tmp_path)
    res = client.submit(*contigs2, rounds=N_ROUNDS)
    assert res.fasta == want
    block = res.rounds
    assert (block["requested"], block["completed"]) == (N_ROUNDS, N_ROUNDS)
    assert [p["round"] for p in block["per_round"]] == [1, 2, 3]
    for p in block["per_round"]:
        assert p["wall_s"] >= 0.0 and p["sequences"] == 2
        assert "cache" not in p
        # the round's launches (none here: host POA and host alignment)
        assert (p["k1_launches"], p["k2_launches"], p["k3_launches"]) == \
            (0, 0, 0)
    assert "cache" not in block
    # rounds=1 is the single pass; a plain submit has no rounds block
    r1 = client.submit(*contigs2, rounds=1)
    plain = client.submit(*contigs2)
    assert r1.fasta == plain.fasta == jax_chained(contigs2, 1, tmp_path)
    assert plain.rounds == {} and r1.rounds["completed"] == 1


def test_rounds_equal_jax_cache_on_and_resubmit(tmp_path, contigs2,
                                                jax_chained):
    """At `-c 1 --cudaaligner-batches 1`: the plain versions of K1 and K2
    in every round, two rounds (the session engine's bytes are the host
    engine's)."""
    want = jax_chained(contigs2, 2, tmp_path)
    srv = PolishServer(socket_path=str(tmp_path / "s.sock"), device="cpu",
                       workers=2, warmup=False, wincache=True,
                       cuda_poa_batches=1, cuda_aligner_batches=1).start()
    try:
        cl = PolishClient(socket_path=srv.config.socket_path, timeout=WAIT)
        res = cl.submit(*contigs2, rounds=2)
        assert res.fasta == want
        cache = res.rounds["cache"]
        assert cache["misses"] > 0
        assert cache == {
            "hits": sum(p["cache"]["hits"] for p in res.rounds["per_round"]),
            "misses": sum(p["cache"]["misses"]
                          for p in res.rounds["per_round"])}
        # the same job again: every window of every round is a hit, no
        # iteration runs, the bytes do not move
        again = cl.submit(*contigs2, rounds=2)
        assert again.fasta == want
        assert again.rounds["cache"]["misses"] == 0
        assert again.rounds["cache"]["hits"] == (cache["hits"]
                                                 + cache["misses"])
        assert all(p["iterations"] == 0
                   for p in again.rounds["per_round"])
        snap = srv.stats_snapshot()
        wc = snap["batcher"]["wincache"]
        assert wc["entries"] == cache["misses"] and wc["bytes"] > 0
        assert snap["rounds"] == {"jobs": 2, "completed": 4,
                                  "inflight": 0}
    finally:
        assert srv.drain(timeout=30)


@pytest.mark.parametrize("bad", [0, 65, -1, True, "two", 1.5])
def test_rounds_validation_as_jax(client, jax_client, contigs2, bad):
    req = raw(contigs2, rounds=bad)
    mine, theirs = refusal(client, req), refusal(jax_client, req)
    assert mine == theirs and mine[0] == "bad-request"


# --------------------------------------------------------- range shards
def test_range_shards_concatenate_and_seg_equal_jax(client, jax_client,
                                                    contig1):
    whole = client.submit(*contig1).fasta.split(b"\n")
    name, data = whole[0][1:].decode(), whole[1]
    segs, metas = [], []
    for lo, hi in ((0, 1000), (1000, 10**9)):
        req = raw(contig1, range_lo=lo, range_hi=hi, stream=True)
        mine, theirs = [], []
        client.request(req, on_part=mine.append)
        jax_client.request(req, on_part=theirs.append)
        assert [(f["fasta"], f["seg"], f["name"]) for f in mine] == \
            [(f["fasta"], f["seg"], f["name"]) for f in theirs]
        assert len(mine) == 1
        segs.append(mine[0]["fasta"].encode("latin-1"))
        metas.append(mine[0]["seg"])
    joined = b"".join(segs)
    ratio = sum(m["polished"] for m in metas) / float(
        metas[0]["total_windows"])
    derived = (f"{name.split()[0]} LN:i:{len(joined)} "
               f"RC:i:{metas[0]['coverage']} XC:f:{ratio:.6f}")
    assert (joined, derived) == (data, name)


# ------------------------------------------------------- fragment jobs
def test_fragment_job_equals_jax(client, jax_client, frags, jax_fragment):
    want = jax_fragment(frags)
    mine, theirs = [], []
    r = client.submit(*frags, fragment=True, on_part=mine.append)
    jax_client.submit(*frags, fragment=True, on_part=theirs.append)
    assert r.fasta == want
    assert [(f["fasta"], f["reads"], f["frag"]) for f in mine] == \
        [(f["fasta"], f["reads"], f["frag"]) for f in theirs]
    assert len(mine) > 1 and all(f["reads"] <= FRAG_GROUP for f in mine)
    expect = 0
    for f in mine:
        lo, hi = f["frag"]
        assert lo == expect and hi > lo
        expect = hi
    assert expect == N_READS
    # buffered, and mode "fragment" through a raw frame, the same bytes
    assert client.submit(*frags, fragment=True).fasta == want
    assert client.request(raw(frags, mode="fragment"))["fasta"].encode(
        "latin-1") == want


def test_frag_slices_concatenate_to_whole(client, frags, jax_fragment):
    cuts = (0, 5, 11, N_READS)
    parts = []
    for lo, hi in zip(cuts, cuts[1:]):
        frames = []
        parts.append(client.submit(*frags, fragment=True, frag_lo=lo,
                                   frag_hi=hi, on_part=frames.append).fasta)
        # the receipts are on the whole read set
        assert frames[0]["frag"][0] == lo and frames[-1]["frag"][1] == hi
    assert b"".join(parts) == jax_fragment(frags)


@pytest.mark.parametrize("kw", [
    {"mode": "fragmnt"},
    {"mode": "fragment", "range_lo": 0, "range_hi": 4},
    {"mode": "fragment", "rounds": 2},
    {"mode": "fragment", "frag_lo": 3, "frag_hi": 3},
    {"mode": "fragment", "frag_lo": -1, "frag_hi": 4},
    {"mode": "fragment", "frag_lo": True, "frag_hi": 4},
    {"mode": "fragment", "frag_lo": 0, "frag_hi": "many"},
    {"mode": "fragment", "frag_lo": 0.5, "frag_hi": 4},
    {"mode": "fragment", "frag_lo": 0, "frag_hi": 4, "rounds": 1},
    {"frag_lo": 0, "frag_hi": 4},
    {"range_lo": 0, "range_hi": 4, "rounds": 2},
    {"range_lo": 4, "range_hi": 4},
    {"range_lo": -1, "range_hi": 4},
    {"range_lo": 0},
    {"range_lo": False, "range_hi": 4}])
def test_refused_combinations_as_jax(client, jax_client, frags, kw):
    req = raw(frags, **kw)
    mine, theirs = refusal(client, req), refusal(jax_client, req)
    assert mine == theirs and mine[0] == "bad-request"


def test_valid_neighbours_accepted(client, frags, contig1, jax_fragment):
    want = jax_fragment(frags)
    assert client.submit(*frags, fragment=True, rounds=1).fasta == want
    assert client.request(raw(contig1, mode="contig"))["type"] == "result"


# ------------------------------------------------------ admit-time ingest
def test_ingest_validate_only(client, frags, contig1, jax_fragment):
    assert client.submit(*frags, fragment=True,
                         ingest=True).fasta == jax_fragment(frags)
    assert client.submit(*contig1, ingest=True).fasta == \
        client.submit(*contig1).fasta


def test_ingest_poisoned_input_refused_server_survives(
        client, jax_client, contig1, tmp_path):
    bad = str(tmp_path / "bad.fasta")
    with open(bad, "w") as fh:
        fh.write("this is not fasta\n")
    # a reads file cut in the middle of a record
    with gzip.open(contig1[0], "rb") as fh:
        body = fh.read()
    cut = str(tmp_path / "cut.fasta")
    with open(cut, "wb") as fh:
        fh.write(body[:body.index(b"\n>r3") + 4])
    for reads in (bad, cut):
        req = raw((reads, contig1[1], contig1[2]), ingest=True)
        with pytest.raises(ServeError) as exc_info:
            client.request(req)
        resp = exc_info.value.response
        assert exc_info.value.code == "bad-request" == refusal(
            jax_client, req)[0]
        assert resp["terminal"] == "rejected-ingest"
        assert resp["stage"] == "validate" and resp["job_id"]
    # the server goes on serving
    assert client.submit(*contig1).fasta.startswith(b">draft")


@pytest.mark.parametrize("kw", [
    {"subsample": {"reference_length": 0, "coverage": 2}},
    {"subsample": {"reference_length": 2000, "coverage": 2, "pct": 50}},
    {"subsample": {"reference_length": 2000, "coverage": 2,
                   "seed": "lucky"}},
    {"subsample": "half"},
    {"ingest": "yes"},
    {"normalize": 1}])
def test_ingest_bad_spec_refused_as_jax(client, jax_client, contig1, kw):
    req = raw(contig1, **kw)
    mine, theirs = refusal(client, req), refusal(jax_client, req)
    assert mine == theirs and mine[0] == "bad-request"


def test_subsample_on_admit_deterministic_and_equal_jax(client, jax_client,
                                                        contig1):
    kw = {"reference_length": 2000, "coverage": 2, "seed": 7}
    a = client.submit(*contig1, subsample=kw)
    assert a.fasta == client.submit(*contig1, subsample=kw).fasta
    assert a.fasta == jax_client.submit(*contig1, subsample=kw).fasta
    c = client.submit(*contig1, subsample=dict(kw, seed=8))
    assert c.fasta != a.fasta
    assert c.fasta == jax_client.submit(*contig1,
                                        subsample=dict(kw, seed=8)).fasta


def test_normalize_on_admit(client, jax_client, tmp_path):
    reads, ovl, draft = make_synth_dataset(str(tmp_path))
    # the PAF names the reads as normalization will rename them
    # ("r0" -> "r01"): the job polishes only if the server renamed them
    ovl_norm = str(tmp_path / "ovl_norm.paf.gz")
    with gzip.open(ovl, "rt") as fh, gzip.open(ovl_norm, "wt") as out:
        for line in fh:
            cols = line.split("\t")
            cols[0] += "1"
            out.write("\t".join(cols))
    with pytest.raises(ServeError):
        client.submit(reads, ovl_norm, draft)
    r = client.submit(reads, ovl_norm, draft, normalize=True)
    assert r.fasta.startswith(b">draft")
    assert r.fasta == jax_client.submit(reads, ovl_norm, draft,
                                        normalize=True).fasta


# ------------------------------------------------------------- the CLI
def test_submit_cli_flags(server, contigs2, frags, jax_chained,
                          jax_fragment, tmp_path, capsysbinary):
    from racon_tpu_torch.serve.client import submit_main

    sock = ["--socket", server.config.socket_path]
    assert submit_main(sock + ["--rounds", "2", *contigs2]) == 0
    out = capsysbinary.readouterr()
    assert out.out == jax_chained(contigs2, 2, tmp_path)
    assert b"rounds 2/2: r1=" in out.err
    whole = jax_fragment(frags)
    assert submit_main(sock + ["--fragment", "--ingest", *frags]) == 0
    assert capsysbinary.readouterr().out == whole
    assert submit_main(sock + ["-f", "--stream", "--frag-lo", "0",
                               "--frag-hi", "5", *frags]) == 0
    head = capsysbinary.readouterr().out
    assert whole.startswith(head) and 0 < head.count(b">") <= 5
