"""The router's fragment read-range shards in the port (serve/router.py),
against the JAX package.

Inputs: the port's `make_fragment_dataset` (the JAX function's files: 17
noisy 400 bp reads off a 2 kb genome, seed 13, their all-vs-all PAF, the
reads also the targets), in-process replicas on the CPU at the server
defaults, one torch thread, fresh winner-table handles (the router
file's `_env`). Tolerance: none.

What is held:

  - the read-index slices a fragment job's children carry equal the JAX
    router's for the same read count, routable replicas and shard cap
    (hypothesis over the grid, through replicas that record each child):
    contiguous, ascending, covering [0, reads), one shard per replica up
    to the cap, no slice when one shard;
  - the fragment job over 1, 2 and 4 replicas gives the JAX package's
    unsharded corrected reads, buffered and streamed, with
    `router.fragment`, `frag_shards` and `reads` set;
  - a replica that drops its slice at once has it requeued; one that
    dies after streaming its first read group has the rerun's duplicate
    group dropped: the journal's `part-routed` receipts tile [0, 17)
    once, and `check_consistency` passes.
"""

import contextlib
import itertools
import os

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from racon_tpu_torch.obs.journal import check_consistency, read_journal
from racon_tpu_torch.serve import PolishClient, make_fragment_dataset
from racon_tpu_torch.serve.protocol import send_frame
from racon_tpu_torch.serve.router import plan_fragment_ranges
from test_torch_router import (WAIT, DyingProxy, _env,  # noqa: F401
                               jax_polish, start_router, start_server,
                               wait_routable)

N_READS = 17


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_fragment_dataset(str(tmp_path_factory.mktemp("rfrag_data")))


@pytest.fixture(scope="module")
def jax_reads(dataset):
    return jax_polish(dataset, fragment=True)


@pytest.fixture(scope="module")
def frag_replicas(tmp_path_factory):
    d = tmp_path_factory.mktemp("rfrag_reps")
    servers = [start_server(d / f"rep{i}.sock", str(d / f"at{i}.json"))
               for i in range(4)]
    yield [s.config.socket_path for s in servers]
    for srv in servers:
        assert srv.drain(timeout=30)


# ---------------------------------------------------------- the slicing
MAX_REPLICAS = 5


@pytest.fixture(scope="module")
def slicing_fleet(tmp_path_factory):
    """MAX_REPLICAS recording replicas (each child answered at once with
    an empty result) and, for each replica count, a JAX and a port router
    over the first that many."""
    jserve = pytest.importorskip("racon_tpu.serve")
    import racon_tpu_torch.serve as pserve

    d = tmp_path_factory.mktemp("slicing")
    seen: list[dict] = []

    def record(conn, req):
        seen.append(req)
        with contextlib.suppress(OSError):
            send_frame(conn, {"type": "result", "job_id": "stub",
                              "fasta": ""})

    stubs = [DyingProxy(d / f"stub{i}.sock", on_submit=record)
             for i in range(MAX_REPLICAS)]
    routers = {}
    for k in range(1, MAX_REPLICAS + 1):
        for name, mod in (("jax", jserve), ("port", pserve)):
            routers[name, k] = mod.PolishRouter(
                replicas=",".join(s.path for s in stubs[:k]),
                socket_path=str(d / f"{name}{k}.sock"),
                health_interval_s=60.0).start()
    yield {"dir": d, "seen": seen, "routers": routers,
           "files": itertools.count()}
    for r in routers.values():
        r.drain(timeout=10)
    for s in stubs:
        s.close()


def children_of(fleet, name, k, max_shards, target, tag) -> list:
    r = fleet["routers"][name, k]
    r.config.max_shards = max_shards
    fleet["seen"].clear()
    cl = PolishClient(socket_path=r.config.socket_path, timeout=WAIT)
    resp = cl.request({"type": "submit", "sequences": target,
                       "overlaps": target, "target": target,
                       "mode": "fragment", "trace_id": tag})
    assert resp["router"]["fragment"] is True
    return sorted((c["shard"], c["shards"], c.get("frag_lo"),
                   c.get("frag_hi"), c["mode"])
                  for c in fleet["seen"])


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(n_reads=st.integers(1, 40), k=st.integers(1, MAX_REPLICAS),
       max_shards=st.integers(0, 6))
def test_fragment_slicing_matches_jax(slicing_fleet, n_reads, k,
                                      max_shards):
    target = os.path.join(slicing_fleet["dir"],
                          f"reads{next(slicing_fleet['files'])}.fasta")
    with open(target, "w") as fh:
        for i in range(n_reads):
            fh.write(f">read{i}\nACGTACGTAC\n")
    mine = children_of(slicing_fleet, "port", k, max_shards, target, "p")
    theirs = children_of(slicing_fleet, "jax", k, max_shards, target, "j")
    assert mine == theirs
    cap = min(k, max_shards) if max_shards > 0 else k
    plan = plan_fragment_ranges(n_reads, cap)
    assert len(mine) == len(plan) == max(1, min(cap, n_reads))
    if len(plan) > 1:
        assert [(lo, hi) for _, _, lo, hi, _ in mine] == plan
        assert plan[0][0] == 0 and plan[-1][1] == n_reads
        assert all(a[1] == b[0] and a[0] < a[1]
                   for a, b in zip(plan, plan[1:]))
    else:
        assert mine == [(0, 1, None, None, "fragment")]


# ------------------------------------------------------------- byte pins
@pytest.mark.parametrize("n", [1, 2, 4])
def test_fragment_job_byte_identical_to_jax(dataset, jax_reads,
                                            frag_replicas, tmp_path, n):
    router = start_router(frag_replicas[:n], tmp_path / "r.sock")
    try:
        cl = PolishClient(socket_path=router.config.socket_path,
                          timeout=WAIT)
        wait_routable(cl, n)
        r = cl.submit(*dataset, fragment=True)
        assert r.fasta == jax_reads
        assert r.router["fragment"] is True
        assert r.router["frag_shards"] == n
        assert r.router["requeues"] == 0
        assert r.router["reads"] == jax_reads.count(b">") == N_READS
        parts: list[dict] = []
        res = cl.submit(*dataset, fragment=True, on_part=parts.append)
        assert res.fasta == jax_reads
        assert [p["part"] for p in parts] == list(range(len(parts)))
    finally:
        assert router.drain()


# -------------------------------------------------------------- failover
def test_fragment_slice_requeued_to_survivor(dataset, jax_reads,
                                             frag_replicas, tmp_path):
    proxy = DyingProxy(tmp_path / "dying.sock", upstream=frag_replicas[0],
                       after=0, dies=2)
    journal = str(tmp_path / "router.jsonl")
    router = start_router([proxy.path, frag_replicas[1]],
                          tmp_path / "r.sock", journal=journal)
    try:
        cl = PolishClient(socket_path=router.config.socket_path,
                          timeout=WAIT)
        wait_routable(cl, 2)
        r = cl.submit(*dataset, fragment=True)
        assert r.fasta == jax_reads
        assert r.router["requeues"] == 1
        assert proxy.submits
    finally:
        assert router.drain()
        proxy.close()
    events = [e["event"] for e in read_journal(journal)]
    assert "frag-plan" in events and "requeued" in events


def test_fragment_midstream_kill_dedupes_read_groups(dataset, jax_reads,
                                                     tmp_path):
    """Shard 0 of 2 over 17 reads is [0, 8); at 4 reads a group its
    replica streams [0, 4) and dies; the survivor reruns the slice with
    the same group size and its [0, 4) is dropped as a duplicate."""
    table = str(tmp_path / "at.json")
    servers = [start_server(tmp_path / f"g{i}.sock", table, frag_group=4)
               for i in range(2)]
    proxy = DyingProxy(tmp_path / "dying.sock",
                       upstream=servers[0].config.socket_path, after=1,
                       dies=2)
    journal = str(tmp_path / "router.jsonl")
    router = start_router([proxy.path, servers[1].config.socket_path],
                          tmp_path / "r.sock", journal=journal)
    try:
        cl = PolishClient(socket_path=router.config.socket_path,
                          timeout=WAIT)
        wait_routable(cl, 2)
        parts: list[dict] = []
        r = cl.submit(*dataset, fragment=True, on_part=parts.append)
        assert r.fasta == jax_reads
        assert r.router["requeues"] == 1
        assert r.router["reads"] == N_READS
        assert len(parts) == r.router["parts"] == 5  # 4 + 4, 4 + 4 + 1
    finally:
        assert router.drain()
        proxy.close()
        for srv in servers:
            assert srv.drain(timeout=30)
    entries = read_journal(journal)
    receipts = sorted((e["frag_lo"], e["frag_hi"]) for e in entries
                      if e["event"] == "part-routed")
    expect = 0
    for lo, hi in receipts:  # the read axis tiled once, no duplicate
        assert lo == expect and hi > lo
        expect = hi
    assert expect == N_READS
    assert check_consistency(entries) == []
