"""The router's window-range shards in the port (serve/router.py), against
the JAX package.

Inputs: the port's one-contig `make_synth_dataset` triple (the JAX
function's files: a 2 kb draft, 4 windows at w 500, 400 bp reads, seed
11), in-process replicas on the CPU at the server defaults, one torch
thread, fresh winner-table handles (the router file's `_env`).
Tolerance: none.

What is held:

  - `_plan_ranges` gives the JAX router's plan over a grid of contig
    lengths, shard caps and window lengths (hypothesis), and every plan
    cuts at window-grid boundaries, gapless per contig, at most one
    shard a window;
  - the one-contig job over 1, 2 and 4 replicas gives the JAX package's
    unsharded FASTA, buffered and streamed; from 2 replicas on it runs
    as range shards (`router.range`, `range_shards`) and still streams
    one whole-contig part; with the window cache armed on the replicas,
    cold and warm;
  - a replica that drops its range shard after streaming its segment has
    the slice requeued and the segment deduped: the same bytes, the
    journal's `part-routed` receipts tile each contig's grid once;
  - a replica that answers a range child with an unsegmented part fails
    the job typed `replica-incompatible`, never merges it.
"""

import contextlib
import socket

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from racon_tpu_torch.obs.journal import check_consistency, read_journal
from racon_tpu_torch.serve import (PolishClient, PolishRouter, ServeError,
                                   make_synth_dataset)
from racon_tpu_torch.serve.protocol import send_frame
from test_torch_router import (WAIT, DyingProxy, _env,  # noqa: F401
                               jax_polish, start_router, start_server,
                               submit, wait_routable)


@pytest.fixture(scope="module")
def dataset1(tmp_path_factory):
    return make_synth_dataset(str(tmp_path_factory.mktemp("range_data")))


@pytest.fixture(scope="module")
def jax1(dataset1):
    return jax_polish(dataset1)


@pytest.fixture(scope="module")
def range_replicas(tmp_path_factory):
    d = tmp_path_factory.mktemp("range_reps")
    servers = [start_server(d / f"rep{i}.sock", str(d / f"at{i}.json"))
               for i in range(4)]
    yield [s.config.socket_path for s in servers]
    for srv in servers:
        assert srv.drain(timeout=30)


class _C:
    def __init__(self, n: int):
        self.data = b"A" * n


@settings(max_examples=200, deadline=None)
@given(lengths=st.lists(st.integers(1, 12000), min_size=1, max_size=6),
       cap=st.integers(1, 24), wl=st.sampled_from([100, 250, 500, 1000]))
def test_plan_ranges_matches_jax(lengths, cap, wl):
    jrouter = pytest.importorskip("racon_tpu.serve.router")
    contigs = [_C(n) for n in lengths]
    plan = PolishRouter._plan_ranges(contigs, cap, wl)
    assert plan == jrouter.PolishRouter._plan_ranges(contigs, cap, wl)
    by_c: dict = {}
    for ci, lo, hi in plan:
        assert lo % wl == 0 and hi % wl == 0 and hi > lo
        by_c.setdefault(ci, []).append((lo, hi))
    assert sorted(by_c) == list(range(len(contigs)))
    for ci, spans in by_c.items():
        w = max(1, (lengths[ci] + wl - 1) // wl)
        assert spans[0][0] == 0 and spans[-1][1] == w * wl
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert len(spans) <= w
    assert len(plan) == max(len(contigs), min(cap, sum(
        max(1, (n + wl - 1) // wl) for n in lengths)))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_range_job_byte_identical_to_jax(dataset1, jax1, range_replicas,
                                         tmp_path, n):
    router = start_router(range_replicas[:n], tmp_path / "r.sock")
    try:
        cl = PolishClient(socket_path=router.config.socket_path,
                          timeout=WAIT)
        wait_routable(cl, n)
        raw = submit(cl, dataset1)
        assert raw["fasta"].encode("latin-1") == jax1
        assert raw["router"]["requeues"] == 0
        if n == 1:
            assert "range" not in raw["router"]
        else:
            assert raw["router"]["range"] is True
            assert raw["router"]["range_shards"] == n
            assert raw["router"]["segments"] == n
        parts: list[dict] = []
        res = cl.submit(*dataset1, on_part=parts.append)
        assert res.fasta == jax1
        assert [p["part"] for p in parts] == [0]
    finally:
        assert router.drain()


def test_range_with_window_cache_byte_identical(dataset1, jax1, tmp_path):
    table = str(tmp_path / "at.json")
    servers = [start_server(tmp_path / f"wc{i}.sock", table, wincache=True)
               for i in range(2)]
    router = start_router([s.config.socket_path for s in servers],
                          tmp_path / "r.sock")
    try:
        cl = PolishClient(socket_path=router.config.socket_path,
                          timeout=WAIT)
        wait_routable(cl, 2)
        for _ in range(2):  # the second run is answered from the cache
            raw = submit(cl, dataset1)
            assert raw["fasta"].encode("latin-1") == jax1
            assert raw["router"]["range"] is True
        hits = sum(s.batcher.wincache.snapshot()["hits"] for s in servers)
        assert hits > 0
    finally:
        assert router.drain()
        for srv in servers:
            assert srv.drain(timeout=30)


@pytest.mark.parametrize("after", [0, 1])
def test_range_shard_requeued_segment_deduped(dataset1, jax1,
                                              range_replicas, tmp_path,
                                              after):
    proxy = DyingProxy(tmp_path / "dying.sock", upstream=range_replicas[0],
                       after=after, dies=2)
    journal = str(tmp_path / "router.jsonl")
    router = start_router([proxy.path, range_replicas[1]],
                          tmp_path / "r.sock", journal=journal)
    try:
        cl = PolishClient(socket_path=router.config.socket_path,
                          timeout=WAIT)
        wait_routable(cl, 2)
        raw = submit(cl, dataset1)
        assert raw["fasta"].encode("latin-1") == jax1
        assert raw["router"]["range"] is True
        assert raw["router"]["requeues"] == 1
        assert raw["router"]["segments"] == 2
        assert proxy.submits
    finally:
        assert router.drain()
        proxy.close()
    entries = read_journal(journal)
    events = [e["event"] for e in entries]
    assert "range-plan" in events and "requeued" in events
    spans = sorted((e["lo"], e["hi"]) for e in entries
                   if e["event"] == "part-routed")
    assert spans[0][0] == 0 and len(spans) == 2
    assert spans[0][1] == spans[1][0]  # each window's segment once
    assert check_consistency(entries) == []


def test_unsegmented_part_fails_typed(dataset1, range_replicas, tmp_path):
    def unsegmented(conn, req):  # a whole-contig part, no `seg`
        with contextlib.suppress(OSError):
            send_frame(conn, {"type": "result_part", "job_id": "stub",
                              "part": 0, "name": "draft",
                              "fasta": ">draft\nACGT\n"})
            send_frame(conn, {"type": "result", "job_id": "stub",
                              "fasta": ""})
            conn.shutdown(socket.SHUT_RDWR)

    stub = DyingProxy(tmp_path / "old.sock", on_submit=unsegmented)
    router = start_router([stub.path, range_replicas[1]],
                          tmp_path / "r.sock")
    try:
        cl = PolishClient(socket_path=router.config.socket_path,
                          timeout=WAIT)
        wait_routable(cl, 2)
        with pytest.raises(ServeError) as exc_info:
            submit(cl, dataset1)
        assert exc_info.value.code == "replica-incompatible"
    finally:
        assert router.drain()
        stub.close()
