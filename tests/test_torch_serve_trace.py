"""The warm server's per-job traces, trace pulls and the client's clock
handshake in the port, on the CPU.

Inputs: the port's `make_synth_dataset` triple (2 kb draft, 400 bp reads,
seed 11) at the server defaults (host POA, 3/-5/-4), torch at one thread.
Tolerance: the clock handshake recovers an injected skew to within half
its round trip plus 5 ms (the reads between the skew and the pong); a
server span mapped onto the client's clock lies inside the client's
request span to within the round trip; every other value held is exact.

What is held:

  - `ping` carries the server's `mono_s`; `clock_sync` recovers an
    injected skew of either sign (a stub server whose clock is shifted,
    as the JAX package's distributed-trace test does) and refuses a pong
    without `mono_s`, typed;
  - `submit_traced` returns the job's FASTA (the JAX package's one-shot
    bytes) and one merged document: the client's spans on pid 1, the
    server's `serve.queue_wait`, `serve.job`, the pipeline's stage spans
    and a `serve.iteration` whose `trace_ids` holds the job's id on pid
    2, every server span inside the client's request span; a skew
    injected into the clock moves every server span by exactly it;
    `submit --trace-out` writes the same kind of document;
  - two traced jobs at once each get their own trace, the flight ring is
    the process tracer again after them, and no tracer after the drain;
  - `trace_pull` refuses ids outside 1-64 chars of [A-Za-z0-9._-] with a
    typed bad-request, and returns one id's `serve.queue_wait`,
    `serve.job` and iteration spans and nothing of another id, capped at
    `max_events`;
  - `debug` returns the ring's recent spans, trimmed to `max_events`,
    with the thread names kept.

The JAX package is imported inside the fixture that uses it.
"""

import contextlib
import io
import json
import socket
import sys
import threading
import time

import pytest
import torch

from racon_tpu_torch.obs import trace
from racon_tpu_torch.obs.trace import TraceRecorder
from racon_tpu_torch.serve import (PolishClient, PolishServer, ServeError,
                                   make_synth_dataset)
from racon_tpu_torch.serve.client import merge_trace, submit_main
from racon_tpu_torch.serve.protocol import (ProtocolError, recv_frame,
                                            send_frame)

WAIT = 120


@pytest.fixture(scope="module", autouse=True)
def _env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RACON_TPU_MAX_DEVICES", "1")
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_synth_dataset(str(tmp_path_factory.mktemp("trace")))


@pytest.fixture(scope="module")
def solo_bytes(dataset):
    """The JAX package's one-shot FASTA at the server defaults."""
    jpol = pytest.importorskip("racon_tpu.core.polisher")
    p = jpol.create_polisher(*dataset, jpol.PolisherType.kC, 500, 10.0, 0.3,
                             num_threads=2)
    p.initialize()
    return b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                    for s in p.polish())


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace_srv")
    srv = PolishServer(socket_path=str(d / "s.sock"), device="cpu",
                       warmup=False, workers=2, flight_dir="").start()
    yield srv
    assert srv.drain(timeout=30)
    assert trace.get_tracer() is None


@pytest.fixture(scope="module")
def client(server):
    return PolishClient(socket_path=server.config.socket_path, timeout=WAIT)


class _SkewedPingServer:
    """A frame-protocol stub whose pong reports this process's
    perf_counter shifted by `skew_s` (or no `mono_s` at all)."""

    def __init__(self, sock_path: str, skew_s: float | None):
        self.skew_s = skew_s
        self._stop = threading.Event()
        self._lst = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._lst.bind(sock_path)
        self._lst.listen(4)
        self._lst.settimeout(0.2)
        self.path = sock_path
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._lst.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(WAIT)
            with contextlib.suppress(OSError, ProtocolError):
                while True:
                    req = recv_frame(conn)
                    if req is None:
                        break
                    pong = {"type": "pong"}
                    if self.skew_s is not None:
                        pong["mono_s"] = time.perf_counter() + self.skew_s
                    send_frame(conn, pong)
            with contextlib.suppress(OSError):
                conn.close()

    def close(self):
        self._stop.set()
        with contextlib.suppress(OSError):
            self._lst.close()


# ------------------------------------------------------------- the clock
@pytest.mark.parametrize("skew_s", [0.05, -0.05])
def test_clock_sync_recovers_injected_skew(skew_s, tmp_path):
    stub = _SkewedPingServer(str(tmp_path / "skew.sock"), skew_s)
    try:
        clock = PolishClient(socket_path=stub.path,
                             timeout=WAIT).clock_sync(samples=5)
        assert clock["rtt_s"] > 0
        assert abs(clock["offset_s"] - skew_s) <= \
            clock["rtt_s"] / 2.0 + 0.005
    finally:
        stub.close()


def test_clock_sync_needs_the_mono_sample(tmp_path, client):
    stub = _SkewedPingServer(str(tmp_path / "bare.sock"), None)
    try:
        with pytest.raises(ServeError) as exc_info:
            PolishClient(socket_path=stub.path, timeout=WAIT).clock_sync()
        assert exc_info.value.code == "bad-response"
    finally:
        stub.close()
    t0 = time.perf_counter()
    mono = client.ping()["mono_s"]
    assert t0 <= mono <= time.perf_counter()


# ------------------------------------------------------ per-job traces
def _spans(doc, pid):
    return [e for e in doc["traceEvents"]
            if e.get("pid") == pid and e.get("ph") == "X"]


def test_submit_traced_merges_one_timeline(client, dataset, solo_bytes,
                                           tmp_path):
    out = tmp_path / "t.json"
    result, doc = client.submit_traced(*dataset, trace_id="tr-one",
                                       trace_out=str(out))
    assert result.fasta == solo_bytes
    assert json.load(open(out)) == json.loads(json.dumps(doc))
    assert doc["trace_context"]["trace_id"] == "tr-one"
    assert doc["trace_context"]["stats"]["serve"] == result.serve
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("name") == "process_name"}
    assert names == {"racon_tpu_torch client", "racon_tpu_torch server"}
    client_spans = _spans(doc, 1)
    server_spans = _spans(doc, 2)
    assert {"client.connect", "client.submit", "client.wait",
            "client.receive"} <= {e["name"] for e in client_spans}
    by_name: dict = {}
    for e in server_spans:
        by_name.setdefault(e["name"], []).append(e)
    for name in ("serve.queue_wait", "serve.job"):
        assert [e["args"] for e in by_name[name]] == [
            {"job": result.job_id, "trace_id": "tr-one"}]
    assert any("tr-one" in e["args"]["trace_ids"]
               for e in by_name["serve.iteration"])
    assert {"pipeline.pack", "pipeline.device", "polisher.initialize",
            "polisher.stitch"} <= set(by_name)
    # on the client's clock, the server's spans lie inside the request
    rtt_us = doc["trace_context"]["clock_rtt_s"] * 1e6
    start = min(e["ts"] for e in client_spans
                if e["name"] == "client.submit")
    end = max(e["ts"] + e["dur"] for e in client_spans
              if e["name"] == "client.receive")
    for e in server_spans:
        assert start - rtt_us - 1.0 <= e["ts"], e["name"]
        assert e["ts"] + e["dur"] <= end + rtt_us + 1.0, e["name"]
    # an injected skew moves every server span by exactly it
    rec = TraceRecorder(None)
    rec.rebase(0.0)  # a zero before every span: nothing clamps
    clock = {"offset_s": doc["trace_context"]["clock_offset_s"],
             "rtt_s": 0.0}
    base = merge_trace(result, rec, clock)
    skewed = merge_trace(result, rec, dict(clock,
                                           offset_s=clock["offset_s"] - 0.25))
    shifts = {round(b["ts"] - a["ts"], 1)
              for a, b in zip(_spans(base, 2), _spans(skewed, 2))}
    assert shifts == {250000.0}


def test_submit_cli_trace_out(server, dataset, solo_bytes, tmp_path,
                              monkeypatch):
    out = tmp_path / "cli.json"
    buf = io.BytesIO()
    text = io.TextIOWrapper(buf)
    monkeypatch.setattr(sys, "stdout", text)
    rc = submit_main(["--socket", server.config.socket_path, "--timeout",
                      str(WAIT), "--trace-out", str(out), "--trace-id",
                      "tr-cli", *dataset])
    text.flush()
    monkeypatch.undo()
    assert rc == 0 and buf.getvalue() == solo_bytes
    doc = json.load(open(out))
    assert doc["trace_context"]["trace_id"] == "tr-cli"
    assert {"serve.job", "client.wait"} <= {e["name"]
                                            for e in doc["traceEvents"]}


def test_traced_jobs_at_once_keep_their_traces(server, client, dataset,
                                               solo_bytes):
    results: dict = {}

    def go(tag):
        results[tag] = client.submit(*dataset, trace=True, trace_id=tag)

    threads = [threading.Thread(target=go, args=(f"tr-{i}",))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    for tag, r in results.items():
        assert r.fasta == solo_bytes and r.trace_base_mono is not None
        jobs = [e for e in r.trace if e.get("name") == "serve.job"]
        assert [e["args"]["trace_id"] for e in jobs] == [tag]
    # the scopes restored the flight ring
    assert trace.get_tracer() is server._flight
    assert server.debug_snapshot(0)["flight_installed"] is True


# ------------------------------------------------------------ trace_pull
@pytest.mark.parametrize("req", [{}, {"trace_id": ""},
                                 {"trace_id": "a" * 65},
                                 {"trace_id": "a b"}, {"trace_id": 5},
                                 {"trace_id": "ok", "trace_ids": []},
                                 {"trace_id": "ok", "trace_ids": ["o/k"]}],
                         ids=["missing", "empty", "long", "space",
                              "number", "empty-list", "bad-list"])
def test_trace_pull_refuses_bad_ids(client, req):
    with pytest.raises(ServeError) as exc_info:
        client.request(dict(req, type="trace_pull"))
    assert exc_info.value.code == "bad-request"
    assert "trace_pull" in str(exc_info.value)


def test_trace_pull_returns_one_ids_spans(client, dataset, solo_bytes):
    for tag in ("pull-a", "pull-b"):
        assert client.submit(*dataset, trace_id=tag).fasta == solo_bytes
    body = client.trace_pull("pull-a")
    assert body["type"] == "trace" and body["base_mono"] is not None
    spans = [e for e in body["events"] if e.get("ph") != "M"]
    names = [e["name"] for e in spans]
    assert names.count("serve.queue_wait") == names.count("serve.job") == 1
    assert "serve.iteration" in names
    for e in spans:
        args = e["args"]
        assert (args.get("trace_id") == "pull-a"
                or "pull-a" in args.get("trace_ids", ()))
        assert args.get("trace_id") != "pull-b"
        assert "pull-b" not in args.get("trace_ids", ())
    capped = client.trace_pull("pull-a", max_events=1)
    assert len([e for e in capped["events"] if e.get("ph") != "M"]) == 1


def test_debug_trims_to_max_events(client, dataset):
    client.submit(*dataset, trace_id="dbg")
    full = client.debug(max_events=0)["events"]
    spans = [e for e in full if e.get("ph") != "M"]
    assert len(spans) > 3
    trimmed = client.debug(max_events=3)
    meta = [e for e in trimmed["events"] if e.get("ph") == "M"]
    assert len(trimmed["events"]) - len(meta) == 3
    assert meta and trimmed["flight_installed"] is True
    assert trimmed["dumps"] == []
