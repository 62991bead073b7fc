"""Closed-loop clients against a warm in-process `PolishServer`: each of
`clients` threads submits its next job through `PolishClient.submit` as
soon as its last one returns, until the window's seconds have passed; the
jobs in flight then finish and count. Jobs cycle over a pool of `pool`
datasets made from the seed, so no input repeats back to back. The rate
is the jobs returned over the time from the window's start to the last
return.

Traffic keys: `clients`, `pool`, `metric` and `unit`; `server` holds
ServeConfig keywords beyond the configuration's device flags (none: the
server's defaults).
"""

from __future__ import annotations

import os
import threading
import time

from portbench import check, gen


def parse_fasta(data: bytes) -> list:
    out = []
    for block in data.split(b">")[1:]:
        head, _, body = block.partition(b"\n")
        out.append((head.decode(), body.replace(b"\n", b"")))
    return out


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.traffic = ctx.traffic
        self.server = None
        self.paths: list = []
        self.address: dict = {}
        self.before: dict = {}
        self.after: dict = {}

    def prepare(self) -> None:
        self.pool = {}
        for k in range(self.traffic["pool"]):
            ds = gen.from_config(self.cfg, self.ctx.seed, stream=k)
            self.paths.append(gen.write(ds, self.ctx.workdir,
                                        f"{self.cfg['name']}{k}",
                                        self.cfg["contig_name"]))
            self.pool[k] = ds

    def warmup(self) -> None:
        from racon_tpu_torch.serve.server import PolishServer

        rc, dv = self.cfg["racon"], dict(self.cfg["device"])
        sock = os.path.join(self.ctx.workdir, "serve.sock")
        # a unix socket path holds at most 107 bytes; past that, a port
        # on the loopback
        self.address = ({"socket_path": sock} if len(sock) < 100
                        else {"port": 0})
        self.server = PolishServer(
            **self.address, device=self.ctx.device,
            autotune_table=self.ctx.autotune_table,
            flight_dir=os.path.join(self.ctx.workdir, "flight"),
            window_length=rc["window_length"],
            quality_threshold=rc["quality_threshold"],
            error_threshold=rc["error_threshold"], trim=rc["trim"],
            match=rc["match"], mismatch=rc["mismatch"], gap=rc["gap"],
            **dv, **self.traffic.get("server", {})).start()
        if "port" in self.address:
            self.address = {"port": self.server.config.port}
        rec = self._submit(0, "pb-warmup")
        if not rec["ok"]:
            raise RuntimeError(f"warm-up job failed: {rec['error']}")
        self.ctx.capture.runs.clear()

    def _submit(self, k: int, trace_id: str) -> dict:
        from racon_tpu_torch.serve.client import PolishClient

        rec = {"dataset": k, "range": None, "trace_id": trace_id,
               "t0": time.perf_counter()}
        try:
            res = PolishClient(**self.address).submit(*self.paths[k],
                                                      trace_id=trace_id)
            rec["output"] = parse_fasta(res.fasta)
            rec["queue_wait_s"] = float(res.serve.get("queue_wait_s", 0.0))
            rec["ok"] = True
        except Exception as exc:  # a failed job counts; the window goes on
            rec["ok"] = False
            rec["error"] = f"{type(exc).__name__}: {exc}"
        rec["t1"] = time.perf_counter()
        return rec

    def window(self, seconds: float) -> tuple[list, float]:
        jobs: list = []
        lock = threading.Lock()
        counter = [0]
        self.before = dict(self.server.batcher.counters)
        t0 = time.perf_counter()

        def client():
            while time.perf_counter() - t0 < seconds:
                with lock:
                    n = counter[0]
                    counter[0] += 1
                rec = self._submit(n % len(self.paths), f"pb{n}")
                with lock:
                    jobs.append(rec)

        threads = [threading.Thread(target=client, name=f"portbench-client{c}")
                   for c in range(self.traffic["clients"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self.after = dict(self.server.batcher.counters)
        runs = self.ctx.capture.runs
        for rec in jobs:
            rec["run"] = runs.pop(rec["trace_id"], None)
            rec["windows"] = len(rec["run"]["windows"] or ()) \
                if rec["run"] else 0
        jobs.sort(key=lambda r: r["t0"])
        return jobs, t0

    def rate(self, jobs: list, t0: float) -> float:
        end = max(j["t1"] for j in jobs)
        return sum(1 for j in jobs if j["ok"]) / (end - t0)

    def inputs(self, jobs: list) -> dict:
        """check.Inputs of each dataset of the pool: one contig each."""
        return {k: check.contig_inputs(ds, self.cfg["contig_name"],
                                       self.cfg["racon"]["error_threshold"])
                for k, ds in self.pool.items()}

    def close(self) -> None:
        if self.server is not None:
            self.server.drain(timeout=60.0)
            self.server = None
