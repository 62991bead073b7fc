"""The serve subcommands as processes, on the CPU.

`python -m racon_tpu_torch serve --device cpu` runs as a subprocess on a
unix socket (one worker, scores 5/-4/-8, warm-up on). A `submit` whose
fault plan stalls its consensus pass for a few seconds holds the
worker; a second `submit`, named with `--trace-id`, waits in the queue
until `cancel --trace-id` reaches it (the submit then exits 1 with the
typed `cancelled` error); SIGTERM then drains the server: the stalled
job finishes and prints the JAX package's one-shot FASTA of the same
triple (`-c 0`), and the server exits 0. Tolerance: none (bytes).
"""

import os
import signal
import subprocess
import sys
import time

import pytest

from racon_tpu_torch.serve import PolishClient, ServeError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORES = ["-m", "5", "-x", "-4", "-g", "-8"]


def _cli(*args):
    return [sys.executable, "-m", "racon_tpu_torch", *args]


def test_serve_submit_cancel_sigterm(tmp_path):
    jax_server = pytest.importorskip("racon_tpu.serve.server")
    jpol = pytest.importorskip("racon_tpu.core.polisher")
    paths = jax_server.make_synth_dataset(str(tmp_path))
    p = jpol.create_polisher(*paths, jpol.PolisherType.kC, 500, 10.0, 0.3,
                             True, 5, -4, -8, num_threads=2)
    p.initialize()
    want = b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                    for s in p.polish())

    sock = str(tmp_path / "s.sock")
    env = dict(os.environ, PYTHONPATH=REPO)
    log_path = tmp_path / "serve.log"
    with open(log_path, "wb") as log_fh:
        server = subprocess.Popen(
            _cli("serve", "--device", "cpu", "--socket", sock, "--workers",
                 "1", *SCORES), env=env, stderr=log_fh)
    procs = [server]
    try:
        cl = PolishClient(socket_path=sock, timeout=30)
        deadline = time.monotonic() + 60
        while True:
            try:
                assert cl.ping()["warm"]
                break
            except (OSError, ServeError):
                assert time.monotonic() < deadline, "server never came up"
                time.sleep(0.1)

        def until(cond, what):
            limit = time.monotonic() + 30
            while not cond(cl.stats()):
                assert time.monotonic() < limit, what
                time.sleep(0.05)

        stalled = subprocess.Popen(
            _cli("submit", "--socket", sock, "--fault-plan",
                 "unpack:chunk=0:hang=4", *paths),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        procs.append(stalled)
        until(lambda s: s["inflight"] == 1, "the stalled job never ran")
        queued = subprocess.Popen(
            _cli("submit", "--socket", sock, "--trace-id", "waiting",
                 *paths),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        procs.append(queued)
        until(lambda s: s["queue"]["depth"] == 1,
              "the second job never queued")
        cancel = subprocess.run(
            _cli("cancel", "--socket", sock, "--trace-id", "waiting"),
            env=env, capture_output=True, timeout=60)
        assert cancel.returncode == 0, cancel.stderr
        assert b"cancelled queued" in cancel.stderr
        out, err = queued.communicate(timeout=60)
        assert queued.returncode == 1 and b"[cancelled]" in err, err
        assert out == b""

        server.send_signal(signal.SIGTERM)
        out, err = stalled.communicate(timeout=60)
        assert stalled.returncode == 0, err
        assert out == want
        assert server.wait(timeout=60) == 0
        log = log_path.read_bytes()
        assert (b"drained cleanly: jobs admitted 2, completed 1, failed 0, "
                b"expired or cancelled in queue 1") in log, log
        late = subprocess.run(_cli("submit", "--socket", sock, *paths),
                              env=env, capture_output=True, timeout=60)
        assert late.returncode == 1
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
