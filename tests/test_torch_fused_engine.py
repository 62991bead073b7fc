"""The port's fused engine (racon_tpu_torch/ops/poa_fused.FusedPOA) and
its flags against the JAX package's.

`FusedPOA.consensus` on the CPU (the plain program) gives the JAX
FusedPOA's results and statuses on the same windows — spanning and
non-spanning windows, a backbone-only window, a window outside the
envelope and windows that overflow it on the device — on the split and
the fused posture, with the fallback to the host engine on and off.
`BatchPOA(engine="fused")` routes the windows the fused engine leaves
to the session engine or the host engine as the JAX BatchPOA does under
RACON_TPU_FUSED_FALLBACK. The CLI parses `--cuda-engine` and
`--cuda-fused` (and refuses a bad value as the JAX CLI does), and the
CLI and the wrapper pass them to the polisher. Tolerance: none.
"""

import random

import numpy as np
import pytest
import torch

from racon_tpu_torch import cli, wrapper
from racon_tpu_torch.errors import RaconError
from racon_tpu_torch.ops import poa_fused, poa_fused_kernels
from racon_tpu_torch.ops.poa_fused import FusedPOA
from racon_tpu_torch.pipeline import DispatchPipeline
from test_torch_fused_poa import make_windows, pack


@pytest.fixture(autouse=True)
def _one_device(monkeypatch):
    monkeypatch.setenv("RACON_TPU_MAX_DEVICES", "1")
    monkeypatch.setenv("RACON_TPU_STRICT", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def engine_windows():
    """Deep spanning windows, non-spanning ones, windows that outgrow 400
    nodes on the device, a backbone-only window and one whose backbone
    is beyond the envelope."""
    rng = random.Random(21)
    ws = (make_windows(rng, 3, length=150, depth=9, rate=0.12)
          + make_windows(rng, 2, length=110, depth=5, spanning=False,
                         rate=0.1)
          + make_windows(rng, 2, length=300, depth=8, rate=0.15))
    out = [pack(w) for w in ws]
    out.append([(b"ACGTACGTAC" * 20, None, 0, 199)])
    big = make_windows(rng, 1, length=420, depth=3, rate=0.05)[0]
    out.append(pack(big))
    return out


KW = dict(max_nodes=400, max_len=256, batch_rows=4, depth_buckets=(4, 8))


def assert_same(got, want):
    (gr, gs), (wr, ws) = got, want
    np.testing.assert_array_equal(gs, ws)
    for i, (g, w) in enumerate(zip(gr, wr)):
        if w is None:
            assert g is None, i
            continue
        assert g[0] == w[0], f"window {i} consensus (status {ws[i]})"
        np.testing.assert_array_equal(g[1], w[1])


@pytest.mark.parametrize("fallback", [False, True],
                         ids=["to_caller", "to_host"])
@pytest.mark.parametrize("fused", ["0", "1"])
def test_fused_engine_matches_jax(fused, fallback):
    from racon_tpu.ops.poa_fused import FusedPOA as JaxFusedPOA

    windows = engine_windows()
    jax_eng = JaxFusedPOA(3, -5, -4, num_threads=2,
                          use_fused=fused == "1", **KW)
    want = jax_eng.consensus([list(w) for w in windows], fallback=fallback)
    eng = FusedPOA(3, -5, -4, device="cpu", num_threads=2, fused=fused,
                   **KW)
    with DispatchPipeline(depth=2) as pl:
        got = eng.consensus([list(w) for w in windows], fallback=fallback,
                            pipeline=pl)
    assert_same(got, want)
    statuses = got[1]
    assert statuses[7] == 2                     # backbone-only
    assert (statuses[:5] == 0).all()            # built on the device
    assert eng.n_fallback == jax_eng.n_fallback >= 2
    stats, jax_stats = eng.last_stats, jax_eng.last_stats
    # the fused posture: one launch a chunk; split: one per chained call
    for key in ("chunks", "launches", "fused_chunks"):
        assert stats[key] == jax_stats[key], key
    assert stats["fused_chunks"] == (2 if fused == "1" else 0)
    assert stats["launches"] == (2 if fused == "1" else 4)


@pytest.mark.parametrize("fallback", ["session", "host"])
def test_batchpoa_fused_fallback_matches_jax(fallback, monkeypatch, capsys):
    """Windows the fused engine leaves go to the session engine (default)
    or the host engine: the consensus equals the JAX BatchPOA's under
    RACON_TPU_FUSED_FALLBACK, and the split is logged."""
    from racon_tpu.core.window import Window as JaxWindow
    from racon_tpu.core.window import WindowType as JaxWindowType
    from racon_tpu.ops import poa_fused as jax_poa_fused
    from racon_tpu.ops.poa import BatchPOA as JaxBatchPOA

    from racon_tpu_torch.ops.poa import BatchPOA

    # a node envelope that the windows outgrow on the device
    small = dict(max_nodes=240, max_len=384, batch_rows=4,
                 depth_buckets=(8,))

    class SmallJax(jax_poa_fused.FusedPOA):
        def __init__(self, *a, **kw):
            kw.update(small)
            super().__init__(*a, **kw)

    class Small(poa_fused.FusedPOA):
        def __init__(self, *a, **kw):
            kw.update(small)
            super().__init__(*a, **kw)

    monkeypatch.setattr(jax_poa_fused, "FusedPOA", SmallJax)
    monkeypatch.setattr(poa_fused, "FusedPOA", Small)
    monkeypatch.setenv("RACON_TPU_ENGINE", "fused")
    monkeypatch.setenv("RACON_TPU_FUSED_FALLBACK", fallback)

    def windows(window_cls, type_cls):
        rng = random.Random(13)
        out = []
        for w in make_windows(rng, 4, length=220, depth=5, rate=0.1):
            x = window_cls(0, 0, type_cls.kTGS, w.sequences[0],
                           w.qualities[0])
            for seq, qual, (b, e) in zip(w.sequences[1:], w.qualities[1:],
                                         w.positions[1:]):
                x.add_layer(seq, qual, b, e)
            out.append(x)
        return out

    want = windows(JaxWindow, JaxWindowType)
    JaxBatchPOA(3, -5, -4, 220, device_batches=1).generate_consensus(
        want, trim=False)
    got = windows(*_port_window())
    eng = BatchPOA(3, -5, -4, 220, device_batches=1, device="cpu",
                   engine="fused", fused_fallback=fallback)
    eng.generate_consensus(got, trim=False)
    for g, w in zip(got, want):
        assert g.polished and g.consensus == w.consensus
    err = capsys.readouterr().err
    assert f"to {fallback} engine" in err
    assert eng.n_fused < len(got)
    assert eng.n_device == (len(got) if fallback == "session"
                            else eng.n_fused)


def _port_window():
    from racon_tpu_torch.core.window import Window, WindowType

    return Window, WindowType


def test_batchpoa_refuses_unknown_engine():
    from racon_tpu_torch.ops.poa import BatchPOA

    with pytest.raises(ValueError, match="engine"):
        BatchPOA(3, -5, -4, 500, engine="bogus")
    with pytest.raises(ValueError, match="fallback"):
        BatchPOA(3, -5, -4, 500, fused_fallback="bogus")
    with pytest.raises(ValueError, match="posture"):
        FusedPOA(3, -5, -4, device="cpu", fused="2")


def test_fused_engine_on_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RaconError, match="no CUDA device"):
        FusedPOA(3, -5, -4, device="cuda")


def test_fused_layers_runs_plain_version_on_cpu_tensors():
    """On CPU tensors the wrapper runs the plain version and counts no
    kernel launch."""
    windows = [pack(w) for w in make_windows(random.Random(4), 2,
                                             length=80, depth=4)]
    eng = FusedPOA(3, -5, -4, device="cpu", max_nodes=256, max_len=128,
                   batch_rows=2, depth_buckets=(4,))
    state, calls = eng._pack_chunk(windows, [0, 1])
    (d, ops, _), = calls
    t = [torch.from_numpy(np.array(x)) for x in state]
    o = [torch.from_numpy(np.array(x)) for x in ops]
    before = poa_fused_kernels.launches
    out = poa_fused_kernels.fused_layers(
        tuple(t), o[0], o[1], o[2], tuple(o[3:]),
        torch.zeros(2, dtype=torch.int32), 3, -5, -4)
    assert poa_fused_kernels.launches == before
    want = poa_fused.fused_raw(256, 128, d, 8, 3, -5, -4)(
        *t, *o, torch.zeros(2, dtype=torch.int32))
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    assert (out[8] > torch.from_numpy(state[8])).all()  # the graphs grew


def test_cli_parses_engine_flags():
    opts = cli.parse_args(["a", "b", "c"])
    assert (opts["cuda_engine"], opts["cuda_fused"]) == ("session", "auto")
    opts = cli.parse_args(["--cuda-engine", "fused", "--cuda-fused=1", "a",
                           "b", "c"])
    assert (opts["cuda_engine"], opts["cuda_fused"]) == ("fused", "1")
    assert "--cuda-engine <session|fused>" in cli.HELP
    assert "--cuda-fused <auto|0|1>" in cli.HELP


@pytest.mark.parametrize("flag,value,message", [
    ("--cuda-engine", "bogus", "--cuda-engine must be 'session' or 'fused'"),
    ("--cuda-fused", "2", "--cuda-fused must be '0', '1' or 'auto'"),
])
def test_cli_refuses_bad_engine_flag(flag, value, message, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.parse_args([flag, value, "a", "b", "c"])
    assert exc.value.code == 1
    assert message in capsys.readouterr().err


class _Captured(Exception):
    pass


def _capture(monkeypatch):
    from racon_tpu_torch.core import polisher

    seen = {}

    def fake(*args, **kw):
        seen.update(kw)
        raise _Captured()

    monkeypatch.setattr(polisher, "create_polisher", fake)
    return seen


def test_cli_passes_engine_flags_to_polisher(monkeypatch):
    seen = _capture(monkeypatch)
    with pytest.raises(_Captured):
        cli.main(["--device", "cpu", "-c", "1", "--cuda-engine", "fused",
                  "--cuda-fused", "1", "r.fa", "o.paf", "t.fa"])
    assert (seen["cuda_engine"], seen["cuda_fused"]) == ("fused", "1")


def test_wrapper_passes_engine_flags_to_polisher(monkeypatch, tmp_path):
    seen = _capture(monkeypatch)
    target = tmp_path / "t.fa"
    target.write_text(">t\nACGT\n")
    with pytest.raises(_Captured):
        wrapper.main(["--device", "cpu", "-c", "1", "--cuda-engine",
                      "fused", "--cuda-fused", "0", "r.fa", "o.paf",
                      str(target)])
    assert (seen["cuda_engine"], seen["cuda_fused"]) == ("fused", "0")
