"""The windows the fused engine leaves (a node envelope the windows
outgrow) polished by the session engine or the host engine: the port's
polisher with `fused_fallback` against the JAX CLI under
RACON_TPU_FUSED_FALLBACK, on tests/test_torch_fused_cli.py's input.
Tolerance: none — the bytes must be equal."""

import pytest

from racon_tpu_torch.core.polisher import PolisherType, create_polisher
from racon_tpu_torch.ops import poa_fused
from test_torch_fused_cli import _env, run, synth  # noqa: F401


@pytest.mark.parametrize("fallback", ["session", "host"])
def test_fused_fallback_fasta_matches_jax(synth, fallback, monkeypatch):
    from racon_tpu import cli as jax_cli
    from racon_tpu.ops import poa_fused as jax_poa_fused

    # 640 nodes: every window is eligible, and most outgrow it
    small = dict(max_nodes=640, depth_buckets=(8,))

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
    monkeypatch.setenv("RACON_TPU_FUSED_FALLBACK", fallback)
    want, _ = run(jax_cli.main, ["-c", "1", "--tpu-engine", "fused",
                                 *synth])
    pol = create_polisher(*synth, PolisherType.kC, 500, 10.0, 0.3, True,
                          cuda_poa_batches=1, cuda_banded_alignment=False,
                          device="cpu", cuda_engine="fused",
                          fused_fallback=fallback)
    pol.initialize()
    got = b"".join(b">" + s.name.encode() + b"\n" + s.data + b"\n"
                   for s in pol.polish())
    assert got == want
    left = pol.poa.engine.n_fallback
    assert left >= 1
    assert pol.poa.n_fused + left == pol.poa.n_device + pol.poa.n_host
