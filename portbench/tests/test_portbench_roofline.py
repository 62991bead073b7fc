"""The frozen bound functions give chip_smoke.py's numbers on the same
small tensors, and the deferred terms give the same bounds."""

import os
import sys

import pytest
import torch

from portbench import roofline

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def k1_args(seed, B=4, N=24, L=16, band=(0, 8)):
    g = torch.Generator().manual_seed(seed)
    codes = torch.randint(0, 4, (B, N), generator=g, dtype=torch.int8)
    preds = torch.randint(-1, N, (B, N, 8), generator=g, dtype=torch.int16)
    centers = torch.randint(0, L, (B, N), generator=g, dtype=torch.int32)
    sinks = torch.randint(0, 2, (B, N), generator=g, dtype=torch.int8)
    seq = torch.randint(0, 4, (B, L), generator=g, dtype=torch.int8)
    lens = torch.randint(1, L + 1, (B,), generator=g, dtype=torch.int32)
    bands = torch.tensor([band[i % 2] for i in range(B)], dtype=torch.int32)
    nnodes = torch.randint(0, N + 1, (B,), generator=g, dtype=torch.int32)
    return [codes, preds, centers, sinks, seq, lens, bands, nnodes]


def k2_args(seed, B=5, waves=41, band=6):
    g = torch.Generator().manual_seed(seed)
    ql = torch.randint(1, 20, (B,), generator=g, dtype=torch.int32)
    tl = torch.randint(1, 20, (B,), generator=g, dtype=torch.int32)
    offs = torch.stack([torch.cummax(torch.randint(0, 2, (waves,), generator=g),
                                     0)[0].cumsum(0).to(torch.int32)
                        for _ in range(B)])
    count = torch.randint(1, waves, (B,), generator=g, dtype=torch.int32)
    return ql, tl, offs, band, count


def test_peaks(chip_smoke):
    assert roofline.PEAK_BYTES == chip_smoke.PEAK_BYTES
    assert roofline.PEAK_OPS == chip_smoke.PEAK_OPS
    assert roofline.bound(1e9, 3e9) == chip_smoke.bound(1e9, 3e9)
    assert roofline.bound(1e12, 3e9) == chip_smoke.bound(1e12, 3e9)


@pytest.mark.parametrize("seed", range(4))
def test_window_sweep_bound(chip_smoke, seed):
    args = k1_args(seed)
    want = chip_smoke.window_sweep_bound(args, 16)
    assert roofline.window_sweep_bound(args, 16) == want
    nbytes, ops = roofline.window_sweep_terms(args, 16)
    assert roofline.bound(nbytes, float(ops)) == want


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_wavefront_bound(chip_smoke, seed, packed):
    ql, tl, offs, band, count = k2_args(seed)
    want = chip_smoke.wavefront_bound(ql, tl, offs, band, count, packed)
    assert roofline.wavefront_bound(ql, tl, offs, band, count,
                                    packed) == want
    nbytes, ops = roofline.wavefront_terms(ql, tl, offs, band, count, packed)
    assert roofline.bound(float(nbytes), float(ops)) == want
